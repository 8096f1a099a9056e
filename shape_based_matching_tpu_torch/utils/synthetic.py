"""Synthetic scenes and the committed template banks, in numpy only.

Copies of ``shape_based_matching_tpu.utils.synthetic`` (the pieces the
match path needs) so the port never imports the JAX package: the same
seeds give the same images, and ``load_bank_cache`` reads the same
``bench_banks/*.npz`` snapshots under the same schema-version check.
"""

from __future__ import annotations

import os

import numpy as np

from ..models.template import Feature, Template

# Bank-cache schema version; must equal the JAX package's writer.
_BANK_CACHE_V = 1

BANK_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "bench_banks")


def synthetic_shape_image(size: int = 256, seed: int = 0) -> np.ndarray:
    """A textured polygon on dark background; strong, well-spread edges."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(size, size) * 20).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    c = size / 2.0
    # spiky star polygon: radius modulated by angle
    ang = np.arctan2(yy - c, xx - c)
    rad = np.hypot(yy - c, xx - c)
    rmax = size * (0.28 + 0.10 * np.cos(3 * ang) + 0.06 * np.sin(7 * ang))
    inside = rad < rmax
    img[inside] = 200
    hole = rad < size * (0.08 + 0.03 * np.sin(5 * ang))
    img[hole] = 40
    return img


def synthetic_scene(h: int, w: int, templ: np.ndarray, n_instances: int = 3,
                    seed: int = 1) -> np.ndarray:
    """Paste template instances into a noisy scene."""
    rng = np.random.RandomState(seed)
    scene = (rng.rand(h, w) * 25).astype(np.uint8)
    th, tw = templ.shape
    for _ in range(n_instances):
        y = rng.randint(0, h - th)
        x = rng.randint(0, w - tw)
        region = scene[y: y + th, x: x + tw]
        scene[y: y + th, x: x + tw] = np.maximum(region, templ)
    return scene


def bank_cache_path(num_templates: int, num_features: int, T=(4, 8),
                    size: int = 256, seed: int = 0,
                    dense: bool = False) -> str:
    """Path of a committed 8-orientation rotation-bank snapshot."""
    t_tag = "-".join(str(t) for t in T)
    name = (f"rot{num_templates}x{num_features}_T{t_tag}_s{size}"
            f"_seed{seed}{'_dense' if dense else ''}_v{_BANK_CACHE_V}.npz")
    return os.path.join(BANK_DIR, name)


def load_bank_cache(path: str):
    """Template pyramids from a bank snapshot, or None when the file is
    missing or was written under another schema version."""
    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        if int(z["v"]) != _BANK_CACHE_V:
            return None
        K, levels = int(z["k"]), int(z["levels"])
        feat, offsets = z["feat"], z["offsets"]
        meta_i, meta_f, fid = z["meta_i"], z["meta_f"], z["fid"]
    pyramids, row = [], 0
    for _ in range(K):
        tp = []
        for _ in range(levels):
            fs = feat[offsets[row]:offsets[row + 1]]
            w, h, tlx, tly, lvl, tagf = (int(v) for v in meta_i[row])
            tp.append(Template(
                width=w, height=h, tl_x=tlx, tl_y=tly, pyramid_level=lvl,
                features=[Feature(int(x), int(y), int(lb)) for x, y, lb
                          in fs],
                sscale=float(meta_f[row][0]),
                orientation=float(meta_f[row][1]),
                tag_field_id=tagf, fiducial_src=str(fid[row])))
            row += 1
        pyramids.append(tp)
    return pyramids
