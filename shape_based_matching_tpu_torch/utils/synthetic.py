"""Synthetic scenes and the committed template banks, in numpy only.

Copies of ``shape_based_matching_tpu.utils.synthetic`` so the port never
imports the JAX package: the same seeds give the same images,
``load_bank_cache`` reads the same ``bench_banks/*.npz`` snapshots under
the same schema-version check, and ``build_rotated_detector`` trains the
banks those snapshots hold (or, with ``cache=True``, reads them).
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


def synthetic_block_noise_image(size: int = 512, block: int = 4,
                                seed: int = 0) -> np.ndarray:
    """Binary block noise: strong edges everywhere, the texture that fills
    a template's feature budget (the dense banks' training image and the
    frames they are matched on)."""
    rng = np.random.RandomState(seed)
    blocks = rng.rand(size // block, size // block) > 0.5
    img = np.kron(blocks, np.ones((block, block), bool))
    return np.where(img, 220, 30).astype(np.uint8)


def huge_frame(side: int = 4096,
               edges: tuple = (1024, 2048, 3072)) -> np.ndarray:
    """The huge gray frame of the sharded and overflow checks: a
    ``synthetic_scene`` of the star shape with 16 instances (seed 3), and
    one more pasted across each of `edges` (the band edges of 4 row
    shards at 4096^2), centred on that row."""
    templ = synthetic_shape_image(256, 0)
    scene = synthetic_scene(side, side, templ, n_instances=16, seed=3)
    for i, row in enumerate(edges):
        y, x = row - 128, 256 + i * (side - 768) // 2
        scene[y:y + 256, x:x + 256] = np.maximum(
            scene[y:y + 256, x:x + 256], templ)
    return scene


def config_frame(cfg: dict) -> tuple:
    """The frame ([H, W] gray or [H, W, 3] BGR uint8) and mask ([H, W]
    uint8 or None) of a golden configuration (the ``config`` of
    ``tests/goldens/torch_port_*_matches.json``): a ``synthetic_scene`` of
    the star shape or of block noise, made BGR as (f, roll(f, 1, axis=1),
    255 - f) when ``color``, masked by ``RandomState(mask_seed).rand(h, w)
    > 0.25`` when ``mask_seed`` is set."""
    t = cfg.get("template", {"kind": "shape", "size": 256})
    templ = (synthetic_block_noise_image(t["size"], seed=0)
             if t["kind"] == "block_noise"
             else synthetic_shape_image(t["size"], 0))
    h, w = cfg["height"], cfg["width"]
    f = synthetic_scene(h, w, templ, n_instances=cfg["n_instances"],
                        seed=cfg["scene_seed"])
    if cfg.get("color"):
        f = np.stack([f, np.roll(f, 1, axis=1), 255 - f], axis=-1)
    mask = None
    if cfg.get("mask_seed") is not None:
        rng = np.random.RandomState(cfg["mask_seed"])
        mask = (rng.rand(h, w) > 0.25).astype(np.uint8) * 255
    return f, mask


def bank_cache_path(num_templates: int, num_features: int, T=(4, 8),
                    size: int = 256, seed: int = 0, dense: bool = False,
                    n_ori: int = 8) -> str:
    """Path of a committed rotation-bank snapshot (8 or 16 orientations)."""
    t_tag = "-".join(str(t) for t in T)
    name = (f"rot{num_templates}x{num_features}_T{t_tag}_s{size}"
            f"_seed{seed}{'_dense' if dense else ''}"
            f"{'_ori16' if n_ori == 16 else ''}_v{_BANK_CACHE_V}.npz")
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


def build_rotated_detector(num_templates: int = 360, num_features: int = 63,
                           T=(4, 8), size: int = 256, seed: int = 0,
                           dense: bool = False, n_ori: int = 8,
                           device="cuda", cache: bool = False):
    """Train a Detector with one class, "bench": one template trained on
    the star image (block noise when `dense`, feature-saturated templates
    for wide banks) under a full mask, and its num_templates - 1
    rotations by 360/num_templates degree steps about the image centre.
    These are the banks of the ``bank_cache_path`` snapshots (which leave
    out Feature.theta). With `cache` the class is read from its snapshot
    where one is committed, as the JAX package's ``cache=True`` does, and
    trained otherwise. Returns (detector, training image)."""
    from ..models.detector import Detector

    templ_img = (synthetic_block_noise_image(size, seed=seed) if dense
                 else synthetic_shape_image(size, seed))
    det = Detector(num_features=num_features, T=T, num_orientations=n_ori,
                   device=device)
    if cache:
        pyramids = load_bank_cache(bank_cache_path(
            num_templates, num_features, T, size, seed, dense, n_ori))
        if pyramids is not None and len(pyramids) == num_templates:
            det.class_templates["bench"] = pyramids
            return det, templ_img
    tid = det.add_template(templ_img, "bench", np.full_like(templ_img, 255))
    if tid != 0:
        raise RuntimeError("synthetic template training failed")
    step = 360.0 / num_templates
    c = size / 2.0
    det.add_templates_rotate("bench", 0,
                             [i * step for i in range(1, num_templates)],
                             (c, c))
    return det, templ_img
