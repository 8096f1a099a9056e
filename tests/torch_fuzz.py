"""The randomized scenes of ``tests/test_fuzz_parity.py`` for the PyTorch
port, and the port's oracle run on them.

Each case draws its frame size, template size, feature count, threshold
and instance count from ``np.random.RandomState(seed)`` in the order the
JAX test draws them, trains one template and three rotations of it in the
port, and renders the scene (BGR for ``color``, a mask for ``mask``, 16
orientations for ``16ori``, T=(2, 4, 8) for ``3level``). The oracle scores
the port's own templates (training is shared, as in the JAX test), so a
difference isolates to the match path.

Used by ``tests/test_torch_fuzz_parity.py`` (CPU), ``tests/
test_torch_cuda.py`` and ``chip_smoke.py`` (the card). Imports neither JAX
nor the JAX package.
"""

import numpy as np

from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.oracle import reference as oracle
from shape_based_matching_tpu_torch.utils.synthetic import (
    synthetic_scene, synthetic_shape_image)

FUZZ_CASES = ((0, "gray"), (1, "gray"), (2, "gray"), (3, "gray"),
              (4, "color"), (5, "mask"), (6, "16ori"), (7, "3level"))
MERGED_THRESHOLD = 72.0


def fuzz_case(seed: int, variant: str, device):
    """(det, scene, mask, threshold) of one case, trained on `device`."""
    rng = np.random.RandomState(seed)
    # 3 levels need 8*2^2-tileable dims (T=8 two pyrDowns up)
    stride = 32 if variant == "3level" else 16
    h = stride * rng.randint(160 // stride, 384 // stride)
    w = stride * rng.randint(160 // stride, 384 // stride)
    templ_size = int(rng.choice([96, 128, 160]))
    nfeat = int(rng.choice([31, 63, 100]))
    threshold = float(rng.choice([75.0, 85.0, 92.0]))
    n_inst = rng.randint(1, 4)

    n_ori = 16 if variant == "16ori" else 8
    T = (2, 4, 8) if variant == "3level" else (4, 8)
    det = Detector(num_features=nfeat, T=T, num_orientations=n_ori,
                   device=device)
    templ = synthetic_shape_image(templ_size, seed=seed + 10)
    if det.add_template(templ, "fuzz", np.full_like(templ, 255)) != 0:
        raise AssertionError(f"case {seed} {variant}: training failed")
    for a in (37.0, 90.0, 203.5):
        det.add_template_rotate("fuzz", 0, a,
                                (templ_size / 2.0, templ_size / 2.0))

    scene = synthetic_scene(h, w, templ, n_instances=n_inst, seed=seed + 20)
    mask = None
    if variant == "color":
        scene = np.stack([scene,
                          np.clip(scene.astype(np.int16) + 12, 0, 255)
                          .astype(np.uint8),
                          scene // 2], axis=-1)
    elif variant == "mask":
        mask = np.zeros((h, w), np.uint8)
        mask[: 3 * h // 4, : 3 * w // 4] = 255  # exclude a border band
    return det, scene, mask, threshold


def merged_case(device):
    """(det, scene) of the merged three-class case (threshold
    MERGED_THRESHOLD), trained on `device`."""
    h, w = 320, 288
    det = Detector(num_features=63, T=(4, 8), device=device)
    templs = {}
    for i, cid in enumerate(("a", "b", "c")):
        t = synthetic_shape_image(96, seed=40 + i)
        templs[cid] = t
        det.add_template(t, cid, np.full_like(t, 255))
        det.add_template_rotate(cid, 0, 30.0 * (i + 1), (48.0, 48.0))

    scene = synthetic_scene(h, w, templs["a"], 1, seed=50)
    scene[180:276, 20:116] = np.maximum(scene[180:276, 20:116],
                                        templs["b"])
    scene[40:136, 170:266] = np.maximum(scene[40:136, 170:266],
                                        templs["c"])
    return det, scene


def oracle_tps(det, class_id):
    """A class's templates in the oracle's form (per template, per
    level)."""
    return [[{"features": [(f.x, f.y, f.label) for f in t.features],
              "width": t.width, "height": t.height} for t in tp]
            for tp in det.class_templates[class_id]]


def oracle_pyramid(det, scene, mask=None):
    """The oracle's linear-memory pyramid of a frame, and its sizes."""
    return oracle.build_lm_pyramid(scene, det.weak_threshold, det.T_at_level,
                                   n_ori=det.num_orientations, mask=mask)


def oracle_matches(det, pyramid, threshold, class_ids=None):
    """``oracle.match_class`` of every class (all of them by default)."""
    lms, sizes = pyramid
    out = []
    for cid in class_ids or det.class_ids():
        out.extend(oracle.match_class(lms, sizes, det.T_at_level,
                                      oracle_tps(det, cid), threshold, cid))
    return out


def _bits(v) -> int:
    return int(np.float32(v).view(np.uint32))


def port_keys(matches):
    """Distinct (class, template, x, y, float32 bits of the similarity):
    several coarse candidates can refine to one location, and both the
    port's ``_sort_dedup`` and the reference's sort + unique collapse
    those."""
    return sorted({(m.class_id, m.template_id, m.x, m.y, _bits(m.similarity))
                   for m in matches})


def oracle_keys(matches):
    return sorted({(m["class_id"], m["template_id"], m["x"], m["y"],
                    _bits(m["similarity"])) for m in matches})
