"""Generate the full-size JAX goldens that the PyTorch port is held to.

Runs the JAX package's XLA path (``Detector(use_pallas=False)``) once on
each configuration -- a 1024x1024 ``synthetic_scene`` with four instances
(seed 3), T=(4, 8), threshold 85, and one committed rotation bank:

* ``e2e1000``: 1000 templates x 63 features, the flagship bank;
* ``e2e10000``: 10,000 templates x 63 features, the dense bank whose
  coarse level takes the delta chain and whose overflow re-run takes the
  map route --

and writes each match list as ``(template_id, x, y, similarity float32
bits)`` rows to ``tests/goldens/torch_port_<name>_matches.json``.

``tests/test_torch_detector.py`` holds the port's CPU path and
``chip_smoke.py`` the CUDA path to both files.

    JAX_PLATFORMS=cpu python tools/gen_torch_port_golden.py [name ...]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def golden_path(name: str) -> str:
    return os.path.join(ROOT, "tests", "goldens",
                        f"torch_port_{name}_matches.json")


def _config(num_templates: int) -> dict:
    return {
        "bank": (f"bench_banks/rot{num_templates}x63_T4-8_s256_seed0"
                 "_v1.npz"),
        "num_templates": num_templates,
        "num_features": 63,
        "T": [4, 8],
        "height": 1024,
        "width": 1024,
        "n_instances": 4,
        "scene_seed": 3,
        "threshold": 85.0,
    }


CONFIGS = {"e2e1000": _config(1000), "e2e10000": _config(10000)}


def main(names) -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    for name in names or CONFIGS:
        cfg = CONFIGS[name]
        det, templ = build_rotated_detector(
            num_templates=cfg["num_templates"],
            num_features=cfg["num_features"], T=tuple(cfg["T"]))
        det.use_pallas = False
        scene = synthetic_scene(cfg["height"], cfg["width"], templ,
                                n_instances=cfg["n_instances"],
                                seed=cfg["scene_seed"])
        matches = det.match(scene, cfg["threshold"])
        rows = [[m.template_id, m.x, m.y,
                 int(np.float32(m.similarity).view(np.uint32))]
                for m in matches]
        out = golden_path(name)
        with open(out, "w") as f:
            json.dump({"config": cfg, "class_id": "bench",
                       "matches": rows}, f, indent=0)
            f.write("\n")
        print(f"{name}: {len(rows)} matches -> {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
