"""Generate the full-size JAX golden that the PyTorch port is held to.

Runs the JAX package's XLA path (``Detector(use_pallas=False)``) once on
the flagship configuration -- a 1024x1024 ``synthetic_scene`` with four
instances, the committed 1000-template x 63-feature rotation bank,
T=(4, 8), threshold 85 -- and writes the match list as
``(template_id, x, y, similarity float32 bits)`` rows to
``tests/goldens/torch_port_e2e1000_matches.json``.

``tests/test_torch_detector.py`` holds the port's CPU path to this file
and ``chip_smoke.py`` holds the CUDA path to it.

    JAX_PLATFORMS=cpu python tools/gen_torch_port_golden.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "goldens",
                   "torch_port_e2e1000_matches.json")

CONFIG = {
    "bank": "bench_banks/rot1000x63_T4-8_s256_seed0_v1.npz",
    "num_templates": 1000,
    "num_features": 63,
    "T": [4, 8],
    "height": 1024,
    "width": 1024,
    "n_instances": 4,
    "scene_seed": 3,
    "threshold": 85.0,
}


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ = build_rotated_detector(
        num_templates=CONFIG["num_templates"],
        num_features=CONFIG["num_features"], T=tuple(CONFIG["T"]))
    det.use_pallas = False
    scene = synthetic_scene(CONFIG["height"], CONFIG["width"], templ,
                            n_instances=CONFIG["n_instances"],
                            seed=CONFIG["scene_seed"])
    matches = det.match(scene, CONFIG["threshold"])
    rows = [[m.template_id, m.x, m.y,
             int(np.float32(m.similarity).view(np.uint32))]
            for m in matches]
    with open(OUT, "w") as f:
        json.dump({"config": CONFIG, "class_id": "bench",
                   "matches": rows}, f, indent=0)
        f.write("\n")
    print(f"{len(rows)} matches -> {OUT}")


if __name__ == "__main__":
    main()
