"""The ICP kernel against its plain twin over a benchmark cell's frame pool.

For each seed, the cell's bank and 128-frame pool are made as
``portbench.harness.run`` makes them, and every frame goes through
``Detector.match_icp`` on the card; each ``icp_refine_points`` call runs
both ``csrc/icp.cu`` and the plain twin (the torch ops that the
benchmark's reference shares) on the same inputs. Printed and written as
JSON: per seed the candidates compared, those whose pose (dtheta, dscale,
tx, ty), inliers or valid flag differ in any bit, those whose pose gap
reaches ``portbench.harness.POSE_TOL``, and the widest gap of each pose
field. Exits 1 where any candidate differs.

    python3 tools/icp_pool_check.py --workload angle361x128.icp_b1 \\
        --seeds 11 12 13 --out build/icp_pool_check.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import frames, harness  # noqa: E402
from shape_based_matching_tpu_torch import Detector  # noqa: E402
from shape_based_matching_tpu_torch.models import icp  # noqa: E402

FIELDS = ("dtheta_deg", "dscale", "tx", "ty")


def _detector(config: dict, seed: int, device: str):
    shape = frames.shape_image(config, seed)
    det = Detector(num_features=int(config["num_features"]),
                   T=tuple(int(t) for t in config["T"]),
                   weak_threshold=float(config["weak_threshold"]),
                   strong_threshold=float(config["strong_threshold"]),
                   device=device)
    if det.add_template(shape, "c", np.full_like(shape, 255)) != 0:
        raise RuntimeError("training the configuration's shape failed")
    det.add_templates_rotate("c", 0, frames.template_angles(config)[1:],
                             (shape.shape[1] / 2.0, shape.shape[0] / 2.0))
    return det, shape


def check_seed(spec: dict, seed: int, device: str = "cuda",
               n_frames: int | None = None) -> dict:
    config, traffic = spec["config"], spec["traffic"]
    det, shape = _detector(config, seed, device)
    pool = frames.frame_pool(config, traffic, shape, seed)[:n_frames]
    kw = {a: int(traffic[a]) for a in harness.ICP_ARGS}
    acc = {"candidates": 0, "live": 0, "differ": 0, "inliers_differ": 0,
           "valid_differ": 0, "past_tol": 0, **{f: 0.0 for f in FIELDS}}
    kernel = icp.icp_refine_points

    def both(*args, **k):
        got = kernel(*args, **k)
        want = icp.icp_refine_points_plain(*args, **k)
        g = {f: getattr(got, f).cpu().numpy() for f in FIELDS}
        w = {f: getattr(want, f).cpu().numpy() for f in FIELDS}
        inl = got.inliers.cpu().numpy() != want.inliers.cpu().numpy()
        val = got.valid.cpu().numpy() != want.valid.cpu().numpy()
        differ, past = inl | val, np.zeros_like(inl)
        for f in FIELDS:
            differ |= g[f].view(np.int32) != w[f].view(np.int32)
            gap = np.abs(g[f].astype(np.float64) - w[f])
            past |= gap >= harness.POSE_TOL[f]
            acc[f] = max(acc[f], float(gap.max()) if gap.size else 0.0)
        acc["candidates"] += inl.size
        acc["live"] += int(want.valid.sum())
        acc["differ"] += int(differ.sum())
        acc["inliers_differ"] += int(inl.sum())
        acc["valid_differ"] += int(val.sum())
        acc["past_tol"] += int(past.sum())
        return got

    icp.icp_refine_points = both
    try:
        for frame in pool:
            det.match_icp(frame, float(config["match_threshold"]), **kw)
    finally:
        icp.icp_refine_points = kernel
    return {"seed": seed, **acc}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="angle361x128.icp_b1")
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=None,
                    help="the pool's first frames only")
    args = ap.parse_args(argv)
    spec = harness.load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        rows.append(check_seed(spec, seed, args.device, args.frames))
        rows[-1]["seconds"] = time.perf_counter() - t0
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 1 if any(r["differ"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
