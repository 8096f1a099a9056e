"""Streaming batch matching: frames in, packed match arrays out.

The throughput pattern for production serving: keep frames on the
device, run ``Detector.match_batch(..., as_matches=False)`` so nothing
comes back to the host until YOU decide, and read one packed set of
tensors per batch. Prints each batch's time and frames/s, then the CSV
summary.

Usage: python -m shape_based_matching_tpu_torch.examples.streaming_match
       [n_batches] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

from shape_based_matching_tpu_torch.utils.synthetic import (
    build_rotated_detector, synthetic_scene)
from shape_based_matching_tpu_torch.utils.timer import CSVStat


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(n_batches: int = 4, batch: int = 8, num_templates: int = 360,
         hw: int = 1024, device: str = "cuda") -> None:
    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=63, device=device)
    frames = torch.from_numpy(np.stack([
        synthetic_scene(hw, hw, templ_img, n_instances=4, seed=s)
        for s in range(batch)
    ])).to(device)
    _sync(device)

    # warm-up: banks, first launches
    det.match_batch(frames, 85.0, as_matches=False)
    _sync(device)

    stat = CSVStat(["BATCH_MS", "FPS", "DETECTIONS"])
    for b in range(n_batches):
        t0 = time.perf_counter()
        packed = det.match_batch(frames, 85.0, as_matches=False)
        _sync(device)
        dt = (time.perf_counter() - t0) * 1e3
        (k, x, y, sc, valid, overflow) = packed["bench"]
        n = int(valid.sum())
        stat.append([dt, batch / dt * 1e3, n])
        print(f"batch {b}: {dt:6.2f} ms  ({batch / dt * 1e3:6.1f} fps)  "
              f"{n} detections")
    print(stat.summary_csv())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_batches", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n_batches, device=args.device)
