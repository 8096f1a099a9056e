"""Deployment-loop tiers: how many host reads of the card per frame?

A per-frame host-facing detect + subpixel-ICP-refine loop costs
`device compute + n_blocking_reads x read latency`. The equivalent
APIs (same results):

  2 reads  det.match() -> refine_matches_icp()   the 1:1 port of the
           reference's jabil driver flow (test_jabil.cpp:121-312)
  1 read   det.match_icp()                       one-call detect+refine:
           candidate top-k and template points stay on the device, match
           and pose results come back together
  1 read,  det.match_icp_async()                 pipelined: dispatch
  hidden                                         frame N+1 before reading
                                                 frame N
  0/frame  match_refine_batch()                  device-complete; read
           once per batch, whenever the consumer wants

Usage: python -m shape_based_matching_tpu_torch.examples.deployment_loop
       [n_frames] [--device cuda|cpu]
"""

import argparse
import time

import torch

from shape_based_matching_tpu_torch.models.icp import (match_refine_batch,
                                                       refine_matches_icp)
from shape_based_matching_tpu_torch.utils.synthetic import (
    build_rotated_detector, synthetic_scene)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(n_frames: int = 3, num_templates: int = 90, hw: int = 512,
         device: str = "cuda") -> None:
    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=63,
                                            size=min(256, hw // 2),
                                            device=device)
    frame = torch.from_numpy(
        synthetic_scene(hw, hw, templ_img, n_instances=3, seed=7)).to(device)
    _sync(device)

    # --- tier 1: the two-read port of the reference's driver loop -----
    def host_loop():
        matches = det.match(frame, 85.0)
        return refine_matches_icp(det, frame, matches[:16])

    # --- tier 2: one call, one read -----------------------------------
    def one_sync():
        return det.match_icp(frame, 85.0, top_c=16)

    # --- tier 2b: pipelined per frame (dispatch N+1, then read N) -----
    def pipelined(n):
        out = []
        prev = None
        for _ in range(n):
            h = det.match_icp_async(frame, 85.0, top_c=16)
            if prev is not None:
                out.append(prev.result())
            prev = h
        out.append(prev.result())
        return out

    # --- tier 3: device-complete; read once at the end ----------------
    def device_complete(n):
        outs = [match_refine_batch(det, frame[None], 85.0, top_c=16)
                for _ in range(n)]
        _sync(device)
        return outs[-1]

    ref = host_loop()          # also builds the banks, first launches
    assert ref, "no detections in the synthetic scene"
    got = one_sync()
    piped = pipelined(2)
    assert all(p == got for p in piped), "pipelined results differ"
    dev = device_complete(1)

    # all three agree on the top pose
    top = ref[0]
    top1 = got[0]
    assert (top["match"].x, top["match"].y) == (top1["match"].x,
                                                top1["match"].y)
    assert abs(top["dtheta_deg"] - top1["dtheta_deg"]) < 1e-3
    first = dev["bench"][0]
    score = first["score"].cpu()
    best = int(torch.argmax(torch.where(torch.isfinite(score), score,
                                        float("-inf"))))
    assert abs(float(first["icp"].dtheta_deg[best]) - top["dtheta_deg"]) \
        < 1e-3
    print(f"parity ok: top pose ({top['match'].x}, {top['match'].y}) "
          f"dtheta {top['dtheta_deg']:+.3f} deg on all three tiers")

    for name, fn in [("2-sync host loop", lambda: [host_loop()
                                                   for _ in range(n_frames)]),
                     ("1-sync match_icp", lambda: [one_sync()
                                                   for _ in range(n_frames)]),
                     ("pipelined async", lambda: pipelined(n_frames)),
                     ("device-complete", lambda: device_complete(n_frames))]:
        t0 = time.perf_counter()
        fn()
        dt = (time.perf_counter() - t0) / n_frames * 1e3
        print(f"{name:18s} {dt:8.2f} ms/frame")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n_frames, device=args.device)
