"""Where the PyTorch port's match time goes on one NVIDIA GPU.

Runs the flagship frame (1024x1024 synthetic scene, T=(4, 8), threshold
85) with a committed 63-feature rotation bank -- 1000 templates by
default, or the dense 10,000-template bank whose coarse level takes the
delta chain -- through ``Detector(device="cuda")`` and reports

* a stage breakdown of one ``match`` call on the host clock, with a
  synchronize after each stage (upload, pyramid, class step at cap 256
  with its download, overflow re-run, match list);
* a torch.profiler trace of warm ``match`` calls: device time by kernel
  and the device's busy share of the wall time.

    python tools/profile_torch_port.py [--iters 20] [--batch 1]
                                       [--templates 1000|10000]

Writes the tables to chiprun_out/profile_torch_port_t<templates>_b<batch>.txt.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _is_kernel(evt) -> bool:
    from torch.autograd import DeviceType

    return getattr(evt, "device_type", None) == DeviceType.CUDA


def _dev_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--templates", type=int, default=1000,
                    choices=(1000, 10000))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: CUDA is not available")
    sys.path.insert(0, ROOT)
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models import detector as D
    from shape_based_matching_tpu_torch.utils import synthetic as s

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    det = Detector(num_features=63, T=(4, 8), device="cuda")
    det.class_templates["bench"] = s.load_bank_cache(
        s.bank_cache_path(args.templates, 63))
    templ = s.synthetic_shape_image(256, 0)
    frames = np.stack([s.synthetic_scene(1024, 1024, templ, n_instances=4,
                                         seed=3 + i)
                       for i in range(args.batch)])
    thr_v = 85.0
    det.match_batch(frames, thr_v)  # build, warm up
    torch.cuda.synchronize()

    stages: dict[str, list[float]] = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages.setdefault(name, []).append((t1 - t0) * 1e3)
        return t1

    for _ in range(args.iters):
        t = time.perf_counter()
        x = torch.as_tensor(frames).to(det.device)
        t = lap("upload", t)
        lms = D._batch_pyramid(x, det.T_at_level, det.pyramid_levels,
                               det.weak_threshold)
        t = lap("pyramid", t)
        thr = torch.tensor(thr_v, dtype=torch.float32, device=det.device)
        sizes = tuple(det._level_sizes(x.shape[1:3]))
        host = det._class_step(lms, "bench", thr, sizes, 256)
        t = lap("class step (cap 256)", t)
        rows = []
        for b in range(args.batch):
            row = host[b]
            if row[-1] > 256:
                cap = next(c for c in D._CAND_BUCKETS if c >= row[-1])
                row = det._class_step(tuple(f[b:b + 1] for f in lms),
                                      "bench", thr, sizes, cap,
                                      rerun=True)[0]
            rows.append(row)
        t = lap("overflow re-run", t)
        [D._sort_dedup(det._matches(r, "bench")) for r in rows]
        lap("match list", t)

    lines = [f"card: {smi}; {args.templates} templates; batch "
             f"{args.batch}; {args.iters} iterations",
             "stage breakdown (host clock, synchronize after each stage), "
             "median ms:"]
    total = 0.0
    for name, v in stages.items():
        med = float(np.median(v))
        total += med
        lines.append(f"  {name:24s} {med:9.4f}")
    lines.append(f"  {'sum':24s} {total:9.4f}")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            det.match_batch(frames, thr_v)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evts = prof.key_averages()
    kernels = [e for e in evts if _is_kernel(e)]
    busy = sum(_dev_time(e) for e in kernels) / 1e3  # us -> ms
    lines.append(f"profiler: wall {wall / args.iters:.4f} ms/call, device "
                 f"busy {busy / args.iters:.4f} ms/call, idle share "
                 f"{1 - busy / wall:.4f}")
    ranked = sorted(kernels, key=_dev_time, reverse=True)
    lines.append("device time by kernel, ms/call (launches/call):")
    for e in ranked[:25]:
        if _dev_time(e) <= 0:
            break
        lines.append(f"  {_dev_time(e) / 1e3 / args.iters:9.4f}  "
                     f"{e.count / args.iters:6.1f}  {e.key[:90]}")
    text = "\n".join(lines)
    print(text)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = f"profile_torch_port_t{args.templates}_b{args.batch}.txt"
    with open(os.path.join(out, name), "w") as f:
        f.write(text + "\n\n" + evts.table(row_limit=60) + "\n")


if __name__ == "__main__":
    main()
