"""Time the port's frontend and chain kernels of one checkout on one GPU.

    python tools/ab_torch_kernels.py [--root DIR] [--iters 200] [--out FILE]

Imports ``shape_based_matching_tpu_torch`` from DIR (default: this
repository), builds its kernels, and times, with CUDA events (mean of
`iters` queued launches after 20 warm ones), each kernel held bitwise
against its plain twin first:

* ``quant_spread`` (frontend.cu) on the flagship frames: 1024^2 at T=4 and
  their 512^2 pyrDown at T=8, gray 8 orientations at B=1 and B=8, and
  color 8 orientations at 1024^2, B=1;
* ``chain_scores`` (chain.cu) on the 10,000-template bank's coarse level
  (512^2, T=8, K=10000, M=4096) at B=1 and B=8, threshold 85.

The inputs come from fixed seeds and the committed bank, so two checkouts
(for a comparison, run the parent's and this one's in turns, in one chip
call) time the same work. Prints one JSON object and writes it to FILE
when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time_ms(fn, iters: int) -> float:
    for _ in range(20):  # warm: clocks up, caches filled
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _same(got, want) -> bool:
    pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
    return all(torch.equal(g.view(torch.int16) if g.dtype == torch.uint16
                           else g, e.view(torch.int16)
                           if e.dtype == torch.uint16 else e)
               for g, e in pairs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_kernels: CUDA is not available")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import shape_based_matching_tpu_torch as pkg
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.chain_plan import plan_chain
    from shape_based_matching_tpu_torch.ops.cuda import build
    from shape_based_matching_tpu_torch.ops.cuda.chain import (
        chain_scores, chain_scores_plain, plan_to_device)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)
    from shape_based_matching_tpu_torch.ops.filters import pyr_down_u8
    from shape_based_matching_tpu_torch.ops.similarity import (
        LevelBank, _positions, _rmin_for_threshold)
    from shape_based_matching_tpu_torch.utils import synthetic
    from shape_based_matching_tpu_torch.utils.convert import (
        pyramids_to_banks)

    if not os.path.abspath(pkg.__file__).startswith(root):
        raise SystemExit(f"imported {pkg.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.library()
    dev = torch.device("cuda")
    shape = synthetic.synthetic_shape_image(256, 0)
    frames = torch.from_numpy(np.stack([synthetic.synthetic_scene(
        1024, 1024, shape, n_instances=4, seed=3 + i) for i in range(8)])
    ).to(dev)
    half = pyr_down_u8(frames)
    color = torch.stack([frames[:1], frames[:1].roll(1, -1),
                         255 - frames[:1]], dim=1).contiguous()
    rows = []

    def run(kernel, name, fn, plain):
        same = _same(fn(), plain())
        torch.cuda.synchronize()
        ms = _time_ms(fn, args.iters)
        rows.append({"kernel": kernel, "case": name, "bitwise": same,
                     "ms": ms})
        print(f"{kernel} {name}: {ms:.4f} ms, bitwise {same}")

    for name, imgs, T in (("gray8 1024^2 T=4 B=1", frames[:1], 4),
                          ("color8 1024^2 T=4 B=1", color, 4),
                          ("gray8 1024^2 T=4 B=8", frames, 4),
                          ("gray8 512^2 T=8 B=1", half[:1], 8),
                          ("gray8 512^2 T=8 B=8", half, 8)):
        run("frontend.cu", name,
            lambda imgs=imgs, T=T: quant_spread(imgs, 30.0, T),
            lambda imgs=imgs, T=T: quant_spread_plain(imgs, 30.0, T))

    pyr = synthetic.load_bank_cache(os.path.join(
        root, "bench_banks", os.path.basename(
            synthetic.bank_cache_path(10000, 63))))
    bank = pyramids_to_banks(pyr, 2)[-1]
    plan = plan_to_device(plan_chain(LevelBank(*(f.numpy() for f in bank)),
                                     8, (512, 512)), dev)
    bank = LevelBank(*(f.to(dev) for f in bank))
    pos = _positions(bank, 8, 64, 64)
    rmin, _ = _rmin_for_threshold(bank.nfeat,
                                  torch.tensor(85.0, device=dev))
    lms = _batch_pyramid(frames, (4, 8), 2, 30.0)
    for B in (1, 8):
        cargs = (lms[1][:B], plan, pos, rmin)
        run("chain.cu", f"K=10000 M=4096 B={B}",
            lambda cargs=cargs: chain_scores(*cargs),
            lambda cargs=cargs: chain_scores_plain(*cargs))
    out = {"root": root, "card": f"{torch.cuda.get_device_name(0)} [{smi}]",
           "rows": rows}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not all(r["bitwise"] for r in rows):
        raise SystemExit("a kernel disagrees with its twin")


if __name__ == "__main__":
    main()
