"""How often torch.profiler loses device events from a window of calls, with
and without idle padding at the window's edges, on one GPU.

    python tools/profiler_drops.py [--seconds 180] [--out FILE]

Repeats, until `--seconds` have passed, windows of 20 queued calls (after
one warm call, as ``utils/profiling.device_kernels`` does) of
``extract_counted`` at three shapes (K=1000 M=4096 C=256 at B=1 and B=8,
K=2000 M=65536 C=65536 at B=1; random scores, 1% live, each held bitwise
to its twin first) and of a two-op torch function, each at several
paddings (idle host seconds before the first call and after the final
synchronize, inside the window). A window that records fewer than 2
kernels a call (the torch function: 4, a memset among them) lost
events. Prints one line per window that lost any, and a summary of the windows
and the losses per shape and padding, which ``--out`` also writes as
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20
PADS = (0.0, 0.002, 0.02, 0.05)


def window(fn, pad: float) -> tuple[int, float, float]:
    """(device events recorded, first event's start and last event's end
    in us from the trace's start) of CALLS calls of `fn`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    ev = [e.time_range for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(ev), min((e.start for e in ev), default=-1.0),
            max((e.end for e in ev), default=-1.0))


def extract_args(B: int, K: int, M: int, C: int, seed: int) -> tuple:
    """extract_counted's arguments on random scores in [0, 100), rmin 99,
    every template's positions M - 7."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = torch.randint(0, 100, (B, K, M), dtype=torch.int32, device="cuda",
                      generator=g)
    pos = torch.full((K,), M - 7, dtype=torch.int32, device="cuda")
    rmin = torch.full((K,), 99, dtype=torch.int32, device="cuda")
    j = torch.arange(M, device="cuda")
    cnt = ((S >= rmin[None, :, None]) & (j < pos[:, None])[None]).sum(
        2, dtype=torch.int32)
    t4n = torch.full((K,), 252.0, device="cuda")
    return S, cnt, pos, rmin, t4n, 8, 64, C


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_drops: CUDA is not available")
    sys.path.insert(0, REPO)
    from shape_based_matching_tpu_torch.ops.cuda.extract import (
        extract_counted, extract_counted_plain)

    fns, expect = {}, {}
    for name, shape in (("B=1 K=1000 M=4096 C=256", (1, 1000, 4096, 256)),
                        ("B=8 K=1000 M=4096 C=256", (8, 1000, 4096, 256)),
                        ("B=1 K=2000 M=65536 C=65536",
                         (1, 2000, 65536, 65536))):
        eargs = extract_args(*shape, seed=len(fns))
        got, want = extract_counted(*eargs), extract_counted_plain(*eargs)
        if not all(torch.equal(*(t.view(torch.int32) if t.is_floating_point()
                                 else t for t in pair))
                   for pair in zip(got, want)):
            raise SystemExit(f"extract_counted disagrees with its twin at "
                             f"{name}")
        fns[name] = (lambda a=eargs: extract_counted(*a))
        expect[name] = 2 * CALLS
    ones = torch.ones(1 << 20, device="cuda")
    fns["torch (x * 2 + 1).sum()"] = lambda: (ones * 2 + 1).sum()
    expect["torch (x * 2 + 1).sum()"] = 4 * CALLS

    t0 = time.perf_counter()
    windows = {f"{n} pad {p}": 0 for n in fns for p in PADS}
    lost = dict.fromkeys(windows, 0)
    while time.perf_counter() - t0 < args.seconds:
        for name, fn in fns.items():
            for pad in PADS:
                key = f"{name} pad {pad}"
                n, first, last = window(fn, pad)
                windows[key] += 1
                if n != expect[name]:
                    lost[key] += 1
                    print(f"t={time.perf_counter() - t0:.1f} s {key}: "
                          f"{n} of {expect[name]} events, first start "
                          f"{first:.1f} us, last end {last:.1f} us",
                          flush=True)
    summary = {"windows": windows, "lost": lost,
               "card": torch.cuda.get_device_name(0)}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
