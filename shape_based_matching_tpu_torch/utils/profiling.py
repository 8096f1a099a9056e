"""The device kernels of a call, as torch.profiler records them on the
card. Imports nothing but torch, so a script can load this file by its
path to measure another checkout of the package with the same code."""

from __future__ import annotations

import torch

CALLS = 20  # profiled calls, after one warm call


def device_kernels(fn) -> list[tuple[str, float]]:
    """(name, device ms) of every device kernel that torch.profiler records
    over CALLS calls of `fn`, after one warm call; empty where it records
    no device work."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
