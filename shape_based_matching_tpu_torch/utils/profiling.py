"""The device kernels of a call, as torch.profiler records them on the
card, and the synchronizing calls torch makes in it. Imports nothing but
torch, so a script can load this file by its path to measure another
checkout of the package with the same code."""

from __future__ import annotations

import warnings

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


def sync_calls(fn):
    """(fn(), the synchronizing CUDA calls torch made in it), counted by
    torch's sync debug mode as warnings."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)
