"""The device kernels of a call, as torch.profiler records them on the
card, and the synchronizing calls torch makes in it. Imports nothing but
torch, so a script can load this file by its path to measure another
checkout of the package with the same code."""

from __future__ import annotations

import time
import warnings

import torch

CALLS = 20  # profiled calls, after one warm call
# idle host seconds at each edge of the profiled window: without them
# torch.profiler (CUPTI through kineto) can lose the device events at the
# tail of a window on the H100, torch's own kernels as well as these
# (tools/profiler_drops.py counts the lost windows at several paddings)
PAD_S = 0.05
# host-side CUDA calls that each queue one device kernel, memset or copy
QUEUE_CALLS = ("LaunchKernel", "Memset", "Memcpy")


def _window(fn) -> list:
    """torch.profiler's events over CALLS calls of `fn`, after one warm
    call, with PAD_S of idle device at each edge of the window."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    return list(prof.events())


def _device_events(events: list) -> list[tuple[str, float]]:
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_kernels(fn) -> list[tuple[str, float]]:
    """(name, device ms) of every device event (kernel, memset, copy) that
    torch.profiler records over CALLS calls of `fn`; empty where it
    records no device work."""
    return _device_events(_window(fn))


def device_work(fn) -> tuple[int, list[tuple[str, float]]]:
    """(the host-side CUDA calls that queued device work, the recorded
    device events as ``device_kernels`` gives them) over CALLS calls of
    `fn`, from one profiled window. The host-side records are complete;
    the device-side ones can miss the first kernels of a window (seen on
    the H100 in long processes, padding or not), so a count of device
    work a call is taken from the first and names and times from the
    second."""
    events = _window(fn)
    queued = sum(1 for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and any(c in e.name for c in QUEUE_CALLS))
    return queued, _device_events(events)


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
