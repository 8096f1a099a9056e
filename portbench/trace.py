"""The traced window: the benchmark's spans around the calls into each
layer of the port, torch.profiler over the window, and the reduction of
its trace to what the per-layer readers (``portbench/metrics/``) read.

The spans are the benchmark's own: for the traced run only, ``spans``
wraps module functions of the port in ``torch.profiler.record_function``
ranges and records each call's shapes and outputs, and puts every
function back afterwards; the program's files are never touched.

From the trace (exported as Chrome JSON and read back):

* device work is every kernel, memset and copy the card ran inside the
  window; its union is the busy time;
* the host-side CUDA calls that queued device work (launches, memsets,
  copies) count the operations queued, complete even where the device
  side loses events late in a process;
* a device operation belongs to a span when the host call that queued it
  falls inside that span (matched through CUPTI's correlation id);
* an idle gap of the device is named by the innermost span the host was
  in at the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict



def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def _pyramid(a, kw, out):
    return {"frame_shape": tuple(a[0].shape), "T": tuple(a[1]),
            "n_ori": _arg(a, kw, 4, "n_ori", 8)}


def _coarse(a, kw, out):
    return {"frames": int(a[0].shape[0]), "bank": a[1], "T": int(a[2]),
            "size_wh": tuple(a[3]), "cap": int(_arg(a, kw, 5, "cand_cap")),
            "n_ori": _arg(a, kw, 7, "n_ori", 8), "n_above": out[5]}


def _refine(a, kw, out):
    return {"bank": a[1], "k": a[4], "valid": a[7]}


def _nothing(a, kw, out):
    return {}


# the port's functions wrapped in the traced run: (module, attribute,
# span, what a call records for the readers: small tensors and shapes
# only, so that tracing holds no frame's buffers)
_DETECTOR = "shape_based_matching_tpu_torch.models.detector"
WRAPPED = (
    (_DETECTOR, "_planar", "upload", _nothing),
    (_DETECTOR, "_batch_pyramid", "pyramid", _pyramid),
    (_DETECTOR, "coarse_extract", "coarse_extract", _coarse),
    (_DETECTOR, "refine_candidates", "refine.window", _refine),
    (_DETECTOR, "refine_by_maps", "refine.maps", _refine),
    (_DETECTOR, "_to_host", "download", _nothing),
    (_DETECTOR, "Detector._matches", "match_list", _nothing),
    (_DETECTOR, "_sort_dedup", "sort_dedup", _nothing),
)
WINDOW = "window"          # the span around the whole traced window
# idle host seconds at each edge of the traced window: without them the
# profiler can lose the device events at a window's tail on the H100
PAD_S = 0.05
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
QUEUE_CALLS = ("LaunchKernel", "Memset", "Memcpy")


@contextlib.contextmanager
def spans(records: dict, api_span: tuple):
    """Within the block, every function of ``WRAPPED`` and the API entry
    `api_span` = (object, attribute, span name) runs inside a
    record_function range of its span's name, and appends what it
    records to ``records[span]``."""
    import importlib

    from torch.profiler import record_function

    targets = []
    for mod, attr, name, keep in WRAPPED:
        owner = importlib.import_module(mod)
        parts = attr.split(".")
        for p in parts[:-1]:
            owner = getattr(owner, p)
        targets.append((owner, parts[-1], name, keep))
    targets.append(api_span + (_nothing,))

    def wrap(fn, name, keep):
        def traced(*args, **kwargs):
            with record_function(name):
                out = fn(*args, **kwargs)
            records[name].append(keep(args, kwargs, out))
            return out
        return traced

    saved = [(o, a, o.__dict__[a]) for o, a, _, _ in targets]
    try:
        for (owner, attr, name, keep), (_, _, fn) in zip(targets, saved):
            setattr(owner, attr, wrap(fn, name, keep))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


class Window:
    """What the readers see of one traced window.

    frames      frames whose results the window returned
    window_s    the window's length on the host clock
    busy_s      seconds in which the device ran an operation (None where
                the trace holds no device events, as on a CPU run)
    queued      host-side CUDA calls that queued device work
    device_ops  [(name, seconds)] of every device operation in the window
    records     span name -> what each wrapped call recorded (``WRAPPED``)
    span_device {span name: device seconds of the operations it queued}
    gaps        [(host span at the gap, seconds)] of the device's idle gaps
    untraced_s_per_frame
                the host clock's seconds a frame of untraced passes over
                the same pool just before, where the run timed them
    """

    untraced_s_per_frame = None

    def __init__(self, frames, window_s, busy_s, queued, device_ops,
                 records, span_device, gaps):
        self.frames = frames
        self.window_s = window_s
        self.busy_s = busy_s
        self.queued = queued
        self.device_ops = device_ops
        self.records = records
        self.span_device = span_device
        self.gaps = gaps

    def span_s(self, name: str):
        """Device seconds queued inside `name` spans; None where the
        device side recorded nothing (no device time to share)."""
        if self.busy_s is None:
            return None
        return self.span_device.get(name, 0.0)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Spans:
    """Host spans of one name (never nested in each other), for
    containment queries."""

    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [a for a, _ in self.iv]

    def around(self, t: float):
        """The length of the span that holds `t`, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.iv[i][0] <= t <= self.iv[i][1]:
            return self.iv[i][1] - self.iv[i][0]
        return None

    def contains(self, t: float) -> bool:
        return self.around(t) is not None


def _innermost(lookup: dict, t: float) -> str:
    """The name of the shortest span that holds host time `t`."""
    held = [(n_len, name) for name, sp in lookup.items()
            if (n_len := sp.around(t)) is not None]
    return min(held)[1] if held else "host outside the spans"


def read_trace(path: str, frames: int, records: dict) -> Window:
    """Reduce an exported Chrome trace of one window to a ``Window``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans_by_name = defaultdict(list)
    device, runtime = [], {}
    queued_ts = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            spans_by_name[e["name"]].append((ts, ts + dur))
        elif cat in DEVICE_CATS:
            device.append((ts, dur, e["name"],
                           e.get("args", {}).get("correlation")))
        elif cat in RUNTIME_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                runtime[corr] = ts
            if any(c in e["name"] for c in QUEUE_CALLS):
                queued_ts.append(ts)
    (w0, w1), = spans_by_name[WINDOW]
    window_s = (w1 - w0) / 1e6
    queued = sum(1 for t in queued_ts if w0 <= t <= w1)
    inside = [d for d in device if d[0] < w1 and d[0] + d[1] > w0]
    if not inside:
        return Window(frames, window_s, None, queued, [], records, {}, [])
    busy = _union([(max(t, w0), min(t + d, w1)) for t, d, _, _ in inside])
    busy_s = sum(b - a for a, b in busy) / 1e6
    device_ops = [(name, d / 1e6) for _, d, name, _ in inside]
    lookup = {n: _Spans(iv) for n, iv in spans_by_name.items()
              if n != WINDOW}
    span_device = defaultdict(float)
    for _, d, _, corr in inside:
        t = runtime.get(corr)
        if t is None:
            continue
        for n, sp in lookup.items():
            if sp.contains(t):
                span_device[n] += d / 1e6
    edges = [w0] + [v for ab in busy for v in ab] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((_innermost(lookup, (a + b) / 2), (b - a) / 1e6))
    return Window(frames, window_s, busy_s, queued, device_ops, records,
                  dict(span_device), gaps)


def traced_window(run_window, records: dict, api_span: tuple) -> Window:
    """Run `run_window()` (which returns the frames it completed) under
    torch.profiler with the spans on and ``PAD_S`` of idle device at each
    edge, and reduce its trace."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with spans(records, api_span):
        with profile(activities=acts) as prof:
            time.sleep(PAD_S)
            with record_function(WINDOW):
                frames = run_window()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            time.sleep(PAD_S)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_trace(path, frames, records)
    finally:
        os.remove(path)


def breakdown(w: Window, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps by
    what the host was doing, each summed by name, at most `top` each."""
    def top_of(pairs):
        acc = defaultdict(float)
        for n, s in pairs:
            acc[n] += s
        return [[n, s] for n, s in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(w.device_ops), "idle_gaps": top_of(w.gaps)}
