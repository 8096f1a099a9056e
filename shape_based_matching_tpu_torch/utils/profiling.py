"""The program's spans and the device work of a call.

**Spans.** ``span(name, **attrs)`` marks a stretch of the match path on
the host. It is off by default: then, unless torch.profiler runs, it
returns one shared no-op context. Inside ``recording()`` every span is
kept (name, start and end on ``time.perf_counter_ns``, the span that
encloses it, the request it belongs to, its attributes) in a list of
slots allocated when the recording starts. While torch.profiler runs,
each span also enters ``torch.profiler.record_function(name)``, so the
spans sit in any exported trace on the trace's own clock; a recording's
anchor (``Recording.wall_ns``) puts its spans on that clock too. Spans
nest by the order in which they open: record one thread at a time.

**Device work.** The device kernels of a call, as torch.profiler records
them on the card, and the synchronizing calls torch makes in it.

Imports nothing but torch, so a script can load this file by its path to
measure another checkout of the package with the same code."""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

# span slots a recording allocates when it starts; a B=1 match keeps 17
# spans, 19 with a re-run
CAPACITY = 1 << 16


class SpanRecord(NamedTuple):
    """One span: `parent` is the index of the span that encloses it in
    ``Recording.spans`` (-1 for a root), `request` the number of its root
    within the recording (1, 2, ...)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: int
    attrs: dict


class Recording:
    """The spans of one ``recording()`` block, by the order they opened."""

    def __init__(self, capacity: int = CAPACITY):
        self._slots = [None] * capacity
        self._n = 0      # slots taken, dropped ones included
        self._open = []  # (slot, request) of each open span, innermost last
        self.requests = 0
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        self.anchor = (wall, (p0 + time.perf_counter_ns()) // 2)

    @property
    def spans(self) -> list:
        """Every span kept, as ``SpanRecord`` s (None for one still open);
        a span's `parent` indexes this list."""
        return [t and SpanRecord(*t)
                for t in self._slots[:min(self._n, len(self._slots))]]

    @property
    def dropped(self) -> int:
        """Spans past the capacity, not kept."""
        return max(0, self._n - len(self._slots))

    def wall_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` stamp as wall-clock ns (``time.time_ns``):
        the clock of an exported Chrome trace, whose ``ts`` (us) x 1000
        plus ``baseTimeNanoseconds`` is wall-clock ns."""
        wall, perf = self.anchor
        return wall + t_ns - perf


class _Noop:
    """The span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def note(self, **attrs) -> None:
        pass


_NOOP = _Noop()
_recording: Recording | None = None


class _Span:
    __slots__ = ("rec", "name", "attrs", "slot", "parent", "request", "t0",
                 "rf")

    def __init__(self, rec: Recording | None, name: str, attrs: dict):
        self.rec, self.name, self.attrs, self.rf = rec, name, attrs, None

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            if rec._open:
                self.parent, self.request = rec._open[-1]
            else:
                rec.requests += 1
                self.parent, self.request = -1, rec.requests
            self.slot = rec._n
            rec._n += 1
            rec._open.append((self.slot, self.request))
            # stamped outside its record_function range: the range's own
            # cost under the profiler falls inside the span
            self.t0 = time.perf_counter_ns()
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        if rec is not None:
            t1 = time.perf_counter_ns()
            rec._open.pop()
            if self.slot < len(rec._slots):
                rec._slots[self.slot] = (self.name, self.t0, t1, self.parent,
                                         self.request, self.attrs)
        return None

    def note(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context around one stretch of the match path, named ``sbm.*``,
    with `attrs` kept beside it (``note(**attrs)`` adds more before it
    closes). Off -- no ``recording()`` and no torch.profiler running --
    it is one shared no-op."""
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(_recording, name, attrs)


@contextlib.contextmanager
def recording(capacity: int = CAPACITY):
    """Keep every span opened in the block, in `capacity` slots allocated
    here (spans past them are counted in ``dropped``); yields the
    ``Recording``."""
    global _recording
    rec, outer = Recording(capacity), _recording
    _recording = rec
    try:
        yield rec
    finally:
        _recording = outer


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
    # a span's record_function range can show on the device side too
    # (a GPU user annotation): no device work
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


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
