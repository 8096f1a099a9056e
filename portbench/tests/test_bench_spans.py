"""The spans pass (``portbench/spans.py``) and its readers: hand-made
passes, a hand-made trace whose program spans sit inside the benchmark's
own, and the command on a tiny cell on the CPU."""

import json

import pytest

from portbench import harness, spans, trace
from portbench.trace import Window

from .conftest import SEED


class Span:
    def __init__(self, name, start_ns, end_ns, parent=-1):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent = parent


def _pass():
    """Two frames: roots of 10 ms and 6 ms, children covering 9 and 5."""
    s = [Span("sbm.match", 0, 10_000_000),
         Span("sbm.upload", 0, 1_000_000, 0),
         Span("sbm.pyramid", 1_000_000, 5_000_000, 0),
         Span("sbm.pyramid.lm", 2_000_000, 3_000_000, 2),
         Span("sbm.coarse", 5_000_000, 6_000_000, 0),
         Span("sbm.refine", 6_000_000, 6_500_000, 0),
         Span("sbm.download", 6_500_000, 8_000_000, 0),
         Span("sbm.list", 8_000_000, 8_500_000, 0),
         Span("sbm.sort_dedup", 8_500_000, 9_000_000, 0),
         Span("sbm.match", 20_000_000, 26_000_000),
         Span("sbm.pyramid", 20_000_000, 24_000_000, 9),
         Span("sbm.download", 24_000_000, 25_000_000, 9)]
    return spans.SpansPass(2, 0.016, s, {"frames": 2, "candidates": 61,
                                         "bank_builds": 0})


def _window(sp=None):
    w = Window(2, 0.01, None, 0, [], {}, {}, [])
    if sp is not None:
        w.spans = sp
    return w


def test_readers_on_a_hand_made_pass():
    want = {"upload_ms_per_frame": 0.5, "pyramid_host_ms_per_frame": 4.0,
            "coarse_host_ms_per_frame": 0.5,
            "refine_host_ms_per_frame": 0.25,
            "download_wait_ms_per_frame": 1.25, "list_ms_per_frame": 0.5,
            "candidates_per_frame": 30.5}
    for name, value in want.items():
        read = harness.load_reader(harness.ROOT, name)
        assert read(_window(_pass())) == pytest.approx(value), name
        assert read(_window()) is None, name  # no spans pass
    assert _pass().coverage() == pytest.approx(14 / 16)
    by = _pass().by_name()
    assert by["sbm.match"] == pytest.approx((8.0, 1.0))
    assert by["sbm.pyramid"] == pytest.approx((4.0, 3.5))


def test_readers_read_nothing_where_the_pass_kept_nothing():
    empty = spans.SpansPass(2, 0.01, [], {})
    for name in spans.READERS:
        assert harness.load_reader(harness.ROOT, name)(
            _window(empty)) is None, name
    assert empty.coverage() is None


def _trace(path, with_program_spans):
    """A window of two frames: the benchmark's spans, a launch in each,
    and (optionally) the program's spans nested inside them."""
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": args}
    ev = [x("window", "user_annotation", 0, 100),
          x("pyramid", "user_annotation", 10, 30),
          x("cudaLaunchKernel", "cuda_runtime", 15, 1, correlation=1),
          x("quant_spread", "kernel", 16, 4, correlation=1),
          x("download", "user_annotation", 50, 20),
          x("cudaMemcpyAsync", "cuda_runtime", 52, 1, correlation=2),
          x("Memcpy DtoH", "gpu_memcpy", 53, 2, correlation=2),
          x("cudaLaunchKernel", "cuda_runtime", 80, 1, correlation=3),
          x("other", "kernel", 81, 3, correlation=3)]
    if with_program_spans:
        ev += [x("sbm.pyramid", "user_annotation", 11, 28),
               x("sbm.pyramid.frontend", "user_annotation", 14, 8),
               x("sbm.pyramid.frontend", "gpu_user_annotation", 16, 4),
               x("sbm.download", "user_annotation", 51, 18)]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    return trace.read_trace(path, 2, {"pyramid": [{"frames": 2}]})


def test_program_spans_leave_the_benchmark_spans_as_they_were(tmp_path):
    a = _trace(str(tmp_path / "a.json"), False)
    b = _trace(str(tmp_path / "b.json"), True)
    names = {name for _, _, name, _ in trace.WRAPPED}
    assert (a.queued, a.records, a.busy_s, a.device_ops) == (
        b.queued, b.records, b.busy_s, b.device_ops)
    assert {n: s for n, s in b.span_device.items() if n in names} == (
        a.span_device)
    assert a.span_device == pytest.approx({"pyramid": 4e-6,
                                           "download": 2e-6})
    assert b.span_device["sbm.pyramid.frontend"] == pytest.approx(4e-6)
    # the gaps: named by the innermost span, the program's where it has one
    assert [g for g, _ in a.gaps] == ["host outside the spans", "pyramid",
                                      "download", "host outside the spans"]
    assert [g for g, _ in b.gaps] == ["host outside the spans",
                                      "sbm.pyramid", "sbm.download",
                                      "host outside the spans"]
    assert [s for _, s in a.gaps] == [s for _, s in b.gaps]


def test_the_command_on_a_tiny_cell(tiny_root):
    r = spans.measure("tiny.b2", SEED, 2, 0.0, device="cpu", root=tiny_root)
    assert set(spans.READERS) <= set(r["metrics"])
    assert len(r["metrics"]["pyramid_host_ms_per_frame.all"]) == 2
    t = r["tracing"]
    assert t["spans_ms_per_frame"] > 0 and t["untraced_ms_per_frame"] > 0
    assert 0.5 < t["spans_coverage"] <= 1.0
    assert t["counters_in_passes"] == {"bank_builds": 0, "chain_plans": 0}
    assert t["counters_per_frame"]["frames"] == 1.0
    assert t["counters_per_frame"]["steps"] == pytest.approx(
        0.5 + t["counters_per_frame"].get("reruns", 0))
    assert r["device"]["kind"] == "cpu"
