"""The match path's spans and counters (``utils/profiling.span``,
``Detector.counters``) on the CPU, at 256x256 with a bank of 4 templates:
nothing recorded while off, the span tree of a B=1 match and of a batch
whose frames re-run, the counters against what the calls returned, the
lists unchanged by recording, and the recorder's clock against
torch.profiler's trace."""

import json

import numpy as np
import pytest
import torch

from shape_based_matching_tpu_torch.utils import profiling
from shape_based_matching_tpu_torch.utils.synthetic import (
    build_rotated_detector, synthetic_scene)

THRESHOLD = 80.0
CAP = 4  # small enough that both frames of the batch re-run


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    det, templ = build_rotated_detector(num_templates=4, num_features=32,
                                        size=56, device="cpu")
    frames = np.stack([synthetic_scene(256, 256, templ, n_instances=2,
                                       seed=s) for s in (5, 6)])
    det.match(frames[0], THRESHOLD)  # banks and chain plans built
    return det, frames


def _keys(lists):
    return [[(m.class_id, m.template_id, m.x, m.y, m.similarity)
             for m in ms] for ms in lists]


def _tree(rec):
    """(name, parent's name) of every span, and the request ids."""
    spans = rec.spans
    return ([(s.name, spans[s.parent].name if s.parent >= 0 else None)
             for s in spans], {s.request for s in spans})


STEP = [("sbm.step", "sbm.match_batch"), ("sbm.coarse", "sbm.step"),
        ("sbm.refine", "sbm.step"), ("sbm.download", "sbm.match_batch")]
PYRAMID = [("sbm.pyramid", "sbm.match_batch"),
           ("sbm.pyramid.frontend", "sbm.pyramid"),
           ("sbm.pyramid.lm", "sbm.pyramid"),
           ("sbm.pyramid.down", "sbm.pyramid"),
           ("sbm.pyramid.frontend", "sbm.pyramid"),
           ("sbm.pyramid.lm", "sbm.pyramid")]


def test_nothing_recorded_while_off(case):
    det, frames = case
    assert profiling.span("sbm.x", level=1) is profiling.span("sbm.y")
    det.match(frames[0], THRESHOLD)
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.dropped == 0 and rec.requests == 0


def test_b1_match_span_tree(case):
    det, frames = case
    with profiling.recording() as rec:
        got = det.match(frames[0], THRESHOLD)
    names, requests = _tree(rec)
    root = "sbm.match"
    assert names == [(root, None), ("sbm.prepare", root),
                     ("sbm.upload", "sbm.prepare")] + [
        (n, root if p == "sbm.match_batch" else p)
        for n, p in PYRAMID + STEP] + [
        ("sbm.list", root), ("sbm.sort_dedup", root)]
    assert requests == {1}
    s = rec.spans
    assert s[0].attrs == {"B": 1, "classes": 1}
    assert s[2].attrs == {"bytes": frames[0].nbytes}
    assert all(p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns
               for c in s[1:] for p in [s[c.parent]])
    # the pyramid's route: the plain twins on the CPU
    assert [x.attrs for x in s if x.name in ("sbm.pyramid.down",
                                             "sbm.pyramid.lm")] == [
        {"level": 0, "route": "plain"}, {"level": 1, "route": "plain"},
        {"level": 1, "route": "plain"}]
    step = next(x for x in s if x.name == "sbm.step")
    assert step.attrs == {"cap": 256, "rerun": False}
    refine = next(x for x in s if x.name == "sbm.refine")
    assert refine.attrs == {"level": 0}
    assert s[-1].attrs == {"matches": len(got)} and len(got) > 0


def test_batch_rerun_spans_and_counters(case):
    det, frames = case
    lms, sizes, thr, _ = det._prepare(frames, None, THRESHOLD, None)
    n_above = det._step(lms, "bench", thr, sizes, CAP)[5].tolist()
    assert min(n_above) > CAP  # both frames re-run
    det.counters.clear()
    with profiling.recording() as rec:
        got = det.match_batch(frames, THRESHOLD, cand_cap=CAP)
        det.match(frames[1], THRESHOLD)
    names, requests = _tree(rec)
    assert requests == {1, 2}
    assert [n for n, p in names if p is None] == ["sbm.match_batch",
                                                   "sbm.match"]
    reruns = [x for x in rec.spans if x.name == "sbm.rerun"]
    caps = [next(c for c in (256, 1024) if c >= n) for n in n_above]
    assert [x.attrs for x in reruns] == [
        {"frame": b, "n_above": n, "cap": c}
        for b, (n, c) in enumerate(zip(n_above, caps))]
    for r in reruns:
        i = rec.spans.index(r)
        assert rec.spans[r.parent].name == "sbm.match_batch"
        assert [(x.name, x.attrs.get("rerun")) for x in rec.spans
                if x.parent == i] == [("sbm.step", True),
                                      ("sbm.download", None)]
    one = det.match_batch(frames[1:], THRESHOLD)
    c = det.counters
    assert c["candidates"] == sum(n_above) + 2 * n_above[1]
    assert c["matches"] == sum(map(len, got)) + 2 * len(one[0])
    assert (c["frames"], c["steps"], c["reruns"]) == (4, 5, 2)
    assert c["bank_builds"] == c["chain_plans"] == 0
    det.match_batch(frames, THRESHOLD, as_matches=False)
    # as_matches=False: n_above stays on the card, no candidates counted
    assert c["candidates"] == sum(n_above) + 2 * n_above[1]
    assert (c["frames"], c["steps"]) == (6, 6)


def test_lists_equal_with_spans_on_and_off(case):
    det, frames = case
    off = det.match_batch(frames, THRESHOLD, cand_cap=CAP)
    with profiling.recording():
        on = det.match_batch(frames, THRESHOLD, cand_cap=CAP)
    assert _keys(on) == _keys(off) and any(off)


def test_capacity_counts_what_it_drops(case):
    det, frames = case
    with profiling.recording(capacity=5) as rec:
        det.match(frames[0], THRESHOLD)
    assert len(rec.spans) == 5 and rec.dropped > 0
    assert rec.spans[0].name == "sbm.match"


def test_spans_on_the_profiler_clock(case, tmp_path):
    """The kept spans, put on the wall clock by the recording's anchor,
    sit on their record_function ranges in the exported trace (``ts`` us
    x 1000 + ``baseTimeNanoseconds``): a span is stamped just outside its
    range, so each holds its twin to within 0.5 ms, and their starts lie
    within 0.5 ms of each other (the median: on a loaded host a thread
    can lose the CPU between a stamp and its range)."""
    det, frames = case
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        det.match(frames[0], THRESHOLD)  # the first ranges cost more
        with profiling.recording() as rec:
            det.match(frames[0], THRESHOLD)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    twins = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("sbm."):
            t0 = float(e["ts"]) * 1e3 + base
            twins.setdefault(e["name"], []).append(
                (t0, t0 + float(e["dur"]) * 1e3))
    assert sum(map(len, twins.values())) == 2 * len(rec.spans)
    tol = 0.5e6
    starts = []
    for s in rec.spans:
        a, b = rec.wall_ns(s.start_ns), rec.wall_ns(s.end_ns)
        assert any(a - tol <= u0 and u1 <= b + tol
                   for u0, u1 in twins[s.name]), s.name
        starts.append(min(abs(a - u0) for u0, _ in twins[s.name]))
    assert sorted(starts)[len(starts) // 2] < tol
