"""With the timed path broken underneath, a run drives on and ``correct``
comes out false: once for each fault a cell of this system can have (an
answer altered where it is produced, an answer left out, a stale answer,
half of a batch left out, a bank trained wrong, a call that fails; for
``match_icp``, besides, a pose altered where it is produced, and an ICP
that returns its state unchanged, takes a step fewer, loses its subpixel
shifts or its flood's smallest stride)."""

import time

import pytest
import torch

from shape_based_matching_tpu_torch.models import detector as dm
from shape_based_matching_tpu_torch.models import icp as picp

from portbench import harness

from .conftest import SEED


def _shift(lists):
    out = []
    for ms in lists:
        ms = list(ms)
        if ms:
            m = ms[0]
            ms[0] = dm.Match(m.x + 1, m.y, m.similarity, m.class_id,
                             m.template_id)
        out.append(ms)
    return out


def _drop(lists):
    return [list(ms)[:-1] for ms in lists]


def _half(lists):
    h = len(lists) // 2
    return lists[:h] + lists[:h] if h else [[] for _ in lists]


class _Stale:
    def __init__(self):
        self.last = None

    def __call__(self, lists):
        out, self.last = (self.last or lists), lists
        return out


FAULTS = {"altered": _shift, "left_out": _drop, "stale": _Stale,
          "half_batch": _half}


def _broken_api(monkeypatch, api, fault):
    """The cell's API entry `api` with `fault` applied to its lists."""
    real = getattr(dm.Detector, api)

    def broken(self, *a, **k):
        if api == "match":
            return fault([real(self, *a, **k)])[0]
        return fault(real(self, *a, **k))

    monkeypatch.setattr(dm.Detector, api, broken)


@pytest.mark.parametrize("cell,api", [("tiny.b1", "match"),
                                      ("tiny.b2", "match_batch")])
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_a_broken_answer_is_not_correct(tiny_root, monkeypatch, cell, api,
                                        name):
    fault = FAULTS[name]
    _broken_api(monkeypatch, api, fault() if name == "stale" else fault)
    r = harness.run(cell, SEED, 0.3, False, time.perf_counter(),
                    device="cpu", root=tiny_root)
    assert r["correct"] is False
    assert r["checks"]["list_mismatch"]["value"] > 0


def test_a_wrongly_trained_bank_is_not_correct(tiny_root, monkeypatch):
    rotate = dm.Detector.add_templates_rotate

    def bad_rotate(self, class_id, zero_id, thetas, center):
        ids = rotate(self, class_id, zero_id, thetas, center)
        f = self.class_templates[class_id][ids[-1]][0].features[0]
        f.label = (f.label + 1) % 8
        return ids

    monkeypatch.setattr(dm.Detector, "add_templates_rotate", bad_rotate)
    r = harness.run("tiny.b1", SEED, 0.3, False, time.perf_counter(),
                    device="cpu", root=tiny_root)
    assert r["correct"] is False
    assert r["checks"]["bank_mismatch"]["value"] == 1


def test_a_failing_call_is_counted_and_not_correct(tiny_root, monkeypatch):
    calls = {"n": 0}
    api = dm.Detector.match

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 6:  # the warm pass has made 4 calls
            raise RuntimeError("injected")
        return api(self, *a, **k)

    monkeypatch.setattr(dm.Detector, "match", flaky)
    r = harness.run("tiny.b1", SEED, 0.3, False, time.perf_counter(),
                    device="cpu", root=tiny_root)
    assert r["correct"] is False and r["failed"] == 1
    assert r["checks"]["failed_frames"]["value"] == 1
    assert r["checks"]["lists_missing"]["value"] == 1


def _icp_broken(monkeypatch, fault):
    real = dm.Detector.match_icp

    def broken(self, *a, **k):
        return fault(real(self, *a, **k))

    monkeypatch.setattr(dm.Detector, "match_icp", broken)


def _nudge(field, by):
    def fault(results):
        results = [dict(r) for r in results]
        if results:
            results[0][field] += by
        return results
    return fault


def _moved_key(results):
    results = [dict(r) for r in results]
    if results:
        m = results[0]["match"]
        results[0]["match"] = dm.Match(m.x, m.y + 1, m.similarity,
                                       m.class_id, m.template_id)
    return results


ICP_FAULTS = {  # just past the pose tolerances, or a key
    "tx_altered": (_nudge("tx", 0.02), "pose_mismatch"),
    "dtheta_altered": (_nudge("dtheta_deg", 0.002), "pose_mismatch"),
    "dscale_altered": (_nudge("dscale", 0.0002), "pose_mismatch"),
    "inliers_altered": (_nudge("inliers", 1), "inliers_mismatch"),
    "key_altered": (_moved_key, "list_mismatch"),
    "left_out": (lambda rs: list(rs)[:-1], "list_mismatch"),
}


@pytest.mark.parametrize("name", sorted(ICP_FAULTS))
def test_a_broken_pose_answer_is_not_correct(tiny_root, monkeypatch, name):
    fault, check = ICP_FAULTS[name]
    _icp_broken(monkeypatch, fault)
    r = harness.run("tiny.icp", SEED, 0.3, False, time.perf_counter(),
                    device="cpu", root=tiny_root)
    assert r["correct"] is False
    assert r["checks"][check]["value"] > r["checks"][check]["limit"]


def _unchanged(monkeypatch):
    real = picp.icp_refine_points

    def unchanged(*a, **k):  # every step returns the state it was given
        return real(*a, **dict(k, iters=0))

    monkeypatch.setattr(picp, "icp_refine_points", unchanged)


def _one_step_fewer(monkeypatch):
    real = picp.icp_refine_points
    monkeypatch.setattr(picp, "icp_refine_points", lambda *a, **k: real(
        *a, **dict(k, iters=k["iters"] - 1)))


def _no_subpixel(monkeypatch):
    real = picp._edge_frontend

    def flat(src, weak):
        edge, normal, subpix = real(src, weak)
        return edge, normal, torch.zeros_like(subpix)

    monkeypatch.setattr(picp, "_edge_frontend", flat)


def _stride_1_dropped(monkeypatch):
    real = picp._strides
    monkeypatch.setattr(picp, "_strides", lambda r: real(r)[:-1])


ICP_STEP_FAULTS = {"unchanged": _unchanged,
                   "one_step_fewer": _one_step_fewer,
                   "no_subpixel": _no_subpixel,
                   "stride_1_dropped": _stride_1_dropped}


@pytest.mark.parametrize("name", sorted(ICP_STEP_FAULTS))
def test_a_broken_icp_is_not_correct(tiny_root, monkeypatch, name):
    """Faults inside the port's ICP layer: the keys stay right, the poses
    go wrong."""
    ICP_STEP_FAULTS[name](monkeypatch)
    r = harness.run("tiny.icp", SEED, 0.3, False, time.perf_counter(),
                    device="cpu", root=tiny_root)
    c = r["checks"]
    assert r["correct"] is False and c["list_mismatch"]["value"] == 0
    assert c["pose_mismatch"]["value"] > 0


def test_a_failing_icp_call_is_counted_and_not_correct(tiny_root,
                                                       monkeypatch):
    calls = {"n": 0}
    api = dm.Detector.match_icp

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 6:  # the warm pass has made 4 calls
            raise RuntimeError("injected")
        return api(self, *a, **k)

    monkeypatch.setattr(dm.Detector, "match_icp", flaky)
    r = harness.run("tiny.icp", SEED, 0.3, False, time.perf_counter(),
                    device="cpu", root=tiny_root)
    assert r["correct"] is False and r["failed"] == 1
    assert r["checks"]["failed_frames"]["value"] == 1
    assert r["checks"]["lists_missing"]["value"] == 1
