"""With the timed path broken underneath, a run drives on and ``correct``
comes out false: once for each fault a cell of this system can have (an
answer altered where it is produced, an answer left out, a stale answer,
half of a batch left out, a bank trained wrong, a call that fails)."""

import time

import pytest

from shape_based_matching_tpu_torch.models import detector as dm

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
