"""The multi-class match and the rest of the match API in the PyTorch port,
against the JAX package.

Two classes of different feature widths, trained in the port and handed
to the JAX ``Detector`` (``use_pallas=False``) as the same pyramids. The
port's merged step, its per-class steps and JAX's merged step give the
same match lists, compared as (class_id, template_id, x, y, similarity
float32 bits), exactly; so do ``match(..., max_candidates=)`` and
``match_batch(..., as_matches=False)``'s valid entries and overflow
flags. The caches of bank groups drop with every add.
"""

import warnings

import numpy as np
import pytest
import torch

from shape_based_matching_tpu import Detector as JDetector
from shape_based_matching_tpu.ops.pallas.chain_plan import (
    plan_chain as jplan_chain)
from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.ops.similarity import LevelBank
from shape_based_matching_tpu_torch.utils import synthetic as tsyn

THRESHOLD = 75.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(matches):
    return [(m.class_id, m.template_id, m.x, m.y,
             int(np.float32(m.similarity).view(np.uint32)))
            for m in matches]


def _train(det):
    """"wide": 64 features on a 64^2 star and 11 rotations; "narrow": 24
    features on a 48^2 star and 7 rotations."""
    for cid, size, seed, n, nf in (("wide", 64, 0, 12, 64),
                                   ("narrow", 48, 1, 8, 24)):
        img = tsyn.synthetic_shape_image(size, seed)
        assert det.add_template(img, cid, num_features=nf) == 0
        det.add_templates_rotate(cid, 0, [i * 360.0 / n for i in range(1, n)],
                                 (size / 2.0, size / 2.0))


@pytest.fixture(scope="module")
def setup():
    """The port Detector, a JAX Detector on the same pyramids, and three
    256^2 frames that hold both shapes."""
    det = Detector(num_features=64, device="cpu")
    _train(det)
    jdet = JDetector(num_features=64, use_pallas=False)
    jdet.class_templates = {c: list(p) for c, p in
                            det.class_templates.items()}
    frames = []
    for seed in (3, 4, 5):
        f = tsyn.synthetic_scene(256, 256, tsyn.synthetic_shape_image(64, 0),
                                 n_instances=2, seed=seed)
        f[150:198, 20:68] = np.maximum(f[150:198, 20:68],
                                       tsyn.synthetic_shape_image(48, 1))
        frames.append(f)
    return det, jdet, np.stack(frames)


def test_merged_equals_per_class_and_jax(setup):
    """More than one class takes one merged step (cap min(cand_cap * 2,
    4096)); caller order ["wide", "narrow"] is not the sorted one. At
    cand_cap=8 a frame overflows the merged cap of 16 and re-runs."""
    det, jdet, frames = setup
    steps = []
    step = det._class_step

    def spy(lms, group, thr, sizes, cap, rerun=False):
        steps.append((group, cap, rerun))
        return step(lms, group, thr, sizes, cap, rerun)

    det._class_step = spy
    try:
        got = det.match_batch(frames, THRESHOLD, ["wide", "narrow"],
                              cand_cap=8)
    finally:
        del det._class_step
    group = ("narrow", "wide")
    assert steps[0] == (group, 16, False)
    assert any(s[0] == group and s[2] for s in steps[1:])
    assert {s[0] for s in steps} == {group}
    want = jdet.match_batch(frames, THRESHOLD, ["wide", "narrow"],
                            cand_cap=8)
    per_class = [det.match_batch(frames, THRESHOLD, [c]) for c in
                 ("wide", "narrow")]
    for b in range(len(frames)):
        union = sorted(_keys(per_class[0][b] + per_class[1][b]),
                       key=lambda t: (-np.float32(np.uint32(t[4]).view(
                           np.float32)), t[1], t[2], t[3], t[0]))
        assert _keys(got[b]) == _keys(want[b]) == union
        assert {m.class_id for m in got[b]} == {"wide", "narrow"}
    # the default cap, and the merged bank's own layout
    assert [_keys(m) for m in det.match_batch(frames, THRESHOLD)] == \
        [_keys(m) for m in jdet.match_batch(frames, THRESHOLD)]
    banks, class_of_k, tid_of_k = det._get_merged(group)
    jbanks, jclass, jtid = jdet._get_merged_banks(group)
    for bank, jbank in zip(banks, jbanks):
        for f, jf in zip(bank, jbank):
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(class_of_k, jclass)
    np.testing.assert_array_equal(tid_of_k, jtid)


@pytest.mark.parametrize("max_candidates", [16, 2])
def test_max_candidates_equals_jax(setup, max_candidates):
    """match(..., max_candidates=): capped buckets, the first candidates in
    extraction order and JAX's warning, class by class (55 and 68
    candidates on this frame). At 2 the truncation loses matches."""
    det, jdet, frames = setup
    with pytest.warns(UserWarning, match="candidate overflow") as rec:
        got = det.match(frames[1], THRESHOLD, max_candidates=max_candidates)
    with pytest.warns(UserWarning, match="candidate overflow") as jrec:
        want = jdet.match(frames[1], THRESHOLD,
                          max_candidates=max_candidates)
    assert _keys(got) == _keys(want)
    assert [str(w.message) for w in rec] == [str(w.message) for w in jrec]
    assert len(rec) == 2
    full = det.match(frames[1], THRESHOLD)
    assert 0 < len(got) <= len(full)
    assert (len(got) < len(full)) == (max_candidates == 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _keys(det.match(frames[1], THRESHOLD,
                               max_candidates=100000)) == _keys(full)


def test_as_matches_false_equals_jax(setup):
    """The packed per-class results: JAX's valid entries (k, x, y, score
    bits, in slot order) and overflow flags, frame by frame; at cand_cap
    40 some frames overflow (n_above > cand_cap: 31-68 candidates per
    class and frame) and some do not."""
    det, jdet, frames = setup
    got = det.match_batch(frames, THRESHOLD, cand_cap=40, as_matches=False,
                          distinct_cap=64)
    want = jdet.match_batch(frames, THRESHOLD, cand_cap=40,
                            as_matches=False)
    assert list(got) == list(want) == ["wide", "narrow"]
    flags = []
    for cid in got:
        k, x, y, sc, valid, ovf = (a.numpy() for a in got[cid])
        jk, jx, jy, jsc, jvalid, jovf = (np.asarray(a) for a in want[cid])
        assert k.shape == (3, 40) and ovf.shape == (3,)
        np.testing.assert_array_equal(valid, jvalid)
        np.testing.assert_array_equal(ovf, jovf)
        for a, ja in ((k, jk), (x, jx), (y, jy),
                      (sc.view(np.int32), jsc.view(np.int32))):
            np.testing.assert_array_equal(a[valid], ja[valid])
        flags += list(ovf)
    assert any(flags) and not all(flags)


def test_adds_drop_cached_groups(setup):
    """An add into a class drops its banks, max dims and chain plans and
    every merged bank that holds it; the next match sees the new
    template. At most 8 merged banks stay, the oldest goes first."""
    det, _, frames = setup
    det = Detector(num_features=64, device="cpu")
    det.class_templates = {c: list(p) for c, p in
                           setup[0].class_templates.items()}
    det.match_batch(frames[:1], THRESHOLD)
    det._get_chain("narrow", (128, 128))
    group = ("narrow", "wide")
    assert group in det._merged and "narrow" in det._banks
    assert ("narrow", (128, 128)) in det._chain_plans
    before = det.num_templates("narrow")
    tid = det.add_template_rotate("narrow", 0, 7.5, (24.0, 24.0))
    assert tid == before
    assert group not in det._merged and group not in det._banks
    assert "narrow" not in det._banks
    assert not any(k[0] in ("narrow", group) for k in det._chain_plans)
    assert "wide" in det._banks
    got = det.match_batch(frames[:1], THRESHOLD)[0]
    per_class = [det.match_batch(frames[:1], THRESHOLD, [c])[0]
                 for c in ("wide", "narrow")]
    assert sorted(_keys(got)) == sorted(_keys(per_class[0] + per_class[1]))
    assert det._merged[group][0].shape[0] == det.num_templates()

    for i in range(4):  # ten merged groups over five classes
        det.class_templates[f"c{i}"] = det.class_templates["narrow"][:2]
    pairs = [("c0", "c1"), ("c0", "c2"), ("c0", "c3"), ("c1", "c2"),
             ("c1", "c3"), ("c2", "c3"), ("c0", "wide"), ("c1", "wide"),
             ("c2", "wide")]
    for p in pairs:
        det._get_merged(p)
        assert len(det._merged) <= 8
    assert pairs[0] not in det._merged and pairs[-1] in det._merged
    assert group not in det._banks  # evicted with its banks


def test_merged_registry_plans_as_jax():
    """The card's multi-class registry, rot1000x63 + rot1000x128 +
    rot10000x63, merged at a 1024^2 frame's coarse level: the planner
    decides on the merged bank as JAX's plan_chain does."""
    det = Detector(num_features=63, device="cpu")
    for cid, args in (("bench", (1000, 63)), ("wide", (1000, 128)),
                      ("dense", (10000, 63))):
        det.class_templates[cid] = tsyn.load_bank_cache(
            tsyn.bank_cache_path(*args))
    group = ("bench", "dense", "wide")
    bank = det._get_merged(group)[0][-1]
    fields = LevelBank(*(f.numpy() for f in bank))
    assert fields.fx.shape == (12000, 63)
    want = jplan_chain(fields, 8, (512, 512), 8) is not None
    assert (det._get_chain(group, (512, 512)) is not None) == want
