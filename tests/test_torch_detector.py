"""The port's match path end to end against the JAX package.

Port ``Detector(device="cpu")`` (every kernel wrapper runs its plain twin
on CPU tensors) against the JAX ``Detector(use_pallas=False)`` on the same
template pyramids and frames: match lists compare as (template_id, x, y,
similarity float32 bits), exactly. The full-size checks hold the port to
the committed goldens of the flagship configuration (1024x1024 frame,
1000-template x 63-feature bank), of the dense 10,000-template bank
(delta-chain coarse scoring, overflow re-run) and of the other input
modes (mask, 16 orientations, BGR color, wide banks), generated by
tools/gen_torch_port_golden.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from shape_based_matching_tpu.utils import synthetic as jsyn
from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.models.detector import (
    _batch_pyramid, candidate_cap)
from shape_based_matching_tpu_torch.ops.similarity import coarse_extract
from shape_based_matching_tpu_torch.utils import profiling
from shape_based_matching_tpu_torch.utils import synthetic as tsyn

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _keys(matches):
    return [(m.template_id, m.x, m.y,
             int(np.float32(m.similarity).view(np.uint32)))
            for m in matches]


def _steps(det):
    """(class steps, re-runs among them), from the detector's counters."""
    return det.counters["steps"], det.counters["reruns"]


@pytest.fixture(scope="module")
def small():
    """The bank of tests/test_interpret_dispatch.py, two 256^2 scenes, the
    JAX match lists, and a port Detector on the same pyramids."""
    jdet, templ = jsyn.build_rotated_detector(num_templates=6,
                                              num_features=32, size=56)
    jdet.use_pallas = False
    frames = np.stack([jsyn.synthetic_scene(256, 256, templ, n_instances=2,
                                            seed=s) for s in (5, 9)])
    want = jdet.match_batch(frames, 80.0)
    det = Detector(num_features=32, T=(4, 8), device="cpu")
    det.class_templates["bench"] = jdet.class_templates["bench"]
    return det, frames, want


def test_match_equals_jax_b1(small):
    det, frames, want = small
    got = det.match(frames[0], 80.0)
    assert len(got) > 0
    assert _keys(got) == _keys(want[0])


def test_match_batch_equals_jax_b2(small):
    det, frames, want = small
    got = det.match_batch(frames, 80.0)
    assert [_keys(g) for g in got] == [_keys(w) for w in want]
    assert all(len(g) for g in got)


def test_forced_overflow_reruns_complete(small):
    """cand_cap=4 overflows (this frame has 9 coarse candidates); the
    frame re-runs at a bucket that holds every candidate, so the list
    still equals JAX's."""
    det, frames, want = small
    lms = _batch_pyramid(torch.from_numpy(frames[:1]), det.T_at_level, 2,
                         det.weak_threshold)
    n_above = coarse_extract(lms[1], det._get_banks("bench")[1], 8,
                             (128, 128), torch.tensor(80.0), 4)[5]
    assert int(n_above[0]) > 4
    got = det.match_batch(frames, 80.0, cand_cap=4)
    assert [_keys(g) for g in got] == [_keys(w) for w in want]


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        Detector(device="cuda")


def test_synthetic_and_bank_cache_equal_jax():
    np.testing.assert_array_equal(tsyn.synthetic_shape_image(64, 2),
                                  jsyn.synthetic_shape_image(64, 2))
    templ = tsyn.synthetic_shape_image(32, 1)
    np.testing.assert_array_equal(
        tsyn.synthetic_scene(96, 128, templ, 3, seed=4),
        jsyn.synthetic_scene(96, 128, templ, 3, seed=4))
    path = tsyn.bank_cache_path(360, 63)
    got, want = tsyn.load_bank_cache(path), jsyn.load_bank_cache(path)
    assert len(got) == len(want) == 360
    for tp_g, tp_w in zip(got, want):
        for g, w in zip(tp_g, tp_w):
            assert (g.width, g.height, g.tl_x, g.tl_y) == \
                (w.width, w.height, w.tl_x, w.tl_y)
            assert [(f.x, f.y, f.label) for f in g.features] == \
                [(f.x, f.y, f.label) for f in w.features]


@pytest.fixture(scope="module")
def dense():
    """The dense fixture of tests/test_chain.py (1500 rotations in 0.24
    degree steps), a 256^2 scene, and a port Detector on the same
    pyramids."""
    jdet, templ = jsyn.build_rotated_detector(num_templates=1500,
                                              num_features=63, size=96)
    jdet.use_pallas = False
    scene = jsyn.synthetic_scene(256, 256, templ, n_instances=2, seed=11)
    det = Detector(num_features=63, T=(4, 8), device="cpu")
    det.class_templates["bench"] = jdet.class_templates["bench"]
    return jdet, det, scene


@pytest.mark.parametrize("threshold", [80.0, 65.0])
def test_dense_bank_chain_and_map_route_equal_jax(dense, threshold):
    """The dense bank chains at the coarse level, and this frame has more
    coarse candidates than the cap of 256 (1486 at 80), so it re-runs
    once, at a cap of 1024 or more, where the JAX package refines through
    its map route and the port through the window."""
    jdet, det, scene = dense
    det.counters.clear()
    got = det.match(scene, threshold)
    assert det._get_chain("bench", (128, 128)) is not None
    assert _steps(det) == (2, 1)
    assert len(got) > 0
    assert _keys(got) == _keys(jdet.match(scene, threshold))


def test_forced_overflow_takes_map_route(dense):
    """cand_cap=4 on two frames: both overflow, each re-runs alone (where
    the JAX package takes its map route), and the lists still equal
    JAX's."""
    jdet, det, scene = dense
    frames = np.stack([scene, np.ascontiguousarray(scene[::-1])])
    det.counters.clear()
    got = det.match_batch(frames, 80.0, cand_cap=4)
    assert _steps(det) == (3, 2)
    assert [_keys(g) for g in got] == [_keys(w) for w in
                                       jdet.match_batch(frames, 80.0)]


@pytest.mark.parametrize("threshold,bucket", [(85.0, 1024), (80.0, 4096)])
def test_overflow_reruns_at_its_bucket(dense, threshold, bucket):
    """A frame that overflows the cap of 256 (590 coarse candidates at 85,
    1486 at 80) re-runs once, alone, at the bucket ``candidate_cap``
    picks; its list equals match_batch's at that bucket, which holds
    every candidate and re-runs nothing, and so does
    ``match(max_candidates=bucket)``'s, which runs the same loop."""
    _, det, scene = dense
    det.counters.clear()
    with profiling.recording() as rec:
        got = det.match(scene, threshold)
    n_above = det.counters["candidates"]
    assert 256 < n_above <= bucket and candidate_cap(n_above) == bucket
    assert [x.attrs for x in rec.spans if x.name == "sbm.rerun"] == [
        {"frame": 0, "n_above": n_above, "cap": bucket}]
    whole = det.match_batch(scene[None], threshold, cand_cap=bucket)[0]
    capped = det.match(scene, threshold, max_candidates=bucket)
    assert _steps(det) == (5, 2)
    assert got and _keys(got) == _keys(whole) == _keys(capped)


def _golden_match(name):
    with open(os.path.join(GOLDENS, f"torch_port_{name}_matches.json")) as f:
        golden = json.load(f)
    cfg = golden["config"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pyramids = tsyn.load_bank_cache(os.path.join(root, cfg["bank"]))
    det = Detector(num_features=cfg["num_features"], T=tuple(cfg["T"]),
                   num_orientations=cfg["num_orientations"], device="cpu")
    det.class_templates[golden["class_id"]] = pyramids
    frame, mask = tsyn.config_frame(cfg)
    return det, det.match(frame, cfg["threshold"], mask=mask), \
        golden["matches"]


@pytest.mark.parametrize("name", ["masked360", "e2e360_16ori", "color1000",
                                  "wide1000x128", "wide1000x256"])
def test_full_size_mode_matches_committed_golden(name):
    """The 1024x1024 golden of each input mode (mask, 16 orientations, BGR
    color, wide banks: 128 and 256 features, the latter 142 slots at the
    coarse level). The 8191-feature golden is held on the card only
    (chip_smoke.py): its level-0 window twin takes about 18 s here."""
    _, got, want = _golden_match(name)
    assert [list(k) for k in _keys(got)] == want
    assert len(got) > 0


def test_full_size_dense_bank_matches_committed_golden():
    """The 10,000-template bank on the flagship frame: the chain scores
    the coarse level, 3668 coarse candidates overflow the cap of 256, and
    the frame re-runs once, at 4096."""
    det, got, want = _golden_match("e2e10000")
    assert det._get_chain("bench", (512, 512)) is not None
    assert _steps(det) == (2, 1)
    assert [list(k) for k in _keys(got)] == want
    assert len(got) > 0


def test_full_size_matches_committed_golden():
    """The flagship frame through the port's CPU path equals the JAX
    golden, overflow re-run included (this frame has more coarse
    candidates than the default cap of 256)."""
    _, got, want = _golden_match("e2e1000")
    assert [list(k) for k in _keys(got)] == want
    assert len(got) > 0
