"""The ICP layer's kernel wrapper and kernel on the CPU
(``ops/cuda/icp.py``, ``csrc/icp.cu``).

On CPU tensors ``icp_steps`` runs the plain twin
(``models/icp.icp_refine_points_plain``) and counts no launch; it rejects
inputs the kernel does not take before any launch; no candidates give
empty results; points that are all dead keep the initial state. The
kernel is replayed in NumPy from its source's constants
(``tests/torch_icp_replay.py``) and the replay must equal the twin within
the production tolerance, inliers and valid flags equal, on the square,
the warped star and the production golden's candidates. The kernel
itself runs in ``tests/test_torch_cuda.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.models import icp
from shape_based_matching_tpu_torch.ops.cuda.icp import icp_steps
from shape_based_matching_tpu_torch.utils import profiling
from shape_based_matching_tpu_torch.utils import synthetic as tsyn

from .test_torch_icp import GOLDEN, TOL, _square, _warped_star
from .torch_icp_replay import K, LAMBDA, replay_torch, scene_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a: tuple, b: tuple) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


# -- the wrapper on the CPU -------------------------------------------------

def test_cpu_tensors_take_the_twin_and_launch_nothing():
    field, pts, origins, pv = scene_case(6, 40, 1)
    before = icp_steps.launches
    got = icp_steps(*field, pts, origins, pv, 12, 8, 8)
    want = icp.icp_refine_points_plain(*field, pts, origins, pv)
    assert _equal(got, tuple(want))
    res = icp.icp_refine_points(*field, pts, origins, pv)
    assert isinstance(res, icp.IcpResult) and _equal(tuple(res), got)
    assert icp_steps.launches == before
    assert int(want.valid.sum()) >= 4


def _bad_inputs(case: str) -> tuple:
    (off, normal, has, subpix), pts, origins, pv = scene_case(3, 10, 2)
    args = dict(off=off, normal=normal, has=has, subpix=subpix, pts=pts,
                origins=origins, pt_valid=pv)
    name, how = case.split(":")
    t = args[name]
    if how == "dtype":
        args[name] = t.to(torch.float64 if t.dtype != torch.float64
                          else torch.float32)
    elif how == "rank":
        args[name] = t[None]
    elif how == "noncontiguous":
        args[name] = t.transpose(0, 1).contiguous().transpose(0, 1)
    elif how == "mismatch":  # one more row along the first axis
        args[name] = torch.cat([t, t[:1]])
    return args


@pytest.mark.parametrize("case", [
    "off:dtype", "normal:dtype", "has:dtype", "subpix:dtype", "pts:dtype",
    "origins:dtype", "pt_valid:dtype", "off:rank", "pts:rank",
    "pt_valid:rank", "pts:noncontiguous", "normal:noncontiguous",
    "pt_valid:noncontiguous", "origins:mismatch", "pt_valid:mismatch",
    "off:mismatch", "subpix:mismatch"])
def test_inputs_the_kernel_does_not_take_raise(case):
    args = _bad_inputs(case)
    before = icp_steps.launches
    with pytest.raises(ValueError):
        icp_steps(**args, iters=12, radius=8, min_inliers=8)
    assert icp_steps.launches == before


def test_mismatched_point_count_and_bad_counts_raise():
    field, pts, origins, pv = scene_case(3, 10, 2)
    with pytest.raises(ValueError):
        icp_steps(*field, pts, origins, pv[:, :9].contiguous(), 12, 8, 8)
    for iters, radius in ((-1, 8), (12, -1)):
        with pytest.raises(ValueError):
            icp_steps(*field, pts, origins, pv, iters, radius, 8)


def test_no_candidates_give_empty_results():
    field, pts, origins, pv = scene_case(3, 10, 3)
    before = icp_steps.launches
    got = icp.icp_refine_points(*field, pts[:0], origins[:0], pv[:0])
    assert [t.shape for t in got] == [(0,)] * 7
    assert [t.dtype for t in got] == [torch.float32] * 5 + [torch.int32,
                                                             torch.bool]
    assert icp_steps.launches == before


def test_all_dead_points_keep_the_initial_state():
    field, pts, origins, pv = scene_case(4, 30, 4)
    dead = torch.zeros_like(pv)
    for out in (icp.icp_refine_points(*field, pts, origins, dead),
                replay_torch(*field, pts, origins, dead)):
        out = [torch.as_tensor(np.asarray(t)) for t in out]
        assert not out[6].any() and not out[5].any()
        assert (out[0] == 0).all() and (out[1] == 1).all()
        assert torch.equal(torch.stack([out[2], out[3]], 1), origins)
        assert (out[4] == 0).all()


def test_span_names_the_route():
    field, pts, origins, pv = scene_case(2, 16, 5)
    with profiling.recording() as rec:
        icp.icp_refine_points(*field, pts, origins, pv, iters=3)
    steps = [s for s in rec.spans if s.name == "sbm.icp.steps"]
    assert [s.attrs for s in steps] == [
        {"route": "plain", "C": 2, "N": 16, "iters": 3}]


# -- the kernel replayed in NumPy against the twin ---------------------------

def test_source_constants():
    assert K["ICP_WARPS"] * K["ICP_WARP"] == K["ICP_THREADS"]
    assert K["GEMV_LANES"] * K["GEMV_RUN"] == K["ICP_THREADS"]
    assert K["ICP_SUMS"] == 14 and LAMBDA == np.float32(icp.LAMBDA)


def _square_case():
    """The square's border as 92 template points, candidates off by up to
    4 px."""
    img = _square()
    side = np.arange(24, dtype=np.float32)
    ring = np.concatenate([np.stack([side, np.zeros(24)], 1),
                           np.stack([side, np.full(24, 23.0)], 1),
                           np.stack([np.zeros(22), side[1:23]], 1),
                           np.stack([np.full(22, 23.0), side[1:23]], 1)])
    shifts = np.array([(0, 0), (2, -1), (-3, 2), (4, 4), (-1, -4)])
    pts = np.broadcast_to(ring, (len(shifts), *ring.shape)).astype(
        np.float32)
    origins = (20.0 + shifts).astype(np.float32)
    return img, pts, origins, np.ones(pts.shape[:2], bool), {}


def _star_case():
    """The star of the warped star's frame, its 40 trained features,
    rotated by 7 degrees at (12, 9): refined from identity at origins off
    by up to 2 px, a twentieth of the points dead."""
    templ = tsyn.synthetic_shape_image(96, 3)
    det = Detector(num_features=63, device="cpu")
    assert det.add_template(templ, "s", np.full_like(templ, 255)) == 0
    t0 = det.get_templates("s", 0)[0]
    feats = np.array([(f.x, f.y) for f in t0.features], np.float32)
    rng = np.random.RandomState(8)
    pts = np.broadcast_to(feats, (6, *feats.shape)).astype(np.float32)
    origins = (np.array([12.0 + t0.tl_x, 9.0 + t0.tl_y])
               + rng.randint(-2, 3, (6, 2))).astype(np.float32)
    return _warped_star(), pts, origins, rng.rand(*pts.shape[:2]) < 0.95, {}


def _production_case():
    """The production golden's refined candidates: their templates'
    level-0 points (134 slots, more than a block's threads) at their
    integer origins on the golden's 1024^2 frame."""
    golden = json.load(open(GOLDEN))
    cfg = golden["config"]
    bank = tsyn.load_bank_cache(os.path.join(ROOT, cfg["bank"]))
    frame, _ = tsyn.config_frame(cfg)
    kk = [e["match"][0] for e in golden["entries"]]
    feats = [[(f.x, f.y) for f in bank[k][0].features] for k in kk]
    N = max(len(f) for f in feats)
    pts = np.zeros((len(kk), N, 2), np.float32)
    pv = np.zeros((len(kk), N), bool)
    for i, f in enumerate(feats):
        pts[i, :len(f)], pv[i, :len(f)] = f, True
    origins = np.array([e["match"][1:3] for e in golden["entries"]],
                       np.float32)
    return frame, pts, origins, pv, dict(iters=cfg["iters"],
                                         radius=cfg["radius"])


def _inputs(case):
    img, pts, origins, pv, kw = case()
    f = icp.edge_nearest_field(torch.from_numpy(img), 30.0, 8)
    return (f[0], f[1], f[3], f[4], *(torch.from_numpy(np.ascontiguousarray(
        a)) for a in (pts, origins, pv))), kw


@pytest.mark.parametrize("case", [_square_case, _star_case,
                                  _production_case])
def test_replay_of_the_kernel_equals_the_twin(case):
    args, kw = _inputs(case)
    want = icp.icp_refine_points_plain(*args, **kw)
    got = replay_torch(*args, **kw)
    np.testing.assert_array_equal(got[5], want.inliers.numpy())
    np.testing.assert_array_equal(got[6], want.valid.numpy())
    assert want.valid.all()
    for i, name in enumerate(("dtheta_deg", "dscale", "tx", "ty")):
        d = np.abs(got[i] - getattr(want, name).numpy()).max()
        assert d < TOL[name], (name, d)
    assert np.abs(got[4] - want.rmse.numpy()).max() < 1e-3

