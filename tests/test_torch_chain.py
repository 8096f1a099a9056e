"""The port's delta-chain coarse path against the JAX package, bit for bit.

* The planner (ops/chain_plan.py) engages or declines exactly where the
  JAX package's plan_chain does.
* chain_scores on CPU tensors runs the plain twin that executes the plan
  (signed slot gathers, a running sum per chain); it must equal plain
  scoring from scratch (coarse_scores_plain) in scores and counts, on
  dense banks and on edge cases: duplicate templates, an all-invalid
  template, off-image features, two frames.
* The chain route's candidates equal JAX's counted chain kernel (Pallas in
  interpret mode) plus its chain extraction, the negative-threshold quirk
  included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_matching_tpu.ops import similarity as jsim
from shape_based_matching_tpu.ops.filters import pyr_down_u8 as jpyr_down
from shape_based_matching_tpu.ops.gradients import (
    quantized_orientations_gray)
from shape_based_matching_tpu.ops.pallas.chain_plan import (
    ChainPlan as JChainPlan)
from shape_based_matching_tpu.ops.pallas.chain_plan import (
    plan_chain as jplan_chain)
from shape_based_matching_tpu.ops.pallas.similarity_pallas import (
    chain_coarse_word_rows_counted)
from shape_based_matching_tpu.ops.response import build_linear_memories
from shape_based_matching_tpu.utils import synthetic as jsyn
from shape_based_matching_tpu_torch.models.detector import _batch_pyramid
from shape_based_matching_tpu_torch.ops import similarity as tsim
from shape_based_matching_tpu_torch.ops.chain_plan import plan_chain
from shape_based_matching_tpu_torch.ops.cuda.chain import (
    chain_scores, plan_to_device)
from shape_based_matching_tpu_torch.ops.cuda.coarse import (
    coarse_scores_plain)
from shape_based_matching_tpu_torch.utils import synthetic as tsyn
from shape_based_matching_tpu_torch.utils.convert import (
    level_bank_from_numpy, pyramids_to_banks)

T = 8


@pytest.fixture(scope="module")
def dense():
    """The dense fixture of tests/test_chain.py: 1500 rotations of a
    96-pixel shape (0.24 degree steps), its coarse bank as numpy fields,
    and the training image."""
    jdet, templ = jsyn.build_rotated_detector(num_templates=1500,
                                              num_features=63, size=96)
    fields = [np.asarray(f) for f in jdet._get_banks("bench")[-1]]
    return fields, templ


def _committed(num_templates):
    pyr = tsyn.load_bank_cache(tsyn.bank_cache_path(num_templates, 63))
    return [f.numpy() for f in pyramids_to_banks(pyr, 2)[-1]]


def _np_bank(fields):
    return tsim.LevelBank(*fields)


def _lmflat(scene_level):
    """JAX linear memories of one coarse-level image (T=8) and the flat
    buffer with its zero tail."""
    g = quantized_orientations_gray(jnp.asarray(scene_level),
                                    jnp.float32(30.0))
    lm = build_linear_memories(g.angle, T)
    M = lm.shape[-1]
    return lm, np.concatenate([np.asarray(lm).reshape(-1),
                               np.zeros(M, np.uint8)])


@pytest.mark.parametrize("bank,size", [
    ("dense", (256, 256)), ("dense", (128, 128)), ("rot360", (512, 512)),
    ("rot10000", (512, 512)), ("rot1000", (512, 512)),
])
def test_planner_decides_as_jax(dense, bank, size):
    fields = {"dense": lambda: dense[0],
              "rot360": lambda: _committed(360),
              "rot10000": lambda: _committed(10000),
              "rot1000": lambda: _committed(1000)}[bank]()
    want = jplan_chain(_np_bank(fields), T, size, 8) is not None
    plan = plan_chain(_np_bank(fields), T, size)
    assert (plan is not None) == want
    assert want == (bank in ("dense", "rot10000"))
    if plan is not None:
        K = fields[0].shape[0]
        assert plan.prog_start[0] == 0 and plan.prog_start[-1] == K
        assert plan.slot_start[-1] == len(plan.slots)
        assert len(plan.slots) < 0.6 * int(fields[4].sum())


@pytest.mark.parametrize("args,n_ori", [
    ((1000, 128), 8), ((1000, 256, (4, 8), 256, 0, True), 8),
    ((8, 8191, (4, 8), 768, 0, True), 8),
    ((360, 63, (4, 8), 256, 0, False, 16), 16),
])
def test_planner_decides_as_jax_on_mode_banks(args, n_ori):
    """The wide and 16-orientation banks at a 1024^2 frame's coarse level
    (T=8): the decision (decline, on all four) equals JAX's."""
    pyr = tsyn.load_bank_cache(tsyn.bank_cache_path(*args))
    fields = [f.numpy() for f in pyramids_to_banks(pyr, 2, n_ori=n_ori)[-1]]
    want = jplan_chain(_np_bank(fields), T, (512, 512), n_ori) is not None
    assert (plan_chain(_np_bank(fields), T, (512, 512), n_ori)
            is not None) == want


@pytest.mark.parametrize("n_ori", [8, 16])
def test_planner_vmem_gate_follows_n_ori(dense, n_ori):
    """At a 768^2 coarse level JAX's VMEM gate admits the 8-orientation
    planes and refuses the 16-orientation ones: the port decides the same
    for the same bank."""
    fields = dense[0]
    want = jplan_chain(_np_bank(fields), T, (768, 768), n_ori) is not None
    assert want == (n_ori == 8)
    plan = plan_chain(_np_bank(fields), T, (768, 768), n_ori)
    assert (plan is not None) == want
    if plan is not None:
        assert plan.L == n_ori * T * T * plan.M


def _scores_equal_plain(fields, size, lmflat, threshold):
    bank = level_bank_from_numpy(fields)
    plan = plan_chain(_np_bank(fields), T, size)
    assert plan is not None
    W, H = size[0] // T, size[1] // T
    M = W * H
    pos = tsim._positions(bank, T, W, H)
    rmin, _ = tsim._rmin_for_threshold(bank.nfeat, torch.tensor(threshold))
    got = chain_scores(lmflat, plan_to_device(plan, "cpu"), pos, rmin)
    want = coarse_scores_plain(lmflat, tsim._flat_offsets(
        bank, T, W, M, size), pos, rmin, M)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return plan, got


def test_chain_equals_plain_dense_fixture(dense):
    fields, templ = dense
    scene = jsyn.synthetic_scene(512, 512, templ, n_instances=2, seed=7)
    _, flat = _lmflat(jpyr_down(jnp.asarray(scene)))
    _, (S, cnt) = _scores_equal_plain(fields, (256, 256),
                                      torch.from_numpy(flat[None]), 80.0)
    assert int(cnt.sum()) > 0 and int(S.max()) > 0


def test_chain_equals_plain_committed_10k_bank():
    """The 10,000-template bank at the coarse level of the 1024^2 frame."""
    scene = tsyn.synthetic_scene(1024, 1024, tsyn.synthetic_shape_image(
        256, 0), n_instances=4, seed=3)
    lms = _batch_pyramid(torch.from_numpy(scene[None]), (4, 8), 2, 30.0)
    plan, (_, cnt) = _scores_equal_plain(_committed(10000), (512, 512),
                                         lms[1], 85.0)
    assert len(plan.prog_start) - 1 >= 66  # >= 264 blocks of 1024 cells
    assert int(cnt.sum()) > 256


def test_chain_edge_cases(dense):
    """Duplicates, all-invalid templates (nfeat kept, and nfeat 0),
    off-image features, and two frames in one call."""
    fields = [f[:600].copy() for f in dense[0]]
    fx, fy, label, valid, nfeat = fields[:5]
    for k in (10, 11, 12):          # exact duplicates of template 9
        for f in (fx, fy, label, valid, nfeat):
            f[k] = f[9]
    valid[20] = False               # no valid feature, nfeat kept
    valid[30] = False
    nfeat[30] = 0
    fx[40:60, :5] = -3              # off the image on the left
    fy[50:55, 5:9] = 10_000         # and below it
    rng = np.random.RandomState(0)
    lm_a = _lmflat(rng.randint(0, 256, (256, 256)).astype(np.uint8))[1]
    lm_b = _lmflat(np.asarray(jpyr_down(jnp.asarray(jsyn.synthetic_scene(
        512, 512, dense[1], n_instances=3, seed=5)))))[1]
    flat = torch.from_numpy(np.stack([lm_a, lm_b]))
    for thr in (60.0, -5.0):
        plan, (S, _) = _scores_equal_plain(fields, (256, 256), flat, thr)
    assert not S[:, 20].any() and not S[:, 30].any()
    assert torch.equal(S[:, 9], S[:, 12])
    first = plan.slot_start
    assert first[11] == first[12]   # a duplicate is an empty delta


def _assert_same_candidates(got, want):
    k, x, y, sc, valid, n_above = (a[0].numpy() for a in got)
    wk, wx, wy, wsc, wvalid, wn = (np.asarray(a) for a in want)
    assert int(n_above) == int(wn)
    np.testing.assert_array_equal(valid, wvalid)
    for a, b in ((k, wk), (x, wx), (y, wy)):
        np.testing.assert_array_equal(a[valid], b[valid])
    np.testing.assert_array_equal(sc[valid].view(np.uint32),
                                  wsc[valid].view(np.uint32))


@pytest.mark.parametrize("threshold,cap", [(80.0, 256), (90.0, 64),
                                           (-5.0, 64)])
def test_chain_candidates_equal_jax_counted_chain(dense, threshold, cap):
    fields, templ = dense
    size = (256, 256)
    W = size[0] // T
    M = W * (size[1] // T)
    scene = jsyn.synthetic_scene(512, 512, templ, n_instances=2, seed=7)
    lm, flat = _lmflat(jpyr_down(jnp.asarray(scene)))
    jbank = jsim.LevelBank(*(jnp.asarray(f) for f in fields))
    jplan, desc = jplan_chain(_np_bank(fields), T, size, 8)
    jplan = JChainPlan(meta=jnp.asarray(jplan.meta),
                       emit=jnp.asarray(jplan.emit))
    thr = jnp.float32(threshold)
    rmin, _ = jsim._rmin_for_threshold(jbank.nfeat, thr)
    words, kcnt, pos = chain_coarse_word_rows_counted(
        lm, jbank, jplan, desc, T, size, rmin, interpret=True)
    want = jsim.extract_candidates_chain_counted(
        words, kcnt, jplan.emit, pos, jbank.nfeat, thr, desc.unit, T, W,
        cap, M)
    plan = plan_to_device(plan_chain(_np_bank(fields), T, size), "cpu")
    got = tsim.coarse_extract(torch.from_numpy(flat[None]),
                              level_bank_from_numpy(fields), T, size,
                              torch.tensor(threshold), cap, chain=plan)
    assert int(want[5]) > 0
    _assert_same_candidates(got, want)
