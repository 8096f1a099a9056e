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
* The CUDA kernel's segments (ops/cuda/chain.segment_plan), replayed
  through chain.cu's loops from the source's constants: every template in
  exactly one segment, every slot staged and summed once, start codes that
  rebuild the template before the segment, and a plain replay over the
  segments equal to chain_scores_plain on the 10,000-template plan.
"""

from collections import Counter
from functools import lru_cache


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
from shape_based_matching_tpu_torch.ops.cuda import chain as tchain
from shape_based_matching_tpu_torch.ops.cuda.chain import (
    chain_scores, chain_scores_plain, plan_to_device, segment_plan)
from shape_based_matching_tpu_torch.ops.cuda.coarse import (
    coarse_scores_plain)
from shape_based_matching_tpu_torch.utils import synthetic as tsyn
from shape_based_matching_tpu_torch.utils.convert import (
    level_bank_from_numpy, pyramids_to_banks)
from tests.torch_csrc import constants

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


@lru_cache(maxsize=None)
def _committed(num_templates):
    """The committed bank's coarse level as numpy fields, loaded once per
    process (callers only read them)."""
    pyr = tsyn.load_bank_cache(tsyn.bank_cache_path(num_templates, 63))
    return tuple(f.numpy() for f in pyramids_to_banks(pyr, 2)[-1])


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


@pytest.fixture(scope="module")
def plan10k():
    """The 10,000-template bank's plan at the coarse level of a 512^2
    frame (T=8): 256^2, M=1024."""
    plan = plan_chain(_np_bank(_committed(10000)), T, (256, 256))
    assert plan is not None
    return plan


def _replay(plan, segs, pre):
    """chain.cu's loops over one tile of one frame, per segment: the start
    codes staged in chunks of STAGE, the own slots staged from the first
    and restaged at STAGE, each staged run summed in packed runs of at most
    LANE_SLOTS. Returns {k: (start codes, slot indices summed before k's
    row)} and the longest packed run."""
    c = constants("chain.cu")
    ss = plan.slot_start
    seen, longest = {}, 0
    for k0, k1, pb, pe in segs.tolist():
        start = []
        for c0 in range(pb, pe, c["STAGE"]):
            c1 = min(c0 + c["STAGE"], pe)
            for r0 in range(0, c1 - c0, c["LANE_SLOTS"]):
                run = pre[c0 + r0:c0 + min(c1 - c0, r0 + c["LANE_SLOTS"])]
                longest = max(longest, len(run))
                start += run.tolist()
        s, c0, c1, walked = ss[k0], ss[k0], ss[k0], []
        for k in range(k0, k1):
            while s < ss[k + 1]:
                if s >= c1:
                    c0, c1 = s, min(s + c["STAGE"], ss[k1])
                n = min(ss[k + 1], c1) - s
                longest = max(longest, min(n, c["LANE_SLOTS"]))
                walked += range(s, s + n)
                s += n
            assert k not in seen  # one segment per template
            seen[k] = (start, list(walked))
    return seen, longest


def _net(codes):
    net = Counter()
    for code in codes:
        net[~code if code < 0 else code] += -1 if code < 0 else 1
    assert min(net.values(), default=0) >= 0
    return +net


@pytest.mark.parametrize("Z", [1, 16, 32, 128, 10000])
def test_segments_cover_the_plan(plan10k, Z):
    """Every template lies in exactly one segment of at most Z templates
    inside one program; the segment's start codes rebuild the template
    before it (the net multiset of the program's signed slots before k0),
    its own slots are summed once each in order; the grid (tile fastest,
    then frame, then segment) names every block once; the segments run
    longest walk first."""
    c = constants("chain.cu")
    assert c["TILE"] == c["THREADS"] * c["CELLS"] == 1024
    assert c["LANE_SLOTS"] * 4 <= 255  # responses are at most 4
    plan = segment_plan(plan10k, Z)
    ps, ss, slots = plan.prog_start, plan.slot_start, plan.slots
    K = len(ss) - 1
    segs = plan.segs
    assert segs.dtype == np.int32 and segs.shape[1] == 4
    seen, longest = _replay(plan, segs, plan.pre)
    assert sorted(seen) == list(range(K))
    assert longest <= c["LANE_SLOTS"]
    prog_of = np.searchsorted(ps, np.arange(K), side="right") - 1
    for k0, k1, pb, pe in segs.tolist():
        assert 0 < k1 - k0 <= Z and prog_of[k0] == prog_of[k1 - 1]
        base = ps[prog_of[k0]]
        assert (k0 - base) % Z == 0
        start = seen[k0][0]
        assert Counter(start) == _net(slots[ss[base]:ss[k0]].tolist())
        assert min(start, default=0) >= 0 and pe - pb == len(start)
        for k in range(k0, k1):
            assert seen[k][1] == list(range(ss[k0], ss[k + 1]))
    walks = (segs[:, 3] - segs[:, 2] + ss[segs[:, 1]] - ss[segs[:, 0]]
             + segs[:, 1] - segs[:, 0])
    assert (np.diff(walks) <= 0).all()
    B, tiles = 2, -(-plan.M // c["TILE"])
    blocks = [((x // tiles) // B, (x // tiles) % B, x % tiles)
              for x in range(tiles * B * len(segs))]
    assert len(set(blocks)) == len(blocks) == tiles * B * len(segs)
    if Z >= 126:  # every program in one segment, no start codes
        assert len(segs) == len(ps) - 1 and (segs[:, 2] == segs[:, 3]).all()


def _replay_subset(plan, n_programs=10, n_others=300, seed=5):
    """Indices into plan.segs of a fixed subset: every segment of the
    programs that hold the `n_programs` longest walks, and `n_others`
    further segments drawn with `seed`."""
    segs, ss = plan.segs, plan.slot_start
    walks = segs[:, 3] - segs[:, 2] + ss[segs[:, 1]] - ss[segs[:, 0]]
    prog = np.searchsorted(plan.prog_start, segs[:, 0], side="right") - 1
    top = prog[np.argsort(-walks, kind="stable")]
    longest = top[np.sort(np.unique(top, return_index=True)[1])][:n_programs]
    picked = np.isin(prog, longest)
    rest = np.flatnonzero(~picked)
    others = np.random.RandomState(seed).choice(
        rest, min(n_others, len(rest)), replace=False)
    return np.sort(np.concatenate([np.flatnonzero(picked), others]))


@pytest.mark.parametrize("Z", [1, 32])
def test_segment_replay_equals_plain(plan10k, Z):
    """The kernel's arithmetic over the segments in plain torch -- each
    segment's start row from its start codes, then a running sum over its
    own templates -- equals chain_scores_plain on the 10,000-template plan,
    two random frames, in scores and counts. The replay takes a fixed
    subset of the segments (_replay_subset: the programs of the longest
    walks and 300 drawn ones) and holds their templates' rows."""
    plan = segment_plan(plan10k, Z)
    rng = np.random.RandomState(16)
    B, M = 2, plan.M
    lmflat = torch.from_numpy(np.concatenate([
        rng.choice(np.array([0, 0, 3, 4], np.uint8), (B, plan.L)),
        np.zeros((B, M), np.uint8)], axis=1))
    windows = lmflat.unfold(1, M, 1)  # [B, L + 1, M] view

    def signed_sum(codes):
        codes = torch.as_tensor(np.asarray(codes, np.int64))
        neg = codes < 0
        sign = (1 - 2 * neg.to(torch.int32))[None, :, None]
        return (windows[:, torch.where(neg, ~codes, codes)].to(torch.int32)
                * sign).sum(1, dtype=torch.int32)

    ss = plan.slot_start
    rows, acc_rows = [], []
    for k0, k1, pb, pe in plan.segs[_replay_subset(plan)].tolist():
        acc = signed_sum(plan.pre[pb:pe])
        for k in range(k0, k1):
            acc = acc + signed_sum(plan.slots[ss[k]:ss[k + 1]])
            rows.append(k)
            acc_rows.append(acc)
    S = torch.stack(acc_rows, dim=1)
    rows = torch.tensor(rows)
    W = H = 256 // T
    bank = level_bank_from_numpy(_committed(10000))
    pos = tsim._positions(bank, T, W, H)
    rmin, _ = tsim._rmin_for_threshold(bank.nfeat, torch.tensor(60.0))
    want = chain_scores_plain(lmflat, plan_to_device(plan10k, "cpu"), pos,
                              rmin)
    assert torch.equal(S, want[0][:, rows])
    cnt = tchain.count_live(S, pos[rows], rmin[rows])
    assert torch.equal(cnt, want[1][:, rows]) and int(cnt.sum()) > 0
