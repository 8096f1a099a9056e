"""The port's CUDA kernels against their plain PyTorch twins on the card.

The randomized scenes of ``tests/test_fuzz_parity.py`` and the frontend at
T=2 are held to the port's copy of the scalar oracle instead.

Marked ``cuda``: these need an NVIDIA GPU and skip elsewhere. They import
neither JAX nor the JAX package, so they run on a machine without JAX:

    SBM_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -o addopts= -q

(SBM_TEST_TPU=1 keeps tests/conftest.py from importing JAX.) Every
comparison is exact: the kernels compute the same integer sums and the
same float32 steps as the twins.
"""

import numpy as np
import pytest
import torch

from shape_based_matching_tpu_torch import Detector, refine_detections
from shape_based_matching_tpu_torch.ops.chain_plan import (
    ChainPlan, plan_chain)
from shape_based_matching_tpu_torch.ops.cuda.chain import (
    chain_scores, chain_scores_plain, plan_to_device, segment_plan)
from shape_based_matching_tpu_torch.ops.cuda.coarse import (
    coarse_maps, coarse_maps_plain, coarse_scores, coarse_scores_plain)
from shape_based_matching_tpu_torch.ops.cuda.extract import (
    SEG_CELLS, count_prefix, count_prefix_plain, extract_counted,
    extract_counted_plain)
from shape_based_matching_tpu_torch.ops.cuda.frontend import (
    phase_deg_kernel, quant_spread, quant_spread_plain)
from shape_based_matching_tpu_torch.ops.fastmath import phase_deg
from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
    map_refine, map_refine_plain)
from shape_based_matching_tpu_torch.ops.cuda.pyramid import (
    linear_memories, linear_memories_plain, pyr_down)
from shape_based_matching_tpu_torch.ops.filters import pyr_down_u8_plain
from shape_based_matching_tpu_torch.ops.cuda.refine import (
    refine_windows, refine_windows_plain)
from shape_based_matching_tpu_torch.ops.response import to_i32
from shape_based_matching_tpu_torch.ops.similarity import (
    _MAP_SLAB, LevelBank, _flat_offsets, _positions, _rmin_for_threshold,
    gather_bank, pack_level_bank, refine_from_maps)
from shape_based_matching_tpu_torch.utils import synthetic
from shape_based_matching_tpu_torch.oracle import reference as oracle
from shape_based_matching_tpu_torch.utils.convert import pyramids_to_banks

from .torch_icp_replay import replay_torch, scene_case
from .torch_extract_cases import (CHAIN_CASES, EXTRACT_CASES,
                                  STRADDLE_CASES, chain_case, chain_rows,
                                  extract_case, straddle_case)
from .torch_fuzz import (FUZZ_CASES, MERGED_THRESHOLD, fuzz_case, merged_case,
                         oracle_keys, oracle_matches, oracle_pyramid,
                         port_keys)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bank(rng, K, n_max, size, device):
    templates = []
    for i in range(K):
        wt, ht = int(rng.randint(4, size)), int(rng.randint(4, size))
        n = int(rng.randint(1, n_max))
        feats = [(int(rng.randint(-6, wt + 1)), int(rng.randint(-2, ht + 1)),
                  int(rng.randint(0, 8))) for _ in range(n)]
        feats[0] = (wt, ht, 1)
        templates.append({"features": [] if i == 2 else feats,
                          "width": wt, "height": ht})
    return pack_level_bank(templates, device=device)


def _lmflat(rng, B, T, w, h, device, n_ori=8, fill=None):
    """B frames of random responses (or every byte `fill`: a saturated
    frame) and the zero tail."""
    M = (w // T) * (h // T)
    shape = (B, n_ori * T * T * M)
    lm = (rng.choice(np.array([0, 0, 3, 4], np.uint8), shape)
          if fill is None else np.full(shape, fill, np.uint8))
    flat = np.concatenate([lm, np.zeros((B, M), np.uint8)], axis=1)
    return torch.from_numpy(flat).to(device)


def _exact_bank(rng, K, N, size, device):
    """K templates of exactly N features inside a size x size box."""
    return pack_level_bank([{
        "features": [(int(rng.randint(0, size)), int(rng.randint(0, size)),
                      int(rng.randint(0, 8))) for _ in range(N)],
        "width": size, "height": size} for _ in range(K)], device=device)


@pytest.mark.parametrize("h,w", [(37, 53), (72, 200), (256, 256)])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 16])
def test_frontend_kernel_equals_plain(dev, h, w, T):
    rng = np.random.RandomState(h + w + T)
    noise = rng.randint(0, 256, (h, w), dtype=np.uint8)
    smooth = synthetic.synthetic_scene(h, w, synthetic.synthetic_shape_image(
        24, T), n_instances=2, seed=T)
    frames = torch.from_numpy(np.stack([noise, smooth, noise // 4])).to(dev)
    for thr in (30.0, 10.0):
        got = quant_spread(frames, thr, T)
        torch.cuda.synchronize()
        assert torch.equal(got, quant_spread_plain(frames, thr, T))


# mode: (color, n_ori, masked, with_quant)
_MODES = {
    "color8": (True, 8, False, False),
    "gray16": (False, 16, False, False),
    "color16": (True, 16, False, False),
    "masked_gray8": (False, 8, True, False),
    "masked_color16": (True, 16, True, False),
    "with_quant": (False, 8, False, True),
    "with_quant_masked_color16": (True, 16, True, True),
}


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("h,w", [(37, 53), (256, 256)])
@pytest.mark.parametrize("T", [1, 4, 8, 16])
def test_frontend_kernel_modes_equal_plain(dev, mode, h, w, T):
    """Color (planar; channels 0 and 2 tie in |grad|^2 everywhere), 16
    orientations (uint16 planes), masks and the quantized plane."""
    color, n_ori, masked, with_quant = _MODES[mode]
    rng = np.random.RandomState(h + w + T)
    gray = np.stack([rng.randint(0, 256, (h, w), dtype=np.uint8),
                     synthetic.synthetic_scene(
                         h, w, synthetic.synthetic_shape_image(24, T),
                         n_instances=2, seed=T)])
    img = (np.stack([gray, np.roll(gray, 1, axis=2), 255 - gray], axis=1)
           if color else gray)
    frames = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
    masks = torch.from_numpy(((rng.rand(2, h, w) > 0.25) * 255).astype(
        np.uint8)).to(dev) if masked else None
    got = quant_spread(frames, 30.0, T, n_ori, masks, with_quant)
    torch.cuda.synchronize()
    want = quant_spread_plain(frames, 30.0, T, n_ori, masks, with_quant)
    for g, e in zip(got if with_quant else (got,),
                    want if with_quant else (want,)):
        assert g.dtype == e.dtype == (torch.uint8 if n_ori == 8
                                      else torch.uint16)
        assert torch.equal(to_i32(g), to_i32(e))


@pytest.mark.parametrize("threshold", [88.0, 70.0, -5.0])
def test_coarse_kernel_equals_plain_wide_8191_bank(dev, threshold):
    """The committed 8 x 8191 dense bank's coarse level (N=3073 slots) at
    a 1024^2 frame's coarse size (512^2, T=8): the shape of the wide TPU
    kernel's route, scores and counts."""
    pyr = synthetic.load_bank_cache(synthetic.bank_cache_path(
        8, 8191, size=768, dense=True))
    bank = LevelBank(*(f.to(dev) for f in pyramids_to_banks(pyr, 2)[-1]))
    assert bank.fx.shape == (8, 3073)
    rng = np.random.RandomState(8191)
    lmflat = _lmflat(rng, 2, 8, 512, 512, dev)
    W = H = 64
    off = _flat_offsets(bank, 8, W, W * H, (512, 512))
    pos = _positions(bank, 8, W, H)
    rmin, _ = _rmin_for_threshold(bank.nfeat,
                                  torch.tensor(threshold, device=dev))
    got = coarse_scores(lmflat, off, pos, rmin, W * H)
    torch.cuda.synchronize()
    for g, e in zip(got, coarse_scores_plain(lmflat, off, pos, rmin, W * H)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("T,w,h,K,n_max", [
    (4, 96, 64, 37, 70), (8, 128, 72, 37, 70), (4, 1024, 1024, 37, 70),
    (4, 64, 64, 5, 3000),  # more slots than one shared-memory chunk
])
@pytest.mark.parametrize("threshold", [60.0, -5.0])
def test_coarse_kernel_equals_plain(dev, T, w, h, K, n_max, threshold):
    rng = np.random.RandomState(T * w + K)
    bank = _bank(rng, K, n_max, 48, dev)
    lmflat = _lmflat(rng, 2, T, w, h, dev)
    W, H = w // T, h // T
    off = _flat_offsets(bank, T, W, W * H, (w, h))
    pos = _positions(bank, T, W, H)
    rmin, _ = _rmin_for_threshold(
        bank.nfeat, torch.tensor(threshold, device=dev))
    got = coarse_scores(lmflat, off, pos, rmin, W * H)
    torch.cuda.synchronize()
    want = coarse_scores_plain(lmflat, off, pos, rmin, W * H)
    for g, e in zip(got, want):
        assert torch.equal(g, e)


@pytest.mark.parametrize("T,size", [(4, 40), (4, 110), (8, 40)])
def test_refine_kernel_equals_plain(dev, T, size):
    """size 110 at 128^2 is a pathological bank (wider than 128 - 16T)."""
    rng = np.random.RandomState(T + size)
    hw = 128
    bank = _bank(rng, 9, 300, size, dev)
    lmflat = _lmflat(rng, 2, T, hw, hw, dev)
    C = 70
    k = torch.from_numpy(rng.randint(0, 9, (2, C)).astype(np.int32)).to(dev)
    wx, wy = (torch.from_numpy(rng.randint(-12, hw // T, (2, C))
                               .astype(np.int32)).to(dev) for _ in range(2))
    live = torch.from_numpy(rng.rand(2, C) > 0.3).to(dev)
    args = (lmflat, bank, T, (hw, hw), k, wx, wy, live)
    got = refine_windows(*args)
    torch.cuda.synchronize()
    for g, e in zip(got, refine_windows_plain(*args)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("size", [512, 1024])
@pytest.mark.parametrize("threshold", [85.0, -5.0])
def test_chain_kernel_equals_plain(dev, size, threshold):
    """The committed 10,000-template bank's coarse level (T=8) at 256^2
    and 512^2, on two random frames, against the twin that executes the
    plan and against coarse.cu from scratch."""
    pyr = synthetic.load_bank_cache(synthetic.bank_cache_path(10000, 63))
    bank = pyramids_to_banks(pyr, 2)[-1]
    size_wh = (size // 2, size // 2)
    plan = plan_chain(LevelBank(*(f.numpy() for f in bank)), 8, size_wh)
    assert plan is not None
    plan = plan_to_device(plan, dev)
    bank = LevelBank(*(f.to(dev) for f in bank))
    rng = np.random.RandomState(size)
    lmflat = _lmflat(rng, 2, 8, *size_wh, dev)
    W, H = size_wh[0] // 8, size_wh[1] // 8
    pos = _positions(bank, 8, W, H)
    rmin, _ = _rmin_for_threshold(bank.nfeat,
                                  torch.tensor(threshold, device=dev))
    got = chain_scores(lmflat, plan, pos, rmin)
    torch.cuda.synchronize()
    for want in (chain_scores_plain(lmflat, plan, pos, rmin),
                 coarse_scores(lmflat, _flat_offsets(bank, 8, W, W * H,
                                                     size_wh),
                               pos, rmin, W * H)):
        for g, e in zip(got, want):
            assert torch.equal(g, e)


@pytest.mark.parametrize("T,w,h,K,n_max", [
    (4, 256, 256, 64, 64), (4, 96, 64, 37, 70), (8, 128, 72, 37, 70),
    (4, 64, 64, 5, 3000),
])
def test_coarse_maps_kernel_equals_plain(dev, T, w, h, K, n_max):
    rng = np.random.RandomState(T * w + K + 1)
    bank = _bank(rng, K, n_max, 48, dev)
    lmflat = _lmflat(rng, 2, T, w, h, dev)
    W = w // T
    off = _flat_offsets(bank, T, W, W * (h // T), (w, h))
    got = coarse_maps(lmflat, off, W * (h // T))
    torch.cuda.synchronize()
    assert torch.equal(got, coarse_maps_plain(lmflat, off, W * (h // T)))


def test_coarse_maps_kernel_equals_plain_dense_bank(dev):
    """The dense path's shapes: level-0 maps (T=4, 1024^2, so M=65536) of
    D=1024 slots of the committed 10,000-template bank (N=63), 1000
    distinct templates and 24 fill slots, as gather_bank gives them."""
    pyr = synthetic.load_bank_cache(synthetic.bank_cache_path(10000, 63))
    bank = LevelBank(*(f.to(dev) for f in pyramids_to_banks(pyr, 2)[0]))
    rng = np.random.RandomState(10000)
    ids = np.sort(rng.choice(10000, 1000, replace=False))
    slots = torch.from_numpy(np.concatenate([ids, np.full(24, 10000)])
                             .astype(np.int32)).to(dev)
    sub = gather_bank(bank, slots)
    lmflat = _lmflat(rng, 2, 4, 1024, 1024, dev)
    W, M = 256, 256 * 256
    off = _flat_offsets(sub, 4, W, M, (1024, 1024))
    assert off.shape == (1024, 63)
    got = coarse_maps(lmflat, off, M)
    torch.cuda.synchronize()
    assert torch.equal(got, coarse_maps_plain(lmflat, off, M))


def _map_refine_args(dev, D, M, W, C, case, B=2, T=4):
    """Random maps and candidates for the map refine step at T=4 on a level
    of W x M/W cells: D templates with a map and 5 without (slot -1),
    random sizes up to the level's (some wider than the level less 16T:
    the clamp bound goes negative), nfeat 0 for three of them, candidates
    over the whole level above and a little past it. case "dead": no
    candidate valid; "zero": all maps 0, so the empty templates score NaN
    and the others 0."""
    rng = np.random.RandomState(D + M + C)
    K = D + 5
    w_img, h_img = W * T, (M // W) * T
    slot_of_k = np.concatenate([np.arange(D), np.full(5, -1)])
    rng.shuffle(slot_of_k)
    nfeat = rng.randint(0, 64, K)
    nfeat[rng.choice(K, 3, replace=False)] = 0
    maps = (np.zeros((B, D, M), np.int32) if case == "zero"
            else rng.randint(-3, 40, (B, D, M)).astype(np.int32))

    def ints(*args):
        return torch.from_numpy(rng.randint(*args).astype(np.int32)).to(dev)

    bank = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        slot_of_k, rng.randint(1, w_img + 1, K), rng.randint(1, h_img + 1, K),
        nfeat)]
    k, x, y = (ints(0, K, (B, C)), ints(-2, w_img // 2 + 3, (B, C)),
               ints(-2, h_img // 2 + 3, (B, C)))
    valid = torch.from_numpy(rng.rand(B, C) > (1.0 if case == "dead"
                                                else 0.3)).to(dev)
    return (torch.from_numpy(maps).to(dev), *bank, T, (w_img, h_img), k, x,
            y, valid, torch.tensor(30.0, device=dev))


def _assert_refine_equal(got, want):
    """k, x, y, valid on every candidate; the score bit for bit where it is
    not NaN, NaN where the other side has one."""
    for i in (0, 1, 2, 4):
        assert torch.equal(got[i], want[i]), i
    nan = torch.isnan(got[3])
    assert torch.equal(nan, torch.isnan(want[3]))
    assert torch.equal(got[3][~nan].view(torch.int32),
                       want[3][~nan].view(torch.int32))


@pytest.mark.parametrize("D,M,W,C,case", [
    (24, 1024, 32, 300, "random"), (1, 256, 16, 300, "random"),
    (1024, 65536, 256, 4096, "random"),  # the dense re-run at cap 4096
    (24, 1024, 32, 1, "random"),  # one candidate: a block of one warp
    (24, 1024, 32, 13, "dead"),   # no candidate valid
    (8, 1024, 32, 77, "zero"),    # zero maps: scores 0 and NaN
])
def test_map_refine_kernel_equals_plain(dev, D, M, W, C, case):
    """The fused map refine step (origin, slot, window, first max, score,
    threshold) against its twin on every output of every candidate, at
    B=2: windows reaching past the last map (clipped) or starting before
    the first, slot -1, nfeat 0, C not a multiple of 8."""
    args = _map_refine_args(dev, D, M, W, C, case)
    before = map_refine.launches
    got = map_refine(*args)
    torch.cuda.synchronize()
    assert map_refine.launches == before + 1
    want = map_refine_plain(*args)
    _assert_refine_equal(got, want)
    valid = got[4]
    if case == "dead":
        assert not valid.any()
    if case == "zero":
        assert torch.isnan(got[3]).any() and not valid.any()
    if case == "random" and C > 1:
        assert valid.any() and not valid.all()


def test_refine_from_maps_is_one_launch_without_host_reads(dev):
    """refine_from_maps on the card is one launch of kernel 9 and reads
    nothing back to the host: it records into a CUDA graph (a host read
    raises during capture), and the replay equals the twin."""
    args = _map_refine_args(dev, 24, 1024, 32, 300, "random")
    Sfull, slot_of_k, width, height, nfeat, T, size, *cand = args
    bank = LevelBank(*(torch.zeros((width.shape[0], 1), dtype=dt,
                                   device=dev)
                       for dt in (torch.int32, torch.int32, torch.int32,
                                  torch.bool)), nfeat, width, height)
    want = map_refine_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm: library loaded, nothing lazy
        refine_from_maps(Sfull, slot_of_k, bank, T, size, *cand)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = map_refine.launches
    with torch.cuda.graph(graph):
        got = refine_from_maps(Sfull, slot_of_k, bank, T, size, *cand)
    assert map_refine.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    _assert_refine_equal(got, want)


def _assert_extract_equal(got, want):
    """Every output of every slot: k, x, y, valid and n_above exactly, the
    score's bits (NaN where the twin's is NaN)."""
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if i == 3:
            nan = torch.isnan(w)
            assert torch.equal(torch.isnan(g), nan)
            assert torch.equal(g[~nan].view(torch.int32),
                               w[~nan].view(torch.int32))
        else:
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", [*EXTRACT_CASES, "unaligned"])
def test_extract_kernel_equals_plain(dev, name):
    """extract.cu against its twin on the CPU replay's cases; "unaligned"
    is the aligned case's rows one cell off a 16-byte address (the
    kernel's scalar loads where M % 4 == 0)."""
    S, *rest = (a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in extract_case("aligned" if name == "unaligned"
                                      else name))
    if name == "unaligned":
        flat = torch.empty(S.numel() + 1, dtype=torch.int32, device=dev)
        flat[1:] = S.reshape(-1)
        S = flat[1:].view(S.shape)
        assert S.data_ptr() % 16 and S.is_contiguous()
    got = _two_launches(S, *rest)
    _assert_extract_equal(got, extract_counted_plain(S, *rest))
    assert got[4].any()


def _two_launches(*args):
    """extract_counted on the card: the prefix kernel and the extraction,
    one launch each."""
    before = (count_prefix.launches, extract_counted.launches)
    got = extract_counted(*args)
    torch.cuda.synchronize()
    assert (count_prefix.launches, extract_counted.launches) == (
        before[0] + 1, before[1] + 1)
    return got


@pytest.mark.parametrize("name", list(STRADDLE_CASES))
def test_extract_kernel_equals_plain_across_segment_edges(dev, name):
    """Rows of 2.5 of the kernel's segments: the cap inside a run of live
    cells across an edge, quirk slots over two segments and an
    overstated count in a row of three, slots past n_above in many
    closed-form groups (odd M: scalar loads)."""
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a
            for a in straddle_case(name, SEG_CELLS)]
    got = _two_launches(*args)
    _assert_extract_equal(got, extract_counted_plain(*args))
    assert got[4].any()


@pytest.mark.parametrize("odd", [0, 3])
def test_extract_kernel_long_rows_in_any_schedule(dev, odd):
    """Three rows of 32 segments at about 0.2% live cells: the segments
    of each row run on many blocks at once, look back through each
    other's words and stop past the cap; ten calls give the twin's bits
    each time, whatever the blocks' order."""
    rng = np.random.RandomState(31 + odd)
    K, M = 3, 32 * SEG_CELLS + odd
    S = torch.from_numpy(np.where(rng.rand(1, K, M) < 0.002, 70, 10)
                         .astype(np.int32)).to(dev)
    pos = torch.tensor([M, M - SEG_CELLS - 9, M // 2], dtype=torch.int32,
                       device=dev)
    rmin = torch.full((K,), 50, dtype=torch.int32, device=dev)
    t4n = torch.tensor([81.0, 93.0, 250.0], device=dev)
    cnt = (torch.arange(M, device=dev) < pos[:, None]) & (S[0] >= 50)
    cnt = cnt.sum(1, dtype=torch.int32)[None]
    C = int(cnt[0, :2].sum()) + int(cnt[0, 2]) // 2  # inside row 2
    args = (S, cnt, pos, rmin, t4n, 4, 512, C)
    want = extract_counted_plain(*args)
    for _ in range(10):
        _assert_extract_equal(_two_launches(*args), want)


def test_extract_kernel_zero_slots_is_the_prefix_alone(dev):
    """C = 0 with B > 0: no slot and no extraction launch; n_above comes
    from the prefix kernel."""
    S, *rest = (a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in extract_case("batch3"))
    rest[-1] = 0
    before = (count_prefix.launches, extract_counted.launches)
    got = extract_counted(S, *rest)
    torch.cuda.synchronize()
    assert (count_prefix.launches, extract_counted.launches) == (
        before[0] + 1, before[1])
    _assert_extract_equal(got, extract_counted_plain(S, *rest))
    assert all(a.shape == (3, 0) for a in got[:5])


@pytest.mark.parametrize("name", [*EXTRACT_CASES, *STRADDLE_CASES])
def test_prefix_kernel_equals_plain(dev, name):
    """count_prefix on the card: n_above, the work list (its records in
    order), the zeroed ticket and, where rows have more than one segment,
    look-back words, against the plain helper."""
    args = extract_case(name) if name in EXTRACT_CASES else \
        straddle_case(name, SEG_CELLS)
    S, cnt, pos, rmin, t4n, _, _, C = (a.to(dev) if isinstance(
        a, torch.Tensor) else a for a in args)
    got = count_prefix(cnt, pos, rmin, t4n, S.shape[2], C)
    torch.cuda.synchronize()
    want = count_prefix_plain(cnt, pos, rmin, t4n, S.shape[2], C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    for b, n in enumerate(want[2][:, 0].tolist()):
        assert torch.equal(got[1][b, :n], want[1][b, :n])
        if S.shape[2] > SEG_CELLS:
            assert (got[3][b, :, :n] == 0).all()


def test_extract_call_is_two_device_kernels(dev):
    """torch.profiler sees two launches a call and no device kernel but
    the prefix kernel and the extraction: no torch op computes the prefix
    on the card (the count from the host-side records, which are
    complete; the device-side ones name the kernels)."""
    from shape_based_matching_tpu_torch.utils.profiling import (
        CALLS, device_work)
    S, *rest = (a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in extract_case("aligned"))
    queued, kern = device_work(lambda: extract_counted(S, *rest))
    names = [n for n, _ in kern]
    prefix = sum("prefix_kernel" in n for n in names)
    extract = sum("extract_kernel" in n for n in names)
    assert queued == 2 * CALLS
    assert prefix + extract == len(names) and prefix > 0 and extract > 0


@pytest.fixture(scope="module")
def card_chain_rows(dev):
    return chain_rows(dev)


@pytest.mark.parametrize("threshold,C", CHAIN_CASES)
def test_extract_kernel_equals_plain_on_chain_rows(card_chain_rows,
                                                   threshold, C):
    args = chain_case(card_chain_rows, threshold, C)
    got = _two_launches(*args)
    _assert_extract_equal(got, extract_counted_plain(*args))
    assert got[4].any()


def test_overflow_rerun_at_65536_bucket_memory_is_bounded(dev):
    """ROADMAP C.1, both terms. The flagship frame with the 10,000-template
    bank at threshold 60 has more than 16,384 coarse candidates, so
    ``match`` re-runs at the 65,536 bucket, through the map route over
    more than 1,024 distinct templates. Its peak device memory above what
    was allocated before the call stays under the chain's S [K, M1] int32,
    one slab of level maps [_MAP_SLAB, M0] int32, 64 bytes a candidate
    slot and 64 MiB for the frame's pyramid, the banks' temporaries and
    the allocator's rounding: (a) the extraction gathers no [C, M1] score
    rows (1.07 GB an int32 tensor here) and (b) the map route holds no
    [K, M0] maps (2.6 GB). The list equals the one at a cap that holds
    every candidate, with no re-run."""
    det = Detector(num_features=63, T=(4, 8), device=dev)
    det.class_templates["c"] = synthetic.load_bank_cache(
        synthetic.bank_cache_path(10000, 63))
    scene = synthetic.synthetic_scene(
        1024, 1024, synthetic.synthetic_shape_image(256, 0), n_instances=4,
        seed=3)
    thr = 60.0
    lms, sizes, thr_t, _ = det._prepare(scene[None], None, thr, ["c"])
    n_above = int(det._step(lms, "c", thr_t, sizes, 256)[5][0])
    assert 16384 < n_above <= 65536
    del lms
    want = det.match_batch(scene[None], thr,
                           cand_cap=-(-n_above // 1024) * 1024)[0]
    kernels = (extract_counted, coarse_maps, map_refine, count_prefix)
    before = [k.launches for k in kernels]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = det.match(scene, thr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    slabs, refines = (k.launches - b for k, b in zip(kernels[1:3],
                                                     before[1:3]))
    # step and re-run, each the prefix and the extraction
    assert extract_counted.launches - before[0] == 2
    assert count_prefix.launches - before[3] == 2
    assert slabs >= 2 and refines == slabs
    K, M1, M0 = 10000, (512 // 8) ** 2, (1024 // 4) ** 2
    bound = 4 * K * M1 + 4 * _MAP_SLAB * M0 + 64 * 65536 + (64 << 20)
    assert peak <= bound, f"peak {peak} bytes over the bound {bound}"
    assert got and [(m.template_id, m.x, m.y, m.similarity) for m in got] \
        == [(m.template_id, m.x, m.y, m.similarity) for m in want]


@pytest.mark.parametrize("n_ori,color,masked", [
    (8, True, True), (16, False, False), (16, True, True)])
def test_detector_modes_cuda_equal_cpu(dev, n_ori, color, masked):
    pyramids = synthetic.load_bank_cache(synthetic.bank_cache_path(
        360, 63, n_ori=n_ori))
    gray = np.stack([synthetic.synthetic_scene(
        512, 512, synthetic.synthetic_shape_image(256, 0), n_instances=1,
        seed=s) for s in (2, 3)])
    frames = (np.stack([gray, np.roll(gray, 1, axis=2), 255 - gray],
                       axis=-1) if color else gray)
    masks = ((np.random.RandomState(4).rand(2, 512, 512) > 0.25) * 255
             ).astype(np.uint8) if masked else None
    out = []
    for device in ("cpu", "cuda"):
        det = Detector(num_features=63, T=(4, 8), num_orientations=n_ori,
                       device=device)
        det.class_templates["c"] = pyramids
        out.append([[(m.template_id, m.x, m.y, m.similarity) for m in ms]
                    for ms in det.match_batch(frames, 70.0, masks=masks)])
    assert any(out[0])
    assert out[0] == out[1]


def test_detector_cuda_equals_cpu(dev):
    pyramids = synthetic.load_bank_cache(synthetic.bank_cache_path(360, 63))
    frames = np.stack([synthetic.synthetic_scene(
        512, 512, synthetic.synthetic_shape_image(256, 0), n_instances=1,
        seed=s) for s in (2, 3, 4)])
    out = []
    for device in ("cpu", "cuda"):
        det = Detector(num_features=63, T=(4, 8), device=device)
        det.class_templates["c"] = pyramids
        out.append(det.match_batch(frames, 80.0, cand_cap=64))
    key = [[(m.template_id, m.x, m.y, m.similarity) for m in ms]
           for ms in out[0]]
    assert any(key)
    assert key == [[(m.template_id, m.x, m.y, m.similarity) for m in ms]
                   for ms in out[1]]


def _coarse_case(lmflat, bank, T, size_wh, threshold, n_ori=8):
    """coarse_scores and coarse_maps against their twins, bitwise."""
    W, H = size_wh[0] // T, size_wh[1] // T
    M = W * H
    off = _flat_offsets(bank, T, W, M, size_wh, n_ori)
    pos = _positions(bank, T, W, H)
    rmin, _ = _rmin_for_threshold(bank.nfeat, torch.tensor(
        threshold, device=lmflat.device))
    got = coarse_scores(lmflat, off, pos, rmin, M)
    maps = coarse_maps(lmflat, off, M)
    torch.cuda.synchronize()
    want = coarse_scores_plain(lmflat, off, pos, rmin, M)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert torch.equal(maps, want[0])
    return got


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("K,n_max", [(37, 70), (2, 3000)])
def test_coarse_kernel_odd_m(dev, B, K, n_max):
    """A 464x592 frame's coarse level at T=8 with 16 orientations: M =
    29 x 37 = 1073 cells and an odd lmflat length, so every frame after
    the first starts unaligned and M is no multiple of 4; K=2 x 3000
    slots takes the split launch."""
    rng = np.random.RandomState(B * K)
    size_wh = (232, 296)
    lmflat = _lmflat(rng, B, 8, *size_wh, dev, n_ori=16)
    assert lmflat.shape[1] % 2 == 1
    _coarse_case(lmflat, _bank(rng, K, n_max, 48, dev), 8, size_wh, 50.0,
                 n_ori=16)


@pytest.mark.parametrize("K,n_max", [(37, 70), (2, 3000)])
def test_coarse_kernel_sliced_frame(dev, K, n_max):
    """Frames 1 and 2 of an odd-length batch as the overflow re-run
    slices them: unaligned data_ptr, and the last one ends the storage."""
    rng = np.random.RandomState(K)
    size_wh = (232, 296)
    lmflat = _lmflat(rng, 3, 8, *size_wh, dev, n_ori=16)
    bank = _bank(rng, K, n_max, 48, dev)
    for b in (1, 2):
        frame = lmflat[b:b + 1]
        assert frame.data_ptr() % 4 != 0
        _coarse_case(frame, bank, 8, size_wh, 50.0, n_ori=16)


@pytest.mark.parametrize("N", [63, 64, 126, 127, 3073])
def test_coarse_kernel_saturated(dev, N):
    """Every response byte 4: the packed lanes at their limit (63 slots
    make 252), one slot past it, and the split launch at 3073 slots."""
    rng = np.random.RandomState(N)
    lmflat = _lmflat(rng, 2, 8, 512, 512, dev, fill=4)
    S, _ = _coarse_case(lmflat, _exact_bank(rng, 8, N, 40, dev), 8,
                        (512, 512), 90.0)
    assert int(S.max()) == 4 * N


def _refine_case(lmflat, bank, T, size_wh, k, wx, wy, live):
    args = (lmflat, bank, T, size_wh, k, wx, wy, live)
    got = refine_windows(*args)
    torch.cuda.synchronize()
    want = refine_windows_plain(*args)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    return got


def _windows(rng, B, C, K, W, H, dev, n_live=None):
    """Random candidates: template, window origin (some off the frame's
    top left or past its far end) and live flags (the first n_live, or
    70% at random)."""
    def ints(lo, hi):
        return torch.from_numpy(rng.randint(lo, hi, (B, C))
                                .astype(np.int32)).to(dev)

    live = (np.arange(C)[None, :] < n_live).repeat(B, 0) if n_live \
        is not None else rng.rand(B, C) > 0.3
    return (ints(0, K), ints(-2, W), ints(-2, H),
            torch.from_numpy(live).to(dev))


@pytest.mark.parametrize("b", [1, 2])
def test_refine_kernel_sliced_frame(dev, b):
    """116x116 at T=4: 29 x 29 cells and an odd lmflat length, so frame
    1 of 3 starts unaligned and frame 2 ends the storage."""
    rng = np.random.RandomState(b)
    lmflat = _lmflat(rng, 3, 4, 116, 116, dev)
    bank = _bank(rng, 9, 300, 40, dev)
    frame = lmflat[b:b + 1]
    assert frame.data_ptr() % 4 != 0
    _refine_case(frame, bank, 4, (116, 116),
                 *_windows(rng, 1, 70, 9, 29, 29, dev))


@pytest.mark.parametrize("N", [63, 64, 126, 127, 9126])
def test_refine_kernel_saturated(dev, N):
    """Every response byte 4 at the packed lanes' limit and past it, and
    split across blocks at 9126 features."""
    rng = np.random.RandomState(N)
    lmflat = _lmflat(rng, 2, 4, 256, 256, dev, fill=4)
    bank = _exact_bank(rng, 3, N, 40, dev)
    best, raw = _refine_case(lmflat, bank, 4, (256, 256),
                             *_windows(rng, 2, 40, 3, 64, 64, dev))
    assert int(raw.max()) == 4 * N


@pytest.mark.parametrize("n_live", [8, 256])
def test_refine_kernel_wide_8191_bank(dev, n_live):
    """The committed 8 x 8191 dense bank's level 0 (9126 slots) at a
    1024^2 frame (T=4), 256 candidates of which the first 8 or all are
    live: the split launch at the wide8191 path's shapes."""
    pyr = synthetic.load_bank_cache(synthetic.bank_cache_path(
        8, 8191, size=768, dense=True))
    bank = LevelBank(*(f.to(dev) for f in pyramids_to_banks(pyr, 2)[0]))
    assert bank.fx.shape == (8, 9126)
    rng = np.random.RandomState(n_live)
    lmflat = _lmflat(rng, 1, 4, 1024, 1024, dev)
    _refine_case(lmflat, bank, 4, (1024, 1024),
                 *_windows(rng, 1, 256, 8, 240, 240, dev, n_live))


@pytest.mark.parametrize("N", [40, 700])
def test_refine_kernel_clamps_at_frame_end(dev, N):
    """A 128x48 frame at T=4 (32 x 12 cells): windows run past the last
    row, so indices clamp to the frame's last byte. The tail bytes are
    set (1..4), so a read of the wrong byte, or of the next frame's
    head, changes the sums; 700 features take the split launch."""
    rng = np.random.RandomState(N)
    lmflat = _lmflat(rng, 2, 4, 128, 48, dev)
    M = 32 * 12
    lmflat[:, -M:] = torch.from_numpy(rng.randint(1, 5, (2, M)).astype(
        np.uint8)).to(dev)
    bank = _bank(rng, 5, N, 40, dev)
    _refine_case(lmflat, bank, 4, (128, 48),
                 *_windows(rng, 2, 70, 5, 32, 12, dev))


@pytest.mark.parametrize("N", [63, 700])
def test_refine_kernel_ties_take_first_max(dev, N):
    """A constant lmflat (tail included): every cell of a window ties,
    so the first cell in rr*16 + cc order must win, also when the
    features are summed in groups across blocks (700)."""
    rng = np.random.RandomState(N)
    lmflat = torch.full((2, (8 * 16 + 1) * 32 * 32), 2, dtype=torch.uint8,
                        device=dev)
    bank = _exact_bank(rng, 4, N, 40, dev)
    k, wx, wy, live = _windows(rng, 2, 64, 4, 32, 32, dev)
    best, raw = _refine_case(lmflat, bank, 4, (128, 128), k, wx, wy, live)
    assert int(best.max()) == 0
    assert torch.equal(raw[live], torch.full_like(raw[live], 2 * N))


def _chain_case(lmflat, plan, threshold_frac=0.5):
    """chain_scores against its twin on a device plan, bitwise; returns
    the scores."""
    K = plan.slot_start.numel() - 1
    dev = lmflat.device
    rng = np.random.RandomState(K)
    pos = torch.from_numpy(rng.randint(0, plan.M + 2, K).astype(np.int32)
                           ).to(dev)
    got = chain_scores(lmflat, plan, pos, torch.zeros(K, dtype=torch.int32,
                                                      device=dev))
    torch.cuda.synchronize()
    rmin = (got[0].amax(dim=(0, 2)) * threshold_frac).to(torch.int32)
    got = chain_scores(lmflat, plan, pos, rmin)
    torch.cuda.synchronize()
    want = chain_scores_plain(lmflat, plan, pos, rmin)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert int(got[1].sum()) > 0
    return got[0]


def _hand_plan(rng, M, L, programs, empty_run=0, tail=0.1, base=None):
    """A chain plan written by hand: programs of the given template counts;
    a base adds 20-40 offsets, or `base` of them (a share `tail` on the
    zero tail, offset L),
    a delta adds and removes a few, and every program after the first
    holds a run of `empty_run` empty deltas (duplicates)."""
    prog_start, slot_start, slots = [], [], []
    k = 0
    for p, n in enumerate(programs):
        prog_start.append(k)
        cur = []
        for t in range(n):
            slot_start.append(len(slots))
            if t == 0:
                new = [L if rng.rand() < tail else int(rng.randint(0, L))
                       for _ in range(base or int(rng.randint(20, 41)))]
                cur = list(new)
            elif p and 1 <= t <= empty_run:
                new = []
            else:
                adds = [L if rng.rand() < tail else int(rng.randint(0, L))
                        for _ in range(int(rng.randint(0, 4)))]
                subs = [cur.pop(int(rng.randint(len(cur))))
                        for _ in range(min(len(cur), int(rng.randint(0, 4))))]
                cur += adds
                new = adds + [~o for o in subs]
            slots.extend(new)
            k += 1
    prog_start.append(k)
    slot_start.append(len(slots))
    return ChainPlan(np.asarray(prog_start, np.int32),
                     np.asarray(slot_start, np.int32),
                     np.asarray(slots, np.int32), M, L)


@pytest.mark.parametrize("Z", [1, 16, 32, 10000])
def test_chain_kernel_10k_plan_segments(dev, Z):
    """The committed 10,000-template bank at the dense path's coarse
    level (512^2, T=8, M=4096; its longest program walks 126 templates),
    with segments of 1 template, 16, 32 and whole programs."""
    pyr = synthetic.load_bank_cache(synthetic.bank_cache_path(10000, 63))
    bank = pyramids_to_banks(pyr, 2)[-1]
    plan = plan_chain(LevelBank(*(f.numpy() for f in bank)), 8, (512, 512))
    assert int(np.diff(plan.prog_start).max()) == 126
    plan = plan_to_device(segment_plan(plan, Z), dev)
    lmflat = _lmflat(np.random.RandomState(Z), 1, 8, 512, 512, dev)
    _chain_case(lmflat, plan)


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("Z", [1, 5, 900])
def test_chain_kernel_odd_m_empty_runs_tail(dev, B, Z):
    """A hand-made plan at M = 29 x 37 = 1073 (odd lmflat length, so frames
    after the first start unaligned and rows are not 16-byte aligned):
    runs of 12 empty deltas, slots on the zero tail, programs of 1 to 900
    templates (that one's 2,700 slots pass the 2,048 codes staged at a
    time)."""
    rng = np.random.RandomState(B * Z)
    M, L = 1073, 16 * 64 * 1073
    plan = _hand_plan(rng, M, L, [1, 40, 900, 7, 126], empty_run=12)
    assert plan.slot_start[941] - plan.slot_start[41] > 2048
    lmflat = _lmflat(rng, B, 8, 232, 296, dev, n_ori=16)
    assert lmflat.shape[1] == L + M and lmflat.shape[1] % 2 == 1
    _chain_case(lmflat, plan_to_device(segment_plan(plan, Z), dev))


@pytest.mark.parametrize("Z", [1, 7])
def test_chain_kernel_wide_start_rows(dev, Z):
    """Bases of 2,100 offsets, as a wide bank's coarse level has them:
    every start row after a base holds more codes than the 2,048 staged
    at a time."""
    rng = np.random.RandomState(Z + 2100)
    M, L = 1073, 16 * 64 * 1073
    plan = segment_plan(_hand_plan(rng, M, L, [30, 9], base=2100), Z)
    assert int((plan.segs[:, 3] - plan.segs[:, 2]).max()) > 2048
    lmflat = _lmflat(rng, 2, 8, 232, 296, dev, n_ori=16)
    _chain_case(lmflat, plan_to_device(plan, dev))


def test_chain_kernel_sliced_frames(dev):
    """Frames 1 and 2 of an odd-length batch, sliced as lmflat[b:b+1]:
    unaligned data_ptr, and the last frame ends the storage."""
    rng = np.random.RandomState(7)
    M, L = 1073, 16 * 64 * 1073
    plan = plan_to_device(segment_plan(_hand_plan(
        rng, M, L, [60, 3, 90], empty_run=5), 8), dev)
    lmflat = _lmflat(rng, 3, 8, 232, 296, dev, n_ori=16)
    for b in (1, 2):
        frame = lmflat[b:b + 1]
        assert frame.data_ptr() % 4 != 0
        _chain_case(frame, plan)


@pytest.mark.parametrize("Z", [1, 64])
def test_chain_kernel_saturated(dev, Z):
    """Every lmflat byte 4: each packed run of 63 start codes or slots
    holds 252 a lane, and a program of 64 bases' worth of adds reaches
    past it."""
    rng = np.random.RandomState(Z)
    M, L = 4096, 8 * 64 * 4096
    plan = _hand_plan(rng, M, L, [64, 200, 2], tail=0.0)
    lmflat = _lmflat(rng, 2, 8, 512, 512, dev, fill=4)
    S = _chain_case(lmflat, plan_to_device(segment_plan(plan, Z), dev), 1.0)
    assert int(S.max()) >= 4 * 40


@pytest.mark.parametrize("T", range(1, 17))
def test_frontend_kernel_edge_sizes(dev, T):
    """Widths and heights of 1, 3, 31, 33, 65, 127 and 129 (frames smaller
    than one block, one lane, and just past a block's output columns) at
    every T: gray 8 orientations, and masked color 16 with the quantized
    plane."""
    rng = np.random.RandomState(T)
    sides = (1, 3, 31, 33, 65, 127, 129)
    for h in sides:
        for w in sides:
            gray = rng.randint(0, 256, (2, h, w)).astype(np.uint8)
            gray[1] = (np.add.outer(np.arange(h) * 7, np.arange(w) * 3)
                       % 256).astype(np.uint8)
            frames = torch.from_numpy(gray).to(dev)
            got = quant_spread(frames, 10.0, T)
            torch.cuda.synchronize()
            assert torch.equal(got, quant_spread_plain(frames, 10.0, T)), \
                (h, w)
            if (h, w) not in ((3, 129), (129, 3), (33, 65), (127, 127)):
                continue
            color = torch.from_numpy(np.ascontiguousarray(np.stack(
                [gray, np.roll(gray, 1, axis=2), 255 - gray], axis=1))
            ).to(dev)
            masks = torch.from_numpy(((rng.rand(2, h, w) > 0.25) * 255)
                                     .astype(np.uint8)).to(dev)
            got = quant_spread(color, 10.0, T, 16, masks, True)
            torch.cuda.synchronize()
            want = quant_spread_plain(color, 10.0, T, 16, masks, True)
            for g, e in zip(got, want):
                assert torch.equal(to_i32(g), to_i32(e)), (h, w)


@pytest.mark.parametrize("side,T", [(1024, 4), (512, 8)])
@pytest.mark.parametrize("mode", ["gray8", "masked_color16_quant"])
def test_frontend_kernel_batch8(dev, side, T, mode):
    """B=8 at the flagship batch's level sizes (the strip the wrapper
    picks at B=8 differs from B=1's)."""
    rng = np.random.RandomState(side + T)
    gray = np.stack([synthetic.synthetic_scene(
        side, side, synthetic.synthetic_shape_image(256, 0), n_instances=2,
        seed=s) for s in range(8)])
    gray[::3] = rng.randint(0, 256, gray[::3].shape).astype(np.uint8)
    if mode == "gray8":
        frames = torch.from_numpy(gray).to(dev)
        assert torch.equal(quant_spread(frames, 30.0, T),
                           quant_spread_plain(frames, 30.0, T))
        return
    color = torch.from_numpy(np.ascontiguousarray(np.stack(
        [gray, np.roll(gray, 1, axis=2), 255 - gray], axis=1))).to(dev)
    masks = torch.from_numpy(((rng.rand(8, side, side) > 0.25) * 255)
                             .astype(np.uint8)).to(dev)
    got = quant_spread(color, 30.0, T, 16, masks, True)
    torch.cuda.synchronize()
    for g, e in zip(got, quant_spread_plain(color, 30.0, T, 16, masks,
                                            True)):
        assert torch.equal(to_i32(g), to_i32(e))


def test_frontend_phase_every_integer_gradient(dev):
    """The kernel's fastAtan2 (its division without the IEEE slow path)
    equals the plain float32 phase_deg bit for bit on every integer
    (dx, dy) in [-1020, 1020]^2, the full range of 3x3 Sobel on uint8."""
    r = torch.arange(-1020, 1021, dtype=torch.float32, device=dev)
    dx, dy = (a.reshape(-1) for a in torch.meshgrid(r, r, indexing="ij"))
    got = phase_deg_kernel(dx, dy)
    torch.cuda.synchronize()
    want = phase_deg(dx.cpu(), dy.cpu())
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _pyramid_fields(pyramids):
    return [(t.width, t.height, t.tl_x, t.tl_y,
             [(f.x, f.y, f.label, int(np.float32(f.theta).view(np.uint32)))
              for f in t.features]) for tp in pyramids for t in tp]


@pytest.mark.parametrize("n_ori,color,masked", [
    (8, False, True), (8, True, False), (16, False, False)])
def test_training_on_card_equals_cpu(dev, n_ori, color, masked):
    """add_templates with the device half on the card trains the same
    templates as on the CPU, theta bits included (a flat frame fails on
    both)."""
    frames = np.stack([synthetic.synthetic_shape_image(128, s)
                       for s in range(3)] + [np.full((128, 128), 90,
                                                     np.uint8)])
    if color:
        frames = np.stack([frames, np.roll(frames, 1, axis=2),
                           255 - frames], axis=-1)
    masks = ((np.random.RandomState(1).rand(4, 128, 128) > 0.1)
             .astype(np.uint8) * 255 if masked else None)
    pyr = []
    for device in ("cpu", dev):
        det = Detector(num_features=48, num_orientations=n_ori,
                       device=device)
        assert det.add_templates(frames, "c", masks, chunk=3)[3] == -1
        pyr.append(_pyramid_fields(det.class_templates["c"]))
    assert pyr[0] == pyr[1]


def test_merged_match_on_card_equals_cpu(dev):
    """Two classes of different widths in one merged step on the card,
    with an overflow re-run at cand_cap=8, give the CPU's lists."""
    frames = np.stack([synthetic.synthetic_scene(
        256, 256, synthetic.synthetic_shape_image(64, 0), n_instances=2,
        seed=s) for s in (3, 4)])
    got = []
    for device in ("cpu", dev):
        det = Detector(num_features=64, device=device)
        for cid, nf in (("wide", 64), ("narrow", 24)):
            det.add_template(synthetic.synthetic_shape_image(64, 0), cid,
                             num_features=nf)
            det.add_templates_rotate(cid, 0, [30.0 * i for i in range(1, 12)],
                                     (32.0, 32.0))
        got.append([[(m.class_id, m.template_id, m.x, m.y, m.similarity)
                     for m in ms] for ms in det.match_batch(
            frames, 75.0, ["wide", "narrow"], cand_cap=8)])
        assert ("narrow", "wide") in det._merged
    assert got[0] == got[1] and all(got[0])


@pytest.mark.parametrize("mode", ["gray8", "gray16", "color8", "color16",
                                  "masked_gray8", "masked_color16",
                                  "with_quant_masked_gray16",
                                  "with_quant_color8"])
@pytest.mark.parametrize("h,w", [(37, 53), (256, 256)])
@pytest.mark.parametrize("T", [1, 4, 8])
def test_frontend_kernel_patch2843_equals_plain(dev, mode, h, w, T):
    """The kernel's patch_2843 mode (weak interior pixels cast no vote)
    against its twin: the spread plane and, where asked, the quantized
    one."""
    color = "color" in mode
    n_ori = 16 if "16" in mode else 8
    rng = np.random.RandomState(h + w + T + 1)
    gray = np.stack([rng.randint(0, 256, (h, w), dtype=np.uint8),
                     synthetic.synthetic_scene(
                         h, w, synthetic.synthetic_shape_image(24, T),
                         n_instances=2, seed=T)])
    img = (np.stack([gray, np.roll(gray, 1, axis=2), 255 - gray], axis=1)
           if color else gray)
    frames = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
    masks = torch.from_numpy(((rng.rand(2, h, w) > 0.25) * 255).astype(
        np.uint8)).to(dev) if "masked" in mode else None
    wq = "with_quant" in mode
    got = quant_spread(frames, 30.0, T, n_ori, masks, wq, patch_2843=True)
    torch.cuda.synchronize()
    want = quant_spread_plain(frames, 30.0, T, n_ori, masks, wq,
                              patch_2843=True)
    for g, e in zip(got if wq else (got,), want if wq else (want,)):
        assert torch.equal(to_i32(g), to_i32(e))


def test_edge_field_on_card_equals_cpu(dev):
    """The ICP edge field on the card: edge, has and off equal the CPU's
    bit for bit; normals and subpixel offsets to float32 rounding."""
    from shape_based_matching_tpu_torch.models.icp import edge_nearest_field

    frame = synthetic.synthetic_scene(
        240, 320, synthetic.synthetic_shape_image(96, 1), n_instances=3,
        seed=2)
    src = torch.from_numpy(frame)
    got = edge_nearest_field(src.to(dev), 30.0, 8)
    want = edge_nearest_field(src, 30.0, 8)
    for i in (0, 2, 3):
        assert torch.equal(got[i].cpu(), want[i])
    for i in (1, 4):
        assert (got[i].cpu() - want[i]).abs().max() <= 2.0 ** -21


def test_match_icp_on_card_equals_cpu(dev):
    """match_icp, match_refine_batch, refine_matches_icp (icp.cu on the
    card, its plain twin on the CPU) and refine_detections: the same match
    keys as on the CPU, inliers and valid equal, poses to float32
    rounding (the production tolerance)."""
    from shape_based_matching_tpu_torch import refine_matches_icp

    frame = synthetic.synthetic_scene(
        256, 256, synthetic.synthetic_shape_image(96, 0), n_instances=2,
        seed=4)
    res = {}
    for device in ("cpu", dev):
        det = Detector(num_features=48, device=device)
        det.add_template(synthetic.synthetic_shape_image(96, 0), "c")
        det.add_templates_rotate("c", 0, [15.0 * i for i in range(1, 24)],
                                 (48.0, 48.0))
        icp = det.match_icp(frame, 70.0, top_c=8)
        batch = refine_matches_icp_batch(det, frame)
        ref = refine_detections(det, frame, det.match(frame, 70.0)[:4])
        listed = refine_matches_icp(det, frame, det.match(frame, 70.0)[:8])
        res[device] = (icp, batch, ref, listed)
    (ci, cb, cr, cl), (gi, gb, gr, gl) = res["cpu"], res[dev]
    assert ci and [r["match"] for r in ci] == [r["match"] for r in gi]
    assert cl and [r["match"] for r in cl] == [r["match"] for r in gl]
    for a, b in [*zip(ci, gi), *zip(cl, gl)]:
        assert a["valid"] == b["valid"] and a["inliers"] == b["inliers"]
        for f, tol in POSE_TOL.items():
            assert abs(a[f] - b[f]) < tol, (f, a[f], b[f])
    assert torch.equal(cb[0], gb[0].cpu())
    assert (cb[1] - gb[1].cpu()).abs().max() < 1e-2
    assert [r["match"] for r in cr] == [r["match"] for r in gr]
    for a, b in zip(cr, gr):
        assert abs(a["x"] - b["x"]) < 1e-3 and abs(a["y"] - b["y"]) < 1e-3


# icp.cu: a candidate of N points on a block of 128 threads: N = 128, more
# points than threads (134 of the production bank, 300), one candidate
# and top_c = 32
ICP_CASES = [(1, 128), (32, 128), (6, 300), (32, 134)]
POSE_TOL = {"dtheta_deg": 1e-3, "dscale": 1e-4, "tx": 1e-2, "ty": 1e-2}


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.mark.parametrize("C,N", ICP_CASES)
def test_icp_steps_kernel_is_its_replay(dev, C, N):
    """icp.cu is its NumPy replay (tests/torch_icp_replay.py) bit for bit:
    the state (tx, ty), rmse, inliers and valid flags; dtheta and dscale,
    which atan2f and hypotf round on the card, to 2 ulps."""
    from shape_based_matching_tpu_torch.ops.cuda.icp import icp_steps

    field, pts, origins, pv = scene_case(C, N, C + N, device=dev)
    before = icp_steps.launches
    got = [t.cpu().numpy() for t in icp_steps(*field, pts, origins, pv, 12,
                                                8, 8)]
    assert icp_steps.launches == before + 1
    want = replay_torch(*field, pts, origins, pv)
    for i in (2, 3, 4, 5, 6):
        np.testing.assert_array_equal(got[i], want[i])
    assert _ulps(got[0], want[0]) <= 2 and _ulps(got[1], want[1]) <= 2
    assert got[6].sum() >= C // 2


@pytest.mark.parametrize("C,N", ICP_CASES)
def test_icp_steps_kernel_equals_twin(dev, C, N):
    """The kernel against the plain twin on the card. At a batch of
    candidates the twin's bmm and solve run cuBLAS's batched kernels, whose
    arithmetic icp.cu takes: poses, inliers and valid flags equal bit for
    bit. One candidate takes other cuBLAS kernels: inliers and valid
    equal, poses within the production tolerance. rmse (the kernel's own
    order) to float32 rounding."""
    from shape_based_matching_tpu_torch.models.icp import (
        icp_refine_points, icp_refine_points_plain)

    field, pts, origins, pv = scene_case(C, N, C + N, device=dev)
    got = icp_refine_points(*field, pts, origins, pv)
    want = icp_refine_points_plain(*field, pts, origins, pv)
    assert torch.equal(got.inliers, want.inliers.to(torch.int32))
    assert torch.equal(got.valid, want.valid)
    for f, tol in POSE_TOL.items():
        g, w = getattr(got, f), getattr(want, f)
        if C > 1:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), f
        else:
            assert float((g - w).abs().max()) < tol, f
    assert float((got.rmse - want.rmse).abs().max()) < 1e-5


def test_icp_steps_is_one_launch_and_no_other_kernel(dev):
    """icp_refine_points on the card queues one device kernel a call, and
    torch.profiler sees no device kernel but icp.cu's: no cuBLAS,
    cuSOLVER or torch op."""
    from shape_based_matching_tpu_torch.models.icp import icp_refine_points
    from shape_based_matching_tpu_torch.utils.profiling import (
        CALLS, device_work)

    field, pts, origins, pv = scene_case(32, 128, 5, device=dev)
    queued, kern = device_work(
        lambda: icp_refine_points(*field, pts, origins, pv))
    assert queued == CALLS
    names = [n for n, _ in kern]
    assert names and all("icp_kernel" in n for n in names), names


def test_match_icp_launches_the_kernel_once_a_class(dev):
    """match_icp on two classes: one icp.cu launch a class and frame;
    match_refine_batch at B=2 one a class and frame."""
    from shape_based_matching_tpu_torch import match_refine_batch
    from shape_based_matching_tpu_torch.ops.cuda.icp import icp_steps

    frame = synthetic.synthetic_scene(
        256, 256, synthetic.synthetic_shape_image(96, 0), n_instances=2,
        seed=4)
    det = Detector(num_features=48, device=dev)
    for cid, seed in (("a", 0), ("b", 1)):
        det.add_template(synthetic.synthetic_shape_image(96, seed), cid)
    det.match_icp(frame, 70.0, top_c=8)
    before = icp_steps.launches
    det.match_icp(frame, 70.0, top_c=8)
    assert icp_steps.launches == before + 2
    match_refine_batch(det, np.stack([frame, frame]), 70.0, top_c=8)
    assert icp_steps.launches == before + 6


def refine_matches_icp_batch(det, frame):
    """match_refine_batch's selection (k, x, y) and poses (tx, ty) at
    B=1."""
    from shape_based_matching_tpu_torch import match_refine_batch

    out = match_refine_batch(det, frame[None], 70.0, top_c=8)["c"][0]
    return (torch.stack([out["k"], out["x"], out["y"]]),
            torch.stack([out["icp"].tx, out["icp"].ty]))


def _cli_lines(argv):
    import contextlib
    import io
    import re

    from shape_based_matching_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [re.sub(r"\[match [0-9.]+ ms\]", "[match]", l)
            for l in buf.getvalue().splitlines()]


def test_cli_match_on_card_equals_cpu(dev, tmp_path):
    """The CLI's train and match (--icp, --verify-ccorr) print the same
    lines on the card as on the CPU at 256^2, the poses within the
    production tolerance; the model directories are equal."""
    import re

    from shape_based_matching_tpu_torch.utils.imageio import save_image

    templ = synthetic.synthetic_shape_image(128, 0)
    scene = synthetic.synthetic_scene(256, 256, templ, n_instances=2, seed=5)
    save_image(templ, str(tmp_path / "templ.png"))
    (tmp_path / "frames").mkdir()
    save_image(scene, str(tmp_path / "frames" / "scene.png"))
    out = {}
    for device in ("cpu", "cuda"):
        md = str(tmp_path / device)
        out[device] = _cli_lines([
            "--device", device, "train", "--model-dir", md, "--class-id",
            "shape", "--image", str(tmp_path / "templ.png"), "--angles",
            "0,90", "--num-features", "48", "--gray"])
        out[device] += _cli_lines([
            "--device", device, "match", "--model-dir", md, "--test-dir",
            str(tmp_path / "frames"), "--threshold", "80", "--gray",
            "--verify-ccorr", "0.5", "--icp"])
        out[device] = [l.replace(md, "{dir}") for l in out[device]]
    icp = re.compile(r" icp\[.*\]")
    assert [icp.sub("", l) for l in out["cuda"]] == \
        [icp.sub("", l) for l in out["cpu"]]
    assert sum(" icp[" in l for l in out["cuda"]) >= 2
    num = re.compile(r"icp\[x=(\S+) y=(\S+) dtheta=(\S+) dscale=(\S+)")
    for a, b in zip(out["cpu"], out["cuda"]):
        ma, mb = num.search(a), num.search(b)
        assert (ma is None) == (mb is None)
        if ma:
            for u, v, t in zip(ma.groups(), mb.groups(),
                               (0.015, 0.015, 1.5e-3, 1.5e-4)):
                assert abs(float(u) - float(v)) <= t, (a, b)


def test_ssim_ccorr_on_card_equal_cpu(dev):
    """The verify ops on the card agree with the CPU within 1e-5 (float32
    SSIM; float64 correlations, no TF32)."""
    from shape_based_matching_tpu_torch.utils import verify

    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (96, 128), np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-30, 30, a.shape), 0,
                255).astype(np.uint8)
    gm, gmap = verify.ssim(a, b, device=dev)
    cm, cmap = verify.ssim(a, b, device="cpu")
    assert gmap.device.type == "cuda"
    assert abs(float(gm) - float(cm)) < 1e-5
    assert (gmap.cpu() - cmap).abs().max() < 1e-5
    templ = a[20:60, 30:90]
    g = verify.match_template_ccorr_normed(a, templ, device=dev)
    c = verify.match_template_ccorr_normed(a, templ, device="cpu")
    assert g.device.type == "cuda" and (g.cpu() - c).abs().max() < 1e-5
    assert float(g[20, 30]) > 0.99999


def test_nms_host_helper_builds_on_the_card_machine(dev):
    """sbm_nms_boxes builds from csrc/host.cpp with the host compiler of
    the card's machine and equals the Python loop."""
    from shape_based_matching_tpu_torch.models import native
    from shape_based_matching_tpu_torch.utils import nms

    assert native.library().sbm_nms_boxes is not None
    rng = np.random.RandomState(1)
    boxes = [tuple(int(v) for v in b) for b in np.c_[
        rng.randint(0, 200, (400, 2)), rng.randint(1, 60, (400, 2))]]
    scores = list(rng.uniform(50, 100, 400))
    for eta in (1.0, 0.9):
        assert nms.nms_boxes(boxes, scores, 60.0, 0.5, eta) == \
            nms.nms_boxes_plain(boxes, scores, 60.0, 0.5, eta)


def _sharded_fixture(device, h=256, n=4):
    """12 rotations of a 56-pixel star and `n` h x 256 scenes of it."""
    det = Detector(num_features=48, device=device)
    templ = synthetic.synthetic_shape_image(56, seed=0)
    det.add_template(templ, "a", np.full_like(templ, 255))
    det.add_templates_rotate("a", 0, [30.0 * i for i in range(1, 12)],
                             (28.0, 28.0))
    frames = np.stack([synthetic.synthetic_scene(h, 256, templ,
                                                 n_instances=2 * h // 256,
                                                 seed=s) for s in range(n)])
    return det, frames


def _keys(ms):
    return [(m.class_id, m.template_id, m.x, m.y, m.similarity) for m in ms]


def test_spatial_on_card_equals_cpu(dev):
    """4 round-robin tiles on the card (the default mesh: every visible
    card) give the CPU's tiles' list and the card's whole-frame match.
    The frame is 1024 x 256: the halo (208 rows) leaves no room for
    4 bands in 256 rows."""
    from shape_based_matching_tpu_torch.parallel import spatial

    got = []
    for device, m in (("cpu", spatial.make_spatial_mesh(4, ["cpu"])),
                      (dev, spatial.make_spatial_mesh(4))):
        det, frames = _sharded_fixture(device, h=1024, n=1)
        before = refine_windows.launches
        got.append(_keys(spatial.match_huge_frame(det, frames[0], 75.0,
                                                  mesh=m)))
        assert got[-1] == _keys(det.match(frames[0], 75.0))
    assert refine_windows.launches > before
    assert got[0] == got[1] and got[0]


def test_mesh_on_card_equals_cpu(dev):
    """A (2, 2) mesh of round-robin shards on the card: the CPU mesh's
    lists and the card's per-frame matches."""
    from shape_based_matching_tpu_torch.parallel import mesh

    got = []
    for device, m in (("cpu", mesh.make_mesh(4, devices=["cpu"])),
                      (dev, mesh.make_mesh(4, data=2))):
        det, frames = _sharded_fixture(device)
        before = coarse_scores.launches
        per = mesh.match_images_sharded(det, frames, 75.0, mesh=m)
        assert [_keys(p) for p in per] == [_keys(det.match(f, 75.0))
                                           for f in frames]
        got.append([_keys(p) for p in per])
    assert coarse_scores.launches > before
    assert got[0] == got[1] and all(got[0])


def test_sharded_training_on_card_equals_cpu(dev):
    """add_templates_sharded on 4 round-robin shards of the card trains
    the CPU's add_templates templates, theta bits included."""
    from shape_based_matching_tpu_torch.parallel import mesh

    frames = np.stack([synthetic.synthetic_shape_image(256, s)
                       for s in range(6)])
    masks = (np.random.RandomState(2).rand(6, 256, 256) > 0.1).astype(
        np.uint8) * 255
    local = Detector(num_features=48, device="cpu")
    ids = local.add_templates(frames, "c", masks)
    det = Detector(num_features=48, device=dev)
    assert mesh.add_templates_sharded(det, frames, "c", masks,
                                      mesh=mesh.make_mesh(4),
                                      chunk_per_dev=1) == ids
    assert (_pyramid_fields(det.class_templates["c"])
            == _pyramid_fields(local.class_templates["c"]))


def test_refine_step_on_card_equals_match_refine_batch(dev):
    """The production tier on a (2, 2) mesh of round-robin shards of the
    card equals the card's per-frame match_refine_batch bit for bit, and
    refines the CPU's candidates (k, x, y, valid)."""
    from shape_based_matching_tpu_torch import match_refine_batch
    from shape_based_matching_tpu_torch.parallel import mesh

    out = {}
    for device, m in (("cpu", mesh.make_mesh(4, devices=["cpu"])),
                      (dev, mesh.make_mesh(4, data=2))):
        det, frames = _sharded_fixture(device)
        banks = det._get_banks("a")
        step = mesh.multichip_refine_step(m, det.T_at_level, (256, 256),
                                          cand_cap=64, top_c=4)
        out[device] = step(frames, 30.0, 75.0,
                           mesh.shard_banks(m, banks, False),
                           mesh.shard_chains(m, banks[-1], 8, (128, 128), 8,
                                             False))
        if device == dev:
            for b in range(4):
                r = match_refine_batch(det, frames[b:b + 1], 75.0, top_c=4,
                                       iters=10, cand_cap=64)["a"][0]
                for g, w in zip(out[dev], [*r["icp"], r["k"], r["x"],
                                           r["y"], r["score"]]):
                    if w.dtype == torch.float32:
                        g, w = g.view(torch.int32), w.view(torch.int32)
                    assert torch.equal(g[b], w)
    assert int(out["cpu"][6].sum()) > 0
    for i in (6, 7, 8, 9):  # valid, template id, x, y
        assert torch.equal(out[dev][i].cpu(), out["cpu"][i])


@pytest.mark.parametrize("seed,variant", FUZZ_CASES)
def test_fuzz_match_on_card_equals_oracle(dev, seed, variant):
    """tests/test_fuzz_parity.py's randomized scenes on the card against
    the port's copy of the scalar oracle (matchClass): distinct (template,
    x, y, float32 bits), at the case's threshold and at 20 (many matches,
    overflow re-runs), through the frontend, coarse and window kernels."""
    det, scene, mask, thr = fuzz_case(seed, variant, dev)
    pyramid = oracle_pyramid(det, scene, mask)
    kernels = (quant_spread, coarse_scores, refine_windows)
    for fn in kernels:
        fn.launches = 0
    for t in (thr, 20.0):
        got = port_keys(det.match(scene, t, ["fuzz"], mask=mask))
        want = oracle_keys(oracle_matches(det, pyramid, t, ["fuzz"]))
        assert got == want, (seed, variant, t)
    assert all(fn.launches for fn in kernels)


def test_fuzz_merged_on_card_equals_oracle(dev):
    det, scene = merged_case(dev)
    got = port_keys(det.match(scene, MERGED_THRESHOLD))
    want = oracle_keys(oracle_matches(det, oracle_pyramid(det, scene),
                                      MERGED_THRESHOLD))
    assert got == want and len({k[0] for k in got}) >= 2


@pytest.mark.parametrize("mode", ["gray8", "color8", "gray16",
                                  "masked_gray8"])
def test_frontend_spread_t2_equals_oracle(dev, mode):
    """frontend.cu at T=2 (the finest level of a three-level pyramid)
    against oracle.spread(quantized_orientations(...)), the quantized
    code masked as build_lm_pyramid masks it."""
    color, n_ori = mode == "color8", 16 if mode == "gray16" else 8
    img = synthetic.synthetic_scene(
        192, 256, synthetic.synthetic_shape_image(96, 3), n_instances=2,
        seed=4)
    if color:
        img = np.stack([img, np.roll(img, 1, axis=1), 255 - img], axis=-1)
    mask = None
    if mode == "masked_gray8":
        mask = ((np.random.RandomState(5).rand(192, 256) > 0.25) * 255
                ).astype(np.uint8)
    frames = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(img, -1, 0) if color else img))[None].to(dev)
    masks = None if mask is None else torch.from_numpy(mask)[None].to(dev)
    got = quant_spread(frames, 30.0, 2, n_ori, masks)
    torch.cuda.synchronize()
    _, quant, _ = oracle.quantized_orientations(img, 30.0, n_ori)
    if mask is not None:
        quant = np.where(mask > 0, quant, 0).astype(quant.dtype)
    want = oracle.spread(quant, 2)
    np.testing.assert_array_equal(
        to_i32(got[0]).cpu().numpy().astype(want.dtype), want)


_PYR_SIDES = (2, 3, 4, 5, 7, 1023, 1024)


@pytest.mark.parametrize("h", _PYR_SIDES)
@pytest.mark.parametrize("w", _PYR_SIDES)
def test_pyr_down_kernel_equals_plain(dev, h, w):
    """pyramid.cu's pyrDown on gray [B, H, W] and planar color [B, 3, H, W]
    at B = 1 and 8: odd, non-square and tiny sides (BORDER_REFLECT_101 at
    2 and 3 pixels), one launch a call."""
    rng = np.random.RandomState(h * 7 + w)
    for shape in ((1, h, w), (8, h, w), (1, 3, h, w), (8, 3, h, w)):
        img = torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)
                               ).to(dev)
        before = pyr_down.launches
        got = pyr_down(img)
        torch.cuda.synchronize()
        assert pyr_down.launches == before + 1
        assert torch.equal(got, pyr_down_u8_plain(img)), shape


def test_pyr_down_kernel_4096_row_tile(dev):
    """The 4096^2 spatial path's 1760 x 4096 row tile, and a scene."""
    tile = synthetic.synthetic_scene(1760, 4096,
                                     synthetic.synthetic_shape_image(256, 0),
                                     n_instances=3, seed=5)
    img = torch.from_numpy(tile[None]).to(dev)
    got = pyr_down(img)
    torch.cuda.synchronize()
    assert torch.equal(got, pyr_down_u8_plain(img))
    assert torch.equal(pyr_down(got), pyr_down_u8_plain(got))


def _spread_planes(rng, B, H, W, n_ori, dev):
    if n_ori == 8:
        return torch.from_numpy(rng.randint(0, 256, (B, H, W), np.uint8)
                                ).to(dev)
    v = rng.randint(0, 1 << 16, (B, H, W)).astype(np.uint16).view(np.int16)
    return torch.from_numpy(v).to(dev).view(torch.uint16)


@pytest.mark.parametrize("T", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n_ori", [8, 16])
def test_linear_memories_kernel_equals_plain(dev, T, n_ori):
    """pyramid.cu's linear memories with the zero tail, byte for byte
    (the tail preset to garbage by the caching allocator's reuse): the
    flagship level sizes, rows longer than one block, runs cut by the
    row's end, rows off 16-byte alignment, B = 1 and 8."""
    rng = np.random.RandomState(T * 100 + n_ori)
    sizes = [(1024, 1024), (512, 512), (T * 3, T * 37), (T * 5, T * 260),
             (T, T), (T * 2, T * 4099 if T <= 2 else T * 261)]
    for B in (1, 8):
        for H, W in sizes:
            sp = _spread_planes(rng, B, H, W, n_ori, dev)
            torch.full((B * (n_ori * H * W + H * W // (T * T)),), 0xA5,
                       dtype=torch.uint8, device=dev)  # freed: garbage
            before = linear_memories.launches
            got = linear_memories(sp, T, n_ori)
            torch.cuda.synchronize()
            assert linear_memories.launches == before + 1
            assert torch.equal(got, linear_memories_plain(sp, T, n_ori)), (
                B, H, W)


@pytest.mark.parametrize("mode", ["gray8", "color8", "gray16",
                                  "masked_gray8"])
def test_batch_pyramid_on_card_equals_cpu(dev, mode):
    """_batch_pyramid on the flagship frames (1024^2, T = (4, 8)) equals
    its CPU run, every level's whole flat buffer."""
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    color, n_ori = mode == "color8", 16 if mode == "gray16" else 8
    shape = synthetic.synthetic_shape_image(256, 0)
    gray = np.stack([synthetic.synthetic_scene(1024, 1024, shape,
                                               n_instances=4, seed=s)
                     for s in (3, 4)])
    img = np.stack([gray, np.roll(gray, 1, axis=2), 255 - gray], axis=1) \
        if color else gray
    masks = torch.from_numpy(((np.random.RandomState(5).rand(2, 1024, 1024)
                               > 0.25) * 255).astype(np.uint8)) \
        if mode == "masked_gray8" else None
    frames = torch.from_numpy(np.ascontiguousarray(img))
    want = _batch_pyramid(frames, (4, 8), 2, 30.0, n_ori, masks)
    got = _batch_pyramid(frames.to(dev), (4, 8), 2, 30.0, n_ori,
                         None if masks is None else masks.to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_batch_pyramid_is_three_launches_a_level(dev):
    """On the card a 1024^2 two-level pyramid queues 5 device operations
    (level 0: the frontend and the linear memories; level 1: pyrDown too),
    none of them a torch kernel, from the host-side launch records."""
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    from shape_based_matching_tpu_torch.utils.profiling import (
        CALLS, device_work)
    frames = torch.from_numpy(synthetic.synthetic_scene(
        1024, 1024, synthetic.synthetic_shape_image(256, 0), n_instances=4,
        seed=3)[None]).to(dev)
    queued, kern = device_work(
        lambda: _batch_pyramid(frames, (4, 8), 2, 30.0))
    assert queued == 5 * CALLS
    names = [n for n, _ in kern]
    ours = ("pyr_down_kernel", "lm_kernel", "quant_spread_kernel")
    assert names and all(any(k in n for k in ours) for n in names), names
