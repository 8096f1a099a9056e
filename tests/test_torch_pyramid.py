"""The pyramid layer's wrappers and kernels on the CPU
(``ops/cuda/pyramid.py``, ``csrc/pyramid.cu``).

On CPU tensors ``pyr_down`` and ``linear_memories`` run their plain twins
and count no launch; the twins equal the oracle's copy, JAX's pyrDown and
``build_lm_from_spread`` plus its zero tail; the wrappers reject bad
inputs before any launch. Both kernels are replayed here in NumPy from the
source's constants -- the grid, the shared tile, the per-thread loops,
the byte-lane response trick and the choice between 16-byte and byte
stores -- and the replay must equal the twin byte for byte and store each
output byte exactly once. The kernels themselves run in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from shape_based_matching_tpu_torch.ops.cuda import pyramid
from shape_based_matching_tpu_torch.ops.cuda.pyramid import (
    linear_memories, linear_memories_plain, lm_split, pyr_down)
from shape_based_matching_tpu_torch.ops.filters import pyr_down_u8_plain
from shape_based_matching_tpu_torch.ops.response import (
    build_lm_from_spread, response_maps)
from shape_based_matching_tpu_torch.oracle import reference as oracle
from tests.torch_csrc import constants

SIDES = (2, 3, 4, 5, 7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def _plane(seed, B, H, W, n_ori):
    """Random spread planes: uint8 for 8 orientations, uint16 (every bit,
    the dead ones too) for 16."""
    rng = np.random.RandomState(seed)
    if n_ori == 8:
        return torch.from_numpy(rng.randint(0, 256, (B, H, W), np.uint8))
    v = rng.randint(0, 1 << 16, (B, H, W)).astype(np.uint16)
    return torch.from_numpy(v.view(np.int16)).view(torch.uint16)


def _np(t):
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.uint16 else t.numpy())


# -- the wrappers on the CPU ----------------------------------------------

def test_cpu_tensors_take_the_twins_and_launch_nothing():
    before = (pyr_down.launches, linear_memories.launches)
    frames = torch.from_numpy(_u8(1, 2, 3, 20, 30))
    assert torch.equal(pyr_down(frames), pyr_down_u8_plain(frames))
    for n_ori in (8, 16):
        sp = _plane(2, 2, 16, 24, n_ori)
        assert torch.equal(linear_memories(sp, 4, n_ori),
                           linear_memories_plain(sp, 4, n_ori))
    assert (pyr_down.launches, linear_memories.launches) == before


@pytest.mark.parametrize("h", SIDES)
@pytest.mark.parametrize("w", SIDES)
def test_pyr_down_plain_equals_oracle_at_small_sizes(h, w):
    """Degenerate sizes: BORDER_REFLECT_101 at 2 and 3 pixels, odd sides;
    gray and BGR."""
    img = _u8(h * 10 + w, h, w)
    assert np.array_equal(pyr_down(torch.from_numpy(img)).numpy(),
                          oracle.pyr_down_u8(img))
    bgr = _u8(h * 10 + w + 1, h, w, 3)
    planar = torch.from_numpy(np.ascontiguousarray(bgr.transpose(2, 0, 1)))
    assert np.array_equal(pyr_down(planar).permute(1, 2, 0).numpy(),
                          oracle.pyr_down_u8(bgr))


def test_pyr_down_plain_equals_jax_odd_non_square():
    from shape_based_matching_tpu.ops import filters as jfl
    import jax.numpy as jnp
    img = _u8(5, 45, 131)
    assert np.array_equal(pyr_down(torch.from_numpy(img)).numpy(),
                          np.asarray(jfl.pyr_down_u8(jnp.asarray(img))))


@pytest.mark.parametrize("T", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n_ori", [8, 16])
def test_linear_memories_equal_build_lm_and_tail(T, n_ori):
    sp = _plane(T + n_ori, 2, 2 * T, 3 * T, n_ori)
    lm = build_lm_from_spread(sp, T, n_ori)
    want = torch.cat([lm.reshape(2, -1),
                      torch.zeros((2, lm.shape[-1]), dtype=torch.uint8)], 1)
    got = linear_memories(sp, T, n_ori)
    assert got.shape == (2, (n_ori * T * T + 1) * 6)
    assert torch.equal(got, want)
    lin = oracle.linearize(oracle.response_maps(_np(sp[1]), n_ori), T)
    assert np.array_equal(got[1, :lin.size].numpy(), lin.ravel())


def _raises(fn, *args, match):
    with pytest.raises(ValueError, match=match):
        fn(*args)


def test_wrappers_reject_bad_inputs():
    """Checked before any launch, on every device: the dtype (uint8 planes
    for 8 orientations, uint16 for 16), the shape, contiguity, the
    orientations (response_maps' message), T, and a plane that is not a
    multiple of T (linearize's message)."""
    _raises(pyr_down, torch.zeros((1, 8, 8), dtype=torch.int32),
            match="uint8")
    _raises(pyr_down, torch.zeros(8, dtype=torch.uint8), match="uint8")
    _raises(pyr_down, torch.zeros((8, 8), dtype=torch.uint8).t()[::2],
            match="contiguous")
    sp = torch.zeros((1, 16, 24), dtype=torch.uint8)
    _raises(linear_memories, sp.to(torch.int32), 4, match="spread planes")
    _raises(linear_memories, sp[0], 4, match="spread planes")
    _raises(linear_memories, sp, 4, 16, match="uint16 .* for 16")
    _raises(linear_memories, _plane(0, 1, 16, 24, 16), 4, 8,
            match="uint8 .* for 8")
    _raises(linear_memories, sp, 4, 12, match="8 or 16 orientations")
    _raises(linear_memories, sp, 0, match="outside")
    _raises(linear_memories, sp, 17, match="outside")
    _raises(linear_memories, sp[:, :, :20], 8,
            match="20x16 is not a multiple of T=8")
    _raises(linear_memories, sp[:, :, ::2], 4, match="contiguous")
    with pytest.raises(ValueError) as err:
        response_maps(sp, 12)
    assert "8 or 16 orientations" in str(err.value)
    meta = torch.zeros((1, 16, 16), dtype=torch.uint8, device="meta")
    _raises(pyr_down, meta, match="unsupported device")
    _raises(linear_memories, meta, 4, match="unsupported device")


# -- the kernels replayed ---------------------------------------------------

C = constants("pyramid.cu")
# a byte the replays put where the kernel leaves memory unwritten
GARBAGE = 0xA5


def _reflect(i, n):
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _pyr_replay(img):
    """pyr_down_kernel over planes [P, H, W]: returns the output and the
    number of stores to each output byte."""
    R, Cc, IR, IC, LD = (C[k] for k in ("PD_ROWS", "PD_COLS", "PD_IN_ROWS",
                                        "PD_IN_COLS", "PD_LD"))
    assert C["PD_THREADS"] == 32 * R and Cc == 4 * 32
    assert LD >= IC + 1 and LD % 8 == 0  # the 12-byte reads, aligned
    P, H, W = img.shape
    H2, W2 = H // 2, W // 2
    out = np.full((P, H2, W2), GARBAGE, np.int64)
    stores = np.zeros((P, H2, W2), np.int64)
    w5 = np.array([1, 4, 6, 4, 1])
    tid = np.arange(C["PD_THREADS"])
    ly, lx = tid // 32, (tid % 32) * 4
    for z in range(P):
        for by in range(-(-H2 // R)):
            for bx in range(-(-W2 // Cc)):
                oy0, ox0 = by * R, bx * Cc
                tile = np.full((IR, LD), GARBAGE, np.int64)
                rows = _reflect(2 * oy0 - 2 + np.arange(IR), H)
                cols = _reflect(2 * ox0 - 2 + np.arange(IC), W)
                tile[:, :IC] = img[z][np.ix_(rows, cols)]
                for t in np.flatnonzero((oy0 + ly < H2) & (ox0 + lx < W2)):
                    y, x = oy0 + ly[t], ox0 + lx[t]
                    win = tile[2 * ly[t]:2 * ly[t] + 5,
                               2 * lx[t]:2 * lx[t] + 12]
                    assert win.shape == (5, 12)
                    v = w5 @ win
                    vals = [(w5 @ v[2 * j:2 * j + 5] + 128) >> 8
                            for j in range(4)]
                    n = 4 if W2 % 4 == 0 else min(4, W2 - x)
                    assert x + n <= W2
                    out[z, y, x:x + n] = vals[:n]
                    stores[z, y, x:x + n] += 1
    return out, stores


@pytest.mark.parametrize("h,w", [(2, 2), (3, 7), (5, 4), (7, 5), (20, 262),
                                 (36, 520), (19, 264), (40, 9)])
def test_pyr_down_kernel_replay_equals_twin(h, w):
    """Partial blocks at the frame's right and bottom edges, packed stores
    (W/2 a multiple of 4) and byte stores, two planes (one color frame's
    channels alike)."""
    img = _u8(h + w, 2, h, w)
    out, stores = _pyr_replay(img)
    assert (stores == 1).all()
    assert np.array_equal(out, pyr_down_u8_plain(torch.from_numpy(img))
                          .numpy())


def _response(s, ori, n_ori):
    s = np.asarray(s, np.int64)
    if n_ori == 8:
        adj = ((s >> ((ori + 1) & 7)) | (s >> ((ori + 7) & 7))) & 1
        return np.where((s >> ori) & 1, 4, np.where(adj, 3, 0))
    near = sum(1 << ((ori + d) & 15) for d in range(-2, 3)) & 0xFFF
    mid = sum(1 << ((ori + d) & 15) for d in (-4, -3, 3, 4)) & 0xFFF
    return np.where(s & near, 4, np.where(s & mid, 1, 0))


def _response8x4(w, ori):
    """pyramid.cu's response8x4 on uint32 words."""
    w = np.asarray(w, np.uint64)
    m = np.uint64(0x01010101)
    e = (w >> np.uint64(ori)) & m
    n = ((w >> np.uint64((ori + 1) & 7)) | (w >> np.uint64((ori + 7) & 7))) \
        & m
    return ((e << np.uint64(2)) | ((n & ~e & np.uint64(0xFFFFFFFF))
                                   * np.uint64(3))) & np.uint64(0xFFFFFFFF)


def test_response8x4_equals_the_lut_on_every_byte():
    """The byte-lane trick on all 256 values in each lane position."""
    v = np.arange(256, dtype=np.uint64)
    for lane in range(4):
        words = (v << np.uint64(8 * lane)) | np.uint64(0x5A00005A
                                                        if lane == 1 else 0)
        for ori in range(8):
            got = (_response8x4(words, ori) >> np.uint64(8 * lane)) & \
                np.uint64(0xFF)
            assert np.array_equal(got.astype(np.int64),
                                  _response(v, ori, 8))


def _lm_replay(sp, T, n_ori):
    """lm_kernel over [B, H, W] planes with the output at a 256-byte
    aligned address: returns the flat output and the stores per byte."""
    RUN, TILE, PAD = C["LM_RUN"], C["LM_TILE"], C["LM_PAD"]
    assert (RUN, TILE) == (pyramid.LM_RUN, pyramid.LM_TILE)
    assert C["LM_THREADS"] == 256 and C["T_MAX"] == 16
    XC = lm_split(T)
    assert XC % RUN == 0 and T * T * XC <= TILE
    B, H, W = sp.shape
    Wd, Hd = W // T, H // T
    M = Hd * Wd
    TTM = T * T * M
    stride = n_ori * TTM + M
    out = np.full(B * stride, GARBAGE, np.int64)
    stores = np.zeros(B * stride, np.int64)
    ld = XC + PAD
    for z in range(B):
        for yd in range(Hd):
            for bx in range(-(-Wd // XC)):
                xd0 = bx * XC
                xc = min(XC, Wd - xd0)
                cols = xc * T
                tile = np.full(TILE + 16 * 16 * PAD, GARBAGE, np.int64)
                i = np.arange(T * cols)
                ty, x = i // cols, i % cols
                xd, tx = x // T, x % T
                idx = (ty * T + tx) * ld + xd
                assert idx.max() < tile.size and len(set(idx)) == idx.size
                tile[idx] = sp[z, yd * T + ty, xd0 * T + x]
                base = z * stride + yd * Wd + xd0
                tail = base + n_ori * TTM + np.arange(xc)
                out[tail] = 0
                stores[tail] += 1
                groups = -(-xc // RUN)
                for it in range(T * T * groups):
                    r, g = divmod(it, groups)
                    n = min(RUN, xc - g * RUN)
                    run = tile[r * ld + g * RUN:r * ld + g * RUN + RUN]
                    d = base + r * M + g * RUN
                    fast = n == RUN and ((d | TTM) & 15) == 0
                    for ori in range(n_ori):
                        if fast and n_ori == 8:
                            words = run.reshape(4, 4) << (8 * np.arange(4))
                            vals = _response8x4(words.sum(1), ori)
                            vals = ((vals[:, None] >> np.uint64(8) *
                                     np.arange(4, dtype=np.uint64))
                                    & np.uint64(0xFF)).ravel()
                        else:
                            vals = _response(run, ori, n_ori)
                        at = d + ori * TTM + np.arange(n)
                        out[at] = vals[:n]
                        stores[at] += 1
    return out.reshape(B, stride), stores


@pytest.mark.parametrize("T,H,W", [(1, 3, 4100), (2, 4, 70), (3, 6, 1350),
                                   (4, 8, 1040), (4, 12, 64), (8, 16, 136),
                                   (16, 32, 48), (5, 10, 85)])
@pytest.mark.parametrize("n_ori,dtype", [(8, np.uint8), (16, np.uint16)])
def test_lm_kernel_replay_equals_twin(T, H, W, n_ori, dtype):
    """Rows of more than one block (W/T past lm_split(T)), runs cut by the
    row's end, aligned and misaligned rows, 8 and 16 orientations; every
    byte, the tail's included, stored once."""
    rng = np.random.RandomState(T * 1000 + W + n_ori)
    sp = rng.randint(0, 256 if dtype == np.uint8 else 1 << 16,
                     (2, H, W)).astype(dtype)
    out, stores = _lm_replay(sp, T, n_ori)
    assert (stores == 1).all()
    tsp = (torch.from_numpy(sp.view(np.int16)).view(torch.uint16)
           if dtype == np.uint16 else torch.from_numpy(sp))
    assert np.array_equal(out, linear_memories_plain(tsp, T, n_ori).numpy())


def test_lm_split():
    for T in range(1, 17):
        XC = lm_split(T)
        assert XC % 16 == 0 and T * T * XC <= 4096
        assert T * T * (XC + 16) > 4096 or XC == 16  # the most that fit
    assert (lm_split(4), lm_split(8)) == (256, 64)  # one block a cell row
