"""The PyTorch port's frontend against the JAX package, bit for bit.

Covers ops/fastmath, ops/filters, ops/gradients and ops/response of
shape_based_matching_tpu_torch, and the plain twin of the CUDA frontend
kernel (ops/cuda/frontend.quant_spread on CPU tensors) against the JAX
Pallas frontend kernel run in interpret mode, in every mode: gray or
color, 8 or 16 orientations, masked, with the quantized plane. The
16-orientation pieces are also held to the compiled C++ experiment's
goldens (tests/goldens/kern16_*). Inputs are numpy arrays from fixed
seeds, handed to both packages; tolerance is exact equality. The CUDA
kernel's tile cover (ops/cuda/frontend.frontend_split and the source's
constants) is replayed here: every output pixel written once, every read
inside the frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_matching_tpu.ops import fastmath as jfm
from shape_based_matching_tpu.ops import filters as jfl
from shape_based_matching_tpu.ops import gradients as jgr
from shape_based_matching_tpu.ops import response as jrs
from shape_based_matching_tpu.ops.pallas.frontend_pallas import (
    quant_spread_pallas)
from shape_based_matching_tpu_torch.ops import fastmath, filters, gradients
from shape_based_matching_tpu_torch.ops import response
from shape_based_matching_tpu_torch.ops.cuda import frontend as tfront
from shape_based_matching_tpu_torch.ops.cuda.frontend import (
    quant_spread, quant_spread_plain)
from tests.torch_csrc import constants
from .golden_utils import load_mat


def _frames(seed, h, w, n=1):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w),
                                               dtype=np.uint8)


def _scene(seed, h, w):
    """Noise plus a bright disc: strong edges in every orientation."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w) * 40).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    img[(yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 3) ** 2] = 200
    return img


def test_phase_deg_every_integer_gradient():
    """Every integer (dx, dy) in [-1020, 1020]^2, the full range of 3x3
    Sobel on uint8: the float32 angle equals JAX's op-by-op phase_deg bit
    for bit, and its bin round(angle * 16/360) & 7 equals the bin of the
    jitted JAX function (whose fused XLA:CPU loop may contract FMAs and
    move the raw angle by an ulp, never across a bin)."""
    r = np.arange(-1020, 1021, dtype=np.float32)
    dx, dy = (a.reshape(-1) for a in np.meshgrid(r, r))
    ang = fastmath.phase_deg(torch.from_numpy(dx),
                             torch.from_numpy(dy)).numpy()
    np.testing.assert_array_equal(
        ang, np.asarray(jfm.phase_deg(jnp.asarray(dx), jnp.asarray(dy))))
    scale = np.float32(16.0 / 360.0)
    jitted = np.asarray(jax.jit(jfm.phase_deg)(jnp.asarray(dx),
                                               jnp.asarray(dy)))
    np.testing.assert_array_equal(
        np.round(ang * scale).astype(np.int32) & 7,
        np.round(jitted * scale).astype(np.int32) & 7)


@pytest.mark.parametrize("h,w", [(64, 128), (37, 53), (72, 201)])
def test_filters_equal_jax(h, w):
    img = _frames(h * w, h, w)[0]
    t = torch.from_numpy(img)
    blur = filters.gaussian_blur7_u8(t)
    np.testing.assert_array_equal(
        blur.numpy(), np.asarray(jfl.gaussian_blur7_u8(jnp.asarray(img))))
    for dx in (True, False):
        np.testing.assert_array_equal(
            filters.sobel3_i32(blur, dx).numpy(),
            np.asarray(jfl.sobel3_i32(jnp.asarray(blur.numpy()), dx)))
    np.testing.assert_array_equal(
        filters.pyr_down_u8_plain(t).numpy(),
        np.asarray(jfl.pyr_down_u8(jnp.asarray(img))))


def test_filters_batched_equal_per_frame():
    imgs = torch.from_numpy(_frames(3, 40, 56, n=3))
    for fn in (filters.gaussian_blur7_u8, filters.pyr_down_u8_plain):
        got = fn(imgs)
        for b in range(3):
            assert torch.equal(got[b], fn(imgs[b]))


def test_quantized_orientations_gray_equal_jax():
    """Squared magnitude and quantized orientation equal the jitted JAX
    function; the raw angle equals JAX's op-by-op phase_deg."""
    img = _scene(11, 64, 96)
    want = jgr.quantized_orientations_gray(jnp.asarray(img), 30.0)
    got = gradients.quantized_orientations_gray(torch.from_numpy(img), 30.0)
    np.testing.assert_array_equal(got.magnitude.numpy(),
                                  np.asarray(want.magnitude))
    np.testing.assert_array_equal(got.angle.numpy(), np.asarray(want.angle))
    blur = jfl.gaussian_blur7_u8(jnp.asarray(img))
    np.testing.assert_array_equal(
        got.angle_ori.numpy(),
        np.asarray(jfm.phase_deg(jfl.sobel3_f32(blur, True),
                                 jfl.sobel3_f32(blur, False))))


@pytest.mark.parametrize("h,w", [(64, 128), (72, 200)])
@pytest.mark.parametrize("T", [4, 8])
def test_frontend_plain_equals_pallas_interpret(h, w, T):
    img = _scene(h + T, h, w)
    want = quant_spread_pallas(jnp.asarray(img), jnp.float32(30.0) ** 2, T,
                               interpret=True)
    frames = torch.from_numpy(img[None])
    got = quant_spread(frames, 30.0, T)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert torch.equal(got, quant_spread_plain(frames, 30.0, T))


@pytest.mark.parametrize("T", [4, 8])
def test_build_lm_from_spread_equals_jax(T):
    sp = np.random.RandomState(T).randint(0, 256, (48, 64), dtype=np.uint8)
    want = jrs.build_lm_from_spread(jnp.asarray(sp), T)
    got = response.build_lm_from_spread(torch.from_numpy(sp), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = (1 << np.random.RandomState(T + 1).randint(0, 8, (48, 64))
         ).astype(np.uint8) * (np.random.RandomState(T + 2)
                               .rand(48, 64) > 0.7)
    np.testing.assert_array_equal(
        response.spread(torch.from_numpy(q), T).numpy(),
        np.asarray(jrs.spread(jnp.asarray(q), T)))


def _bgr(img):
    """A BGR frame from a gray one: channels 0 and 2 tie in |grad|^2 at
    every pixel (so the first-max rule decides), channel 1 is shifted."""
    return np.stack([img, np.roll(img, 1, axis=1), 255 - img], axis=-1)


def _planar(img):
    t = torch.from_numpy(np.array(img[None]))
    return t.permute(0, 3, 1, 2).contiguous() if img.ndim == 3 else t


# mode: (color, n_ori, masked, with_quant)
_MODES = {
    "color8": (True, 8, False, False),
    "gray16": (False, 16, False, False),
    "color16": (True, 16, False, False),
    "masked_gray8": (False, 8, True, False),
    "masked_color16": (True, 16, True, False),
    "with_quant": (False, 8, False, True),
}


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("T", [4, 8])
def test_frontend_modes_plain_equal_pallas_interpret(mode, T):
    """Every mode of the frontend's plain twin against the JAX Pallas
    kernel in interpret mode, bit for bit: spread plane (uint16 for 16
    orientations) and, with_quant, the quantized plane."""
    color, n_ori, masked, with_quant = _MODES[mode]
    gray = _scene(T + 17, 48, 80)
    img = _bgr(gray) if color else gray
    mask = ((np.random.RandomState(T).rand(48, 80) > 0.25) * 255
            ).astype(np.uint8) if masked else None
    want = quant_spread_pallas(
        jnp.asarray(img), jnp.float32(30.0) ** 2, T, with_quant=with_quant,
        interpret=True, n_ori=n_ori,
        mask=None if mask is None else jnp.asarray(mask))
    got = quant_spread(_planar(img), 30.0, T, n_ori,
                       None if mask is None else torch.from_numpy(mask[None]),
                       with_quant)
    want = want if with_quant else (want,)
    got = got if with_quant else (got,)
    for g, w in zip(got, want):
        assert g.dtype == (torch.uint8 if n_ori == 8 else torch.uint16)
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert int((got[0].to(torch.int32) > 0).sum()) > 100


def test_quantized16_color_equals_compiled_golden():
    """The 16-orientation color quantization of the compiled experiment's
    BGR crop (tests/goldens/kern16_*, tests/test_golden_16ori.py)."""
    img = load_mat("kern16_img.bin")
    got = gradients.quantized_orientations_color(_planar(img)[0], 30.0, 16)
    np.testing.assert_array_equal(
        got.angle.numpy(), load_mat("kern16_quantized.bin", dtype=np.uint16))
    want = jgr.quantized_orientations(img, 30.0, n_ori=16)
    np.testing.assert_array_equal(got.magnitude.numpy(),
                                  np.asarray(want.magnitude))


def test_response_maps16_equal_jax():
    """The compiled 16-orientation LUT, dead bits 12..15 included, on every
    12-bit value and random 16-bit ones."""
    rng = np.random.RandomState(0)
    s = np.concatenate([np.arange(4096), rng.randint(0, 1 << 16, 4096)]
                       ).astype(np.uint16).reshape(128, 64)
    np.testing.assert_array_equal(
        response.response_maps(torch.from_numpy(s), 16).numpy(),
        np.asarray(jrs.response_maps(jnp.asarray(s), 16)))


@pytest.mark.parametrize("T", [4, 8])
def test_spread_response_lm16_equal_compiled_golden(T):
    quant = torch.from_numpy(np.array(load_mat("kern16_quantized.bin",
                                               dtype=np.uint16)))
    sp = response.spread(quant, T)
    np.testing.assert_array_equal(
        sp.numpy(), load_mat(f"kern16_spread_T{T}.bin", dtype=np.uint16))
    np.testing.assert_array_equal(
        response.response_maps(sp, 16).numpy().reshape(-1, 128),
        load_mat(f"kern16_resp_T{T}.bin"))
    lm = response.build_lm_from_spread(sp, T, 16)
    np.testing.assert_array_equal(lm.numpy().reshape(-1, lm.shape[-1]),
                                  load_mat(f"kern16_lm_T{T}.bin"))


def test_resize_nearest_equals_jax_in_float32():
    """Ratios that are not powers of two; at 26 -> 22 (so 52 -> 44) the
    index floor(i * h/oh) taken in float32, as JAX takes it, differs from
    float64's, and the port follows float32."""
    img = _frames(5, 52, 78)[0]
    i = np.arange(44)
    f32 = np.floor(i.astype(np.float32) * np.float32(52 / 44)).astype(int)
    assert (f32 != np.floor(i * (52 / 44)).astype(int)).any()
    for out_hw in ((44, 66), (30, 50)):
        np.testing.assert_array_equal(
            filters.resize_nearest(torch.from_numpy(img), out_hw).numpy(),
            np.asarray(jfl.resize_nearest(jnp.asarray(img), out_hw)))


def test_pyr_down_planar_color_equals_jax():
    img = np.random.RandomState(6).randint(0, 256, (40, 54, 3),
                                           dtype=np.uint8)
    got = filters.pyr_down_u8_plain(_planar(img)[0]).permute(1, 2, 0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfl.pyr_down_u8(jnp.asarray(img))))


_SIDES = (1, 3, 31, 33, 65, 127, 129)


def _cover(B, H, W, T):
    """frontend.cu's grid and loops for one launch: per output pixel the
    number of stores, and every image/mask index the kernel reads."""
    c = constants("frontend.cu")
    assert c["WIN"] == c["LANES"] * c["CPT"] == 128
    assert c["VALID_RIGHT"] == tfront.VALID_RIGHT and c["T_MAX"] == 16
    RS = tfront.frontend_split(B, H, W, T)
    tw = tfront.out_cols(T)
    # window columns: the blur holds from 3, Sobel from 4, the vote from 5
    # up to 122 (WIN - 6), and the last output column's spread reads the
    # vote T - 1 columns to its right
    assert c["LEFT"] >= 5
    assert (c["LEFT"] + tw - 1) + (T - 1) <= c["WIN"] - 6
    assert tw % c["CPT"] == 0 and c["LEFT"] % c["CPT"] == 0
    writes = np.zeros((B, H, W), np.int64)
    lanes = np.arange(c["LANES"])
    for b in range(B):
        for bx in range(-(-W // tw)):
            cw = bx * tw - c["LEFT"]
            x0 = cw + lanes * c["CPT"]
            xs = x0[:, None] + np.arange(c["CPT"])[None]
            full = (x0 >= 0) & (x0 + c["CPT"] <= W)
            cols = np.where(full[:, None], xs, np.clip(xs, 0, W - 1))
            assert cols.min() >= 0 and cols.max() < W  # reads stay in rows
            if cw < 0:  # column 0 lives in the lane the edge fix reads
                assert xs[(-cw) >> 2, (-cw) & 3] == 0
            if cw + c["WIN"] > W:
                assert xs[(W - 1 - cw) >> 2, (W - 1 - cw) & 3] == W - 1
            out = ((lanes >= c["LEFT"] // c["CPT"])
                   & (lanes < (c["LEFT"] + tw) // c["CPT"]) & (x0 < W))
            for by in range(-(-H // RS)):
                y0 = by * RS
                o_end = min(y0 + RS, H)
                rows = np.clip(np.arange(y0 - 5, o_end + T + 5), 0, H - 1)
                assert rows.min() >= 0 and rows.max() < H
                for x in xs[out].ravel():
                    if x < W:
                        writes[b, y0:o_end, x] += 1
    return writes, RS


@pytest.mark.parametrize("T", range(1, 17))
def test_frontend_tile_cover(T):
    """Every output pixel is stored exactly once, and every image and mask
    read (image rows y0 - 5 .. o_end + T + 4, clamped; word loads only
    where all 4 columns lie in the row) stays inside the frame, at widths
    and heights of 1 .. 129 and at B = 8."""
    for H in _SIDES:
        for W in _SIDES:
            writes, _ = _cover(1, H, W, T)
            assert (writes == 1).all(), (H, W)
    writes, _ = _cover(8, 65, 129, T)
    assert (writes == 1).all()


@pytest.mark.parametrize("B,side,T", [(1, 512, 8), (1, 1024, 4),
                                      (8, 512, 8), (8, 1024, 4)])
def test_frontend_split_fills_the_card(B, side, T):
    """The flagship's levels: at least 2 one-warp blocks an SM at 512^2 and
    B=1, the longest strip that reaches FULL_WARPS otherwise."""
    RS = tfront.frontend_split(B, side, side, T)
    blocks = B * -(-side // tfront.out_cols(T)) * -(-side // RS)
    assert blocks >= 2 * tfront.SM_COUNT
    assert RS in tfront.ROW_STRIPS
    if RS != tfront.ROW_STRIPS[-1]:
        assert blocks >= tfront.FULL_WARPS
    if RS != tfront.ROW_STRIPS[0]:
        longer = tfront.ROW_STRIPS[tfront.ROW_STRIPS.index(RS) - 1]
        assert B * -(-side // tfront.out_cols(T)) * -(-side // longer) \
            < tfront.FULL_WARPS
