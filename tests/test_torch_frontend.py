"""The PyTorch port's frontend against the JAX package, bit for bit.

Covers ops/fastmath, ops/filters, ops/gradients and ops/response of
shape_based_matching_tpu_torch, and the plain twin of the CUDA frontend
kernel (ops/cuda/frontend.quant_spread on CPU tensors) against the JAX
Pallas frontend kernel run in interpret mode. Inputs are numpy arrays
from fixed seeds, handed to both packages; tolerance is exact equality.
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
from shape_based_matching_tpu_torch.ops.cuda.frontend import (
    quant_spread, quant_spread_plain)


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
        filters.pyr_down_u8(t).numpy(),
        np.asarray(jfl.pyr_down_u8(jnp.asarray(img))))


def test_filters_batched_equal_per_frame():
    imgs = torch.from_numpy(_frames(3, 40, 56, n=3))
    for fn in (filters.gaussian_blur7_u8, filters.pyr_down_u8):
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
