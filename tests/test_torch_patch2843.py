"""patch_2843 in the PyTorch port (opencv_contrib #2843: an interior pixel
at or under the weak threshold casts no orientation vote) against the
JAX package's XLA chain, on the CPU: the quantized and spread planes in
all eight frontend modes, training, and the flagship match list.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_matching_tpu import Detector as JDetector
from shape_based_matching_tpu.ops import gradients as jgr
from shape_based_matching_tpu.ops import response as jrs
from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.ops import gradients
from shape_based_matching_tpu_torch.ops.cuda.frontend import (
    quant_spread, quant_spread_plain)
from shape_based_matching_tpu_torch.ops.response import to_i32
from shape_based_matching_tpu_torch.utils import synthetic as tsyn

from .test_torch_training import _fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy(seed, h=72, w=88):
    """A star scene with noise: many weak pixels beside strong ones."""
    f = tsyn.synthetic_scene(h, w, tsyn.synthetic_shape_image(48, seed),
                             n_instances=1, seed=seed).astype(np.int32)
    f += np.random.RandomState(seed).randint(-12, 13, f.shape)
    return np.clip(f, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("color,n_ori", [(False, 8), (False, 16),
                                         (True, 8), (True, 16)],
                         ids=["gray8", "gray16", "color8", "color16"])
def test_patch_planes_equal_jax(color, n_ori, masked):
    """The quantized plane (hysteresis_quantize) and the spread plane of
    quant_spread_plain, patched, equal JAX's quantized_orientations_*
    (patch_2843=True), masked and spread, bit for bit; the patch changes
    the planes of this frame."""
    img = _noisy(3)
    if color:
        img = np.stack([img, np.roll(img, 1, axis=1), 255 - _noisy(4)],
                       axis=-1)
    mask = (np.random.RandomState(5).rand(*img.shape[:2]) > 0.2).astype(
        np.uint8) * 255
    jq = (jgr.quantized_orientations_color if color
          else jgr.quantized_orientations_gray)(
              jnp.asarray(img), jnp.float32(30.0), n_ori, True).angle
    if masked:
        jq = jnp.where(jnp.asarray(mask) > 0, jq, 0)
    T = 4
    jsp = jrs.spread(jq, T)
    frames = torch.from_numpy(img[None])
    if color:
        frames = frames.permute(0, 3, 1, 2).contiguous()
    m = torch.from_numpy(mask[None]) if masked else None
    sp, q = quant_spread(frames, 30.0, T, n_ori, m, with_quant=True,
                         patch_2843=True)
    np.testing.assert_array_equal(to_i32(q[0]).numpy(),
                                  np.asarray(jq).astype(np.int32))
    np.testing.assert_array_equal(to_i32(sp[0]).numpy(),
                                  np.asarray(jsp).astype(np.int32))
    sp0, q0 = quant_spread_plain(frames, 30.0, T, n_ori, m, with_quant=True)
    changed = int((to_i32(q0) != to_i32(q)).sum())
    assert changed > 0 and (to_i32(sp0) != to_i32(sp)).any(), changed


def test_hysteresis_quantize_patch_rules():
    """Hand-made 5x5 votes: a weak interior pixel votes nothing, a
    frame-edge pixel votes bin 0 whatever its magnitude, and the final
    gate (strong, >= 5 votes) is unchanged."""
    ang = torch.full((5, 5), 45.0)          # bin 2 of 8 everywhere
    mag = torch.full((5, 5), 1000.0)
    mag[1, 1] = mag[1, 2] = mag[1, 3] = mag[2, 1] = 100.0  # weak
    thr = 900.0
    plain = gradients.hysteresis_quantize(mag, ang, thr, 8)
    patched = gradients.hysteresis_quantize(mag, ang, thr, 8, True)
    # (2, 2): 9 votes for bin 2, 4 of them from weak pixels
    assert int(plain[2, 2]) == 4 and int(patched[2, 2]) == 4
    # (2, 3): of its 9 votes 2 are weak and 3 frame-edge (bin 0): 4 left
    assert int(plain[2, 3]) == 4 and int(patched[2, 3]) == 0
    jq = jgr.hysteresis_quantize(jnp.asarray(mag.numpy()),
                                 jnp.asarray(ang.numpy()), jnp.float32(thr),
                                 8, True)
    np.testing.assert_array_equal(patched.numpy(), np.asarray(jq))


@pytest.mark.parametrize("kind", ["gray_masked", "bgr", "gray16"])
def test_add_template_patch_equals_jax(kind):
    """Detector(patch_2843=True).add_template in the port and in JAX on a
    star frame (tests/test_torch_training.py's): every field, theta's
    float32 bits included."""
    n_ori = 16 if kind == "gray16" else 8
    img = tsyn.synthetic_shape_image(96, 2)
    mask = None
    if kind == "bgr":
        img = np.stack([img, np.roll(img, 1, axis=1), 255 - img], axis=-1)
    if kind == "gray_masked":
        mask = (np.random.RandomState(0).rand(96, 96) > 0.1).astype(
            np.uint8) * 255
    det = Detector(num_features=32, num_orientations=n_ori, patch_2843=True,
                   device="cpu")
    jdet = JDetector(num_features=32, num_orientations=n_ori,
                     patch_2843=True)
    assert det.add_template(img, "c", mask) == 0
    assert jdet.add_template(img, "c", mask) == 0
    assert _fields(det.class_templates["c"]) == \
        _fields(jdet.class_templates["c"])


def _uniform(seed):
    return np.random.RandomState(seed).randint(0, 256, (96, 96)).astype(
        np.uint8)


@pytest.mark.parametrize("kind", ["gray_masked", "bgr"])
def test_patch_changes_training_as_in_jax(kind):
    """On uniform noise the patch changes what is trained, in the port as
    in JAX: every field equal but theta, which is within one float32 ulp
    (in both modes a few features differ by one: JAX's jitted fastAtan2
    contracts its polynomial and differs from the op-by-op reference by
    an ulp on about 2% of gradients; ROADMAP C)."""
    if kind == "bgr":
        img, mask = np.stack([_uniform(0), _uniform(1), _uniform(2)],
                             axis=-1), None
    else:
        img = _uniform(0)
        mask = (np.random.RandomState(0).rand(96, 96) > 0.02).astype(
            np.uint8) * 255
    out = {}
    for patch in (True, False):
        det = Detector(num_features=64, patch_2843=patch, device="cpu")
        jdet = JDetector(num_features=64, patch_2843=patch)
        assert det.add_template(img, "c", mask) == 0
        assert jdet.add_template(img, "c", mask) == 0
        got = det.class_templates["c"]
        want = jdet.class_templates["c"]
        assert _fields(got, theta=False) == _fields(want, theta=False)
        bits = [np.float32([f.theta for tp in pyr for t in tp
                            for f in t.features]).view(np.int32).astype(
                                np.int64) for pyr in (got, want)]
        assert np.abs(bits[0] - bits[1]).max() <= 1
        out[patch] = _fields(got, theta=False)
    assert out[True] != out[False]


def test_patch_flagship_golden():
    """Detector(patch_2843=True) on the flagship frame (1000 templates,
    1024^2) equals the JAX golden, which differs from the default mode's
    e2e1000 list."""
    golden = json.load(open(os.path.join(
        ROOT, "tests", "goldens",
        "torch_port_e2e1000_patch2843_matches.json")))
    cfg = golden["config"]
    assert cfg["patch_2843"]
    det = Detector(num_features=cfg["num_features"], T=tuple(cfg["T"]),
                   patch_2843=True, device="cpu")
    det.class_templates[golden["class_id"]] = tsyn.load_bank_cache(
        os.path.join(ROOT, cfg["bank"]))
    frame, _ = tsyn.config_frame(cfg)
    got = [[m.template_id, m.x, m.y,
            int(np.float32(m.similarity).view(np.uint32))]
           for m in det.match(frame, cfg["threshold"])]
    assert got == golden["matches"]
    default = json.load(open(os.path.join(
        ROOT, "tests", "goldens", "torch_port_e2e1000_matches.json")))
    assert got != default["matches"]
