"""The port's copy of the scalar oracle, and the port held to it on the CPU.

1. The copy (``shape_based_matching_tpu_torch/oracle/reference.py``)
   against the JAX package's oracle, function by function, on seeded
   inputs (gray and BGR, 8 and 16 orientations, masks, non-square frames):
   equal arrays of equal dtype, equal lists and dicts.
2. The copy on the compiled reference's ``kern_*`` and ``kern16_*``
   goldens, with the assertions of ``tests/test_golden_kernels.py`` and
   ``tests/test_golden_16ori.py``.
3. The port's ops against the copy, where every kernel wrapper runs its
   plain twin (CPU tensors), with the comparisons and tolerances of the
   JAX tests that hold the JAX ops to the same oracle function
   (``test_filters.py``, ``test_gradients.py``, ``test_16ori.py``,
   ``test_response.py``, ``test_golden_kernels.py``): filters,
   fastAtan2, quantization, spread, responses, linear memories, coarse
   similarity, the refine window, and training (extraction, scattered
   selection, crop).
4. ``coarse_route`` (``ops/similarity.py``, ``Detector``) against the JAX
   package's ``coarse_route(..., use_pallas=True)`` on the committed
   bench banks, each loaded by its own package; the 4096^2 frame where
   JAX returns the TPU-only ``'cells'`` is the documented divergence.
"""

import ast
import copy

import numpy as np
import pytest
import torch

from shape_based_matching_tpu.models.detector import Detector as JDetector
from shape_based_matching_tpu.ops.similarity import coarse_route as jroute
from shape_based_matching_tpu.oracle import reference as joracle
from shape_based_matching_tpu.utils import synthetic as jsyn
from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.models import training
from shape_based_matching_tpu_torch.models.template import (Feature,
                                                            Template,
                                                            crop_templates)
from shape_based_matching_tpu_torch.ops import filters, gradients, response
from shape_based_matching_tpu_torch.ops.cuda.refine import refine_windows
from shape_based_matching_tpu_torch.ops.fastmath import phase_deg
from shape_based_matching_tpu_torch.ops.similarity import (
    coarse_route, coarse_similarity, pack_level_bank)
from shape_based_matching_tpu_torch.ops.window import window_origin
from shape_based_matching_tpu_torch.oracle import reference as oracle
from shape_based_matching_tpu_torch.utils import synthetic as tsyn

from .golden_utils import load_json, load_mat


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b, where="out"):
    """Equal values of equal types: arrays of equal dtype and shape,
    lists, tuples and dicts (keys in order) element by element."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b, (where, a, b)


# ---------------------------------------------------------------------------
# Shared seeded inputs
# ---------------------------------------------------------------------------

def _scene(h, w, seed, color=False):
    f = tsyn.synthetic_scene(h, w, tsyn.synthetic_shape_image(min(h, w) // 2,
                                                              seed), 2,
                             seed=seed)
    return np.stack([f, np.roll(f, 1, axis=1), 255 - f], axis=-1) \
        if color else f


def _mask(h, w, seed):
    rng = np.random.RandomState(seed)
    return ((rng.rand(h, w) > 0.25) * 255).astype(np.uint8)


def _object_mask(size):
    """A training mask that keeps the object and cuts one corner band."""
    m = np.full((size, size), 255, np.uint8)
    m[: size // 4, : size // 2] = 0
    return m


def _feats(rng, n, tw, th, n_ori):
    """Random features in a tw x th template box, with one at (tw, th):
    the reference's flat over-read at the template's edge."""
    f = [(int(rng.randint(0, tw)), int(rng.randint(0, th)),
          int(rng.randint(0, n_ori))) for _ in range(n - 1)]
    return f + [(tw, th, int(rng.randint(0, n_ori)))]


def _candidates(rng, n):
    """Score-sorted candidate dicts as extract_template hands them to the
    scattered selection (ties kept in scan order)."""
    c = [dict(x=int(rng.randint(0, 80)), y=int(rng.randint(0, 60)),
              label=int(rng.randint(0, 8)),
              score=float(rng.randint(1, 40)) * 100.0,
              theta=float(np.float32(rng.rand() * 360)))
         for _ in range(n)]
    c.sort(key=lambda d: -d["score"])
    return c


def _train_image(size, seed, color=False):
    img = tsyn.synthetic_shape_image(size, seed)
    return np.stack([img, np.roll(img, 2, axis=0), 255 - img], axis=-1) \
        if color else img


def _oracle_pyramid(o, img, mask, nfeat, levels, n_ori=8, strong=60.0):
    """A template pyramid by the oracle's own functions, as addTemplate
    builds one (line2Dup.cpp:1299-1353): per level quantize, extract with
    nfeat >> l features from the eroded mask, pyrDown and the nearest
    mask resize; then the crop. None where extraction aborts."""
    tps = []
    for l in range(levels):
        if l > 0:
            img = o.pyr_down_u8(img)
            if mask is not None:
                mask = o.resize_nearest(mask, img.shape[:2])
        mag, quant, ang = o.quantized_orientations(img, 30.0, n_ori)
        feats = o.extract_template(mag, quant, ang, mask, nfeat >> l, strong)
        if feats is None:
            return None
        tps.append({"features": feats, "pyramid_level": l})
    return o.crop_templates(tps)


@pytest.fixture(scope="module")
def pipeline():
    """A gray and a BGR scene (non-square), a mask, and each side's
    linear-memory pyramids: gray 8 orientations at T=(2, 4, 8) under the
    mask, BGR 16 orientations at T=(4, 8)."""
    gray, bgr = _scene(96, 128, 3), _scene(96, 128, 4, color=True)
    mask = _mask(96, 128, 5)
    out = {"gray": gray, "bgr": bgr, "mask": mask}
    for name, o in (("jax", joracle), ("port", oracle)):
        out[name] = {
            "gray": o.build_lm_pyramid(gray, 30.0, (2, 4, 8), 8, mask),
            "bgr16": o.build_lm_pyramid(bgr, 30.0, (4, 8), 16),
        }
    return out


@pytest.fixture(scope="module")
def oracle_templates():
    """Each side's template pyramids from its own oracle: three trainings
    (gray under a mask, BGR, gray with 16 orientations), two levels."""
    out = {}
    for name, o in (("jax", joracle), ("port", oracle)):
        out[name] = [
            _oracle_pyramid(o, _train_image(64, 1), _object_mask(64), 31,
                            2),
            _oracle_pyramid(o, _train_image(64, 3, color=True),
                            np.full((64, 64), 255, np.uint8), 31, 2),
            _oracle_pyramid(o, _train_image(64, 5), None, 31, 2, n_ori=16),
        ]
    return out


# ---------------------------------------------------------------------------
# 1. The copy against the JAX package's oracle
# ---------------------------------------------------------------------------

def test_copy_imports_only_math_and_numpy():
    with open(oracle.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert names == {"__future__", "math", "numpy"}


def _cases(rng):
    """name -> (args, kwargs) of each oracle function, seeded."""
    gray = rng.randint(0, 256, (57, 83), dtype=np.uint8)
    bgr = rng.randint(0, 256, (57, 83, 3), dtype=np.uint8)
    m = (rng.randint(0, 2, (33, 47)) * 255).astype(np.uint8)
    mag = rng.rand(40, 52).astype(np.float32) * 5000.0
    ang = rng.rand(40, 52).astype(np.float32) * 360.0
    q8 = rng.randint(0, 256, (32, 48), dtype=np.uint8)
    q16 = rng.randint(0, 1 << 16, (24, 32)).astype(np.uint16)
    resp = rng.randint(0, 5, (8, 32, 48), dtype=np.uint8)
    lm = rng.choice(np.array([0, 0, 3, 4], np.uint8), (8, 16, 12 * 8))
    lm16 = rng.choice(np.array([0, 1, 4], np.uint8), (16, 64, 12 * 8))
    dx = (rng.randn(2000) * 300).astype(np.float32)
    dy = (rng.randn(2000) * 300).astype(np.float32)
    return {
        "gaussian_blur7_u8": [((gray,), {}), ((bgr,), {})],
        "sobel3": [((gray, True), {}), ((gray, False), {}),
                   ((bgr, True), {}), ((bgr, False), {})],
        "pyr_down_u8": [((gray,), {}), ((bgr,), {})],
        "resize_nearest": [((m, hw), {})
                           for hw in ((16, 23), (8, 11), (33, 47))],
        "erode3_u8": [((m,), {})],
        "fast_atan2_deg": [((dy, dx), {}),
                           ((np.round(dy), np.round(dx)), {})],
        "hysteresis_quantize": [((mag, ang, 900.0), {}),
                                ((mag, ang, 900.0), {"n_ori": 16})],
        "quantized_orientations": [((gray, 30.0), {}), ((bgr, 30.0), {}),
                                   ((bgr, 30.0, 16), {})],
        "spread": [((q8, T), {}) for T in (2, 4, 8)] + [((q16, 8), {})],
        "response_maps": [((q8,), {}), ((q16, 16), {})],
        "linearize": [((resp, T), {}) for T in (2, 4, 8)],
        # lm [8, T*T, M] with T=4, a 48 x 32 frame (W=12, H=8 cells)
        "similarity": [((lm, _feats(rng, 20, 13, 9, 8), (13, 9), (48, 32),
                         4), {}),
                       ((lm16[:, :16], _feats(rng, 20, 16, 12, 16),
                         (16, 12), (48, 32), 4), {})],
        "similarity_local": [((lm, _feats(rng, 20, 13, 9, 8), (48, 32), 4,
                               c), {}) for c in ((20, 17), (5, 40), (47, 0))],
        "select_scattered_features": [((_candidates(rng, 60), 16, 4.0),
                                       {}),
                                      ((_candidates(rng, 30), 40, 1.0),
                                       {})],
        "crop_templates": [(([{"pyramid_level": l, "features": [
            {"x": int(rng.randint(-9, 30)), "y": int(rng.randint(-9, 30)),
             "label": 0} for _ in range(12)]} for l in (0, 1)],), {})],
    }


@pytest.mark.parametrize("name", [
    "gaussian_blur7_u8", "sobel3", "pyr_down_u8", "resize_nearest",
    "erode3_u8", "fast_atan2_deg", "hysteresis_quantize",
    "quantized_orientations", "spread", "response_maps", "linearize",
    "similarity", "similarity_local", "select_scattered_features",
    "crop_templates"])
def test_copy_equals_jax_oracle(name):
    """Each function of the copy returns what the JAX package's oracle
    returns, on the same seeded inputs (deep-copied: the crop mutates)."""
    for args, kwargs in _cases(np.random.RandomState(11))[name]:
        want = getattr(joracle, name)(*copy.deepcopy(args), **kwargs)
        got = getattr(oracle, name)(*copy.deepcopy(args), **kwargs)
        _same(got, want, name)


def test_copy_equals_jax_oracle_pipeline(pipeline, oracle_templates):
    """build_lm_pyramid (a mask, three levels from T=2; BGR with 16
    orientations), extract_template (under a mask, BGR, 16 orientations;
    through the crop), and match_class of the two 8-orientation
    trainings on the gray scene's two finest levels."""
    _same(pipeline["port"], pipeline["jax"], "build_lm_pyramid")
    _same(oracle_templates["port"], oracle_templates["jax"],
          "extract_template + crop_templates")
    assert all(tp is not None for tp in oracle_templates["port"])
    tps = [[{"features": [(f["x"], f["y"], f["label"])
                          for f in t["features"]],
             "width": t["width"], "height": t["height"]} for t in tp]
           for tp in oracle_templates["port"][:2]]
    lms, sizes = pipeline["port"]["gray"]
    for thr in (40.0, 70.0):
        got = oracle.match_class(lms[:2], sizes[:2], (2, 4), tps, thr, "c")
        want = joracle.match_class(lms[:2], sizes[:2], (2, 4), tps, thr, "c")
        _same(got, want, f"match_class thr={thr}")
        assert thr > 40.0 or got


# ---------------------------------------------------------------------------
# 2. The copy on the compiled reference's goldens
# ---------------------------------------------------------------------------

def test_copy_quantized_golden():
    _, quant, _ = oracle.quantized_orientations(load_mat("kern_img.bin"),
                                                30.0)
    np.testing.assert_array_equal(quant, load_mat("kern_quantized.bin"))
    np.testing.assert_array_equal(quant, load_mat("kern_angle.bin"))
    _, quant16, _ = oracle.quantized_orientations(load_mat("kern16_img.bin"),
                                                  30.0, 16)
    np.testing.assert_array_equal(
        quant16, load_mat("kern16_quantized.bin", dtype=np.uint16))


@pytest.mark.parametrize("T", [4, 8])
def test_copy_spread_response_linearize_golden(T):
    sp = oracle.spread(load_mat("kern_quantized.bin"), T)
    np.testing.assert_array_equal(sp, load_mat(f"kern_spread_T{T}.bin"))
    resp = oracle.response_maps(sp)
    for o in range(8):
        np.testing.assert_array_equal(resp[o],
                                      load_mat(f"kern_resp_T{T}_o{o}.bin"))
    lm = oracle.linearize(resp, T)
    for o in range(8):
        np.testing.assert_array_equal(lm[o],
                                      load_mat(f"kern_lm_T{T}_o{o}.bin"))
    sp16 = oracle.spread(load_mat("kern16_quantized.bin", dtype=np.uint16),
                         T)
    np.testing.assert_array_equal(
        sp16, load_mat(f"kern16_spread_T{T}.bin", dtype=np.uint16))
    resp16 = oracle.response_maps(sp16, 16)
    np.testing.assert_array_equal(resp16.reshape(-1, 128),
                                  load_mat(f"kern16_resp_T{T}.bin"))
    lm16 = oracle.linearize(resp16, T)
    np.testing.assert_array_equal(lm16.reshape(-1, lm16.shape[-1]),
                                  load_mat(f"kern16_lm_T{T}.bin"))


@pytest.mark.parametrize("n_ori", [8, 16])
@pytest.mark.parametrize("T", [4, 8])
def test_copy_similarity_golden(T, n_ori):
    """similarity over every cell and similarity_local around (40, 40)
    against the u16 and u8 goldens (test_golden_kernels.py:50-92,
    test_golden_16ori.py:108-137)."""
    pre = "kern" if n_ori == 8 else "kern16"
    quant = load_mat(f"{pre}_quantized.bin",
                     dtype=np.uint8 if n_ori == 8 else np.uint16)
    lm = oracle.linearize(oracle.response_maps(oracle.spread(quant, T),
                                               n_ori), T)
    feats = [tuple(f) for f in load_json(f"{pre}_templ_T{T}.json")[
        "features"]]
    S = oracle.similarity(lm, feats, (24, 24), (128, 128), T)
    np.testing.assert_array_equal(S.astype(np.int64), load_mat(
        f"{pre}_sim_T{T}.bin", dtype=np.uint16).astype(np.int64))
    np.testing.assert_array_equal(S.astype(np.int64), load_mat(
        f"{pre}_sim64_T{T}.bin").astype(np.int64))
    loc = oracle.similarity_local(lm, feats, (128, 128), T, (40, 40))
    np.testing.assert_array_equal(loc.astype(np.int64), load_mat(
        f"{pre}_simlocal_T{T}.bin", dtype=np.uint16).astype(np.int64))
    np.testing.assert_array_equal(loc.astype(np.int64), load_mat(
        f"{pre}_simlocal64_T{T}.bin").astype(np.int64))


# ---------------------------------------------------------------------------
# 3. The port's ops against the copy (CPU: plain twins)
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planar(img):
    """The port's filters take channels first."""
    return _t(img).permute(2, 0, 1) if img.ndim == 3 else _t(img)


def _hwc(t):
    return (t.permute(1, 2, 0) if t.dim() == 3 else t).numpy()


@pytest.mark.parametrize("color", [False, True])
def test_filters_equal_copy(color):
    """test_filters.py: blur, Sobel, pyrDown bit-exact on gray and BGR
    57 x 83 frames; the nearest resize and the 3 x 3 erosion of a
    33 x 47 mask."""
    rng = np.random.RandomState(42)
    img = rng.randint(0, 256, (57, 83) + ((3,) if color else ()),
                      dtype=np.uint8)
    np.testing.assert_array_equal(
        _hwc(filters.gaussian_blur7_u8(_planar(img))),
        oracle.gaussian_blur7_u8(img))
    for dx in (True, False):
        np.testing.assert_array_equal(
            _hwc(filters.sobel3_i32(_planar(img), dx)).astype(np.int64),
            oracle.sobel3(img, dx))
    np.testing.assert_array_equal(
        _hwc(filters.pyr_down_u8_plain(_planar(img))),
        oracle.pyr_down_u8(img))
    m = (rng.randint(0, 2, (33, 47)) * 255).astype(np.uint8)
    for hw in ((16, 23), (8, 11), (33, 47), (17, 24), (4, 6)):
        np.testing.assert_array_equal(
            filters.resize_nearest(_t(m), hw).numpy(),
            oracle.resize_nearest(m, hw))
    np.testing.assert_array_equal(filters.erode3_u8(_t(m)).numpy(),
                                  oracle.erode3_u8(m))


def _bins(angle, n_ori):
    """The orientation bin an angle quantizes to (float64 rint, as the
    oracle buckets)."""
    return (np.rint(angle.astype(np.float64) * (2.0 * n_ori / 360.0))
            .astype(np.int64) & (n_ori - 1))


def test_fast_atan2_equals_copy_in_bins():
    """phase_deg against fast_atan2_deg: the same bins for 8 and 16
    orientations, within test_gradients.py's 1e-3 degrees, on random and
    on integer gradients (the frontend's inputs, every one of
    [-64, 64]^2). Both take each float32 step op by op, so the angles are
    bitwise equal too (the jitted JAX function is not: ROADMAP C.4)."""
    rng = np.random.RandomState(42)
    ints = np.arange(-64, 65, dtype=np.float32)
    gx, gy = np.meshgrid(ints, ints)
    for dx, dy in (((rng.randn(5000) * 300).astype(np.float32),
                    (rng.randn(5000) * 300).astype(np.float32)),
                   (gx.ravel(), gy.ravel())):
        got = phase_deg(_t(dx), _t(dy)).numpy()
        want = oracle.fast_atan2_deg(dy, dx)
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got - want).max() < 1e-3
        np.testing.assert_array_equal(got, want)
        for n_ori in (8, 16):
            np.testing.assert_array_equal(_bins(got, n_ori),
                                          _bins(want, n_ori))


@pytest.mark.parametrize("n_ori", [8, 16])
def test_hysteresis_quantize_equals_copy(n_ori):
    """test_gradients.py / test_16ori.py: random magnitudes and angles,
    and test_gradients.py's structured halves."""
    rng = np.random.RandomState(42)
    mag = rng.rand(40, 52).astype(np.float32) * 5000.0
    ang = rng.rand(40, 52).astype(np.float32) * 360.0
    half = np.zeros((32, 32), np.float32)
    half[:, 16:] = 91.0
    for m, a in ((mag, ang), (np.full((32, 32), 1e6, np.float32), half)):
        got = gradients.hysteresis_quantize(_t(m), _t(a), 900.0, n_ori)
        want = oracle.hysteresis_quantize(m, a, 900.0, n_ori=n_ori)
        got = response.to_i32(got).numpy().astype(want.dtype)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("color,n_ori", [(False, 8), (True, 8), (False, 16),
                                         (True, 16)])
def test_quantized_orientations_equal_copy(color, n_ori):
    """test_gradients.py: magnitude and code bit-exact, the angle within
    1e-3 degrees, on a random 48 x 64 frame and on a scene."""
    rng = np.random.RandomState(42)
    shape = (48, 64, 3) if color else (48, 64)
    for img in (rng.randint(0, 256, shape, dtype=np.uint8),
                _scene(48, 64, 7, color)):
        got = gradients.quantized_orientations(_t(img), 30.0, n_ori)
        mag, quant, ang = oracle.quantized_orientations(img, 30.0, n_ori)
        np.testing.assert_array_equal(got.magnitude.numpy(), mag)
        np.testing.assert_array_equal(
            response.to_i32(got.angle).numpy().astype(quant.dtype), quant)
        np.testing.assert_allclose(got.angle_ori.numpy(), ang, atol=1e-3)


@pytest.mark.parametrize("T", [2, 4, 8])
def test_spread_response_linearize_equal_copy(T):
    """test_response.py / test_16ori.py: spread of random codes (uint8,
    and uint16 for 16 orientations), the response LUTs, linearize, and
    build_lm_from_spread against linearize(response_maps(spread))."""
    rng = np.random.RandomState(42)
    for q, n_ori in ((rng.randint(0, 256, (32, 48), dtype=np.uint8), 8),
                     (rng.randint(0, 1 << 16, (24, 32)).astype(np.uint16),
                      16)):
        sp = oracle.spread(q, T)
        tq = (_t(q.view(np.int16)).view(torch.uint16) if n_ori == 16
              else _t(q))
        got_sp = response.spread(tq, T)
        np.testing.assert_array_equal(
            response.to_i32(got_sp).numpy().astype(sp.dtype), sp)
        resp = oracle.response_maps(sp, n_ori)
        np.testing.assert_array_equal(
            response.response_maps(got_sp, n_ori).numpy(), resp)
        np.testing.assert_array_equal(
            response.build_lm_from_spread(got_sp, T, n_ori).numpy(),
            oracle.linearize(resp, T))
    resp = rng.randint(0, 5, (8, 32, 48), dtype=np.uint8)
    np.testing.assert_array_equal(response.linearize(_t(resp), T).numpy(),
                                  oracle.linearize(resp, T))


def _lmflat(lm):
    """The oracle's [n_ori, T*T, M] linear memories as the port's flat
    buffer with its M-byte zero tail."""
    M = lm.shape[-1]
    return _t(np.concatenate([lm.reshape(-1), np.zeros(M, np.uint8)]))


def _similarity_cases(pipeline):
    """(lm, size_wh, T, n_ori, templates) over the scene pyramids' levels
    and the kern goldens' frames: random templates with an edge feature
    (fx == width), some wider than the level less 16T, and the
    goldens'."""
    rng = np.random.RandomState(3)
    out = []
    levels = [(pipeline["port"]["gray"], (2, 4, 8), 8),
              (pipeline["port"]["bgr16"], (4, 8), 16)]
    for (lms, sizes), Ts, n_ori in levels:
        for lm, size, T in zip(lms, sizes, Ts):
            boxes = [(n, max(T, int(size[0] * fw)), max(T, int(size[1] * fh)))
                     for n, fw, fh in ((31, 0.4, 0.3), (63, 0.6, 0.7),
                                       (7, 0.15, 0.2), (100, 0.8, 0.5))]
            templates = [{"features": _feats(rng, n, tw, th, n_ori),
                          "width": tw, "height": th} for n, tw, th in boxes]
            out.append((lm, size, T, n_ori, templates))
    for pre, n_ori in (("kern", 8), ("kern16", 16)):
        quant = load_mat(f"{pre}_quantized.bin",
                         dtype=np.uint8 if n_ori == 8 else np.uint16)
        for T in (4, 8):
            lm = oracle.linearize(oracle.response_maps(
                oracle.spread(quant, T), n_ori), T)
            feats = [tuple(f) for f in load_json(f"{pre}_templ_T{T}.json")[
                "features"]]
            out.append((lm, (128, 128), T, n_ori,
                        [{"features": feats, "width": 24, "height": 24}]))
    return out


def test_coarse_similarity_equals_copy(pipeline):
    """test_golden_kernels.py:50-76: the whole-frame similarity of every
    cell (zero past a template's positions), gray and BGR, 8 and 16
    orientations, T in {2, 4, 8}."""
    for lm, size, T, n_ori, templates in _similarity_cases(pipeline):
        S, _ = coarse_similarity(_lmflat(lm), pack_level_bank(templates), T,
                                 size, n_ori=n_ori)
        H, W = size[1] // T, size[0] // T
        for k, t in enumerate(templates):
            want = oracle.similarity(lm, t["features"],
                                     (t["width"], t["height"]), size, T)
            np.testing.assert_array_equal(
                S[k].numpy().reshape(H, W).astype(np.int64),
                want.astype(np.int64), err_msg=f"T={T} k={k} {size}")


def test_refine_window_equals_copy(pipeline):
    """The window step of refine_candidates (window_origin, then
    refine_windows' first max and its raw score) against
    similarity_local's 16 x 16 window at the center match_class takes
    (the doubled coarse position, clamped to the border), for every
    third coarse position of each template at each finer level."""
    for lm, size, T, n_ori, templates in _similarity_cases(pipeline):
        bank = pack_level_bank(templates)
        # candidate positions on the coarser level, border ones included
        xs, ys = np.meshgrid(np.arange(0, size[0] // 2, 3),
                             np.arange(0, size[1] // 2, 3))
        x, y = _t(xs.ravel().astype(np.int32)), _t(ys.ravel().astype(
            np.int32))
        for k, t in enumerate(templates):
            kk = torch.full_like(x, k)
            wx, wy = window_origin(bank.width, bank.height, T, size, kk, x, y)
            best, raw = refine_windows(_lmflat(lm)[None], bank, T, size,
                                       kk[None], wx[None], wy[None],
                                       torch.ones_like(x, dtype=torch.bool)
                                       [None], n_ori)
            border = 8 * T
            max_x = size[0] - t["width"] - border
            max_y = size[1] - t["height"] - border
            for i in range(0, x.numel(), 7):
                cx = min(max(int(x[i]) * 2 + 1, border), max_x)
                cy = min(max(int(y[i]) * 2 + 1, border), max_y)
                win = oracle.similarity_local(lm, t["features"], size, T,
                                              (cx, cy)).astype(np.int64)
                assert (int(wx[i]), int(wy[i])) == (cx // T - 8, cy // T - 8)
                assert int(raw[0, i]) == win.max()
                assert int(best[0, i]) == int(np.argmax(win))


@pytest.mark.parametrize("mode", ["gray_masked", "bgr", "gray16"])
def test_training_equals_copy(mode):
    """add_template against the oracle's pyramid (extract_template per
    level, crop_templates): features (x, y, label, theta within 1e-3
    degrees) and the crop, at 64 and 96 pixels."""
    color, n_ori = mode == "bgr", 16 if mode == "gray16" else 8
    for size, seed, nfeat in ((64, 1, 31), (96, 6, 63)):
        img = _train_image(size, seed, color)
        mask = (_object_mask(size) if mode == "gray_masked"
                else np.full((size, size), 255, np.uint8))
        det = Detector(num_features=nfeat, T=(4, 8), num_orientations=n_ori,
                       device="cpu")
        assert det.add_template(img, "c", mask) == 0
        want = _oracle_pyramid(oracle, img, mask, nfeat, 2, n_ori)
        got = det.get_templates("c", 0)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert (g.width, g.height, g.tl_x, g.tl_y, g.pyramid_level) == (
                w["width"], w["height"], w["tl_x"], w["tl_y"],
                w["pyramid_level"])
            assert [(f.x, f.y, f.label) for f in g.features] == [
                (f["x"], f["y"], f["label"]) for f in w["features"]]
            np.testing.assert_allclose([f.theta for f in g.features],
                                       [f["theta"] for f in w["features"]],
                                       atol=1e-3)


def test_scattered_selection_and_crop_equal_copy():
    """The compiled scattered selection and its plain loop against
    select_scattered_features; the crop against crop_templates, negative
    odd minima included (C's remainder)."""
    rng = np.random.RandomState(42)
    for n, want_n, dist in ((60, 16, 4.0), (30, 40, 1.0), (200, 63, 3.0),
                            (5, 8, 2.0)):
        cands = _candidates(rng, n)
        want = oracle.select_scattered_features(cands, want_n, dist)
        objs = [training.Candidate(c["x"], c["y"], c["label"], c["score"],
                                   c["theta"]) for c in cands]
        for fn in (training.select_scattered_features,
                   training.select_scattered_plain):
            got = fn(objs, want_n, dist)
            assert [(c.x, c.y) for c in got] == [(c["x"], c["y"])
                                                 for c in want]
    for _ in range(20):
        feats = [[(int(rng.randint(-9, 30)), int(rng.randint(-9, 30)))
                  for _ in range(int(rng.randint(1, 12)))] for _ in (0, 1)]
        tp = [Template(pyramid_level=l, features=[Feature(x, y, 0)
                                                  for x, y in fs])
              for l, fs in enumerate(feats)]
        ot = [{"pyramid_level": l, "features": [{"x": x, "y": y, "label": 0}
                                                for x, y in fs]}
              for l, fs in enumerate(feats)]
        crop_templates(tp)
        oracle.crop_templates(ot)
        for t, o in zip(tp, ot):
            assert (t.width, t.height, t.tl_x, t.tl_y) == (
                o["width"], o["height"], o["tl_x"], o["tl_y"])
            assert [(f.x, f.y) for f in t.features] == [
                (f["x"], f["y"]) for f in o["features"]]


# ---------------------------------------------------------------------------
# 4. coarse_route against the JAX package's
# ---------------------------------------------------------------------------

# (templates, features, training size, dense, orientations, frame side)
_BENCH_BANKS = {
    "rot1000x63": (1000, 63, 256, False, 8, 1024),
    "rot10000x63": (10000, 63, 256, False, 8, 1024),
    "rot1000x128": (1000, 128, 256, False, 8, 1024),
    "rot1000x256_dense": (1000, 256, 256, True, 8, 1024),
    "rot8x8191_dense": (8, 8191, 768, True, 8, 1024),
    "rot360x63_ori16": (360, 63, 256, False, 16, 1024),
}


def _both_detectors(K, N, size, dense, n_ori):
    path = tsyn.bank_cache_path(K, N, size=size, dense=dense, n_ori=n_ori)
    jdet = JDetector(num_features=N, T=(4, 8), use_pallas=True,
                     num_orientations=n_ori)
    jdet.class_templates["c"] = jsyn.load_bank_cache(path)
    det = Detector(num_features=N, T=(4, 8), num_orientations=n_ori,
                   device="cpu")
    det.class_templates["c"] = tsyn.load_bank_cache(path)
    return jdet, det


@pytest.mark.parametrize("name", list(_BENCH_BANKS))
def test_coarse_route_equals_jax(name):
    """Detector.coarse_route and ops.similarity.coarse_route give the JAX
    package's label on each committed bench bank at its bench frame size
    (the dense 10,000-template bank takes the chain at 1024^2)."""
    K, N, size, dense, n_ori, side = _BENCH_BANKS[name]
    jdet, det = _both_detectors(K, N, size, dense, n_ori)
    want = jdet.coarse_route("c", (side, side))
    assert want in ("chain", "packed4", "wide")
    assert det.coarse_route("c", (side, side)) == want
    sizes = det._level_sizes((side, side))
    chain = det._get_chain("c", sizes[-1]) is not None
    assert chain == (want == "chain")
    jbank = jdet._get_banks("c")[-1]
    assert coarse_route(det._get_banks("c")[-1], 8, sizes[-1], n_ori,
                        chain) == want == jroute(jbank, 8, sizes[-1], n_ori,
                                                 chain, use_pallas=True)


def test_coarse_route_cells_divergence():
    """At 4096^2 the JAX package's VMEM gate sends rot1000x63 to its
    TPU-only 'cells' route; the port reports what it runs there, the
    narrow coarse.cu route (ROADMAP C.6)."""
    jdet, det = _both_detectors(1000, 63, 256, False, 8)
    assert jdet.coarse_route("c", (4096, 4096)) == "cells"
    assert det.coarse_route("c", (4096, 4096)) == "packed4"
    # past 16383 slots JAX returns 'cells' too; the port's route is 'wide'
    wide = pack_level_bank([{"features": [(0, 0, 0)] * 16384, "width": 8,
                             "height": 8}])
    assert coarse_route(wide, 8, (512, 512)) == "wide"
