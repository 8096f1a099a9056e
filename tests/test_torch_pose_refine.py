"""The point-to-plane pose refiner of the PyTorch port
(``models/refine.py``, ``refine_detections``) against the JAX package's,
on the CPU, and tests/test_refine.py's accuracy contract on the port.

Poses agree with JAX within 1e-3 px in position, 1e-3 degrees in angle
and 1e-4 in scale, residual and every affine entry: float32 rounding
differs (XLA contracts multiply-adds; sin and cos differ by ulps), and a
ray sample whose rounded position flips would move a pose further than
that.
"""

import numpy as np
import pytest
import torch

from shape_based_matching_tpu import Detector as JDetector
from shape_based_matching_tpu.models.refine import (
    refine_detections as jrefine)
from shape_based_matching_tpu_torch import Detector, refine_detections
from shape_based_matching_tpu_torch.utils.cv_resize import resize_linear_u8
from shape_based_matching_tpu_torch.utils.synthetic import (
    synthetic_shape_image)

from .test_refine import _paste, _rotate_float, _shear_float

TOL = {"x": 1e-3, "y": 1e-3, "angle_delta": 1e-3, "scale": 1e-4,
       "residual": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    """tests/test_refine.py's template, trained in the port and in JAX."""
    templ = synthetic_shape_image(128, seed=1)
    det = Detector(num_features=64, device="cpu")
    jdet = JDetector(num_features=64)
    for d in (det, jdet):
        assert d.add_template(templ, "s", np.full_like(templ, 255)) == 0
    return det, jdet, templ


def _scene(templ, kind):
    """tests/test_refine.py's scenes: (scene, match threshold)."""
    scene = np.zeros((256, 256), np.uint8)
    if kind == "rotation":
        return _paste(scene, _rotate_float(templ, 2.0), 60, 70), 70.0
    if kind == "scale":
        return _paste(scene, resize_linear_u8(templ, 1.05, 1.05), 50,
                      40), 60.0
    if kind == "exact":
        return _paste(scene, templ, 64, 48), 85.0
    return _paste(scene, _shear_float(templ, 0.04), 60, 70), 60.0


@pytest.mark.parametrize("kind,model", [
    ("rotation", "sim2"), ("scale", "sim2"), ("exact", "sim2"),
    ("shear", "affine"), ("shear", "sim2"), ("scale", "affine")])
def test_refine_detections_equals_jax(trained, kind, model):
    det, jdet, templ = trained
    scene, thr = _scene(templ, kind)
    matches = det.match(scene, thr)
    assert matches
    got = refine_detections(det, scene, matches[:3], model=model,
                            iterations=5)
    want = jrefine(jdet, scene, matches[:3], model=model, iterations=5)
    assert got and [g["match"] for g in got] == [w["match"] for w in want]
    for g, w in zip(got, want):
        for f, tol in TOL.items():
            assert abs(g[f] - w[f]) < tol, (f, g[f], w[f])
        assert np.abs(g["affine"] - np.asarray(w["affine"])).max() < 1e-4


def test_refine_accuracy_contract(trained):
    """tests/test_refine.py's four cases on the port alone."""
    det, _, templ = trained
    scene, thr = _scene(templ, "rotation")
    r = refine_detections(det, scene, det.match(scene, thr)[:1])[0]
    assert abs(abs(r["angle_delta"]) - 2.0) < 0.7, r
    assert abs(r["scale"] - 1.0) < 0.05 and r["residual"] < 1.5

    scene, thr = _scene(templ, "scale")
    r = refine_detections(det, scene, det.match(scene, thr)[:1])[0]
    assert abs(r["scale"] - 1.05) < 0.03 and abs(r["angle_delta"]) < 1.0

    scene, thr = _scene(templ, "exact")
    m = det.match(scene, thr)[0]
    t0 = det.get_templates("s", 0)[0]
    r = refine_detections(det, scene, [m])[0]
    assert abs(r["x"] - (64 + t0.tl_x)) < 0.7
    assert abs(r["y"] - (48 + t0.tl_y)) < 0.7
    assert abs(r["angle_delta"]) < 0.5 and abs(r["scale"] - 1.0) < 0.02
    assert r["residual"] < 0.8

    scene, thr = _scene(templ, "shear")
    matches = det.match(scene, thr)[:1]
    r = refine_detections(det, scene, matches, model="affine",
                          iterations=5)[0]
    A = r["affine"]
    assert abs(A[0, 1] - 0.04) < 0.02, A
    assert abs(A[0, 0] - 1.0) < 0.03 and abs(A[1, 1] - 1.0) < 0.03, A
    assert r["residual"] < 1.5
    base = refine_detections(det, scene, matches, iterations=5)[0]
    assert r["residual"] <= base["residual"] + 0.05


def test_refine_detections_bgr_and_empty(trained):
    """A BGR frame refines through the color gradients; no match, no
    work."""
    det, _, templ = trained
    scene, thr = _scene(templ, "exact")
    matches = det.match(scene, thr)[:1]
    bgr = np.stack([scene, scene, scene], axis=-1)
    gray = refine_detections(det, scene, matches)
    color = refine_detections(det, bgr, matches)
    assert color and abs(color[0]["x"] - gray[0]["x"]) < 1e-3
    assert refine_detections(det, scene, []) == []
