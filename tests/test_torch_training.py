"""Training in the PyTorch port, against the compiled C++ reference's
goldens, the JAX package's training, and its own plain versions.

Port ``Detector(device="cpu")`` (the device half of a sweep runs as torch
ops on CPU tensors; the host helpers are compiled from csrc/host.cpp).
Every comparison is exact: template geometry, feature (x, y, label), the
fork's metadata, and Feature.theta's float32 bits where the other side
has them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from shape_based_matching_tpu import Detector as JDetector
from shape_based_matching_tpu.models import template as jtemplate
from shape_based_matching_tpu.models import training as jtraining
from shape_based_matching_tpu.models.shape_info import (
    ShapeInfoProducer as JShapeInfoProducer)
from shape_based_matching_tpu.ops.filters import erode3_u8 as jerode3_u8
from shape_based_matching_tpu.utils.cv_resize import (
    resize_linear_u8 as jresize_linear_u8)
from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.models import training
from shape_based_matching_tpu_torch.models.shape_info import (
    ShapeInfo, ShapeInfoProducer)
from shape_based_matching_tpu_torch.models import template as ttemplate
from shape_based_matching_tpu_torch.models.template import crop_templates
from shape_based_matching_tpu_torch.ops.filters import erode3_u8
from shape_based_matching_tpu_torch.utils import synthetic as tsyn
from shape_based_matching_tpu_torch.utils.cv_resize import resize_linear_u8

from .golden_utils import load_json, load_mat
from .test_golden_training import _golden_as_tuples, _templates_as_tuples


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(pyramids, theta=True):
    """Every Template field and every feature, theta as float32 bits."""
    return [(t.width, t.height, t.tl_x, t.tl_y, t.pyramid_level, t.sscale,
             t.orientation, t.tag_field_id, t.fiducial_src,
             [(f.x, f.y, f.label)
              + ((int(np.float32(f.theta).view(np.uint32)),) if theta
                 else ()) for f in t.features])
            for tp in pyramids for t in tp]


# ---------------------------------------------------------------------------
# The compiled C++ reference's training goldens


def _case1(det):
    img = load_mat("case1_train_img.bin")
    assert det.add_template(img, "test", load_mat("case1_train_mask.bin")) \
        == 0
    center = (img.shape[1] / 2.0, img.shape[0] / 2.0)
    for a in range(45, 360, 45):
        det.add_template_rotate("test", 0, float(a), center)
    return "test"


def _case0(det):
    img = load_mat("case0_train_img.bin")
    producer = ShapeInfoProducer(img)
    m255 = np.full(img.shape[:2], 255, np.uint8)
    for i in range(1, 11):
        scale = i / 10.0
        msk = (producer.transform(m255, 0, scale) > 0) * np.uint8(255)
        assert det.add_template(producer.transform(img, 0, scale), "circle",
                                msk, num_features=int(150 * scale)) == i - 1
    return "circle"


def _jabil(det):
    shapes = ShapeInfoProducer(load_mat("jabil_fid_img.bin"))
    shapes.angle_range = [0.0, 270.0]
    shapes.angle_step = 90.0
    shapes.scale_range = [0.9, 1.1]
    shapes.scale_step = 0.1
    infos = shapes.produce_infos()
    assert len(infos) == 12
    for info in infos:
        assert det.add_template(shapes.src_of(info), "17",
                                shapes.mask_of(info), info.scale,
                                info.angle, 3, "fid.png") >= 0
    pyr = det.class_templates["17"]
    assert [(t.sscale, t.orientation, t.tag_field_id, t.fiducial_src)
            for t in pyr[5]] == [(infos[5].scale, infos[5].angle, 3,
                                  "fid.png")] * 2
    return "17"


@pytest.mark.parametrize("case,kwargs,train", [
    ("case1", dict(num_features=128), _case1),
    ("case0", dict(num_features=150), _case0),
    ("jabil", dict(num_features=150, weak_threshold=100.0,
                   strong_threshold=200.0), _jabil),
])
def test_training_equals_cpp_golden(case, kwargs, train):
    """As tests/test_golden_training.py compares the JAX package: every
    template's geometry and its feature set equal the C++ reference's."""
    det = Detector(T=(4, 8), device="cpu", **kwargs)
    cid = train(det)
    want = _golden_as_tuples(load_json(f"{case}_train_templates.json"))
    got = _templates_as_tuples(det, cid)
    assert len(got) == len(want)
    for tid, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{case} template {tid} differs"


# ---------------------------------------------------------------------------
# The JAX package's training


@pytest.mark.parametrize("args", [
    dict(num_templates=360, num_features=63),
    dict(num_templates=360, num_features=63, n_ori=16),
    dict(num_templates=1000, num_features=63),
])
def test_build_rotated_detector_equals_snapshot(args):
    """The port trains the committed bench_banks/ snapshots (written by the
    JAX package) field for field (tests/test_bank_cache.py)."""
    det, _ = tsyn.build_rotated_detector(device="cpu", **args)
    want = tsyn.load_bank_cache(tsyn.bank_cache_path(
        args["num_templates"], args["num_features"],
        n_ori=args.get("n_ori", 8)))
    assert want is not None
    assert _fields(det.class_templates["bench"], theta=False) == \
        _fields(want, theta=False)


def _frames(kind):
    """Four 96^2 frames: three star images and a flat one, on which every
    level fails; BGR as (f, roll(f, 1), 255 - f)."""
    f = np.stack([tsyn.synthetic_shape_image(96, s) for s in (1, 2, 3)]
                 + [np.full((96, 96), 127, np.uint8)])
    if kind == "bgr":
        f = np.stack([f, np.roll(f, 1, axis=2), 255 - f], axis=-1)
    return f


@pytest.mark.parametrize("kind,n_ori,masked", [
    ("gray", 8, True), ("bgr", 8, False), ("gray", 16, False)])
def test_add_templates_equals_jax(kind, n_ori, masked):
    """A live JAX add_templates and the port's on the same frames: the same
    ids (-1 for the flat frame), every field, and theta's float32 bits."""
    frames = _frames(kind)
    masks = ((np.random.RandomState(0).rand(4, 96, 96) > 0.1)
             .astype(np.uint8) * 255 if masked else None)
    meta = dict(sscales=[0.5, 1.0, 1.5, 2.0], orientations=[0, 90, 180, 5],
                tag_field_ids=[1, 2, 3, 4], fiducial_src="f.png")
    jdet = JDetector(num_features=32, num_orientations=n_ori)
    want = jdet.add_templates(frames, "c", masks, **meta)
    det = Detector(num_features=32, num_orientations=n_ori, device="cpu")
    got = det.add_templates(frames, "c", masks, chunk=3, **meta)
    assert got == want
    assert got[3] == -1 and sum(i >= 0 for i in got) >= 2
    assert _fields(det.class_templates["c"]) == \
        _fields(jdet.class_templates["c"])


def test_add_template_equals_add_templates():
    """add_template is add_templates at B=1: same ids, same templates;
    a frame that fails adds nothing and returns -1."""
    frames = _frames("gray")
    bat = Detector(num_features=24, device="cpu")
    ids = bat.add_templates(frames, "c", chunk=2)
    seq = Detector(num_features=24, device="cpu")
    assert [seq.add_template(f, "c") for f in frames] == ids == [0, 1, 2, -1]
    assert _fields(seq.class_templates["c"]) == \
        _fields(bat.class_templates["c"])
    assert seq.num_templates("c") == 3 and seq.num_classes() == 1
    assert seq.class_ids() == ["c"] and seq.get_t(1) == 8


def test_rotation_sweep_equals_jax():
    """add_templates_rotate (the vectorised sweep) equals one
    add_template_rotate per angle and the JAX package's batch, theta bits
    included, on angles past 360 and below 0."""
    det = Detector(num_features=48, device="cpu")
    det.add_template(tsyn.synthetic_shape_image(96, 0), "c")
    base = det.get_templates("c", 0)
    thetas = [0.0, 1.0 / 3.0, 45.0, 181.25, 359.99, 400.0, -30.0]
    center = (48.0, 47.5)
    ids = det.add_templates_rotate("c", 0, thetas, center)
    assert ids == list(range(1, 8))
    for t in thetas:
        det.add_template_rotate("c", 0, t, center)
    pyr = det.class_templates["c"]
    assert _fields(pyr[1:8]) == _fields(pyr[8:])
    want = jtraining.rotate_templates_batch(base, thetas, center, 2)
    assert _fields(pyr[1:8]) == _fields(want)


def test_crop_templates_negative_odd_corner():
    """The C remainder: an odd negative min corner stays odd."""
    def pyramid(mod):
        return [mod.Template(pyramid_level=l, features=[
            mod.Feature(-3 if l == 0 else 1, 5, 1),
            mod.Feature(7, -5 if l == 0 else 1, 2),
            mod.Feature(11, 9, 3)]) for l in range(2)]

    got, want = pyramid(ttemplate), pyramid(jtemplate)
    assert crop_templates(got) == jtemplate.crop_templates(want)
    assert _fields([got]) == _fields([want])
    assert got[0].tl_x == -3 and got[0].tl_y == -5


# ---------------------------------------------------------------------------
# Pieces against the JAX package's and against their plain versions


def test_local_max_map_and_erode_equal_jax():
    """Planes with flat ties (values 0-2) and a plateau; binary masks."""
    rng = np.random.RandomState(3)
    mag = rng.randint(0, 3, (2, 37, 45)).astype(np.float32)
    mag[1, 10:20, 5:30] = 2.0
    got = training.local_max_map(torch.from_numpy(mag)).numpy()
    for b in range(2):
        want = np.asarray(jtraining.local_max_map(jnp.asarray(mag[b])))
        np.testing.assert_array_equal(got[b], want)
    msk = (rng.rand(2, 37, 45) > 0.2).astype(np.uint8) * 255
    got = erode3_u8(torch.from_numpy(msk)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jerode3_u8(jnp.asarray(msk[b]))))


def test_greedy_accept_equals_plain():
    """The compiled acceptance scan equals the Python loop on dense tie
    chains (a plateau's row-major runs) and on sparse points."""
    rng = np.random.RandomState(5)
    for density in (0.9, 0.08):
        pts = rng.rand(60, 70) < density
        pts[20:30, 10:50] = True
        ys, xs = np.nonzero(pts)
        got = training.greedy_accept(60, 70, ys, xs)
        np.testing.assert_array_equal(
            got, training.greedy_accept_plain(60, 70, ys, xs))
        assert 0 < got.sum() < len(ys)
    assert training.greedy_accept(4, 4, [], []).shape == (0,)
    with pytest.raises(ValueError):
        training.greedy_accept(4, 4, [1, 4], [0, 0])


@pytest.mark.parametrize("spread,num_features,enough", [
    (200, 40, True),   # first pass keeps enough: widen, then settle
    (6, 60, False),    # clustered: shrink until the distance falls below 3
])
def test_select_scattered_equals_plain(spread, num_features, enough):
    rng = np.random.RandomState(spread)
    cands = [training.Candidate(int(rng.randint(0, spread)),
                                int(rng.randint(0, spread)), 0,
                                float(200 - i), 0.0) for i in range(150)]
    distance = float(len(cands) // num_features + 1)
    got = training.select_scattered_features(cands, num_features, distance)
    want = training.select_scattered_plain(cands, num_features, distance)
    assert [id(c) for c in got] == [id(c) for c in want]
    assert (len(got) >= num_features) == enough


def test_resize_and_shape_info_equal_jax(tmp_path):
    """resize_linear_u8 at scales 0.1 to 1.1 (the 2x2 area path at 0.5),
    gray and BGR; the producer's sweep, frames and masks; save / load of
    the infos."""
    rng = np.random.RandomState(9)
    gray = rng.randint(0, 256, (61, 47), dtype=np.uint8)
    bgr = rng.randint(0, 256, (40, 52, 3), dtype=np.uint8)
    for s in np.arange(1, 12) / 10.0:
        s = float(np.float32(s))
        for img in (gray, bgr):
            np.testing.assert_array_equal(resize_linear_u8(img, s, s),
                                          jresize_linear_u8(img, s, s))
    src = rng.randint(0, 256, (48, 40), dtype=np.uint8)
    mask = (rng.rand(48, 40) > 0.3).astype(np.uint8) * 255
    got = ShapeInfoProducer(src, mask, [0.0, 270.0], [0.8, 1.1], 90.0, 0.1)
    want = JShapeInfoProducer(src, mask, [0.0, 270.0], [0.8, 1.1], 90.0,
                              0.1)
    infos = got.produce_infos()
    assert [(i.angle, i.scale) for i in infos] == [
        (i.angle, i.scale) for i in want.produce_infos()]
    assert len(infos) == 16
    for gi, wi in zip(infos, want.infos):
        np.testing.assert_array_equal(got.src_of(gi), want.src_of(wi))
        np.testing.assert_array_equal(got.mask_of(gi), want.mask_of(wi))
    path = str(tmp_path / "infos.yaml")
    ShapeInfoProducer.save_infos(infos, path)
    assert ShapeInfoProducer.load_infos(path) == infos
    assert ShapeInfoProducer(src).produce_infos() == [ShapeInfo(0.0, 1.0)]
