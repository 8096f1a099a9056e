"""The application utilities of the PyTorch port against the JAX package
(and OpenCV or Pillow where the JAX package's own tests use them): timer,
SSIM/CCORR and the fiducial gate, histograms, rotations, drawing, NMS,
the image codec and the tag database.

Tolerances: ``ssim`` and ``match_template_ccorr_normed`` are float32 torch
ops here and XLA float32 there (the port's CCORR correlates in float64),
so they agree within 1e-5 and a gate decision agrees wherever the score
is farther than that from its threshold; against OpenCV the JAX package's
own bounds hold (1e-4 SSIM, 2e-4 CCORR). Everything else is equal.
"""

import json
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from shape_based_matching_tpu import db as jdb
from shape_based_matching_tpu.utils import nms as jnms
from shape_based_matching_tpu.utils import verify as jverify
from shape_based_matching_tpu.utils import viz as jviz
from shape_based_matching_tpu_torch import db as tdb
from shape_based_matching_tpu_torch.models.template import Template
from shape_based_matching_tpu_torch.utils import imageio, nms
from shape_based_matching_tpu_torch.utils import verify, viz
from shape_based_matching_tpu_torch.utils.synthetic import (
    synthetic_scene, synthetic_shape_image)
from shape_based_matching_tpu_torch.utils.timer import CSVStat, Timer

FLOAT_TOL = 1e-5


def test_timer_and_csv_stat():
    t = Timer()
    t.record("A")
    t.record("A")
    torch.ones(3).sum()
    t.record("B")
    assert set(t.records) == {"A", "B"}
    assert t.display_csv(["A", "B"], first_column="frame0").startswith(
        "frame0,")
    s = CSVStat(["m", "n"])
    s.append([1.0, 10.0])
    s.append([3.0, 20.0])
    assert (s.get_mins(), s.get_maxes(), s.get_mean()) == (
        [1.0, 10.0], [3.0, 20.0], [2.0, 15.0])
    assert s.summary_csv() == "stat,m,n\nmin,1,10\nmax,3,20\nmean,2,15"


def test_ssim_and_ccorr_against_jax_and_cv2(rng):
    a = rng.randint(0, 256, (64, 64), np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-20, 20, (64, 64)), 0,
                255).astype(np.uint8)
    mean, smap = verify.ssim(a, b, device="cpu")
    jmean, jmap = jverify.ssim(a, b)
    assert smap.shape == (59, 59) and smap.dtype == torch.float32
    assert abs(float(mean) - float(jmean)) < FLOAT_TOL
    np.testing.assert_allclose(smap.numpy(), np.asarray(jmap),
                               atol=FLOAT_TOL)

    img = rng.randint(0, 256, (48, 64), np.uint8)
    templ = img[10:30, 20:44]
    got = verify.match_template_ccorr_normed(img, templ, device="cpu")
    assert got.shape == (29, 41) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jverify.match_template_ccorr_normed(
            img, templ)), atol=FLOAT_TOL)
    # a tensor stays on its device
    assert verify.match_template_ccorr_normed(
        torch.from_numpy(img), templ).device.type == "cpu"

    cv2 = pytest.importorskip("cv2")
    np.testing.assert_allclose(
        got.numpy(), cv2.matchTemplate(img, templ, cv2.TM_CCORR_NORMED),
        atol=2e-4)
    blur = lambda im: cv2.GaussianBlur(im, (11, 11), 1.5)  # noqa: E731
    x, y = a.astype(np.float32), b.astype(np.float32)
    mu1, mu2 = blur(x), blur(y)
    m = ((2 * mu1 * mu2 + 6.5025) * (2 * (blur(x * y) - mu1 * mu2)
                                     + 58.5225)) / (
        (mu1 * mu1 + mu2 * mu2 + 6.5025)
        * (blur(x * x) - mu1 * mu1 + blur(y * y) - mu2 * mu2 + 58.5225))
    assert abs(float(mean) - float(m[5:, 5:].mean())) < 1e-4


def _templ(**kw):
    t = Template(width=24, height=20, tl_x=6, tl_y=4, sscale=1.0,
                 orientation=0.0)
    for k, v in kw.items():
        setattr(t, k, v)
    return t


@pytest.mark.parametrize("case", ["match", "elsewhere", "rot90_scaled",
                                  "outside"])
def test_fiducial_gate_against_jax(case, rng):
    fid = rng.randint(0, 256, (40, 40), np.uint8)
    scene = rng.randint(0, 60, (96, 96), np.uint8)
    templ = _templ()
    xy = (30, 50)
    if case == "match":
        scene[50:70, 30:54] = fid[4:24, 6:30]
    elif case == "rot90_scaled":
        templ = _templ(sscale=0.9, orientation=90.0)
        ref = jverify.rotate_scale_image(fid, 0.9, 90.0)
        scene[50:70, 30:54] = ref[4:24, 6:30]
    elif case == "outside":
        xy = (80, 90)
    got = verify.verify_match_fiducial(scene, xy, templ, fid, 0.8,
                                       device="cpu")
    want = jverify.verify_match_fiducial(scene, xy, templ, fid, 0.8)
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) < FLOAT_TOL
    assert got[0] == (case in ("match", "rot90_scaled"))
    ok, score = verify.verify_match_ccorr(scene, xy, fid[4:24, 6:30], 0.8,
                                          device="cpu")
    jok, jscore = jverify.verify_match_ccorr(scene, xy, fid[4:24, 6:30], 0.8)
    assert ok == jok and abs(score - jscore) < FLOAT_TOL


def test_numpy_helpers_equal_jax(rng):
    img = rng.randint(0, 256, (33, 47), np.uint8)
    bgr = rng.randint(0, 256, (33, 47, 3), np.uint8)
    h = verify.calc_histogram(img)
    assert (h == jverify.calc_histogram(img)).all()
    h2 = verify.calc_histogram(bgr[..., 0])
    assert verify.comp_histogram(h, h2) == jverify.comp_histogram(h, h2)
    assert verify.comp_histogram(h, h) == pytest.approx(1.0)
    for scale in (1.0, 0.7, 1.3):
        for angle in (0, 90, 180, 270, -90, 45):
            assert (verify.rotate_scale_image(img, scale, angle)
                    == jverify.rotate_scale_image(img, scale, angle)).all()
            assert verify.rotate_scale_rect(
                (5, 7, 20, 11), scale, angle, (47, 33)) == \
                jverify.rotate_scale_rect((5, 7, 20, 11), scale, angle,
                                          (47, 33))
    assert (verify.normalize_minmax_u8(img)
            == jverify.normalize_minmax_u8(img)).all()
    assert (verify.bgr2gray_u8(bgr) == jverify.bgr2gray_u8(bgr)).all()
    assert (verify.bgr2gray_u8(torch.from_numpy(bgr)).numpy()
            == jverify.bgr2gray_u8(bgr)).all()
    t = _templ(fiducial_src="f", sscale=0.8, orientation=270.0)
    assert (verify.extract_fiducial_img({"f": img}, t)
            == jverify.extract_fiducial_img({"f": img}, t)).all()


def test_drawing_equals_jax(rng):
    from shape_based_matching_tpu_torch import Detector, Match
    from shape_based_matching_tpu_torch.utils.synthetic import (
        bank_cache_path, load_bank_cache)

    q = rng.choice(np.array([0, 1, 2, 4, 8, 16, 32, 64, 128, 255, 7],
                            np.uint8), (16, 24))
    assert (viz.display_quantized(q) == jviz.display_quantized(q)).all()
    det = Detector(device="cpu")
    det.class_templates["c"] = load_bank_cache(bank_cache_path(360, 63))[:3]
    matches = [Match(10, 20, 99.0, "c", 0), Match(200, 230, 90.0, "c", 2),
               Match(-5, 3, 80.0, "c", 1)]
    img = rng.randint(0, 256, (256, 256), np.uint8)
    assert (viz.draw_matches(img, matches, det)
            == jviz.draw_matches(img, matches, det)).all()
    out = img[..., None].repeat(3, axis=2)
    assert (viz.draw_dot(out.copy(), (3, 250)) == jviz.draw_dot(
        out.copy(), (3, 250))).all()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("eta", [1.0, 0.9])
def test_nms_native_equals_plain_and_jax(seed, eta):
    r = np.random.RandomState(seed)
    n = 300
    boxes = [tuple(int(v) for v in b) for b in np.c_[
        r.randint(0, 200, (n, 2)), r.randint(0, 60, (n, 2))]]
    boxes[:3] = [(5, 5, 0, 0), (5, 5, 0, 0), (7, 5, 0, 3)]  # empty boxes
    scores = list(np.round(r.uniform(50, 100, n), 1))  # ties
    for thr in (0.3, 0.5):
        want = jnms.nms_boxes(boxes, scores, 60.0, thr, eta)
        assert nms.nms_boxes(boxes, scores, 60.0, thr, eta) == want
        assert nms.nms_boxes_plain(boxes, scores, 60.0, thr, eta) == want
        assert nms.nms_boxes(boxes, scores, 60.0, thr, eta, top_k=50) == \
            jnms.nms_boxes(boxes, scores, 60.0, thr, eta, top_k=50)
    assert nms.nms_boxes([], [], 0.0, 0.5) == []


def _png(rows: np.ndarray, ctype: int, filters) -> bytes:
    """A PNG of uint8 [H, W*C] rows, row y filtered with filters[y] (the
    PNG specification's filters, written independently of the codec)."""
    c = {0: 1, 2: 3, 6: 4}[ctype]
    h, wc = rows.shape
    x = rows.astype(np.int32)
    out = []
    for y in range(h):
        prior = x[y - 1] if y else np.zeros(wc, np.int32)
        left = np.r_[np.zeros(c, np.int32), x[y, :-c]]
        ul = np.r_[np.zeros(c, np.int32), prior[:-c]]
        f = filters[y]
        if f == 4:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
        else:
            pred = [0, left, prior, (left + prior) // 2][f]
        out.append(bytes([f]) + ((x[y] - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", wc // c, h, 8, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 6])
def test_png_decoder_every_filter(ctype, rng, tmp_path):
    c = {0: 1, 2: 3, 6: 4}[ctype]
    pix = rng.randint(0, 256, (23, 17, c), np.uint8)
    pix[5:12] = 250  # runs that favour Sub / Up
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(pix.reshape(23, -1), ctype,
                     [y % 5 for y in range(23)]))
    assert (imageio.decode_png(open(path, "rb").read()) == pix).all()
    gray = imageio.load_image(path, gray=True)
    color = imageio.load_image(path)
    assert imageio.image_size(path) == (17, 23)
    cv2 = pytest.importorskip("cv2")
    assert (color == cv2.imread(path, cv2.IMREAD_COLOR)).all()
    if c == 1:
        assert (gray == pix[..., 0]).all()
    assert (gray == verify.bgr2gray_u8(color)).all()


def test_codec_against_pil_and_cv2(rng, tmp_path):
    cv2 = pytest.importorskip("cv2")
    from PIL import Image

    scene = synthetic_scene(64, 96, synthetic_shape_image(32, 1),
                            n_instances=2, seed=3)
    bgr = np.stack([scene, np.roll(scene, 3), 255 - scene], axis=-1)
    noise = rng.randint(0, 256, (31, 45, 3), np.uint8)
    for name, img in (("gray", scene), ("bgr", bgr), ("noise", noise)):
        gray = img.ndim == 2
        flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
        # files the libraries wrote (their own filter choices), read here
        for lib in ("cv2", "pil"):
            path = str(tmp_path / f"{name}_{lib}.png")
            if lib == "cv2":
                cv2.imwrite(path, img)
            else:
                Image.fromarray(img if gray else img[..., ::-1]).save(path)
            assert (imageio.load_image(path, gray=gray) == img).all()
            # a color file read as gray: cvtColor's formula here, libpng's
            # own conversion in cv2.imread (one level apart at most)
            got = imageio.load_image(path, gray=True).astype(int)
            want = cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(int)
            assert np.abs(got - want).max() <= (0 if gray else 1)
            if not gray:
                assert (got == verify.bgr2gray_u8(img)).all()
        # files written here, read by the libraries
        for ext in ("png", "pgm" if gray else "ppm"):
            path = str(tmp_path / f"{name}_port.{ext}")
            imageio.save_image(img, path)
            assert (cv2.imread(path, flag) == img).all()
            assert (imageio.load_image(path, gray=gray) == img).all()
            assert imageio.image_size(path) == img.shape[1::-1]
            pil = np.asarray(Image.open(path))
            assert (pil == (img if gray else img[..., ::-1])).all()
        path = str(tmp_path / f"{name}_cv2.pgm")
        cv2.imwrite(path, img if gray else img[..., 0])
        assert (imageio.load_image(path, gray=True)
                == (img if gray else img[..., 0])).all()
    rgba = rng.randint(0, 256, (9, 7, 4), np.uint8)
    path = str(tmp_path / "rgba.png")
    Image.fromarray(rgba).save(path)
    assert (imageio.load_image(path)
            == cv2.imread(path, cv2.IMREAD_COLOR)).all()
    # other formats go through the libraries
    path = str(tmp_path / "x.bmp")
    imageio.save_image(bgr, path)
    assert (imageio.load_image(path) == bgr).all()


def test_codec_without_image_libraries(rng, tmp_path, monkeypatch):
    img = rng.randint(0, 256, (12, 10, 3), np.uint8)
    cv2 = pytest.importorskip("cv2")
    cv2.imwrite(str(tmp_path / "x.jpg"), img)
    for name in ("cv2", "PIL", "yaml"):
        monkeypatch.setitem(sys.modules, name, None)
    for ext in ("png", "ppm"):
        path = str(tmp_path / f"x.{ext}")
        imageio.save_image(img, path)
        assert (imageio.load_image(path) == img).all()
    with pytest.raises(ImportError, match="x.jpg"):
        imageio.load_image(str(tmp_path / "x.jpg"))
    with pytest.raises(ImportError, match="PIL"):
        viz.Annotator(img)


def test_db_functions_equal_jax(tmp_path):
    geo = tdb.make_fiducial_geo(0.37, 0.25, 0.1, 0.5, (640, 480))
    assert geo == jdb.make_fiducial_geo(0.37, 0.25, 0.1, 0.5, (640, 480))
    assert tdb.parse_positions(geo, (640, 480)).__dict__ == \
        jdb.parse_positions(geo, (640, 480)).__dict__
    for bad in ("{}", "not json"):
        with pytest.raises(ValueError):
            tdb.parse_positions(bad, (10, 10))
    assert tdb.fiducial_crop_path("/m/tag7.png", 3) == \
        jdb.fiducial_crop_path("/m/tag7.png", 3)

    path = str(tmp_path / "model.png")
    imageio.save_image(synthetic_shape_image(128, 3), path)
    got = []
    for mod in (tdb, jdb):
        db = mod.TagDB.get_instance(str(tmp_path / f"{mod.__name__}.sqlite"))
        assert mod.TagDB.get_instance(db.path) is db
        db.add_tag_field(11, "fid", 3)
        db.add_tag_field(12, "other", 1)
        db.add_tag_model(7, "tag-model", path, [
            (11, mod.make_fiducial_geo(0.25, 0.125, 0.5, 0.5, (128, 128))),
            (12, mod.make_fiducial_geo(0, 0, 0.25, 0.25, (128, 128)))])
        got.append([json.dumps(t.__dict__) for t in
                    mod.extract_tag_model_fiducials(db)])
        db.add_tag_field(13, "bad", 3)
        db.add_tag_model(8, "bad", path, [
            (13, mod.make_fiducial_geo(0.75, 0.75, 0.5, 0.5, (128, 128)))])
        with pytest.raises(ValueError, match="template database"):
            mod.extract_tag_model_fiducials(db)
        db.close()
    assert got[0] == got[1] and len(got[0]) == 1
