"""The fiducial inspection (``models/inspect.py``) on the CPU: the batched
CCORR gate against its plain twin ``verify_match_fiducial``, score bit
for score bit, and ``Detector.inspect`` against the command line's old
loop (``det.match``, ``nms_boxes``, ``verify_match_fiducial`` a kept
match), on the jabil fiducial's 12-template sweep."""

import numpy as np
import pytest
import torch

from shape_based_matching_tpu_torch import (Detector, Match,
                                            ShapeInfoProducer, nms_boxes)
from shape_based_matching_tpu_torch.models import inspect
from shape_based_matching_tpu_torch.utils.profiling import recording
from shape_based_matching_tpu_torch.utils.verify import (
    bgr2gray_u8, verify_match_fiducial)

from .golden_utils import load_mat

CLASS = "fid"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fid():
    return load_mat("jabil_fid_img.bin")


@pytest.fixture(scope="module")
def sweep(fid):
    shapes = ShapeInfoProducer(fid, angle_range=[0.0, 270.0],
                               angle_step=90.0, scale_range=[0.9, 1.1],
                               scale_step=0.1)
    return shapes, shapes.produce_infos()


def _detector(fid, sweep):
    """The jabil sweep (test_jabil.cpp:79-104) on the CPU, its fiducial
    registered."""
    shapes, infos = sweep
    det = Detector(num_features=150, T=(4, 8), weak_threshold=100.0,
                   strong_threshold=200.0, device="cpu")
    for info in infos:
        assert det.add_template(shapes.src_of(info), CLASS,
                                shapes.mask_of(info), info.scale,
                                info.angle) >= 0
    det.set_fiducial(CLASS, fid)
    return det


@pytest.fixture(scope="module")
def det(fid, sweep):
    return _detector(fid, sweep)


def _board(rng, h, w):
    img = np.empty((h, w, 3), np.uint8)
    img[...] = (40, 100, 30)
    img += rng.integers(0, 16, size=(h, w, 1), dtype=np.uint8)
    return img


def _rows(results):
    return [(r.match.template_id, r.match.x, r.match.y,
             int(np.float32(r.match.similarity).view(np.int32)),
             int(np.float32(r.ccorr).view(np.int32)), r.passed)
            for r in results]


def _gate_plain(d, scene, results, ccorr):
    """The plain twin's gate of the matches of `results` on one frame."""
    matches = [r.match for r in results]
    scores, passed = inspect._gate_plain(d, torch.from_numpy(scene[None]),
                                         [(0, m) for m in matches], ccorr)
    return [inspect.Inspected(m, float(s), bool(p))
            for m, s, p in zip(matches, scores, passed)]


def test_batched_gate_equals_plain(fid, sweep, det):
    """Every template (3 scales x 4 angles) gated at its own pasted
    render, at seeded offsets from it, on a flat patch, past the frame's
    right and bottom edges, and with a fiducial smaller than its rect:
    the batched gate's float32 scores and decisions are the plain
    twin's."""
    shapes, infos = sweep
    rng = np.random.default_rng(7)
    H, W = 830, 1400
    scene = _board(rng, H, W)
    scene[300:560, 1130:] = 77                         # a flat patch
    # low-contrast patches whose min-max spreads are ones where 255 / d
    # and 255 * (1 / d) round apart
    for i, d in enumerate((14, 28, 50, 62, 100)):
        scene[570:820, 20 + i * 270:270 + i * 270] = rng.integers(
            100, 101 + d, size=(250, 250, 1), dtype=np.uint8)
    matches, placed = [], {}
    for tid, info in enumerate(infos):
        t0 = det.class_templates[CLASS][tid][0]
        x0, y0 = 20 + (tid % 4) * 270, 20 + (tid // 4) * 270
        if tid < 8:     # scales 0.9 and 1.0; every third one inverted
            patch = shapes.src_of(info)
            scene[y0:y0 + patch.shape[0], x0:x0 + patch.shape[1]] = (
                patch if tid % 3 else 255 - patch)
            placed[tid] = (x0 + t0.tl_x, y0 + t0.tl_y)
        xy = [(x0 + t0.tl_x, y0 + t0.tl_y)]
        xy += [(x0 + t0.tl_x + int(dx), y0 + t0.tl_y + int(dy))
               for dx, dy in rng.integers(-3, 4, size=(2, 2))]
        xy += [(1135, 305), (W - t0.width + 1, 10), (10, H - t0.height + 2),
               (W - t0.width, H - t0.height)]
        if tid >= 7:
            xy.append((21 + (tid - 7) * 270, 571))
        matches += [Match(int(x), int(y), 90.0 + tid, CLASS, tid)
                    for x, y in xy]
    small = Detector(num_features=150, T=(4, 8), weak_threshold=100.0,
                     strong_threshold=200.0, device="cpu")
    small.class_templates = det.class_templates
    small.set_fiducial(CLASS, fid)
    small.set_fiducial(CLASS, fid[:120, :120], template_ids=[3, 9])

    got = {}
    for name, d in (("det", det), ("small", small)):
        # an IoU limit of 1 keeps every box: the gate sees every match
        gated, rejected = (d.counters[k] for k in ("inspect.gated",
                                                   "inspect.rejected"))
        got[name] = inspect.inspect_matches(d, scene[None], [matches],
                                            nms=1.0, ccorr=0.8)[0]
        assert d.counters["inspect.gated"] - gated == len(matches)
        assert d.counters["inspect.rejected"] - rejected == sum(
            not r.passed for r in got[name])
        want = _gate_plain(d, scene, got[name], 0.8)
        assert len(got[name]) == len(matches)
        assert _rows(got[name]) == _rows(want)
        for r in want:
            t0 = d.class_templates[CLASS][r.match.template_id][0]
            fits = d is det or r.match.template_id not in (3, 9)
            inside = r.match.x + t0.width <= W and r.match.y + t0.height <= H
            if not (fits and inside):
                assert (r.ccorr, r.passed) == (0.0, False)
    # the flat patch scores 0; the true renders pass, the inverted fail
    by_key = {(r.match.template_id, r.match.x, r.match.y): r
              for r in got["det"]}
    for tid, (x, y) in placed.items():
        assert by_key[(tid, x, y)].passed == bool(tid % 3)
        assert by_key[(tid, 1135, 305)].ccorr == 0.0


def test_inspect_equals_the_cli_loop(fid, sweep, det):
    """``Detector.inspect`` on a seeded 512x512 BGR frame with one
    fiducial and one contrast-inverted copy: the matches NMS keeps and
    their gate are the old command-line loop's, bit for bit; the
    inverted copy is matched and rejected; the spans and counters."""
    shapes, infos = sweep
    rng = np.random.default_rng(3)
    frame = _board(rng, 512, 512)
    p = shapes.src_of(infos[5])
    frame[20:20 + p.shape[0], 30:30 + p.shape[1]] = p
    q = 255 - shapes.src_of(infos[2])
    frame[260:260 + q.shape[0], 250:250 + q.shape[1]] = q

    matches = det.match(frame, 90.0)
    boxes = [(m.x, m.y, det.class_templates[CLASS][m.template_id][0].width,
              det.class_templates[CLASS][m.template_id][0].height)
             for m in matches]
    gray = bgr2gray_u8(frame)
    want = []
    for i in nms_boxes(boxes, [m.similarity for m in matches], 0.0, 0.5):
        m = matches[i]
        ok, score = verify_match_fiducial(
            gray, (m.x, m.y), det.class_templates[CLASS][m.template_id][0],
            fid, 0.8, device="cpu")
        want.append((m.template_id, m.x, m.y,
                     int(np.float32(m.similarity).view(np.int32)),
                     int(np.float32(score).view(np.int32)), ok))

    before = dict(det.counters)
    with recording() as rec:
        got = det.inspect(frame, 90.0, nms=0.5, ccorr=0.8)
    assert _rows(got) == want
    assert {(r.match.template_id, r.passed) for r in got} == {(5, True),
                                                              (2, False)}
    spans = rec.spans
    root = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in root] == ["sbm.inspect"]
    assert spans[root[0]].attrs == {"B": 1, "classes": 1}
    children = {s.name: s for s in spans if s.parent == root[0]}
    assert set(children) == {"sbm.inspect.upload", "sbm.match_batch",
                             "sbm.inspect.nms", "sbm.inspect.gate"}
    assert children["sbm.inspect.upload"].attrs == {
        "bytes": frame.nbytes, "route": "direct"}
    assert children["sbm.inspect.nms"].attrs == {"matches": len(matches),
                                                 "kept": 2}
    assert children["sbm.inspect.gate"].attrs == {"route": "batched",
                                                  "M": 2, "passed": 1}
    delta = {k: det.counters[k] - before.get(k, 0)
             for k in ("inspect.frames", "inspect.gated",
                       "inspect.rejected")}
    assert delta == {"inspect.frames": 1, "inspect.gated": 2,
                     "inspect.rejected": 1}

    # no gate at a CCORR limit of 0
    assert [(r.passed, np.isnan(r.ccorr)) for r in det.inspect(
        frame, 90.0, ccorr=0.0)] == [(True, True)] * 2


def test_gate_crops_are_cached_and_dropped(fid, sweep):
    """The reference crops are built once per template, kept across
    calls, and dropped with the class's other caches, on a new fiducial
    and with new settings."""
    shapes, infos = sweep
    det = _detector(fid, sweep)
    bank = inspect.gate_bank(det)
    assert len(bank.rows) == 12 and bank.fits.all()
    assert inspect.gate_bank(det) is bank
    det.add_template(shapes.src_of(infos[0]), CLASS, shapes.mask_of(infos[0]),
                     infos[0].scale, infos[0].angle)
    assert det._gate_bank is None
    assert len(inspect.gate_bank(det).rows) == 13
    det.set_fiducial(CLASS, fid, template_ids=[12])
    assert det._gate_bank is None
    det.set_fiducial(CLASS, fid[:100, :100])
    assert not inspect.gate_bank(det).fits.any()
    # new settings drop every class and fiducial: nothing left to gate
    det.read_settings(det.write_settings())
    assert det._gate_bank is None and not inspect.gate_bank(det).rows


def test_upload_off_the_card_is_direct(det):
    """Off a card the inspection's upload stages nothing: a C-contiguous
    host frame becomes a tensor over its own memory, and the detector
    keeps no page-locked buffer."""
    frame = np.arange(2 * 30 * 40 * 3, dtype=np.uint8).reshape(2, 30, 40, 3)
    got = inspect._upload(det, frame)
    assert got.data_ptr() == frame.ctypes.data
    assert det._upload_stage is None
