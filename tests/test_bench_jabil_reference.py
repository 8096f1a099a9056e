"""The benchmark's plain reference of ddcr's fiducial inspection
(``portbench/reference/jabil.py``) on the CPU: its bank against the
compiled C++ golden, its answer against ``Detector.inspect``'s on a small
seeded BGR frame, and its lower-precision control against both."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import jabil, line2d, training
from shape_based_matching_tpu_torch import ShapeInfoProducer

from .golden_utils import load_json, load_mat


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deployment():
    return harness.load_deployment({"module": "jabil_fiducials"})


@pytest.fixture(scope="module")
def config(deployment):
    return deployment._config()


@pytest.fixture(scope="module")
def fid(deployment, config):
    fid = deployment.fiducial(config)
    assert (fid == load_mat("jabil_fid_img.bin")).all()
    return fid


@pytest.fixture(scope="module")
def bank(fid, config):
    return jabil.train_bank(fid, config)


def test_the_bank_equals_the_cpp_golden(bank, fid, config):
    """Every template of the sweep, geometry and feature set, equals the
    C++ reference's (tests/goldens/jabil_train_templates.json); the
    renders equal the port's producer's."""
    want = [[(t["width"], t["height"], t["tl_x"], t["tl_y"],
              sorted(map(tuple, t["features"]))) for t in tp]
            for tp in load_json("jabil_train_templates.json")["templates"]]
    got = [[(w, h, x, y, sorted(f)) for w, h, x, y, f in tp]
           for tp in training.fingerprint(bank)]
    assert got == want
    shapes = ShapeInfoProducer(fid, angle_range=[0.0, 270.0],
                               angle_step=90.0, scale_range=[0.9, 1.1],
                               scale_step=0.1)
    infos = shapes.produce_infos()
    assert [(i.angle, i.scale) for i in infos] == jabil.poses(config)
    for info in infos:
        assert (jabil.render(fid, info.angle, info.scale)
                == shapes.src_of(info)).all()


def test_the_reference_answers_as_detector_inspect(deployment, config, bank,
                                                   fid):
    """On two seeded 384x640 frames of the deployment's generator (a
    fiducial and an inverted one each), the reference's rows are the
    port's, and its bfloat16 / float32 control's differ."""
    small = dict(config, frame_height=384, frame_width=640)
    traffic = {"api": "inspect", "batch": 1, "pool": 2, "instances": [1],
               "distractors": [1], "check_frames": 2}
    seed = 2 ** 31 + 27
    pool, counts = deployment.frame_pool(small, traffic, seed)
    assert pool.shape == (2, 384, 640, 3) and list(counts) == [1, 1]
    det = deployment.train(small, seed, "cpu")
    assert deployment.fingerprint(det) == training.fingerprint(bank)
    client = deployment.client(det, traffic, pool, 90.0)
    got = [set(map(tuple, client.rows(client(i)[1][0]).tolist()))
           for i in range(2)]
    banks = [line2d.pack_bank(training.level_views(bank, l), "cpu")
             for l in range(2)]
    fid_gray = jabil.bgr2gray(fid)
    want = [jabil.inspect_frame(f, banks, bank, fid_gray, small, "cpu")
            for f in pool]
    assert got == want
    assert all(sorted(r[5] for r in rows) == [0, 1] for rows in want)
    low = [jabil.inspect_frame(f, banks, bank, fid_gray, small, "cpu",
                               lower=True) for f in pool]
    assert low != want


def test_the_gate_pieces():
    """The gate's arithmetic: a flat crop normalizes to zeros and scores
    0, a rect past the fiducial or the frame gives (False, 0.0), and the
    fixed-point gray conversion."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, size=(30, 40)).astype(np.uint8)
    assert jabil.ccorr_normed(jabil.normalize_minmax(a),
                              jabil.normalize_minmax(a)) == 1.0
    flat = jabil.normalize_minmax(np.full((30, 40), 9, np.uint8))
    assert not flat.any() and jabil.ccorr_normed(flat, flat) == 0.0
    templ = {"tl_x": 2, "tl_y": 2, "width": 30, "height": 30}
    fid = rng.integers(0, 256, size=(40, 40)).astype(np.uint8)
    frame = rng.integers(0, 256, size=(100, 100)).astype(np.uint8)
    assert jabil.gate(frame, 71, 0, templ, fid, 0.0, 1.0, 0.8) == (False,
                                                                    0.0)
    assert jabil.gate(frame, 0, 0, templ, fid[:20], 0.0, 1.0, 0.8) == (
        False, 0.0)
    assert jabil.gate(frame, 70, 70, templ, fid, 0.0, 1.0, 0.8)[1] > 0.0
    bgr = np.array([[[255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 9, 9]]],
                   np.uint8)
    assert jabil.bgr2gray(bgr).tolist() == [[29, 150, 76, 9]]
