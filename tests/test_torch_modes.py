"""The port's Detector on every input mode against the JAX package.

Port ``Detector(device="cpu")`` (every kernel wrapper runs its plain twin)
against the JAX ``Detector(use_pallas=False)`` on the same template
pyramids and frames, at 256x256 with at most 8 templates: BGR color
frames, uint8 masks, 16 orientations and a wide bank (more than 256
feature slots at level 0). Match lists compare as (template_id, x, y,
similarity float32 bits), exactly. The 16-orientation color path is also
held to the compiled C++ experiment's match list
(tests/goldens/case16_matches.json) under the contract of
tests/test_golden_16ori.py.
"""

import numpy as np
import pytest

from shape_based_matching_tpu import Detector as JaxDetector
from shape_based_matching_tpu.utils import synthetic as jsyn
from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.models.template import Feature, Template
from shape_based_matching_tpu_torch.utils import synthetic as tsyn
from .golden_utils import load_json, load_mat
from .test_golden_16ori import _assert_match_parity

THRESHOLD = 65.0


def _keys(matches):
    return [(m.template_id, m.x, m.y,
             int(np.float32(m.similarity).view(np.uint32)))
            for m in matches]


def _pair(pyramids, num_features, n_ori):
    jdet = JaxDetector(num_features=num_features, T=(4, 8),
                       num_orientations=n_ori, use_pallas=False)
    det = Detector(num_features=num_features, T=(4, 8),
                   num_orientations=n_ori, device="cpu")
    jdet.class_templates["bench"] = det.class_templates["bench"] = pyramids
    return jdet, det


@pytest.fixture(scope="module")
def banks():
    """Three (JAX, port) detector pairs and the gray frame each matches:
    8 rotations of the committed 8- and 16-orientation banks on their
    training image, and a live-trained wide bank (4 rotations of 160-pixel
    block noise, 312 slots at level 0, 114 at the coarse level) on a
    scene of it."""
    shape = tsyn.synthetic_shape_image(256, 0)
    out = {}
    for n_ori in (8, 16):
        pyr = tsyn.load_bank_cache(tsyn.bank_cache_path(360, 63,
                                                        n_ori=n_ori))[:8]
        out[f"ori{n_ori}"] = (*_pair(pyr, 63, n_ori), shape)
    jdet, templ = jsyn.build_rotated_detector(num_templates=4,
                                              num_features=300, size=160,
                                              dense=True)
    pyr = jdet.class_templates["bench"]
    assert len(pyr[0][0].features) > 256
    out["wide"] = (*_pair(pyr, 300, 8),
                   jsyn.synthetic_scene(256, 256, templ, n_instances=1,
                                        seed=11))
    return out


def _bgr(f):
    return np.stack([f, np.roll(f, 1, axis=1), 255 - f], axis=-1)


def _mask(seed, h, w):
    return ((np.random.RandomState(seed).rand(h, w) > 0.25) * 255
            ).astype(np.uint8)


@pytest.mark.parametrize("bank,color,masked", [
    ("ori8", True, False), ("ori16", False, False), ("ori16", True, True),
    ("wide", False, True),
])
def test_match_equals_jax(banks, bank, color, masked):
    jdet, det, gray = banks[bank]
    frame = _bgr(gray) if color else gray
    mask = _mask(4, *gray.shape) if masked else None
    want = jdet.match(frame, THRESHOLD, mask=mask)
    got = det.match(frame, THRESHOLD, mask=mask)
    assert len(got) > 0
    assert _keys(got) == _keys(want)


def test_match_batch_masks_equal_jax(banks):
    """Two masked color frames in one batch, each with its own mask."""
    jdet, det, gray = banks["ori8"]
    frames = np.stack([_bgr(gray), _bgr(np.roll(gray, (8, 16), (0, 1)))])
    masks = np.stack([_mask(4, 256, 256), _mask(5, 256, 256)])
    want = jdet.match_batch(frames, THRESHOLD, masks=masks)
    got = det.match_batch(frames, THRESHOLD, masks=masks)
    assert all(got)
    assert [_keys(g) for g in got] == [_keys(w) for w in want]


def test_mode_arguments_are_checked(banks):
    _, det, gray = banks["ori8"]
    with pytest.raises(ValueError):
        det.match(gray.astype(np.int32), THRESHOLD)
    with pytest.raises(ValueError):
        det.match(gray, THRESHOLD, mask=_mask(4, 128, 128))
    with pytest.raises(ValueError):
        Detector(num_orientations=12, device="cpu")


def test_case16_equals_compiled_golden():
    """The compiled 16-orientation experiment's trained templates on its
    464x592 BGR test frame (weak 10, strong 55, threshold 30)."""
    det = Detector(num_features=63, T=(4, 8), weak_threshold=10.0,
                   strong_threshold=55.0, num_orientations=16, device="cpu")
    det.class_templates["test"] = [
        [Template(width=t["width"], height=t["height"], tl_x=t["tl_x"],
                  tl_y=t["tl_y"], pyramid_level=t["pyramid_level"],
                  features=[Feature(x, y, lb) for x, y, lb in t["features"]])
         for t in tp]
        for tp in load_json("case16_train_templates.json")["templates"]]
    img = load_mat("case16_img.bin")
    assert img.shape == (464, 592, 3)
    want = load_json("case16_matches.json")["matches"]
    assert len(want) >= 50
    _assert_match_parity(det.match(img, 30.0, ["test"]), want)
