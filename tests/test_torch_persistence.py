"""Persistence in the PyTorch port against the JAX package: class and
settings files, the port's own YAML reader, the detector singleton.

The files' decompressed texts are identical between the packages, each
package reads the other's files into equal templates (``theta`` is not
stored: 0 after a read), and the port's reader gives what PyYAML's
CSafeLoader gives through the JAX package's ``load_opencv_yaml``, value
for value and type for type. A round trip through a model directory
leaves a match list bitwise and the ICP poses exactly as they were:
matching and ICP read only x, y and label.
"""

import gzip
import re
import sys

import numpy as np
import pytest
import torch
import yaml

from shape_based_matching_tpu import Detector as JDetector
from shape_based_matching_tpu.utils.yaml_io import (
    dump_opencv_yaml as jdump, load_opencv_yaml as jload)
from shape_based_matching_tpu_torch import (Detector, get_instance,
                                            refine_matches_icp,
                                            reset_instance)
from shape_based_matching_tpu_torch.models import detector as tdetector
from shape_based_matching_tpu_torch.utils import synthetic as tsyn
from shape_based_matching_tpu_torch.utils.yaml_io import (
    load_opencv_yaml, parse_opencv_yaml)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bank():
    """The rot360x63 snapshot, with the fork's metadata set per template
    so that every field is written."""
    pyr = tsyn.load_bank_cache(tsyn.bank_cache_path(360, 63))
    for i, tp in enumerate(pyr):
        for t in tp:
            t.sscale = 1.0 if i % 3 else 0.9960000038146973
            t.orientation = float(i) - 0.5
            t.tag_field_id = i % 5
            t.fiducial_src = f'/models/fid {i}.png' if i % 2 else 'q"x\\y'
    return pyr


def _copy(pyramids, module):
    """The same pyramids as the other package's dataclasses."""
    return [[module.Template(
        width=t.width, height=t.height, tl_x=t.tl_x, tl_y=t.tl_y,
        pyramid_level=t.pyramid_level, sscale=t.sscale,
        orientation=t.orientation, tag_field_id=t.tag_field_id,
        fiducial_src=t.fiducial_src,
        features=[module.Feature(f.x, f.y, f.label, f.theta)
                  for f in t.features]) for t in tp] for tp in pyramids]


def _fields(pyramids):
    return [(t.width, t.height, t.tl_x, t.tl_y, t.pyramid_level, t.sscale,
             t.orientation, t.tag_field_id, t.fiducial_src,
             [(f.x, f.y, f.label, f.theta) for f in t.features])
            for tp in pyramids for t in tp]


def _same(a, b) -> bool:
    """Equal values of equal types, recursively, dict order included."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _csafe(path):
    """PyYAML's reading of a file, as the JAX package's loader applies
    it (asserted to be that loader's result)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = re.sub(r"^%YAML:[\d.]+\s*\n", "", f.read())
    doc = yaml.load(text.replace("!!opencv-matrix", ""),
                    Loader=yaml.CSafeLoader)
    assert _same(doc, jload(path))
    return doc


def _write_both(bank, tmp_path):
    """The bank written by each package as a model directory: (JAX dir,
    port dir)."""
    from shape_based_matching_tpu.models import template as jtemplate
    from shape_based_matching_tpu_torch.models import template as ttemplate

    dirs = []
    for name, cls, module in (("jax", JDetector, jtemplate),
                              ("port", None, ttemplate)):
        d = tmp_path / name
        det = (cls(num_features=63, T=(4, 8)) if cls
               else Detector(num_features=63, T=(4, 8), device="cpu"))
        det.class_templates["bench"] = _copy(bank, module)
        det.class_templates["two"] = _copy(bank[:2], module)
        det.write_classes(str(d / "%s.yaml.gz"))
        det.save_settings(str(d / "detector_linemod.yaml"),
                          templates_dir=str(tmp_path / "models"),
                          classes=["bench", "two"])
        dirs.append(d)
    return dirs


def _text(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return f.read()


def test_files_equal_jax_and_read_across(bank, tmp_path):
    """Identical decompressed texts; each package reads the other's
    files into templates equal field for field (theta 0 after a read);
    the port's reader equals CSafeLoader on them."""
    jdir, pdir = _write_both(bank[:120], tmp_path)
    for f in ("bench.yaml.gz", "two.yaml.gz", "detector_linemod.yaml"):
        assert _text(str(jdir / f)) == _text(str(pdir / f)), f
        assert _same(load_opencv_yaml(str(pdir / f)),
                     _csafe(str(pdir / f))), f

    want = _fields([[_notheta(t) for t in tp] for tp in bank[:120]])
    port = Detector.load_settings(str(jdir / "detector_linemod.yaml"),
                                  device="cpu")
    port.read_classes(["bench", "two"], str(jdir / "%s.yaml.gz"))
    jax = JDetector.load_settings(str(pdir / "detector_linemod.yaml"))
    jax.read_classes(["bench", "two"], str(pdir / "%s.yaml.gz"))
    assert _fields(port.class_templates["bench"]) == want
    assert _fields(jax.class_templates["bench"]) == want
    assert port.class_ids() == jax.class_ids() == ["bench", "two"]
    assert (port.T_at_level, port.weak_threshold, port.num_features,
            port.strong_threshold) == (jax.T_at_level, jax.weak_threshold,
                                       jax.num_features,
                                       jax.strong_threshold)


DOC = {
    "class_id": "shape",
    "pyramid_levels": 2,
    "T": [4, 8],
    "weak_threshold": 30.0,
    "neg": -1.0,
    "negs": [-0.5, -3.0, -7],
    "scale": 0.9960000038146973,
    "tiny": 1e-05,
    "big": 1e+16,
    "note": 'quote"and\\slash',
    "colon": "C:/dir #1/[a], {b}",
    "path": "/x/y z.png",
    "empty": "",
    "empty_list": [],
    "empty_map": {},
    "strings": ["s", "", 'q"x', "-1x"],
    "template_pyramids": [
        {"template_id": 0,
         "templates": [
             {"width": 16, "tl_x": -3, "pyramid_level": 0,
              "features": [[0, 1, 2], [15, 23, 7], [-1, 0, 0]]},
             {"features": []},
         ]},
    ],
}

HAND_WRITTEN = """%YAML:1.0
---
# a comment line
T: [ 4,
     8 ]
plain: some words
quoted: "a \\"b\\" c"
empty_value:
seq:
   - 1
   - -2.5e-03
   -
      k: v
   - [  ]
"""


@pytest.mark.parametrize("case", ["dict", "hand_written"])
def test_reader_equals_csafeloader(case, tmp_path):
    path = str(tmp_path / "doc.yaml")
    if case == "dict":
        jdump(DOC, path)
    else:
        with open(path, "w") as f:
            f.write(HAND_WRITTEN)
    got = load_opencv_yaml(path)
    assert _same(got, _csafe(path))
    if case == "dict":
        # the writer's own round trip: {} comes back as None, 1e-05 and
        # 1e+16 as strings, in PyYAML and here alike
        assert got["empty_map"] is None and got["tiny"] == "1e-05"


@pytest.mark.parametrize("text,line", [
    ("a: yes", 1), ("a: 0x1F", 1), ("a: 1_000", 1), ("a: ~", 1),
    ("a: 2020-01-01", 1), ("a: 'x'", 1), ('a: "\\n"', 1), ("a: !!str x", 1),
    ("a: [ [1, 2] ]", 1), ("a:\n   - b: 1", 2), ("a: b # c", 1),
    ("on: 1", 1), ("a: [ 1, 2, ]", 1), ("a: .5", 1), ("a:\n- 1", 2),
    ("a: 1\n     b: 2", 2), ("a: [ 1, 2", 1), ("a:\tb", 1),
])
def test_reader_raises_outside_the_subset(text, line):
    with pytest.raises(ValueError, match=rf"^<text>:{line}: "):
        parse_opencv_yaml(text)


def test_reader_needs_no_pyyaml(bank, tmp_path, monkeypatch):
    """With PyYAML, PIL and cv2 hidden, a model directory and a PNG frame
    still load."""
    from shape_based_matching_tpu_torch.cli import load_registry_detector
    from shape_based_matching_tpu_torch.utils import imageio

    det = Detector(num_features=63, T=(4, 8), device="cpu")
    det.class_templates["bench"] = bank[:3]
    det.write_classes(str(tmp_path / "%s.yaml.gz"))
    det.save_settings(str(tmp_path / "detector_linemod.yaml"))
    frame = tsyn.synthetic_shape_image(64, 1)
    for name in ("yaml", "PIL", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    imageio.save_image(frame, str(tmp_path / "f.png"))
    loaded = load_registry_detector(str(tmp_path), device="cpu")
    assert _fields(loaded.class_templates["bench"]) == _fields(
        [[_notheta(t) for t in tp] for tp in bank[:3]])
    assert (imageio.load_image(str(tmp_path / "f.png"), gray=True)
            == frame).all()


def _notheta(t):
    from shape_based_matching_tpu_torch.models.template import (Feature,
                                                                Template)

    return Template(t.width, t.height, t.tl_x, t.tl_y, t.pyramid_level,
                    [Feature(f.x, f.y, f.label) for f in t.features],
                    t.sscale, t.orientation, t.tag_field_id, t.fiducial_src)


def test_get_instance_and_cache_drops(bank, tmp_path):
    """get_instance loads the settings' classes once; reset_instance
    starts over; read_class and read_settings drop every cache that held
    the class."""
    det = Detector(num_features=63, T=(4, 8), device="cpu")
    det.class_templates["a"] = bank[:40]
    det.class_templates["b"] = bank[40:80]
    det.write_classes(str(tmp_path / "%s.yaml.gz"))
    path = str(tmp_path / "detector_linemod.yaml")
    det.save_settings(path, templates_dir=str(tmp_path))
    reset_instance()
    try:
        with pytest.raises(FileNotFoundError):
            get_instance(str(tmp_path / "missing.yaml"), device="cpu")
        inst = get_instance(path, device="cpu")
        assert get_instance() is inst and inst.device.type == "cpu"
        assert inst.class_ids() == ["a", "b"]
        assert len(inst.class_templates["b"]) == 40
        reset_instance()
        assert get_instance(path, device="cpu") is not inst
    finally:
        reset_instance()
    assert tdetector._instance is None

    scene = tsyn.synthetic_shape_image(256, 0)
    det.match(scene, 80.0)
    det.match(scene, 80.0, ["a"])
    refine_matches_icp(det, scene, det.match(scene, 95.0, ["a"])[:1])
    assert ("a", "b") in det._banks and "a" in det._banks and det._icp_pts
    det.read_class(load_opencv_yaml(str(tmp_path / "a.yaml.gz")))
    assert "a" not in det._banks and ("a", "b") not in det._merged
    assert not any(k[0] in ("a", ("a", "b")) for k in det._chain_plans)
    assert not det._icp_pts
    det.match(scene, 80.0, ["b"])
    det.read_settings(load_opencv_yaml(path))
    assert not det.class_templates and not det._banks


def test_round_trip_keeps_matches_and_poses(bank, tmp_path):
    """A 256^2 match list (bitwise) and the ICP poses of its matches
    (exactly) are the same from memory and from a model directory."""
    det = Detector(num_features=63, T=(4, 8), device="cpu")
    det.class_templates["bench"] = bank[:90]
    det.write_classes(str(tmp_path / "%s.yaml.gz"))
    det.save_settings(str(tmp_path / "detector_linemod.yaml"),
                      templates_dir=str(tmp_path))
    # the bank's training image turned a quarter: its 89-degree template
    # and its neighbours match
    scene = np.ascontiguousarray(np.rot90(tsyn.synthetic_shape_image(256, 0)))
    reset_instance()
    try:
        loaded = get_instance(str(tmp_path / "detector_linemod.yaml"),
                              device="cpu")
    finally:
        reset_instance()

    def run(d):
        ms = d.match(scene, 60.0)
        poses = refine_matches_icp(d, scene, ms[:6])
        return ([(m.template_id, m.x, m.y,
                  np.float32(m.similarity).view(np.int32)) for m in ms],
                [(r["tx"], r["ty"], r["dtheta_deg"], r["dscale"],
                  r["valid"]) for r in poses])

    want = run(det)
    assert want[0] and want[1]
    assert run(loaded) == want
