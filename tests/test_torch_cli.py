"""The PyTorch port's command line (``--device cpu``) against the JAX
package's, on the inputs of the JAX package's own CLI and DB tests.

Both CLIs run in one process on the same files. Their printed lines are
equal apart from the ``[match ... ms]`` field and the directories the
lines name; the files they write are equal: the class and settings
texts, the registry, the annotations and CLAHE previews pixel for pixel,
the CSV header. ``--icp`` poses agree within the production tolerance
of ``PERF.md`` section 2 (|d x|, |d y| < 1e-2 px, |d dtheta| < 1e-3
degree, |d dscale| < 1e-4) plus half a unit of the printed digits.
"""

import contextlib
import gzip
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from shape_based_matching_tpu.cli import main as jmain
from shape_based_matching_tpu.db import TagDB, make_fiducial_geo
from shape_based_matching_tpu.models import detector as jdetector
from shape_based_matching_tpu_torch.cli import main as tmain
from shape_based_matching_tpu_torch.models import detector as tdetector
from shape_based_matching_tpu_torch.utils.imageio import (load_image,
                                                          save_image)
from shape_based_matching_tpu_torch.utils.synthetic import (
    synthetic_scene, synthetic_shape_image)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MS = re.compile(r"\[match [0-9.]+ ms\]")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _both(tmp_path, commands):
    """Run each command with the JAX CLI in tmp/jax and the port's in
    tmp/port ({dir} in an argument names that directory); returns the
    printed lines of each, with the directory written as {dir} and the
    match time dropped."""
    out = {}
    for name, main, pre in (("jax", jmain, []),
                            ("port", tmain, ["--device", "cpu"])):
        d = str(tmp_path / name)
        os.makedirs(d, exist_ok=True)
        lines = []
        for argv in commands:
            lines += _run(main, pre + [a.replace("{dir}", d) for a in argv])
        out[name] = [MS.sub("[match]", l.replace(d, "{dir}"))
                     for l in lines]
    return out["jax"], out["port"]


def _text(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return f.read()


def _same_files(tmp_path, names):
    for f in names:
        a, b = str(tmp_path / "jax" / f), str(tmp_path / "port" / f)
        if f.endswith(".png"):
            assert (load_image(a) == load_image(b)).all(), f
        else:
            ta = _text(a).replace(str(tmp_path / "jax"), "{dir}")
            tb = _text(b).replace(str(tmp_path / "port"), "{dir}")
            assert ta == tb, f


_ICP = re.compile(r" icp\[x=(\S+) y=(\S+) dtheta=(\S+) dscale=(\S+) "
                  r"rmse=(\S+)\]")
# production tolerance + half a unit of the printed digits
_ICP_TOL = (0.01 + 0.005, 0.01 + 0.005, 1e-3 + 5e-4, 1e-4 + 5e-5, 0.01)


def _split_icp(lines):
    """(lines without their icp[...] fields, the fields as floats)."""
    poses = [[float(v) for v in m.groups()] for l in lines
             for m in [_ICP.search(l)] if m]
    return [_ICP.sub(" icp[]", l) for l in lines], poses


def test_train_and_match_equal_jax(tmp_path):
    """tests/test_cli.py's train-and-match, with --icp: equal lines
    (poses within the tolerance) and equal files."""
    templ = synthetic_shape_image(128, seed=0)
    scene = synthetic_scene(256, 256, templ, n_instances=2, seed=5)
    save_image(templ, str(tmp_path / "templ.png"))
    os.makedirs(tmp_path / "frames")
    save_image(scene, str(tmp_path / "frames" / "scene.png"))
    # a second frame in color (without --gray the first is read as BGR
    # too, its three channels equal)
    save_image(np.stack([scene, scene, 255 - scene], -1),
               str(tmp_path / "frames" / "scene_bgr.png"))
    jax, port = _both(tmp_path, [
        ["train", "--model-dir", "{dir}/models", "--class-id", "shape",
         "--image", str(tmp_path / "templ.png"), "--angles", "0,90",
         "--scales", "1.0", "--num-features", "48", "--gray"],
        ["match", "--model-dir", "{dir}/models", "--test-dir",
         str(tmp_path / "frames"), "--threshold", "80", "--csv",
         "{dir}/timings.csv", "--annotate", "{dir}/out", "--icp"],
    ])
    jl, jposes = _split_icp(jax)
    pl, pposes = _split_icp(port)
    assert pl == jl
    assert any("after NMS/verify" in l for l in pl) and len(pposes) >= 2
    assert len(pposes) == len(jposes)
    for p, j in zip(pposes, jposes):
        assert all(abs(a - b) <= t for a, b, t in zip(p, j, _ICP_TOL)), (p, j)
    _same_files(tmp_path, ["models/shape.yaml.gz",
                           "models/detector_linemod.yaml",
                           "models/registry.json", "models/shape.fid.png",
                           "out/scene.png.match.png",
                           "out/scene_bgr.png.match.png"])
    for name in ("jax", "port"):
        with open(tmp_path / name / "timings.csv") as f:
            assert f.read().startswith("stat,MATCH,NMS,VERIFY")


def test_train_sweep_and_verify(tmp_path):
    """A sweep over several scales (which the JAX CLI cannot stack)
    trains as add_template per render would, and match --verify-ccorr
    gates with the stored fiducial; --debug writes its dumps."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.shape_info import (
        ShapeInfoProducer)

    templ = synthetic_shape_image(96, seed=4)
    save_image(templ, str(tmp_path / "templ.png"))
    md = str(tmp_path / "models")
    _run(tmain, ["--device", "cpu", "train", "--model-dir", md,
                 "--class-id", "s", "--image", str(tmp_path / "templ.png"),
                 "--angles", "0,90", "--scales", "0.9:1.1:0.1",
                 "--num-features", "32", "--gray"])
    det = Detector(num_features=32, device="cpu")
    full = np.full(templ.shape, 255, np.uint8)
    for scale in (0.9, 1.0, 1.1):
        for angle in (0.0, 90.0):
            det.add_template(ShapeInfoProducer.transform(templ, angle, scale),
                             "s", ShapeInfoProducer.transform(full, angle,
                                                              scale),
                             sscale=scale, orientation=angle,
                             fiducial_src=os.path.join(md, "s.fid.png"))
    det.write_classes(str(tmp_path / "%s.yaml.gz"))
    assert _text(os.path.join(md, "s.yaml.gz")) == _text(
        str(tmp_path / "s.yaml.gz"))

    os.makedirs(tmp_path / "frames")
    save_image(synthetic_scene(192, 192, templ, n_instances=1, seed=2),
               str(tmp_path / "frames" / "f.png"))
    lines = _run(tmain, ["--device", "cpu", "match", "--model-dir", md,
                         "--test-dir", str(tmp_path / "frames"),
                         "--threshold", "80", "--verify-ccorr", "0.8",
                         "--gray", "--debug", "--annotate",
                         str(tmp_path / "out")])
    assert re.match(r"f.png: \d+ matches, [1-9]\d* after NMS/verify",
                    lines[0])
    assert os.path.isfile(tmp_path / "out" / "f.png.quant.png")
    assert os.path.isfile(tmp_path / "out" / "f.png.resp7.png")


def _tag_db(d, fid_shape):
    model_img = np.zeros((192, 192), np.uint8)
    model_img[32:128, 48:144] = fid_shape
    model_path = os.path.join(d, "tag_model.png")
    save_image(model_img, model_path)
    db = TagDB(os.path.join(d, "tags.sqlite"))
    db.add_tag_field(3, "field0", 3)
    db.add_tag_model(42, "m42", model_path, [
        (3, make_fiducial_geo(48 / 192, 32 / 192, 96 / 192, 96 / 192,
                              (192, 192)))])
    db.close()
    return db.path


def test_db_train_and_match_equal_jax(tmp_path):
    """tests/test_db.py's train-db -> match-db, each CLI on its own copy
    of the tag database: equal lines and files."""
    fid_shape = synthetic_shape_image(96, seed=0)
    os.makedirs(tmp_path / "frames")
    save_image(synthetic_scene(256, 256, fid_shape, n_instances=2, seed=5),
               str(tmp_path / "frames" / "scene.png"))
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
        _tag_db(str(tmp_path / name), fid_shape)
    # both CLIs' match-db bootstraps its package's detector singleton:
    # start from none and leave none for the next test of the worker
    jdetector.reset_instance()
    tdetector.reset_instance()
    try:
        jax, port = _both(tmp_path, [
            ["train-db", "--db", "{dir}/tags.sqlite", "--model-dir",
             "{dir}/model_images", "--num-features", "48", "--weak", "30",
             "--strong", "60", "--angles", "0", "--scales", "1.0"],
            ["match-db", "--db", "{dir}/tags.sqlite", "--model-dir",
             "{dir}/model_images", "--test-dir", str(tmp_path / "frames"),
             "--threshold", "80", "--verify-ccorr", "0.5", "--csv",
             "{dir}/t.csv", "--annotate", "{dir}/out", "--gray"],
        ])
    finally:
        jdetector.reset_instance()
        tdetector.reset_instance()
    assert port == jax
    assert any(l.startswith("  model=m42 class=42") for l in port)
    _same_files(tmp_path, ["model_images/42.yaml.gz",
                           "model_images/detector_linemod.yaml",
                           "tag_model.3.png", "out/scene.png.match.png"])
    for name in ("jax", "port"):
        with open(tmp_path / name / "t.csv") as f:
            assert f.read().startswith("stat,MATCH,NMS,HCORR")


def _golden(name):
    with gzip.open(os.path.join(GOLDENS, name + ".gz"), "rb") as f:
        h, w, c = np.frombuffer(f.read(12), np.int32)
        data = np.frombuffer(f.read(), np.uint8).reshape(h, w, c)
    return data[..., 0] if c == 1 else data


def test_preprocess_equals_jax_and_goldens(tmp_path):
    """preprocess writes JAX's previews; the port's equalizeHist and
    CLAHE equal the compiled OpenCV goldens (he_*)."""
    from shape_based_matching_tpu_torch.utils.preprocess import (
        clahe, equalize_hist)

    for line in open(os.path.join(GOLDENS, "he_manifest.txt")):
        n, clip, tx, ty = line.split()
        src = _golden(f"he_src_{int(n):03d}.bin")
        assert (equalize_hist(src)
                == _golden(f"he_eq_{int(n):03d}.bin")).all(), n
        assert (clahe(src, float(clip), (int(tx), int(ty)))
                == _golden(f"he_cl_{int(n):03d}.bin")).all(), n

    rng = np.random.RandomState(0)
    os.makedirs(tmp_path / "in")
    save_image((rng.rand(70, 90, 3) * 255).astype(np.uint8),
               str(tmp_path / "in" / "a.png"))
    save_image((rng.rand(64, 48) * 255).astype(np.uint8),
               str(tmp_path / "in" / "b.png"))
    for mode in ("clahe", "eqhist"):
        jax, port = _both(tmp_path, [
            ["preprocess", "--test-dir", str(tmp_path / "in"), "--out-dir",
             "{dir}/" + mode, "--mode", mode]])
        assert [l.split(":")[0] for l in port] == \
            [l.split(":")[0] for l in jax]
        _same_files(tmp_path, [f"{mode}/a.png.preproc.png",
                               f"{mode}/b.png.preproc.png"])


def test_demo_case2_synthetic(tmp_path):
    """tests/test_cli.py's demo case2 on the port: train with a coarse
    angle step, then match + NMS."""
    pytest.importorskip("PIL")
    templ = synthetic_shape_image(96, seed=3)
    scene = synthetic_scene(256, 256, templ, n_instances=2, seed=9)
    case = tmp_path / "case2"
    case.mkdir()
    save_image(templ, str(case / "train.png"))
    save_image(scene, str(case / "test.png"))
    _run(tmain, ["--device", "cpu", "demo", "case2", "--data", str(tmp_path),
                 "--out", str(case), "--mode", "train", "--angle-step", "90",
                 "--gray"])
    assert os.path.exists(case / "test_templ.yaml")
    assert os.path.exists(case / "test_info.yaml")
    out = tmp_path / "out"
    _run(tmain, ["--device", "cpu", "demo", "case2", "--data", str(tmp_path),
                 "--out", str(out), "--threshold", "60", "--gray"])
    assert os.path.exists(out / "case2_result.png")
    with open(out / "case2_matches.json") as f:
        rows = json.load(f)
    assert rows and all(r["similarity"] >= 60 for r in rows)


def test_info_and_trace_on_cpu(tmp_path):
    lines = _run(tmain, ["--device", "cpu", "--trace", str(tmp_path / "tr"),
                         "info", "--size", "512x512", "--templates", "16",
                         "--dispatch"])
    text = "\n".join(lines)
    for key in ("torch version:", "CUDA kernels:", "host helpers:",
                "frontend level 0:", "coarse.cu:", "chain planner:",
                "refine.cu:", "dispatch audit"):
        assert key in text, key
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _run(tmain, ["info", "--templates", "4"])
