"""Boundaries of the PyTorch port: it never imports JAX (training,
persistence, the CLI, the utilities, the sharded paths, the examples,
the entry points, the bench and the oracle's copy included, which
need neither
PyYAML nor an image library either), its kernel wrappers run the plain twins (and count no launch)
only for CPU tensors, it builds kernels only with nvcc, and a failed
build of its host helpers raises. The oracle's copy is the JAX package's
file but for its docstring."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.models import native
from shape_based_matching_tpu_torch.ops.cuda import build
from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
from shape_based_matching_tpu_torch.ops.cuda.coarse import (
    coarse_maps, coarse_scores)
from shape_based_matching_tpu_torch.ops.cuda.extract import extract_counted
from shape_based_matching_tpu_torch.ops.cuda.frontend import quant_spread
from shape_based_matching_tpu_torch.ops.cuda.map_refine import map_refine
from shape_based_matching_tpu_torch.ops.cuda.pyramid import (
    linear_memories, pyr_down)
from shape_based_matching_tpu_torch.ops.cuda.refine import refine_windows
from shape_based_matching_tpu_torch.utils import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CPU_MATCH = """
import sys
import numpy as np
from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.utils import synthetic as s
det = Detector(num_features=63, T=(4, 8), device="cpu")
det.class_templates["c"] = s.load_bank_cache(s.bank_cache_path(360, 63))
img = s.synthetic_shape_image(256, 0)
matches = det.match(img, 85.0)  # train image
assert matches[0].template_id == 0 and matches[0].similarity == 100.0
# train, rotate, match two classes in one merged step
assert det.add_template(img, "t", np.full_like(img, 255)) == 0
assert det.add_templates_rotate("t", 0, [90.0, 180.0], (128.0, 128.0)) \
    == [1, 2]
both = det.match(img, 85.0)
assert ("c", "t") in det._merged
top = {(m.class_id, m.template_id) for m in both if m.similarity == 100.0}
assert {("c", 0), ("t", 0)} <= top
# persistence, the CLI and the utilities import neither jax, PyYAML nor
# an image library
import tempfile
from shape_based_matching_tpu_torch import cli, db, get_instance
from shape_based_matching_tpu_torch.utils import (imageio, nms, preprocess,
                                                  timer, verify, viz,
                                                  yaml_io)
d = tempfile.mkdtemp()
det.write_classes(d + "/%s.yaml.gz")
det.save_settings(d + "/detector_linemod.yaml", templates_dir=d)
imageio.save_image(img, d + "/f.png")
again = get_instance(d + "/detector_linemod.yaml", device="cpu")
assert again.match(imageio.load_image(d + "/f.png", gray=True), 85.0) \
    == both
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):
    assert cli.main(["--device", "cpu", "preprocess", "--test-dir", d,
                     "--out-dir", d + "/pre"]) == 0
# the sharded paths and the examples import none of them either
from shape_based_matching_tpu_torch.examples import (deployment_loop,
                                                     multichip_match,
                                                     streaming_match,
                                                     train_rotation_bank)
from shape_based_matching_tpu_torch.parallel import mesh, spatial
sharded = mesh.match_images_sharded(
    det, img[None], 85.0, mesh=mesh.make_mesh(2, devices=["cpu"]),
    class_id="t")
assert sharded[0] == det.match(img, 85.0, ["t"])
# the entry points and the bench import none of them either
from shape_based_matching_tpu_torch import bench, entry
fn, args = entry.entry(8, device="cpu")
assert fn.coarse_route == "packed4" and args[0].shape == (1024, 1024)
# the oracle's copy is NumPy only, and the package has its version
import shape_based_matching_tpu_torch as port
from shape_based_matching_tpu_torch.oracle import reference
assert port.__version__ == "0.1.0" and "__version__" in port.__all__
for name in ("jax", "yaml", "PIL", "cv2"):
    assert name not in sys.modules, f"the port imported {name}"
print(len(matches))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CPU_MATCH], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) > 0


def _body(path: str) -> str:
    """A module's syntax tree without its docstring, as text."""
    with open(path) as f:
        tree = ast.parse(f.read())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


def test_oracle_copy_is_the_jax_oracle():
    """The port's oracle is a copy: its syntax tree equals the JAX
    package's ``oracle/reference.py`` apart from the module docstring,
    and its package's ``__init__.py`` is empty as the JAX one is."""
    jax_dir = os.path.join(ROOT, "shape_based_matching_tpu", "oracle")
    port_dir = os.path.join(ROOT, "shape_based_matching_tpu_torch",
                            "oracle")
    assert _body(os.path.join(port_dir, "reference.py")) == _body(
        os.path.join(jax_dir, "reference.py"))
    for d in (jax_dir, port_dir):
        assert os.path.getsize(os.path.join(d, "__init__.py")) == 0


def test_cpu_tensors_launch_no_kernel():
    kernels = (quant_spread, coarse_scores, refine_windows, chain_scores,
               coarse_maps, map_refine, extract_counted, pyr_down,
               linear_memories)
    before = [fn.launches for fn in kernels]
    det = Detector(num_features=63, T=(4, 8), device="cpu")
    det.class_templates["c"] = synthetic.load_bank_cache(
        synthetic.bank_cache_path(360, 63))[:40]
    scene = synthetic.synthetic_scene(320, 320,
                                      synthetic.synthetic_shape_image(256, 0),
                                      n_instances=1, seed=2)
    matches = det.match_batch(np.stack([scene, scene]), 60.0)
    assert all(matches)
    assert [fn.launches for fn in kernels] == before


def test_detector_defaults_to_the_card():
    """Detector() runs on the card unless the caller asks for the CPU:
    without CUDA the default raises instead of falling back."""
    if torch.cuda.is_available():
        assert Detector().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Detector()
    assert Detector(device="cpu").device.type == "cpu"


def test_wrappers_reject_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises instead of running the plain twin."""
    frames = torch.zeros((1, 32, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        quant_spread(frames, 30.0, 4)
    with pytest.raises(ValueError):
        quant_spread(torch.zeros((1, 32, 32), dtype=torch.int32), 30.0, 4)
    with pytest.raises(ValueError):
        pyr_down(frames)
    with pytest.raises(ValueError):
        linear_memories(frames, 4)
    meta = {"device": "meta", "dtype": torch.int32}
    with pytest.raises(ValueError):
        extract_counted(torch.zeros((1, 3, 16), **meta),
                        torch.zeros((1, 3), **meta), torch.zeros(3, **meta),
                        torch.zeros(3, **meta),
                        torch.zeros(3, device="meta"), 4, 4, 8)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    try:
        build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert not os.path.exists(tmp_path / "kernels")


def test_library_name_follows_sources():
    path = build.library_path()
    assert path.startswith(build.BUILD_DIR)
    assert path == build.library_path()
    assert sorted(os.path.basename(s) for s in build._sources()) == [
        "argmax.cuh", "chain.cu", "coarse.cu", "extract.cu", "frontend.cu",
        "icp.cu", "icp_field.cu", "lmword.cuh", "map_refine.cu", "pyramid.cu",
        "refine.cu"]


def test_host_helper_build_failure_raises(monkeypatch, tmp_path):
    """The training helpers build with the host C++ compiler; a build that
    fails raises with the compiler's message (no silent Python
    fallback)."""
    bad = tmp_path / "host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "host"))
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="host.cpp") as err:
            native.library()
        assert "error" in str(err.value)
        assert not [f for f in os.listdir(tmp_path / "host")
                    if f.endswith(".so")]
    finally:
        native.library.cache_clear()
