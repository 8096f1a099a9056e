"""Boundaries of the PyTorch port: it never imports JAX, its kernel
wrappers run the plain twins (and count no launch) only for CPU tensors,
and it builds kernels only with nvcc."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.ops.cuda import build
from shape_based_matching_tpu_torch.ops.cuda.coarse import coarse_scores
from shape_based_matching_tpu_torch.ops.cuda.frontend import quant_spread
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
matches = det.match(s.synthetic_shape_image(256, 0), 85.0)  # train image
assert matches[0].template_id == 0 and matches[0].similarity == 100.0
assert "jax" not in sys.modules, "the port imported jax"
print(len(matches))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CPU_MATCH], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) > 0


def test_cpu_tensors_launch_no_kernel():
    kernels = (quant_spread, coarse_scores, refine_windows)
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


def test_wrappers_reject_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises instead of running the plain twin."""
    frames = torch.zeros((1, 32, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        quant_spread(frames, 30.0, 4)
    with pytest.raises(ValueError):
        quant_spread(torch.zeros((1, 32, 32), dtype=torch.int32), 30.0, 4)


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
        "coarse.cu", "frontend.cu", "refine.cu"]
