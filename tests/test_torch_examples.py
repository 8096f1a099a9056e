"""The port's runnable examples (``shape_based_matching_tpu_torch/
examples/``) at ``tests/test_examples.py``'s small sizes, on the CPU: each
``main`` runs, prints the JAX examples' lines and writes their files."""

import contextlib
import io
import os

import pytest
import torch

from shape_based_matching_tpu_torch.examples import (deployment_loop,
                                                     multichip_match,
                                                     streaming_match,
                                                     train_rotation_bank)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stdout(fn, *args, **kw) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def test_train_rotation_bank_example(tmp_path):
    lines = _stdout(train_rotation_bank.main, str(tmp_path),
                    angle_step=45.0, size=128, device="cpu")
    assert lines == [f"9 templates -> {tmp_path}"]  # 0, 45, ..., 360
    for name in ("part.yaml.gz", "detector_linemod.yaml", "infos.yaml"):
        assert os.path.exists(tmp_path / name)


def test_multichip_example_round_robin_shards():
    lines = _stdout(multichip_match.main, 4, device="cpu")
    assert lines[0] == "mesh: {'data': 2, 'templ': 2}"
    assert len(lines) == 3
    assert all(l.endswith("matches — sharded == single-device")
               for l in lines[1:])


def test_deployment_loop_example():
    lines = _stdout(deployment_loop.main, n_frames=1, num_templates=24,
                    hw=256, device="cpu")
    assert lines[0].startswith("parity ok: top pose")
    assert [l.split()[0] for l in lines[1:]] == ["2-sync", "1-sync",
                                                 "pipelined",
                                                 "device-complete"]


def test_streaming_match_example():
    lines = _stdout(streaming_match.main, n_batches=2, batch=2,
                    num_templates=8, hw=512, device="cpu")
    assert lines[0].startswith("batch 0:") and "detections" in lines[0]
    assert lines[2] == "stat,BATCH_MS,FPS,DETECTIONS"
    assert lines[-1].startswith("mean,")
