"""On the card (marker ``cuda``; skips without one): a tiny cell runs on
the device path and proves correct, and the control fails there too.

    python3 -m pytest portbench/tests/test_bench_card.py -o addopts= -q
"""

import time

import pytest
import torch

from portbench import control, harness

from .conftest import SEED


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.b1", "tiny.b2"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_on_the_card(tiny_root, cell, trace):
    _card()
    r = harness.run(cell, SEED, 0.5, bool(trace), time.perf_counter(),
                    device="cuda", root=tiny_root)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    if trace:
        assert r["device"]["busy_s"] > 0
        assert 0 < r["metrics"]["device_idle_pct"]["value"] < 100
        for name in ("pyramid_roofline_pct", "coarse_roofline_pct",
                     "refine_roofline_pct"):
            assert 0 < r["metrics"][name]["value"] <= 100


@pytest.mark.cuda
def test_the_control_fails_on_the_card(tiny_root):
    _card()
    r = control.control_readings("tiny.b1", SEED, "cuda", tiny_root)
    assert r["list_mismatch"] > 0 and r["bank_mismatch"] > 0
