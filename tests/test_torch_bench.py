"""The port's bench harness (``shape_based_matching_tpu_torch/bench.py``)
against the JAX package's ``bench.py``: the same contract as
``tests/test_bench_harness.py`` and ``tests/test_bench_detail_complete.py``
(the primary line first and alone on stdout, the detail rewritten with
failures under ``skipped``, the budget), the same metric table less the
TPU-only packed2 metric, and the same detail keys and rounding.

No card: the metrics are stubbed in-process, and the one subprocess runs
``case1``, which is None without the reference checkout."""

import ast
import io
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as jbench  # noqa: E402  (the JAX bench: json and time only)

from shape_based_matching_tpu_torch import bench  # noqa: E402

PACKED2 = "wide1000x256_packed2"

# one finished value per metric, as a metric subprocess hands it over
VALS = {
    "e2e1000": 2.71828, "e2e360": 2.04567, "e2e10000": 5.55555,
    "masked360": [2.33333, 2.11111], "fps_b8": 555.55,
    "match1000x128": [3.14159, 63, "packed4"],
    "wide8191": [2.5, 3073, "wide"], "wide1000x256": [4.25, 142, "wide"],
    "e2e360_16ori": 2.75, "train_sweep": [700.123, 0.18],
    "bank_build_10k": 1.23456, "icp_refine": 4.4444,
    "production_batch": 50.5, "production_onecall": 30.3,
    "production_stream": 20.2, "production_device": 7.7777,
    "case1": [2.8, {"exec_total": 2}, "wide"],
}


@pytest.fixture
def stub_bench(monkeypatch, tmp_path):
    """Instant stub metrics, run in this process on the CPU, the detail
    written under tmp."""
    def _boom(device):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "_METRICS", {
        "e2e1000": lambda device: 2.5,
        "e2e360": lambda device: 2.0,
        "failing": _boom,
    })
    monkeypatch.setattr(bench, "_DETAIL_ORDER",
                        [("e2e360", 1), ("failing", 1)])
    return tmp_path / "detail.json"


def _run_main(monkeypatch, detail):
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    bench.main(["--device", "cpu", "--in-process", "--detail", str(detail)])
    return out.getvalue()


def test_primary_line_is_first_and_only_stdout(stub_bench, monkeypatch):
    lines = _run_main(monkeypatch, stub_bench).strip().splitlines()
    assert len(lines) == 1, f"stdout must be exactly one line: {lines}"
    rec = json.loads(lines[0])
    assert rec == {"metric": "match_1024x1024_1000templates_e2e_ms",
                   "value": 2.5, "unit": "ms",
                   "vs_baseline": round(bench.BASELINE_1000_MS / 2.5, 2)}


def test_detail_written_with_skipped_failures(stub_bench, monkeypatch):
    _run_main(monkeypatch, stub_bench)
    detail = json.loads(stub_bench.read_text())
    assert detail["match_1024x1024_1000templates_e2e_ms"] == 2.5
    assert detail["match_1024x1024_360templates_e2e_ms"] == 2.0
    assert detail["skipped"] == ["failing"]
    assert detail["values"] == {"e2e1000": 2.5, "e2e360": 2.0}
    assert detail["device"] == {"kind": "cpu", "count": 0,
                                "nvidia_smi": None}


def test_budget_zero_skips_all_detail_metrics(stub_bench, monkeypatch):
    monkeypatch.setenv("SBM_BENCH_BUDGET_S", "0")
    rec = json.loads(_run_main(monkeypatch, stub_bench).splitlines()[0])
    assert rec["value"] == 2.5  # the primary still runs and prints
    detail = json.loads(stub_bench.read_text())
    assert sorted(detail["skipped"]) == ["e2e360", "failing"]
    assert "match_1024x1024_360templates_e2e_ms" not in detail


def test_detail_order_covers_all_optional_metrics():
    names = [n for n, _ in bench._DETAIL_ORDER]
    assert len(names) == len(set(names))
    assert set(names) == set(bench._METRICS) - {"e2e1000"}
    # the JAX bench's order, less the packed2 metric
    assert names == [n for n, _ in jbench._DETAIL_ORDER if n != PACKED2]


def _jax_metric_names() -> set:
    """The keys of the JAX bench's ``_METRICS``, read from its source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "_METRICS"
                        for t in node.targets)):
            return {ast.literal_eval(k) for k in node.value.keys}
    raise AssertionError("bench.py has no _METRICS")


def test_metrics_are_the_jax_metrics_less_packed2():
    assert set(bench._METRICS) == _jax_metric_names() - {PACKED2}


def test_detail_keys_and_rounding_equal_jax():
    """Every key of the JAX bench's detail but the packed2 ones, with the
    same values and rounding, from the same metric values."""
    got = bench._detail_from_vals(VALS, ["x"])
    want = jbench._detail_from_vals(
        {**VALS, PACKED2: [5.25, 142, "packed2"]}, ["x"])
    dropped = {k for k in want if "packed2" in k}
    assert dropped == {
        "match_1024x1024_1000t_256f_dense_packed2_e2e_ms",
        "match_1000t_256f_packed2_coarse_nfeat",
        "match_1000t_256f_packed2_coarse_route",
        "wide_vs_packed2_speedup_1000t_256f"}
    assert got == {k: v for k, v in want.items() if k not in dropped}


def test_detail_defaults_under_build():
    """The default detail file lies under build/ (ignored by git), never
    on the JAX bench's BENCH_DETAIL.json."""
    assert bench.DEFAULT_DETAIL == os.path.join(
        ROOT, "build", "bench_torch", "BENCH_DETAIL.json")


def test_bench_without_cuda_raises():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--metric", "e2e1000"])


def test_metric_subprocess_from_any_directory(monkeypatch, tmp_path):
    """A metric runs as ``python -m shape_based_matching_tpu_torch.bench
    --metric NAME`` in its own process, with the repository on its path
    wherever the caller stands; case1 is None without the reference."""
    monkeypatch.delenv("SBM_REFERENCE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert bench._run_metric_subprocess(
        "case1", torch.device("cpu"), timeout_s=120) is None


def test_measure_case1_on_a_case1_directory(monkeypatch, tmp_path):
    """case1's body on the CPU: a ``test/case1`` directory under
    ``SBM_REFERENCE_DIR`` whose ``test_templ.yaml`` the port wrote (two
    templates x 128 features of a synthetic shape), the committed case1
    frame (BGR 1088x960): a positive time, the launch records (none on
    CPU tensors, where the wrappers run their twins) and the coarse route
    of ``Detector.coarse_route`` on that frame."""
    import numpy as np

    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.utils.synthetic import (
        synthetic_shape_image)

    case1 = tmp_path / "test" / "case1"
    det = Detector(num_features=128, T=(4, 8), device="cpu")
    img = synthetic_shape_image(160, seed=1)
    assert det.add_template(img, "test", np.full_like(img, 255)) == 0
    det.add_template_rotate("test", 0, 45.0, (80.0, 80.0))
    det.write_classes(str(case1 / "%s_templ.yaml"))
    monkeypatch.setenv("SBM_REFERENCE_DIR", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ms, counts, route = bench._measure_case1(torch.device("cpu"),
                                                 iters=1)
    finally:
        torch.set_num_threads(n)
    frame = bench._load_mat(os.path.join(ROOT, "tests", "goldens",
                                         "case1_img.bin.gz"))
    assert frame.shape == (960, 1088, 3)
    assert ms > 0 and counts == {}
    assert route == det.coarse_route("test", frame.shape[:2])
