"""The command line and the result line's keys."""

import json
import time

import pytest
import torch

from portbench import harness, run

from .conftest import SEED


def test_parse_args_takes_the_drivers_flags():
    a = run.parse_args(["--workload", "angle361x128.b1", "--seed",
                        str(2 ** 33 + 5), "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "angle361x128.b1", 2 ** 33 + 5, 10.0, 1)
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "x", "--seed", "1", "--seconds", "1",
                        "--trace", "2"])
    with pytest.raises(SystemExit):
        run.parse_args(["--seed", "1", "--seconds", "1"])


def test_unknown_cell_exits_nonzero_without_a_result(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds",
                     "1"]) == 2
    assert capsys.readouterr().out == ""


def test_no_card_exits_nonzero_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert run.main(["--workload", "angle361x128.b1", "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_every_cell_of_the_benchmark_loads():
    with open(f"{harness.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        spec = harness.load_cell(cell["name"])
        assert spec["config"]["name"] == cell["config"]
        assert {m["name"] for m in spec["end_to_end"]} >= {
            "setup_s", "frames_per_s", "frame_ms_p95"}
        assert spec["per_layer"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(tiny_root, trace):
    r = harness.run("tiny.b1", SEED, 0.3, bool(trace), time.perf_counter(),
                    device="cpu", root=tiny_root)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in r) == bool(trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 4
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    assert isinstance(r["setup"]["built"], bool)
    assert 0 <= r["setup"]["build_s"] <= r["setup"]["setup_s"]
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert r["tracing"]["untraced_ms_per_frame"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert r["metrics"]["coarse_steps_per_frame"]["value"] == 1.0
    else:
        assert set(r["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                     "setup_s"}
        for m in r["metrics"].values():
            assert m["value"] > 0 and m["unit"]
    json.dumps(r)  # the line is plain JSON
    lines = run.check_lines(r["checks"])
    assert lines[0].startswith("check bank_mismatch 0 limit 0")
    assert all(line.startswith("check ") for line in lines)


def test_p95_is_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([3.0]) == 3.0
    assert harness.p95([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                        16, 17, 18, 19, 20, 21]) == 20


def test_without_the_port_a_run_fails_without_a_result(tmp_path):
    import os
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "portbench"),
                    tmp_path / "portbench")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-c",
         "import time, json; from portbench import harness; "
         "print(json.dumps(harness.run('angle361x128.b1', 1, 0.1, False, "
         "time.perf_counter(), device='cpu')))"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "shape_based_matching_tpu_torch" in p.stderr
