"""The command line and the result line's keys."""

import json
import time

import numpy as np
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


class _Det:
    """Records the API calls a Client makes."""

    def __init__(self):
        self.calls = []

    def match(self, frame, threshold):
        self.calls.append(("match", frame.shape, threshold))
        return []

    def match_icp(self, frame, threshold, **kw):
        self.calls.append(("match_icp", frame.shape, threshold, kw))
        return []


def test_client_calls_match_icp_with_the_mix_arguments():
    pool = np.zeros((3, 8, 8), np.uint8)
    mix = {"api": "match_icp", "batch": 1, "top_c": 16, "iters": 5,
           "radius": 6, "cand_cap": 256}
    det = _Det()
    c = harness.Client(det, mix, pool, 90.0)
    idx, answers = c(4)
    assert list(idx) == [1] and answers == [[]]
    assert det.calls == [("match_icp", (8, 8), 90.0,
                          {"top_c": 16, "iters": 5, "radius": 6,
                           "cand_cap": 256})]
    assert c.api_span()[1:] == ("match_icp", "detector.match_icp")
    assert c.rows([]).shape == (0, 10)
    assert harness.Client(det, {"api": "match"}, pool, 90.0).rows(
        []).shape == (0, 4)


@pytest.mark.parametrize("mix,why", [
    ({"api": "match_many"}, "unknown api"),
    ({"api": "match_icp", "batch": 2, "top_c": 1, "iters": 1, "radius": 1,
      "cand_cap": 256}, "one frame a call"),
    ({"api": "match", "batch": 4}, "one frame a call")])
def test_client_rejects_a_mix_it_cannot_run(mix, why):
    with pytest.raises(ValueError, match=why):
        harness.Client(_Det(), mix, np.zeros((4, 8, 8), np.uint8), 90.0)


def _icp_answer(tx, dtheta=0.5, dscale=1.0, inliers=100, valid=True):
    from shape_based_matching_tpu_torch import Match

    return [{"match": Match(10, 20, 93.75, "c", 3), "dtheta_deg": dtheta,
             "dscale": dscale, "tx": tx, "ty": 20.25, "rmse": 0.1,
             "inliers": inliers, "valid": valid}]


KEY = (3, 10, 20, int(np.float32(93.75).view(np.int32)))
REF = {KEY: (0.5, 1.0, 10.5, 20.25, 100, True)}
FIELDS = ("dtheta_deg", "dscale", "tx", "ty")


def _moved(field, by, **kw):
    """The reference's answer with `field` moved by `by`."""
    base = dict(zip(FIELDS, REF[KEY][:4]))
    base[field] += by
    a = _icp_answer(base["tx"], base["dtheta_deg"], base["dscale"], **kw)
    a[0]["ty"] = base["ty"]
    return a


@pytest.mark.parametrize("field", FIELDS)
def test_pose_mismatch_on_hand_made_answers(field):
    tol = harness.POSE_TOL[field]
    past = harness.compare_poses(
        {0: [harness.icp_rows(_moved(field, 1.05 * tol))]}, {0: REF})
    assert past["poses_checked"] == 1 and past["pose_mismatch"] == 1
    assert past["inliers_mismatch"] == 0
    inside = harness.compare_poses(
        {0: [harness.icp_rows(_moved(field, -0.9 * tol))]}, {0: REF})
    assert inside["pose_mismatch"] == 0
    assert 0 < max(inside[n] for n in harness.POSE_GAPS) < tol
    same = harness.compare_poses({0: [harness.icp_rows(_moved(field, 0.0))]},
                                 {0: REF})
    assert same["pose_mismatch"] == 0 and all(
        same[n] == 0 for n in harness.POSE_GAPS)
    # a key the reference lacks is the list's to count, not the poses'
    other = harness.compare_icp({0: [harness.icp_rows(_moved(field, 1.0))]},
                                {0: 1}, {0: {(9, 9, 9, 9): REF[KEY]}})
    assert other["poses_checked"] == 0 and other["list_mismatch"] == 2


@pytest.mark.parametrize("which", ["valid", "inliers"])
def test_a_valid_flag_or_an_inlier_count_that_differs(which):
    """A valid flag that differs is a pose mismatch, an inlier count that
    differs an inliers mismatch; each pool frame's candidate is counted
    once however often the window answered it."""
    kw = {"valid": False} if which == "valid" else {"inliers": 99}
    rows = harness.icp_rows(_moved("tx", 0.0, **kw))
    got = harness.compare_poses({0: [rows, rows, rows], 1: [rows]},
                                {0: REF, 1: REF})
    assert got["poses_checked"] == 4
    assert (got["pose_mismatch"], got["inliers_mismatch"]) == (
        (2, 0) if which == "valid" else (0, 2))


def test_a_pose_that_is_no_number_fails():
    kept = {0: [harness.icp_rows(_icp_answer(float("nan")))]}
    gaps = harness.compare_poses(kept, {0: REF})
    assert gaps["pose_gap_px"] == harness.NO_NUMBER
    assert gaps["pose_mismatch"] == 1


@pytest.mark.parametrize("icp", [False, True])
def test_the_verdict_holds_every_number_to_its_limit(icp):
    rows = harness.icp_rows(_moved("tx", 0.0))
    cmp = (harness.compare_icp({0: [rows]}, {0: 1}, {0: REF}) if icp else
           harness.compare({0: [rows[:, :4]]}, {0: 1}, {0: set(REF)}))
    checks, correct = harness.verdict(cmp, 0, 0)
    assert correct and list(checks)[-1] == "lists_checked"
    assert ("pose_mismatch" in checks) == icp
    for name, c in checks.items():
        if "limit" not in c:
            continue
        worse = dict(cmp, **{name: 1}) if name in cmp else cmp
        bad = harness.verdict(worse, int(name == "failed_frames"),
                              int(name == "bank_mismatch"))
        assert bad[1] is False, name
    assert harness.verdict(dict(cmp, lists_checked=0), 0, 0)[1] is False
