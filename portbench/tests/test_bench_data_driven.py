"""A configuration, a traffic mix and a per-layer metric are added by
files alone: new data files and a reader beside the others, new entries
in BENCHMARK.json, and no change to the harness's code."""

import json
import os
import time

from portbench import harness

from .conftest import SEED, TINY_CONFIG


def test_a_cell_from_data_files_alone(tiny_root, tmp_path):
    import shutil

    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny_wide.json"), "w") as f:
        json.dump(dict(TINY_CONFIG, name="tiny_wide", num_templates=36,
                       angle_step=10.0, frame_width=384,
                       match_threshold=70.0), f)
    with open(os.path.join(pb, "traffic", "b3_one.json"), "w") as f:
        json.dump({"api": "match_batch", "batch": 3, "pool": 6,
                   "instances": [1, 2], "noise_amplitude": 40,
                   "check_frames": 3}, f)
    with open(os.path.join(pb, "metrics", "calls_per_frame.py"), "w") as f:
        f.write("def read(w):\n"
                "    calls = w.records.get('detector.match_batch', [])\n"
                "    return len(calls) / w.frames if calls else None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_wide", "source": "test",
                             "file": "portbench/configs/tiny_wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_wide.b3", "config": "tiny_wide",
                               "traffic": "b3_one", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "calls_per_frame", "unit": "calls/frame", "better": "lower",
        "source": "program_span", "layer": "models/detector.py host glue",
        "moves": "frames_per_s", "workloads": ["tiny_wide.b3"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    r = harness.run("tiny_wide.b3", SEED, 0.2, True, time.perf_counter(),
                    device="cpu", root=root)
    assert r["correct"], r["checks"]
    assert r["metrics"] == {"calls_per_frame": {"value": 1 / 3,
                                                "unit": "calls/frame"}}
    # whole untraced passes over the pool of 6, then the traced pass
    assert r["attempted"] % 6 == 0 and r["attempted"] >= 12
    r = harness.run("tiny_wide.b3", SEED, 0.2, False, time.perf_counter(),
                    device="cpu", root=root)
    assert r["correct"] and r["attempted"] % 3 == 0
    assert set(r["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    # the other cells do not report the new metric
    r = harness.run("tiny.b1", SEED, 0.2, True, time.perf_counter(),
                    device="cpu", root=root)
    assert "calls_per_frame" not in r["metrics"]
