"""A tiny benchmark root for the CPU tests: the repository's
BENCHMARK.json with tiny cells added, their data files and the metric
readers, under a temporary directory. The tiny configuration shrinks
only sizes (a 128^2 star, 72 templates at 5 deg, 320^2 frames, a pool of
4), so a run takes a second or two on the CPU with the port's plain
twins."""

import json
import os
import shutil

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 12345

TINY_CONFIG = {
    "name": "tiny", "source": "a CPU test configuration",
    "num_templates": 72, "angle_step": 5.0, "num_features": 48,
    "T": [4, 8], "weak_threshold": 30.0, "strong_threshold": 60.0,
    "match_threshold": 75.0, "frame_height": 320, "frame_width": 320,
    "train_image": "star", "train_size": 128,
    "score_dtype": "float32", "reduced": [], "assumed": {},
}
TINY_TRAFFIC = {
    "b1": {"api": "match", "batch": 1, "pool": 4, "instances": [2, 3],
           "noise_amplitude": 25, "check_frames": 4},
    "b2": {"api": "match_batch", "batch": 2, "pool": 4,
           "instances": [2, 3], "noise_amplitude": 25, "check_frames": 4},
    "icp": {"api": "match_icp", "batch": 1, "top_c": 32, "iters": 12,
            "radius": 8, "cand_cap": 256, "pool": 4, "instances": [2, 3],
            "noise_amplitude": 25, "check_frames": 4},
}


def make_root(path) -> str:
    """A benchmark root at `path` with cells tiny.b1, tiny.b2 and tiny.icp
    added."""
    root = str(path)
    os.makedirs(os.path.join(root, "portbench", "configs"))
    os.makedirs(os.path.join(root, "portbench", "traffic"))
    shutil.copytree(os.path.join(REPO, "portbench", "metrics"),
                    os.path.join(root, "portbench", "metrics"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "portbench", "configs", "tiny.json"),
              "w") as f:
        json.dump(TINY_CONFIG, f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for name, traffic in TINY_TRAFFIC.items():
        with open(os.path.join(root, "portbench", "traffic",
                               f"tiny_{name}.json"), "w") as f:
            json.dump(traffic, f)
        bench["workloads"].append({"name": f"tiny.{name}", "config": "tiny",
                                   "traffic": f"tiny_{name}", "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["per_layer"]:
            m["workloads"].append(f"tiny.{name}")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("bench_root"))
