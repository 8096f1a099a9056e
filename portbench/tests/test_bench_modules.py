"""A configuration that names a deployment module runs that module's
training, frames, call and reference through the harness's own window,
comparison and limits: the built-in star rotation bank stated as a
module gives what the built-in route gives, a module whose call drops a
match is not correct, its control is not correct, and a module that the
checkout lacks is refused like an unknown cell."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import control, harness

from .conftest import REPO, SEED, TINY_CONFIG

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(HERE, "star_deployment.py")) as f:
    STAR = f.read()
# the star module with a call that leaves out each frame's last match
DROP = STAR + '''

class _Dropping(harness.Client):
    def __call__(self, i):
        idx, answers = super().__call__(i)
        return idx, [list(a)[:-1] for a in answers]


def client(det, traffic, pool, threshold):
    return _Dropping(det, traffic, pool, threshold)
'''
MODULES = {"star_rotation": STAR, "star_dropping": DROP}
# (configuration, its module); each gets the cells .b1 and .b2 on the
# tiny root's mixes tiny_b1 (match) and tiny_b2 (match_batch)
CONFIGS = {"tiny_star": "star_rotation", "tiny_drop": "star_dropping"}
INTERFACE = ("train", "fingerprint", "frame_pool", "client", "reference")


@pytest.fixture(scope="module")
def module_root(tiny_root, tmp_path_factory):
    torch.set_num_threads(2)
    root = str(tmp_path_factory.mktemp("module_root") / "root")
    shutil.copytree(tiny_root, root)
    pb = os.path.join(root, "portbench")
    os.makedirs(os.path.join(pb, "deployments"))
    for name, text in MODULES.items():
        with open(os.path.join(pb, "deployments", name + ".py"), "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, module in CONFIGS.items():
        with open(os.path.join(pb, "configs", name + ".json"), "w") as f:
            json.dump(dict(TINY_CONFIG, name=name, module=module), f)
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "CPU tests"})
        for mix in ("b1", "b2"):
            bench["workloads"].append({
                "name": f"{name}.{mix}", "config": name,
                "traffic": f"tiny_{mix}", "chips": 1, "why": "CPU tests"})
            for m in bench["per_layer"]:
                m["workloads"].append(f"{name}.{mix}")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root


@pytest.fixture
def seen(monkeypatch):
    """Windows of exactly one pass over the pool (so two runs make the
    same calls), what each run's windows kept and its banks were, and
    which of a deployment module's functions the runs called."""
    seen = {"windows": [], "banks": [], "calls": []}

    class OnePass(harness.WindowLog):
        def __init__(self, sample):
            super().__init__(sample)
            seen["windows"].append(self)

        def run(self, client, n_calls=None, seconds=None):
            if seconds is not None:
                n_calls = client.calls_per_pass
            return super().run(client, n_calls=n_calls)

    real = harness.bank_difference

    def banks(got, want):
        seen["banks"].append((got, want))
        return real(got, want)

    load = harness.load_deployment

    def spied(config, root=harness.ROOT):
        mod = load(config, root)
        if mod is None:
            return None

        def spy(name):
            def call(*a, **k):
                seen["calls"].append(name)
                return getattr(mod, name)(*a, **k)
            return call
        return types.SimpleNamespace(**{n: spy(n) for n in INTERFACE})

    monkeypatch.setattr(harness, "WindowLog", OnePass)
    monkeypatch.setattr(harness, "load_deployment", spied)
    monkeypatch.setattr(harness, "bank_difference", banks)
    return seen


def _kept(win) -> dict:
    return {pos: [a.tolist() for a in answers]
            for pos, answers in win.kept.items()}


@pytest.mark.parametrize("mix", ["b1", "b2"])
def test_the_star_module_runs_as_the_built_in_route(module_root, seen,
                                                    mix):
    base = harness.run(f"tiny.{mix}", SEED, 1.0, False, time.perf_counter(),
                       device="cpu", root=module_root)
    mod = harness.run(f"tiny_star.{mix}", SEED, 1.0, False,
                      time.perf_counter(), device="cpu", root=module_root)
    assert base["correct"] and mod["correct"], (base["checks"],
                                                mod["checks"])
    # the built-in run called no module; the module run each function once
    assert sorted(seen["calls"]) == sorted(INTERFACE)
    assert mod["checks"] == base["checks"]
    assert mod["attempted"] == base["attempted"] == 4
    assert list(mod["metrics"]) == list(base["metrics"])
    (got_a, want_a), (got_b, want_b) = seen["banks"]
    assert got_b == got_a and want_b == want_a and len(got_a) == 72
    w_a, w_b = seen["windows"]
    assert _kept(w_b) == _kept(w_a) and len(w_a.kept) == 4
    assert dict(w_b.due) == dict(w_a.due)


def test_a_traced_module_run_reads_every_per_layer_metric(module_root):
    base = harness.run("tiny.b2", SEED, 0.2, True, time.perf_counter(),
                       device="cpu", root=module_root)
    mod = harness.run("tiny_star.b2", SEED, 0.2, True, time.perf_counter(),
                      device="cpu", root=module_root)
    assert mod["correct"], mod["checks"]
    assert set(mod["metrics"]) == set(base["metrics"])
    assert list(mod["checks"]) == list(base["checks"])


@pytest.mark.parametrize("mix", ["b1", "b2"])
def test_a_module_that_drops_a_match_is_not_correct(module_root, mix):
    r = harness.run(f"tiny_drop.{mix}", SEED, 0.3, False,
                    time.perf_counter(), device="cpu", root=module_root)
    assert r["correct"] is False
    assert r["checks"]["list_mismatch"]["value"] >= r["checks"][
        "lists_checked"]["value"] > 0
    assert r["checks"]["bank_mismatch"]["value"] == 0


def test_the_module_cells_control_is_not_correct(module_root, seen):
    r = control.control_readings("tiny_star.b1", SEED, "cpu", module_root)
    assert r["correct"] is False and r["control"]["correct"] is False, r
    assert seen["calls"] == ["frame_pool", "reference", "reference"]
    # the star module's control is the built-in cell's, number for number
    assert r == control.control_readings("tiny.b1", SEED, "cpu",
                                         module_root)


def test_a_missing_module_exits_2(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "portbench", "configs", "gone.json"),
              "w") as f:
        json.dump(dict(TINY_CONFIG, name="gone", module="nowhere"), f)
    bench["configs"].append({"name": "gone", "source": "test",
                             "file": "portbench/configs/gone.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "gone.b1", "config": "gone",
                               "traffic": "b1_1to4", "chips": 1,
                               "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "gone.b1", "--seed", str(SEED), "--seconds", "1"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and p.stdout == "", p.stderr
    assert "nowhere" in p.stderr


def test_no_configuration_of_the_benchmark_names_a_module():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for entry in bench["configs"]:
        with open(os.path.join(REPO, entry["file"])) as f:
            assert "module" not in json.load(f), entry["name"]
