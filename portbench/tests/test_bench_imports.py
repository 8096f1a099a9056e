"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from .conftest import REPO, SEED

FORBIDDEN = {"jax", "jaxlib", "flax", "shape_based_matching_tpu"}

PROBE = """
import sys, time
{body}
print("MODULES", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _modules(body: str) -> set:
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", PROBE.format(body=body)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("MODULES")][-1]
    return set(eval(line[len("MODULES "):]))


def test_a_run_of_every_entry_loads_no_jax(tiny_root):
    found = _modules(f"""
import torch
torch.set_num_threads(2)
from portbench import run, harness, control, trace, frames
from portbench.reference import line2d, training, oracle_np, icp
for cell in ("tiny.b2", "tiny.icp"):
    for t in (0, 1):
        r = harness.run(cell, {SEED}, 0.2, bool(t), time.perf_counter(),
                        device="cpu", root={tiny_root!r})
        assert r["correct"], r["checks"]
for cell in ("tiny.b1", "tiny.icp"):
    r = control.control_readings(cell, {SEED}, "cpu", {tiny_root!r})
    assert r["correct"] is False and r["control"]["correct"] is False, r
assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) == 2
""")
    assert "shape_based_matching_tpu_torch" in found  # the run was real
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_the_command_as_the_driver_runs_it_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "portbench.run", "--workload", "angle361x128.b1",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    loaded = {ln.split("|")[-1].strip().split(".")[0]
              for ln in p.stderr.splitlines() if ln.startswith("import time")}
    assert "portbench" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN
    if p.returncode == 3:  # no card here: no result line
        assert p.stdout == ""


def test_the_reference_imports_nothing_of_the_program():
    found = _modules("from portbench.reference import line2d, training, "
                     "oracle_np, icp")
    assert not any(m.startswith("shape_based_matching") for m in found)
    ref = os.path.join(REPO, "portbench", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in {"__future__", "math", "typing",
                                           "numpy", "torch"}, (name, m)


def test_the_benchmark_reads_no_jax_bench_file():
    banned = ("bench_banks", "BENCH_", "BASELINE", "MULTICHIP_",
              "bench.py", "__graft_entry__")
    for dirpath, _, names in os.walk(os.path.join(REPO, "portbench")):
        if "tests" in dirpath.split(os.sep):
            continue
        for name in names:
            if name.endswith((".py", ".json")):
                with open(os.path.join(dirpath, name)) as f:
                    text = f.read()
                for b in banned:
                    assert b not in text, (name, b)
