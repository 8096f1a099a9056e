"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port ``shape_based_matching_tpu_torch``. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown`` and ``tracing`` (the seconds a frame of untraced passes and
of the traced one), ``setup`` (whether this process built the port's
libraries, the seconds that took, and ``setup_s``), and last ``checks``,
each number compared with its limit, which are also the last lines of
standard error. Exits non-zero, with no
result, where CUDA is not available or has fewer cards than the cell asks
for, where the cell is unknown or its configuration names a deployment
module that ``portbench/deployments/`` lacks, and where the process has
loaded JAX or the JAX package by the end of the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: python3 portbench/run.py
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def check_lines(checks: dict) -> list[str]:
    """One line a number compared: its name, value and limit."""
    out = []
    for name, c in checks.items():
        rule = (f"limit {c['limit']}" if "limit" in c
                else f"at least {c['at_least']}")
        out.append(f"check {name} {c['value']} {rule}")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        spec = harness.load_cell(args.workload)
        harness.load_deployment(spec["config"])
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
