"""Compile-time constants of the PyTorch port's CUDA sources, read from
their text, so that CPU tests can replay a kernel's loop bounds."""

import os
import re

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "shape_based_matching_tpu_torch", "csrc")


def constants(*sources: str) -> dict:
    """Every namespace-scope ``constexpr int NAME = EXPR;`` of `sources`
    (unindented), in order, evaluated as integers (``/`` is integer
    division)."""
    env: dict = {}
    for src in sources:
        with open(os.path.join(CSRC, src)) as f:
            text = f.read()
        for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                     text, re.M):
            env[name] = eval(expr.replace("sbm::", "").replace("/", "//"),
                             {"__builtins__": {}}, dict(env))
    return env
