"""OpenCV-FileStorage-style YAML, read and written (a copy of the JAX
package's ``utils/yaml_io.py`` reader and writer, so the port never
imports that package).

The port uses it for ``ShapeInfoProducer.save_infos`` / ``load_infos``
(the upstream ``*_info.yaml`` schema). Reading strips the "%YAML:1.0"
directive and parses with PyYAML, imported only there; writing emits
OpenCV-style YAML (3-space indent, '-' sequences) and needs nothing.
Paths ending in ``.gz`` are gzipped.
"""

from __future__ import annotations

import gzip
import re
from typing import Any


def _read_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path, "r") as f:
        return f.read()


def _write_text(path: str, text: str) -> None:
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


def load_opencv_yaml(path: str) -> dict:
    """Load an OpenCV YAML file into plain Python structures."""
    text = _read_text(path)
    # Drop the OpenCV YAML directive; PyYAML rejects "%YAML:1.0".
    text = re.sub(r"^%YAML:[\d.]+\s*\n", "", text)
    # OpenCV writes "!!opencv-matrix" tags in some files; none appear in the
    # template schema, but neutralize them defensively.
    text = text.replace("!!opencv-matrix", "")
    # libyaml parses the 2.4 MB case1 registry in 2.4 s vs pure-python
    # safe_load's 12 s (1-CPU host) with identical output; registry load
    # is on the CLI's critical path, so prefer it when available.
    import yaml  # PyYAML, needed only to read

    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    return yaml.load(text, Loader=loader)


def _fmt_float(v: float) -> str:
    """OpenCV FileStorage float formatting ('1.', '-1.', '9.9600000381469727e-01')."""
    if v == int(v) and abs(v) < 1e15:
        s = f"{int(v)}."
        return s
    return repr(float(v))


def _fmt_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        return _fmt_float(v)
    if isinstance(v, int):
        return str(v)
    s = str(v)
    if s == "" or re.search(r"[:#\[\]{},&*!|>'\"%@`]", s) or s != s.strip():
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s


def dump_opencv_yaml(doc: dict, path: str) -> None:
    """Emit OpenCV-FileStorage-style YAML (3-space indent, '-' sequences)."""
    lines = ["%YAML:1.0", "---"]

    def emit(value: Any, indent: int, into: list):
        pad = "   " * indent
        if isinstance(value, dict):
            for k, v in value.items():
                if isinstance(v, (dict, list)) and not _is_flat_list(v):
                    into.append(f"{pad}{k}:")
                    emit(v, indent + 1, into)
                elif _is_flat_list(v):
                    into.append(f"{pad}{k}: {_flat(v)}")
                else:
                    into.append(f"{pad}{k}: {_fmt_scalar(v)}")
        elif isinstance(value, list):
            for item in value:
                if isinstance(item, dict):
                    into.append(f"{pad}-")
                    emit(item, indent + 1, into)
                elif _is_flat_list(item):
                    into.append(f"{pad}- {_flat(item)}")
                else:
                    into.append(f"{pad}- {_fmt_scalar(item)}")

    def _is_flat_list(v: Any) -> bool:
        return isinstance(v, list) and all(
            not isinstance(i, (dict, list)) for i in v
        )

    def _flat(v: list) -> str:
        return "[ " + ", ".join(_fmt_scalar(i) for i in v) + " ]"

    emit(doc, 0, lines)
    _write_text(path, "\n".join(lines) + "\n")
