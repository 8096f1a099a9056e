"""OpenCV-FileStorage-style YAML, read and written without PyYAML.

Templates, classes and detector settings persist as the reference writes
them (line2Dup.cpp:1489-1599; ``*.yaml.gz`` is gzipped):

    %YAML:1.0
    ---
    class_id: shape
    pyramid_levels: 2
    template_pyramids:
       -
          template_id: 0
          templates:
             -
                width: 93
                scale: 1.
                fiducial_src: "/models/shape.fid.png"
                features:
                   - [ 81, 9, 1 ]

The writer is the JAX package's ``dump_opencv_yaml`` (3-space indent,
'-' sequences, flow lists of scalars). The reader is the port's own and
reads exactly that subset: the ``%YAML:1.0`` and ``---`` header, block
maps at any consistent indent, ``-`` sequences of maps, flow lists and
scalars, ``[ a, b ]`` flow lists of scalars (which may run over several
lines), double-quoted strings with the escapes ``\\\\`` and ``\\"``, and
plain scalars. Its result equals what the JAX package's
``load_opencv_yaml`` (PyYAML's CSafeLoader after stripping the
directive) gives on the same text, value for value and type for type: a
plain scalar is an int for ``[-+]?(0|[1-9][0-9]*)``, a float for
``[-+]?[0-9]+.[0-9]*`` with an optional signed exponent (``1.``,
``-1.``, ``9.9600000381469727e-01``), a string otherwise, and ``key:``
with nothing under it is None. Anything outside the subset (tags,
anchors, single quotes, other escapes, compact nested maps, and every
plain scalar PyYAML would read as a bool, null, timestamp, hex, octal or
underscored number) raises ``ValueError`` with the file and line number.
The reader walks the lines once with an index, recursing only per
nesting level, and reads a line of ints such as a feature in one regular
expression: class files of 10,000 templates are on the CLI's critical
path.
"""

from __future__ import annotations

import gzip
import re
from typing import Any


def _read_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read().decode("utf-8")
    with open(path, "rb") as f:
        return f.read().decode("utf-8")


def _write_text(path: str, text: str) -> None:
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
# PyYAML's implicit resolvers (yaml/resolver.py): a plain scalar that
# matches one of them but neither _INT nor _FLOAT is not a string there,
# and is outside the subset here
_RESOLVED = re.compile(r"""
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
  | [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
  | \.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
  | [-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
  | [-+]?\.(?:inf|Inf|INF) | \.(?:nan|NaN|NAN)
  | [-+]?0b[0-1_]+ | [-+]?0[0-7_]+ | [-+]?(?:0|[1-9][0-9_]*)
  | [-+]?0x[0-9a-fA-F_]+ | [-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
  | << | ~ | null|Null|NULL | = | [!&*]
  | [0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
    (?:(?:[Tt]|[\ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
       (?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?
""", re.X)
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
# a flow list of ints on one line: the features of every template
_INT_LIST = re.compile(r"\[ *((?:[-+]?(?:0|[1-9][0-9]*) *, *)*"
                       r"[-+]?(?:0|[1-9][0-9]*)) *\]")
# comma-separated ints: the items of a run of int flow lists
_INT_SEQ = re.compile(r" *[-+]?(?:0|[1-9][0-9]*) *(?:, *[-+]?(?:0|[1-9][0-9]*) *)*")
# characters that may not start a plain scalar (YAML indicators; '-'
# may, before a character other than a space)
_INDICATORS = frozenset("-?:,[]{}#&*!|>'\"%@`")


class _Reader:
    """One pass over the lines of a document."""

    def __init__(self, text: str, path: str):
        self.path = path
        self.lines = text.split("\n")
        self.n = len(self.lines)
        self.i = 0

    def error(self, lineno: int, what: str) -> ValueError:
        return ValueError(f"{self.path}:{lineno + 1}: {what} (outside the "
                          f"OpenCV YAML subset this reader takes)")

    def next_line(self):
        """(indent, content) of the next line that holds anything, with
        self.i on it; None at the end."""
        lines = self.lines
        while self.i < self.n:
            line = lines[self.i]
            content = line.lstrip(" ")
            if content.strip() and content[0] != "#":
                if content[0] == "\t":
                    raise self.error(self.i, "a tab in the indentation")
                return len(line) - len(content), content.rstrip()
            self.i += 1
        return None

    def document(self):
        first = self.next_line()
        if first is not None and first[1].startswith("%YAML"):
            if not re.fullmatch(r"%YAML:[\d.]+", first[1]) or first[0]:
                raise self.error(self.i, "a directive other than %YAML:1.0")
            self.i += 1
            first = self.next_line()
        if first is not None and first[1] == "---":
            if first[0]:
                raise self.error(self.i, "an indented document start")
            self.i += 1
            first = self.next_line()
        if first is None:
            return None
        if first[0]:
            raise self.error(self.i, "an indented top-level node")
        return self.block(0)

    def block(self, indent: int):
        _, content = self.next_line()
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            nxt = self.next_line()
            if nxt is None or nxt[0] < indent:
                return out
            ind, content = nxt
            lineno = self.i
            if ind > indent:
                raise self.error(lineno, "an unexpected indent")
            key, sep, rest = content.partition(":")
            if not sep or (rest and rest[0] != " ") \
                    or not _KEY.fullmatch(key) or _RESOLVED.fullmatch(key):
                raise self.error(lineno, f"not a 'key: value' line: "
                                         f"{content!r}")
            self.i += 1
            rest = rest.strip()
            if rest:
                out[key] = self.inline(rest, lineno)
                continue
            nxt = self.next_line()
            if nxt is not None and nxt[0] > indent:
                out[key] = self.block(nxt[0])
            else:
                out[key] = None

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            nxt = self.next_line()
            if nxt is None or nxt[0] < indent:
                return out
            ind, content = nxt
            lineno = self.i
            if ind > indent:
                raise self.error(lineno, "an unexpected indent")
            if content == "-":
                self.i += 1
                nxt = self.next_line()
                if nxt is not None and nxt[0] > indent:
                    out.append(self.block(nxt[0]))
                else:
                    out.append(None)
                continue
            if not content.startswith("- "):
                raise self.error(lineno, f"not a '- ' item: {content!r}")
            if self._int_lists(indent, out):
                continue
            rest = content[2:].strip()
            # a compact nested node ('- - x', '- key: v') is a plain
            # scalar that plain() refuses
            self.i += 1
            out.append(self.inline(rest, lineno))

    def _int_lists(self, indent: int, out: list) -> bool:
        """Append the run of '- [ ints ]' items from the current line on
        (a template's features), checked by one regular expression and
        converted in one pass; whether there was one."""
        lines, i, n = self.lines, self.i, self.n
        prefix = " " * indent + "- ["
        j = i
        while j < n and lines[j].startswith(prefix) and lines[j].endswith("]"):
            j += 1
        inner = [line[len(prefix):-1] for line in lines[i:j]]
        joined = ",".join(inner)
        if j == i or not _INT_SEQ.fullmatch(joined):
            return False
        flat = list(map(int, joined.split(",")))
        commas = [part.count(",") for part in inner]
        if commas.count(commas[0]) == len(commas):
            out.extend(map(list, zip(*[iter(flat)] * (commas[0] + 1))))
        else:
            k = 0
            for c in commas:
                out.append(flat[k:k + c + 1])
                k += c + 1
        self.i = j
        return True

    def inline(self, text: str, lineno: int):
        """The value after 'key: ' or '- ': a flow list (which may go on
        over the next lines), a double-quoted string or a plain scalar."""
        if text[0] == "[":
            while not _flow_closed(text):
                nxt = self.next_line()
                if nxt is None:
                    raise self.error(lineno, "an unclosed flow list")
                text += " " + nxt[1]
                self.i += 1
            return self.flow(text, lineno)
        if text[0] == '"':
            value, end = self.quoted(text, 0, lineno)
            if text[end:].strip():
                raise self.error(lineno, "text after a quoted string")
            return value
        return self.plain(text, lineno, flow=False)

    def flow(self, text: str, lineno: int) -> list:
        m = _INT_LIST.fullmatch(text)
        if m is not None:
            return [int(v) for v in m.group(1).split(",")]
        out = []
        pos = 1
        n = len(text)
        expect_item = True
        while True:
            while pos < n and text[pos] == " ":
                pos += 1
            if pos >= n:
                raise self.error(lineno, "an unclosed flow list")
            c = text[pos]
            if c == "]":
                if expect_item and out:
                    raise self.error(lineno, "a trailing comma in a flow "
                                             "list")
                if text[pos + 1:].strip():
                    raise self.error(lineno, "text after a flow list")
                return out
            if not expect_item:
                if c != ",":
                    raise self.error(lineno, "items of a flow list must be "
                                             "separated by commas")
                pos += 1
                expect_item = True
                continue
            if c == '"':
                value, pos = self.quoted(text, pos, lineno)
            else:
                end = pos
                while end < n and text[end] not in ",]":
                    end += 1
                value = self.plain(text[pos:end].strip(), lineno, flow=True)
                pos = end
            out.append(value)
            expect_item = False

    def quoted(self, text: str, pos: int, lineno: int) -> tuple:
        """The double-quoted string starting at text[pos]: (value, the
        position after its closing quote)."""
        out = []
        i = pos + 1
        n = len(text)
        while i < n:
            c = text[i]
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                if i + 1 < n and text[i + 1] in '\\"':
                    out.append(text[i + 1])
                    i += 2
                    continue
                raise self.error(lineno, "an escape other than \\\\ and "
                                         "\\\" in a quoted string")
            out.append(c)
            i += 1
        raise self.error(lineno, "an unclosed quoted string")

    def plain(self, s: str, lineno: int, flow: bool):
        if _INT.fullmatch(s):
            return int(s)
        if _FLOAT.fullmatch(s):
            return float(s)
        if (not s or (s[0] in _INDICATORS and not (s[0] == "-" and s[1:2]
                                                   not in ("", " ")))
                or _RESOLVED.fullmatch(s)
                or ": " in s or s.endswith(":") or " #" in s or "\t" in s
                or (flow and any(c in s for c in "[]{},"))):
            raise self.error(lineno, f"the scalar {s!r}")
        return s


def _flow_closed(text: str) -> bool:
    """Whether a flow list's text holds its closing bracket (outside
    quoted strings)."""
    if '"' not in text:
        return "]" in text
    quoted = False
    i = 0
    while i < len(text):
        c = text[i]
        if quoted and c == "\\":
            i += 2
            continue
        if c == '"':
            quoted = not quoted
        elif c == "]" and not quoted:
            return True
        i += 1
    return False


def parse_opencv_yaml(text: str, path: str = "<text>"):
    """The document of an OpenCV YAML text (see the module docstring)."""
    return _Reader(text, path).document()


def load_opencv_yaml(path: str):
    """Load an OpenCV YAML file (``.gz``: gzipped) into plain Python
    structures, as the JAX package's ``load_opencv_yaml`` does."""
    return parse_opencv_yaml(_read_text(path), path)


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
                if type(item) is list and all(type(i) is int for i in item):
                    # a feature: the common line, formatted as _flat does
                    into.append(f"{pad}- [ {', '.join(map(str, item))} ]")
                elif isinstance(item, dict):
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


def class_file_path(fmt: str, class_id: str) -> str:
    """cv::format("%s", class_id) application (line2Dup.cpp:1583)."""
    import os

    return fmt % (class_id,) if "%s" in fmt else os.path.join(fmt, class_id)
