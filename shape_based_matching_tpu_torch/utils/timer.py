"""Wall-clock timing with named accumulation and CSV export.

Mirror of the reference Timer (line2Dup.h:15-104): `out()` prints elapsed ms
and resets; `record(key)` accumulates into a named bucket; `display()` /
`display_csv()` emit totals. `CSVStat` reproduces the jabil driver's
min/max/mean aggregation over per-frame rows (test_jabil.cpp:364-371).

These clocks are the host's: device work queued in a timed region may
still run after it. The match path's own spans (``utils/profiling.span``)
and the CLI's ``--trace`` (torch.profiler) split a frame's time by layer.
"""

from __future__ import annotations

import io
import time
from typing import Dict, Iterable, List


class Timer:
    def __init__(self):
        self._beg = time.perf_counter()
        self._acc: Dict[str, float] = {}

    def reset(self) -> None:
        self._beg = time.perf_counter()

    def elapsed(self) -> float:
        """Elapsed milliseconds since construction/reset."""
        return (time.perf_counter() - self._beg) * 1e3

    def out(self, message: str = "") -> float:
        t = self.elapsed()
        print(f"{message}:{t} ms")
        self.reset()
        return t

    def record(self, message: str = "") -> None:
        self._acc[message] = self._acc.get(message, 0.0) + self.elapsed()
        self.reset()

    def display(self, message: str = "") -> None:
        if not message:
            for k, v in self._acc.items():
                print(f"{k}:{v} ms\n")
        else:
            print(f"{message}:{self._acc.get(message, 0.0)} ms\n")

    def display_csv(self, keys: Iterable[str] | None = None,
                    first_column: str = "") -> str:
        buf = io.StringIO()
        row: List[str] = [first_column] if first_column else []
        if keys is None:
            keys = list(self._acc.keys())
        row.extend(str(self._acc.get(k, 0.0)) for k in keys)
        buf.write(",".join(row))
        return buf.getvalue()

    @property
    def records(self) -> Dict[str, float]:
        return dict(self._acc)


class CSVStat:
    """Column-wise min/max/mean over appended rows (csv::CSVStat analog)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.rows: List[List[float]] = []

    def append(self, row: Iterable[float]) -> None:
        row = [float(v) for v in row]
        assert len(row) == len(self.columns)
        self.rows.append(row)

    def _agg(self, fn):
        if not self.rows:
            return [0.0] * len(self.columns)
        cols = list(zip(*self.rows))
        return [fn(c) for c in cols]

    def get_mins(self):
        return self._agg(min)

    def get_maxes(self):
        return self._agg(max)

    def get_mean(self):
        return self._agg(lambda c: sum(c) / len(c))

    def summary_csv(self) -> str:
        lines = ["stat," + ",".join(self.columns)]
        for name, vals in (("min", self.get_mins()), ("max", self.get_maxes()),
                           ("mean", self.get_mean())):
            lines.append(name + "," + ",".join(f"{v:.6g}" for v in vals))
        return "\n".join(lines)
