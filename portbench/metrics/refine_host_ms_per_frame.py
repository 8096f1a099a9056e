"""Host ms a frame in ``sbm.refine`` (the refine step at each finer
level, by the window or the map route, re-runs included) over the spans
pass (``portbench/spans.py``)."""

from portbench.spans import host_ms_per_frame


def read(w):
    return host_ms_per_frame(w, "sbm.refine")
