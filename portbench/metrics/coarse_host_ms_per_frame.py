"""Host ms a frame in ``sbm.coarse`` (``coarse_extract``: coarse scores
and candidate extraction at the top level, re-runs included) over the
spans pass (``portbench/spans.py``)."""

from portbench.spans import host_ms_per_frame


def read(w):
    return host_ms_per_frame(w, "sbm.coarse")
