"""Host ms a frame building the match lists: ``sbm.list`` (``_matches``)
and ``sbm.sort_dedup`` over the spans pass (``portbench/spans.py``)."""

from portbench.spans import host_ms_per_frame


def read(w):
    return host_ms_per_frame(w, "sbm.list", "sbm.sort_dedup")
