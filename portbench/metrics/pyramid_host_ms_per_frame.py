"""Host ms a frame in ``sbm.pyramid`` (``_batch_pyramid``: pyrDown, the
frontend kernel, the linear memories and their zero tail, per level)
over the spans pass (``portbench/spans.py``)."""

from portbench.spans import host_ms_per_frame


def read(w):
    return host_ms_per_frame(w, "sbm.pyramid")
