"""Host ms a frame in ``sbm.upload`` (``_planar``: the frames' copy to
the device) over the spans pass (``portbench/spans.py``)."""

from portbench.spans import host_ms_per_frame


def read(w):
    return host_ms_per_frame(w, "sbm.upload")
