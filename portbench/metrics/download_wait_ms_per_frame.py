"""Host ms a frame in ``sbm.download`` (``_to_host``: the results packed
and the blocking copy to the host, which waits for the device to finish
the step) over the spans pass (``portbench/spans.py``)."""

from portbench.spans import host_ms_per_frame


def read(w):
    return host_ms_per_frame(w, "sbm.download")
