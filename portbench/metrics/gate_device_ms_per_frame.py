"""Device ms a frame queued inside the inspection's gate
(``sbm.inspect.gate``, ``models/inspect.py``: the crops' gather, their
normalization and the correlations); None where the program has no such
span."""

SPAN = "sbm.inspect.gate"


def read(w):
    if w.busy_s is None or not w.frames or SPAN not in w.span_device:
        return None
    return w.span_s(SPAN) / w.frames * 1e3
