"""Device idle ms a frame in gaps whose innermost host span is the
inspection's host tail, ``sbm.inspect.nms`` or ``sbm.inspect.gate``
(``models/inspect.py``): the NMS and the gate's host work that the card
waits on. None where the program has no gate span."""

SPANS = ("sbm.inspect.nms", "sbm.inspect.gate")


def read(w):
    if w.busy_s is None or not w.frames or SPANS[1] not in w.span_device:
        return None
    return sum(s for name, s in w.gaps if name in SPANS) / w.frames * 1e3
