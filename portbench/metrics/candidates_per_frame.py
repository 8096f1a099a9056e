"""Coarse candidates a frame: ``Detector.counters``' ``candidates`` (the
sum of each listed frame's n_above) over its ``frames``, as the spans
pass (``portbench/spans.py``) raised them. Past the cap of 256 a frame
re-runs, so this reads how near the cells run to a re-run."""


def read(w):
    sp = getattr(w, "spans", None)
    if sp is None or not sp.counters.get("frames"):
        return None
    return sp.counters.get("candidates", 0) / sp.counters["frames"]
