"""Device ms a frame queued inside the ICP's spans: ``icp.field``
(``edge_nearest_field``: the edge frontend and the jump flood) and
``icp.refine`` (``refine_packed_candidates``: the top_c selection and the
ICP steps)."""

SPANS = ("icp.field", "icp.refine")


def read(w):
    if w.busy_s is None or not w.frames or not w.records.get(SPANS[0]):
        return None
    return sum(w.span_s(s) for s in SPANS) / w.frames * 1e3
