"""``_batch_pyramid``'s share of its roofline (``roofline.py``)."""

from portbench.metrics import roofline


def read(w):
    calls = w.records.get("pyramid", [])
    if not calls:
        return None
    n_bytes = sum(roofline.pyramid_bytes(c["frame_shape"], c["T"],
                                         c["n_ori"]) for c in calls)
    return roofline.share_pct(roofline.bound_s(n_bytes), w.span_s("pyramid"))
