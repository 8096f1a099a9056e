"""The ICP layer's share of its roofline (``roofline.py``): the frame
read once by the edge field, each refined candidate's live level-0 points
read once and its result written once, and ``ICP_POINT_OPS`` a live
point and step; over the device time of ``icp.field`` and
``icp.refine``."""

import torch

from portbench.metrics import roofline

SPANS = ("icp.field", "icp.refine")


def read(w):
    fields = w.records.get("icp.field", [])
    refines = w.records.get("icp.refine", [])
    if not fields or not refines:
        return None
    n_bytes = sum(roofline.icp_field_bytes(c["frame_shape"]) for c in fields)
    n_ops = 0
    for c in refines:
        live = torch.isfinite(c["score"])
        points = int(c["bank_valid"][c["k"][live].long()].sum())
        b, o = roofline.icp_refine_work(points, c["iters"], c["top_c"])
        n_bytes += b
        n_ops += o
    device_s = None
    if w.busy_s is not None:
        device_s = sum(w.span_s(s) for s in SPANS)
    return roofline.share_pct(roofline.bound_s(n_bytes, n_ops), device_s)
