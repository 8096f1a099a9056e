"""The refine step's share of its roofline (``roofline.py``), over both
routes: ``refine_candidates`` (the window) and ``refine_by_maps``."""

import torch

from portbench.metrics import roofline

SPANS = ("refine.window", "refine.maps")


def read(w):
    calls = [c for s in SPANS for c in w.records.get(s, [])]
    if not calls:
        return None
    n_bytes = n_ops = 0
    for c in calls:
        nfeat = c["bank"].nfeat.to(torch.int64)
        live_k = c["k"][c["valid"]].to(torch.int64)
        distinct = torch.unique(live_k)
        b, o = roofline.refine_work(
            int(live_k.numel()), int(nfeat[live_k].sum()),
            int(nfeat[distinct].sum()), int(distinct.numel()))
        n_bytes += b
        n_ops += o
    device_s = None
    if w.busy_s is not None:
        device_s = sum(w.span_s(s) for s in SPANS)
    return roofline.share_pct(roofline.bound_s(n_bytes, n_ops), device_s)
