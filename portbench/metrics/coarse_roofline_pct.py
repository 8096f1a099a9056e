"""``coarse_extract``'s share of its roofline (``roofline.py``): bound by
bytes, since the delta chain makes fewer adds than K x N x M."""

from portbench.metrics import roofline


def read(w):
    calls = w.records.get("coarse_extract", [])
    if not calls:
        return None
    banks = {}
    n_bytes = 0
    for c in calls:
        bank = c["bank"]
        if id(bank) not in banks:
            banks[id(bank)] = (int(bank.nfeat.sum()), int(bank.nfeat.shape[0]))
        n_feat, K = banks[id(bank)]
        written = int(c["n_above"].clamp(max=c["cap"]).sum())
        n_bytes += roofline.coarse_bytes(c["frames"], c["n_ori"], c["T"],
                                         c["size_wh"], n_feat, K, written)
    return roofline.share_pct(roofline.bound_s(n_bytes),
                              w.span_s("coarse_extract"))
