"""Detection-level NMS (greedy IoU), parity with nms.hpp:21-96.

Small-N, order-dependent greedy: it runs on the host over the (already
short) match list, as the reference's cv_dnn::NMSBoxes does.
``nms_boxes`` runs the compiled ``sbm_nms_boxes`` of ``csrc/host.cpp``
(built at first use by ``models/native.py``; a failed build raises);
``nms_boxes_plain`` is the Python loop the tests hold it against.
"""

from __future__ import annotations

import numpy as np


def _jaccard(a, b) -> float:
    """1 - jaccardDistance__ (nms.hpp:70-89). Boxes are (x, y, w, h)."""
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    area_a = float(aw) * float(ah)
    area_b = float(bw) * float(bh)
    if (area_a + area_b) <= np.finfo(np.float32).eps:
        return 1.0  # distance 0 -> overlap 1
    ix = max(0.0, min(ax + aw, bx + bw) - max(ax, bx))
    iy = max(0.0, min(ay + ah, by + bh) - max(ay, by))
    inter = ix * iy
    return float(inter / (area_a + area_b - inter))


def _order(scores, score_threshold: float, top_k: int) -> list[int]:
    """Indices of the scores above the threshold, best first (ties keep
    index order), at most top_k of them when top_k > 0."""
    pairs = [(s, i) for i, s in enumerate(scores) if s > score_threshold]
    pairs.sort(key=lambda p: -p[0])
    if top_k > 0:
        pairs = pairs[:top_k]
    return [i for _, i in pairs]


def nms_boxes(bboxes, scores, score_threshold: float, nms_threshold: float,
              eta: float = 1.0, top_k: int = 0) -> list[int]:
    """Greedy NMS; returns kept indices (cv_dnn::NMSBoxes semantics)."""
    import ctypes

    from ..models import native

    if len(bboxes) != len(scores):
        raise ValueError(f"{len(bboxes)} boxes but {len(scores)} scores")
    order = _order(scores, score_threshold, top_k)
    if not order:
        return []
    b = np.ascontiguousarray(
        [[float(v) for v in bb] for bb in bboxes], np.float32).reshape(-1, 4)
    idx = np.ascontiguousarray(order, np.int32)
    out = np.zeros(len(order), np.int32)
    cnt = native.library().sbm_nms_boxes(
        len(bboxes), b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(order),
        ctypes.c_float(nms_threshold), ctypes.c_float(eta),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return [int(i) for i in out[:cnt]]


def nms_boxes_plain(bboxes, scores, score_threshold: float,
                    nms_threshold: float, eta: float = 1.0,
                    top_k: int = 0) -> list[int]:
    """The Python loop ``nms_boxes`` replaces (float64 overlaps)."""
    if len(bboxes) != len(scores):
        raise ValueError(f"{len(bboxes)} boxes but {len(scores)} scores")
    adaptive = nms_threshold
    keep: list[int] = []
    for idx in _order(scores, score_threshold, top_k):
        ok = True
        for kept in keep:
            if _jaccard(bboxes[idx], bboxes[kept]) > adaptive:
                ok = False
                break
        if ok:
            keep.append(idx)
            if eta < 1 and adaptive > 0.5:
                adaptive *= eta
    return keep
