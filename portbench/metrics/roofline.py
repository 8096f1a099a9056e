"""The roofline yardstick of the match path's stages on one NVIDIA H100.

A stage's bound is the larger of two times: the bytes that any
implementation of the stage must move for these inputs over the card's
memory bandwidth, and the scalar operations that no route can avoid over
its scalar rate. Its share is that bound over the stage's device time, in
percent. Intermediates of today's kernels (such as the coarse score
matrix S) are not counted, so a later fused kernel cannot read over 100%.
Published peaks of the H100 SXM (NVIDIA's data sheet, at its full 700 W):
3.35 TB/s of HBM3 and 67e12 float32 operations a second outside the
tensor cores. A card set to a lower power limit runs below them; the run
prints the card's limit beside the share.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
FEATURE_BYTES = 4     # x, y and label of a feature packed in one word
TEMPLATE_BYTES = 8    # a template's width, height, feature count
CANDIDATE_BYTES = 16  # template, x, y and score of a candidate
WINDOW_CELLS = 256    # the 16 x 16 positions a refine window scores


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time the card could take for the work."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S)


def share_pct(bound: float, device_s) -> float | None:
    """bound / device time in percent; None without device time."""
    if device_s is None or device_s <= 0.0:
        return None
    return 100.0 * bound / device_s


def pyramid_bytes(frame_shape, T, n_ori: int) -> int:
    """``_batch_pyramid``: the frames read once ([B, H, W] gray or
    [B, 3, H, W] planar color uint8) and every level's linear memories
    written once (n_ori x T^2 x M bytes a frame, M the level's cells;
    the level's size halves, floored, at each level)."""
    B = int(frame_shape[0])
    H, W = int(frame_shape[-2]), int(frame_shape[-1])
    n = 1
    for d in frame_shape:
        n *= int(d)
    total = n
    for l, t in enumerate(T):
        if l > 0:
            H, W = H // 2, W // 2
        total += B * n_ori * (H // t) * (W // t) * t * t
    return total


def bank_bytes(n_features: int, n_templates: int) -> int:
    """A bank level read once: its live features and template sizes."""
    return FEATURE_BYTES * n_features + TEMPLATE_BYTES * n_templates


def coarse_bytes(B: int, n_ori: int, T: int, size_wh, n_features: int,
                 n_templates: int, written: int) -> int:
    """``coarse_extract``: the level's linear memories of B frames and the
    bank read once, and the `written` candidates written once."""
    M = (size_wh[0] // T) * (size_wh[1] // T)
    return (B * n_ori * T * T * M + bank_bytes(n_features, n_templates)
            + CANDIDATE_BYTES * written)


def refine_work(n_live: int, window_features: int, n_features: int,
                n_templates: int) -> tuple:
    """A refine step over `n_live` live candidates whose templates hold
    `window_features` features together (a template counted once a
    candidate), reading the `n_templates` distinct templates' `n_features`
    features: (bytes, operations). Bytes: those templates read once, the
    candidates read once and written once. Operations: one add a feature
    and window cell, which every route must make (the linear memories a
    window reads are not counted: the windows of neighbouring candidates
    overlap, so what they need together depends on the data)."""
    n_bytes = (bank_bytes(n_features, n_templates)
               + 2 * CANDIDATE_BYTES * n_live)
    return n_bytes, WINDOW_CELLS * window_features
