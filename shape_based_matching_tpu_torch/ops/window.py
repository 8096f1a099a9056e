"""The two ends of a refine step around its 16x16 window, shared by the
window route (``ops/similarity.refine_candidates``) and the plain twin of
the map route (``ops/cuda/map_refine.map_refine_plain``): the window's
origin from the doubled candidate under the border clamp, and the score
epilogue of the window's first-max cell. Both follow the JAX package's
``refine_candidates`` / ``refine_from_maps`` step by step
(line2Dup.cpp:1239-1293)."""

from __future__ import annotations

import torch


def window_origin(width: torch.Tensor, height: torch.Tensor, T: int,
                  size_wh, k: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor):
    """Doubling and border clamp of each candidate (line2Dup.cpp:1239-1245)
    -> the 16x16 window's origin (wx, wy) on the level's T-grid, int32.
    width, height [K] int32 are the level's template sizes; k, x, y the
    candidates. The clamp may leave cx negative (a template wider than
    the image less 16T): the division floors, as JAX's ``//`` does."""
    w_img, h_img = size_wh
    border = 8 * T
    max_x = w_img - width[k] - border
    max_y = h_img - height[k] - border
    cx = torch.minimum((x * 2 + 1).clamp(min=border), max_x)
    cy = torch.minimum((y * 2 + 1).clamp(min=border), max_y)
    wx = (torch.div(cx, T, rounding_mode="floor") - 8).to(torch.int32)
    wy = (torch.div(cy, T, rounding_mode="floor") - 8).to(torch.int32)
    return wx, wy


def window_result(nfeat: torch.Tensor, T: int, k, wx, wy, best, raw, valid,
                  threshold):
    """Score epilogue of a refine step, in the JAX order: the float32
    similarity raw*100 / (4*nfeat[k]) of the window's best cell (each step
    rounded), its position, the threshold. Returns (k, x, y, score,
    valid)."""
    offset = T // 2 + (T % 2 - 1)
    sim = raw.to(torch.float32) * 100.0 / (4.0 * nfeat[k].to(torch.float32))
    nx = (wx + best % 16) * T + offset
    ny = (wy + torch.div(best, 16, rounding_mode="floor")) * T + offset
    return k, nx, ny, sim, valid & (sim >= threshold)
