"""Gradient extraction and 8-bin orientation quantization (LINE-2D front
end, line2Dup.cpp:218-330), the plain reference of the CUDA frontend.

Same semantics as the JAX package's ``ops/gradients.py`` for gray frames,
8 orientations: squared magnitudes, round-half-to-even bucketing, zeroed
borders and the 3x3 majority vote with nibble-packed bin counters (counts
<= 9 fit a nibble; eight bins fill 32 bits, held in int64 here).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .fastmath import phase_deg
from .filters import gaussian_blur7_u8, sobel3_i32

# f32(2 * n_ori / 360) for n_ori = 8
BIN_SCALE = float(np.float32(16.0 / 360.0))


class QuantizedGradients(NamedTuple):
    """Per-level gradient state (ColorGradientPyramid, line2Dup.h:185-191)."""

    magnitude: torch.Tensor  # [..., H, W] float32, SQUARED magnitude
    angle: torch.Tensor      # [..., H, W] uint8, single-bit orientation
    angle_ori: torch.Tensor  # [..., H, W] float32, raw angle in degrees


def weak_threshold_sq(weak_threshold: float) -> float:
    """f32(weak_threshold) ** 2 in float32, as the reference compares
    squared magnitudes (line2Dup.cpp:326,328)."""
    t = np.float32(weak_threshold)
    return float(t * t)


def hysteresis_quantize(magnitude: torch.Tensor, angle_deg: torch.Tensor,
                        threshold_sq: float) -> torch.Tensor:
    """8-bin quantization with 3x3 majority vote (line2Dup.cpp:218-311).

    1. bucket = round_half_even(angle * 16/360), borders zeroed, & 7;
    2. keep a pixel only if magnitude > threshold_sq;
    3. every in-image pixel votes its bucket over its 3x3 neighbourhood;
       the bin with most votes (lowest index wins ties) needs >= 5 of 9.
    Output is 1 << bin as uint8, else 0."""
    h, w = angle_deg.shape[-2:]
    dev = angle_deg.device
    q16 = torch.round(angle_deg * torch.tensor(
        BIN_SCALE, dtype=torch.float32, device=dev)).to(torch.int64)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    border = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    q8 = torch.where(border, q16 & 7, torch.zeros_like(q16))

    packed = torch.ones_like(q8) << (4 * q8)
    p = F.pad(packed, (1, 1, 1, 1))  # out-of-image pixels cast no vote
    votes = sum(p[..., i:i + h, j:j + w] for i in range(3) for j in range(3))

    # first max wins (the C++ scans bins ascending with strict >)
    max_votes = torch.zeros_like(votes)
    best_bin = torch.zeros_like(votes)
    for b in range(8):
        cnt = (votes >> (4 * b)) & 15
        better = cnt > max_votes
        max_votes = torch.where(better, cnt, max_votes)
        best_bin = torch.where(better, torch.full_like(best_bin, b),
                               best_bin)

    thr = torch.tensor(threshold_sq, dtype=torch.float32, device=dev)
    ok = border & (magnitude > thr) & (max_votes >= 5)
    out = torch.where(ok, torch.ones_like(best_bin) << best_bin,
                      torch.zeros_like(best_bin))
    return out.to(torch.uint8)


def quantized_orientations_gray(src: torch.Tensor, weak_threshold: float
                                ) -> QuantizedGradients:
    """Gray path of quantizedOrientations (line2Dup.cpp:322-330) on
    [..., H, W] uint8 frames."""
    smoothed = gaussian_blur7_u8(src)
    dx = sobel3_i32(smoothed, dx=True).to(torch.float32)
    dy = sobel3_i32(smoothed, dx=False).to(torch.float32)
    magnitude = dx * dx + dy * dy
    ang = phase_deg(dx, dy)
    quant = hysteresis_quantize(magnitude, ang,
                                weak_threshold_sq(weak_threshold))
    return QuantizedGradients(magnitude, quant, ang)
