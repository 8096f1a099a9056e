"""Gradient extraction and orientation quantization (LINE-2D front end,
line2Dup.cpp:218-404), the plain reference of the CUDA frontend.

Same semantics as the JAX package's ``ops/gradients.py``: squared
magnitudes, round-half-to-even bucketing, zeroed borders and the 3x3
majority vote with nibble-packed bin counters (counts <= 9 fit a nibble;
eight bins fill 32 bits, held in int64 here; 16 orientations vote into
two such words). Gray frames are ``[..., H, W]``; color frames are planar
``[..., 3, H, W]`` (the channels of a BGR ``[H, W, 3]`` frame, moved
forward once at upload).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .fastmath import phase_deg
from .filters import gaussian_blur7_u8, sobel3_i32
from .response import from_i32



def bin_scale(n_ori: int) -> float:
    """f32(2 * n_ori / 360): the bucket scale of convertTo."""
    return float(np.float32(2.0 * n_ori / 360.0))


class QuantizedGradients(NamedTuple):
    """Per-level gradient state (ColorGradientPyramid, line2Dup.h:185-191)."""

    magnitude: torch.Tensor  # [..., H, W] float32, SQUARED magnitude
    angle: torch.Tensor      # [..., H, W] uint8 (uint16 for 16 bins),
    #                          single-bit orientation
    angle_ori: torch.Tensor  # [..., H, W] float32, raw angle in degrees


def weak_threshold_sq(weak_threshold: float) -> float:
    """f32(weak_threshold) ** 2 in float32, as the reference compares
    squared magnitudes (line2Dup.cpp:326,328)."""
    t = np.float32(weak_threshold)
    return float(t * t)


def hysteresis_quantize(magnitude: torch.Tensor, angle_deg: torch.Tensor,
                        threshold_sq: float, n_ori: int = 8,
                        patch_2843: bool = False) -> torch.Tensor:
    """n_ori-bin quantization with 3x3 majority vote (line2Dup.cpp:218-311;
    16 bins as line2Dup_16bit_ori.cpp:216-297).

    1. bucket = round_half_even(angle * 2*n_ori/360), borders zeroed,
       & (n_ori - 1);
    2. keep a pixel only if magnitude > threshold_sq;
    3. every in-image pixel votes its bucket over its 3x3 neighbourhood
       (bins 0-7 in one nibble-packed word, 8-15 in a second); the bin
       with most votes (lowest index wins ties) needs >= 5 of 9.
    Output is 1 << bin (uint8 for 8 bins, uint16 for 16), else 0.

    `patch_2843` (opencv_contrib #2843, line2Dup.cpp:9,239-257): an
    interior pixel with magnitude <= threshold_sq casts no vote; pixels
    of the frame's edge still vote bin 0 whatever their magnitude."""
    if n_ori not in (8, 16):
        raise ValueError(f"n_ori={n_ori}: 8 or 16 orientations")
    h, w = angle_deg.shape[-2:]
    dev = angle_deg.device
    q = torch.round(angle_deg * torch.tensor(
        bin_scale(n_ori), dtype=torch.float32, device=dev)).to(torch.int64)
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    border = (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1)
    q = torch.where(border, q & (n_ori - 1), torch.zeros_like(q))
    thr = torch.tensor(threshold_sq, dtype=torch.float32, device=dev)
    votes = ~(border & (magnitude <= thr)) if patch_2843 else torch.ones_like(
        border)

    def vote_word(in_word):
        packed = torch.where(in_word, torch.ones_like(q) << (4 * (q % 8)),
                             torch.zeros_like(q))
        p = F.pad(packed, (1, 1, 1, 1))  # out-of-image pixels cast no vote
        return sum(p[..., i:i + h, j:j + w]
                   for i in range(3) for j in range(3))

    words = ((vote_word(votes),) if n_ori == 8
             else (vote_word(votes & (q < 8)), vote_word(votes & (q >= 8))))

    # first max wins (the C++ scans bins ascending with strict >)
    max_votes = torch.zeros_like(words[0])
    best_bin = torch.zeros_like(words[0])
    for b in range(n_ori):
        cnt = (words[b // 8] >> (4 * (b % 8))) & 15
        better = cnt > max_votes
        max_votes = torch.where(better, cnt, max_votes)
        best_bin = torch.where(better, torch.full_like(best_bin, b),
                               best_bin)

    ok = border & (magnitude > thr) & (max_votes >= 5)
    out = torch.where(ok, torch.ones_like(best_bin) << best_bin,
                      torch.zeros_like(best_bin))
    return from_i32(out, torch.uint8 if n_ori == 8 else torch.uint16)


def quantized_orientations_gray(src: torch.Tensor, weak_threshold: float,
                                n_ori: int = 8, patch_2843: bool = False
                                ) -> QuantizedGradients:
    """Gray path of quantizedOrientations (line2Dup.cpp:322-330) on
    [..., H, W] uint8 frames."""
    smoothed = gaussian_blur7_u8(src)
    dx = sobel3_i32(smoothed, dx=True).to(torch.float32)
    dy = sobel3_i32(smoothed, dx=False).to(torch.float32)
    magnitude = dx * dx + dy * dy
    ang = phase_deg(dx, dy)
    quant = hysteresis_quantize(magnitude, ang,
                                weak_threshold_sq(weak_threshold), n_ori,
                                patch_2843)
    return QuantizedGradients(magnitude, quant, ang)


def pick_channel(dx3: torch.Tensor, dy3: torch.Tensor):
    """(dx, dy, |grad|^2) of the channel with the largest squared
    magnitude per pixel, from int32 [..., 3, H, W] gradients, with the
    reference's tie rule (line2Dup.cpp:370-387): channel 0 wins ties
    against 1 and 2, channel 1 against 2 -- the first maximum."""
    mag3 = dx3 * dx3 + dy3 * dy3
    m0, m1, m2 = mag3.unbind(-3)
    pick0 = (m0 >= m1) & (m0 >= m2)
    pick1 = ~pick0 & (m1 >= m0) & (m1 >= m2)
    sel = torch.where(pick0, 0, torch.where(pick1, 1, 2)).unsqueeze(-3)
    return tuple(t.gather(-3, sel).squeeze(-3) for t in (dx3, dy3, mag3))


def quantized_orientations_color(src: torch.Tensor, weak_threshold: float,
                                 n_ori: int = 8, patch_2843: bool = False
                                 ) -> QuantizedGradients:
    """Color path of quantizedOrientations (line2Dup.cpp:331-401) on planar
    [..., 3, H, W] uint8 frames: per-channel blur and Sobel, then the
    max-|grad|^2 channel (``pick_channel``)."""
    smoothed = gaussian_blur7_u8(src)
    dx, dy, mag = pick_channel(sobel3_i32(smoothed, dx=True),
                               sobel3_i32(smoothed, dx=False))
    magnitude = mag.to(torch.float32)
    ang = phase_deg(dx.to(torch.float32), dy.to(torch.float32))
    quant = hysteresis_quantize(magnitude, ang,
                                weak_threshold_sq(weak_threshold), n_ori,
                                patch_2843)
    return QuantizedGradients(magnitude, quant, ang)


def quantized_orientations(src: torch.Tensor, weak_threshold: float,
                           n_ori: int = 8, patch_2843: bool = False
                           ) -> QuantizedGradients:
    """Dispatch one uint8 frame on its shape, as modality->process does
    (line2Dup.cpp:313): gray [H, W], or BGR [H, W, 3] (moved to planar
    channels for ``quantized_orientations_color``)."""
    if src.dim() == 2:
        return quantized_orientations_gray(src, weak_threshold, n_ori,
                                           patch_2843)
    if src.dim() == 3 and src.shape[-1] == 3:
        return quantized_orientations_color(src.permute(2, 0, 1),
                                            weak_threshold, n_ori,
                                            patch_2843)
    raise ValueError(f"expected [H,W] gray or [H,W,3] color, got "
                     f"{tuple(src.shape)}")
