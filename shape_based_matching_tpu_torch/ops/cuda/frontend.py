"""Kernel 1: the fused frontend, ``csrc/frontend.cu``.

``quant_spread(imgs, weak_threshold, T)`` maps gray uint8 frames
``[B, H, W]`` to their T x T-spread orientation planes ``[B, H, W]``
uint8: blur, Sobel, fastAtan2, vote-quantize and spread in one launch.
It replaces the TPU kernel
``shape_based_matching_tpu/ops/pallas/frontend_pallas.py::_quant_spread_kernel``.

On a CPU tensor the wrapper runs ``quant_spread_plain``; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..gradients import quantized_orientations_gray, weak_threshold_sq
from ..response import spread
from . import build

T_MAX = 16  # the kernel's shared-memory halo is sized for T <= 16


def quant_spread_plain(imgs: torch.Tensor, weak_threshold: float,
                       T: int) -> torch.Tensor:
    """Plain twin: spread(quantized_orientations_gray(...).angle, T)."""
    return spread(quantized_orientations_gray(imgs, weak_threshold).angle, T)


def quant_spread(imgs: torch.Tensor, weak_threshold: float,
                 T: int) -> torch.Tensor:
    """[B, H, W] uint8 frames -> [B, H, W] uint8 spread planes."""
    if imgs.dim() != 3 or imgs.dtype != torch.uint8:
        raise ValueError(f"expected [B, H, W] uint8, got {imgs.dtype} "
                         f"{tuple(imgs.shape)}")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"T={T} outside 1..{T_MAX}")
    if imgs.device.type == "cpu":
        return quant_spread_plain(imgs, weak_threshold, T)
    if imgs.device.type != "cuda":
        raise ValueError(f"unsupported device {imgs.device}")
    if not imgs.is_contiguous():
        raise ValueError("frames must be contiguous")
    B, H, W = imgs.shape
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    lib = build.library()
    build.check(lib.sbm_quant_spread(
        imgs.data_ptr(), out.data_ptr(), B, H, W, T,
        weak_threshold_sq(weak_threshold), build.stream_ptr(imgs.device)),
        "sbm_quant_spread")
    quant_spread.launches += 1
    return out


quant_spread.launches = 0
