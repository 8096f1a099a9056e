"""Kernels 1 and 2: the fused frontend, ``csrc/frontend.cu``.

``quant_spread(imgs, weak_threshold, T, n_ori, masks, with_quant,
patch_2843)`` maps uint8 frames -- gray ``[B, H, W]`` or planar color
``[B, 3, H, W]`` -- to their T x T-spread orientation planes ``[B, H,
W]``, uint8 for 8 orientations and uint16 for 16: blur, Sobel (color: the
channel of largest |grad|^2), fastAtan2, vote-quantize, mask and spread
in one launch. ``masks`` (``[B, H, W]`` uint8) zeroes the quantized code
where it is 0, before the spread; ``with_quant`` also returns the
pre-spread quantized plane; ``patch_2843`` takes the opencv_contrib #2843
vote (an interior pixel at or under the weak threshold casts no vote).
It replaces the TPU kernel
``shape_based_matching_tpu/ops/pallas/frontend_pallas.py::_quant_spread_kernel``
as run by ``_quant_spread_batched_impl`` and ``_quant_spread_impl``.

On a CPU tensor the wrapper runs ``quant_spread_plain``; on a CUDA tensor
it launches the kernel or raises. ``frontend_split`` chooses, from the
shapes alone, how many output rows each one-warp block walks (see
``csrc/frontend.cu``).
"""

from __future__ import annotations

import torch

from ..gradients import (quantized_orientations_color,
                         quantized_orientations_gray, weak_threshold_sq)
from ..response import from_i32, spread, to_i32
from . import build
from .coarse import SM_COUNT

T_MAX = 16  # the kernel's spread ring holds T <= 16 rows
VALID_RIGHT = 116  # frontend.cu: a warp writes (VALID_RIGHT - T) & ~3 cols
ROW_STRIPS = (32, 16, 8, 4)  # rows per block, longest first
# one-warp blocks that hide a step's latency, 16 an SM (tools/
# tune_torch_split.py: the fastest strip at the flagship's shapes gives
# 1,280-2,560 of them)
FULL_WARPS = 16 * SM_COUNT


def out_cols(T: int) -> int:
    """Output columns of one block of frontend.cu at spread T."""
    return (VALID_RIGHT - T) & ~3


def frontend_split(B: int, H: int, W: int, T: int) -> int:
    """RS, the output rows a block walks: the longest of ROW_STRIPS whose
    grid of B * ceil(W / out_cols(T)) * ceil(H / RS) blocks still reaches
    FULL_WARPS, else the shortest. A strip walks RS + T + 9 image rows, so
    longer strips waste less on the halo and shorter ones fill the
    card."""
    cols = -(-W // out_cols(T))
    return next((rs for rs in ROW_STRIPS
                 if B * cols * -(-H // rs) >= FULL_WARPS), ROW_STRIPS[-1])


def quant_spread_plain(imgs: torch.Tensor, weak_threshold: float, T: int,
                       n_ori: int = 8, masks: torch.Tensor | None = None,
                       with_quant: bool = False, patch_2843: bool = False):
    """Plain twin: spread(quantized_orientations_{gray,color}(...).angle
    masked where masks == 0, T)."""
    quantize = (quantized_orientations_color if imgs.dim() == 4
                else quantized_orientations_gray)
    angle = quantize(imgs, weak_threshold, n_ori, patch_2843).angle
    quant = to_i32(angle)
    if masks is not None:
        quant = torch.where(masks != 0, quant, 0)
    sp = from_i32(spread(quant, T), angle.dtype)
    return (sp, from_i32(quant, angle.dtype)) if with_quant else sp


def _check(imgs, masks, T, n_ori) -> None:
    if imgs.dtype != torch.uint8 or imgs.dim() not in (3, 4) or (
            imgs.dim() == 4 and imgs.shape[1] != 3):
        raise ValueError(f"expected uint8 [B, H, W] or [B, 3, H, W], got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"T={T} outside 1..{T_MAX}")
    if n_ori not in (8, 16):
        raise ValueError(f"n_ori={n_ori}: 8 or 16 orientations")
    if masks is not None:
        want = (imgs.shape[0], *imgs.shape[-2:])
        if masks.dtype != torch.uint8 or tuple(masks.shape) != want:
            raise ValueError(f"masks: expected uint8 {want}, got "
                             f"{masks.dtype} {tuple(masks.shape)}")
        if masks.device != imgs.device:
            raise ValueError(f"masks are on {masks.device}, frames on "
                             f"{imgs.device}")
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {imgs.device}")


def quant_spread(imgs: torch.Tensor, weak_threshold: float, T: int,
                 n_ori: int = 8, masks: torch.Tensor | None = None,
                 with_quant: bool = False, patch_2843: bool = False):
    """uint8 [B, H, W] or [B, 3, H, W] frames -> [B, H, W] spread planes
    (uint8 for 8 orientations, uint16 for 16), or (spread, quantized)
    with `with_quant`."""
    _check(imgs, masks, T, n_ori)
    if imgs.device.type == "cpu":
        return quant_spread_plain(imgs, weak_threshold, T, n_ori, masks,
                                  with_quant, patch_2843)
    if not imgs.is_contiguous() or (masks is not None
                                    and not masks.is_contiguous()):
        raise ValueError("frames and masks must be contiguous")
    B, H, W = imgs.shape[0], imgs.shape[-2], imgs.shape[-1]
    dtype = torch.uint8 if n_ori == 8 else torch.uint16
    out = torch.empty((B, H, W), dtype=dtype, device=imgs.device)
    quant = torch.empty_like(out) if with_quant else None
    if out.numel():
        lib = build.library()
        build.check(lib.sbm_quant_spread(
            imgs.data_ptr(), None if masks is None else masks.data_ptr(),
            out.data_ptr(), None if quant is None else quant.data_ptr(),
            B, H, W, T, frontend_split(B, H, W, T), n_ori,
            3 if imgs.dim() == 4 else 1, int(patch_2843),
            weak_threshold_sq(weak_threshold),
            build.stream_ptr(imgs.device)), "sbm_quant_spread")
        quant_spread.launches += 1
    return (out, quant) if with_quant else out


quant_spread.launches = 0


def phase_deg_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The frontend kernel's fastAtan2 alone on float32 CUDA tensors (for
    holding it to ``ops/fastmath.phase_deg`` on the card)."""
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or y.dtype != torch.float32 or x.shape != y.shape
            or y.device != x.device):
        raise ValueError("x, y: float32 CUDA tensors of one shape")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    build.check(build.library().sbm_phase_deg(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
        build.stream_ptr(x.device)), "sbm_phase_deg")
    return out
