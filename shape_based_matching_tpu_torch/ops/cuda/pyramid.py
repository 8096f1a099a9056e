"""The pyramid layer's kernels around the frontend, ``csrc/pyramid.cu``.

``pyr_down(imgs)`` maps uint8 frames ``[..., H, W]`` -- gray ``[B, H,
W]`` or planar color ``[B, 3, H, W]`` -- to ``[..., H//2, W//2]``,
cv::pyrDown bit for bit (``ops/filters.py::pyr_down_u8_plain``).

``linear_memories(sp, T, n_ori)`` maps spread planes ``[B, H, W]``
(uint8 for 8 orientations, uint16 for 16) to a level's flat buffer ``[B,
n_ori*T*T*M + M]`` uint8, M = (H/T)(W/T): the ``[n_ori, T*T, M]`` linear
memories of each frame (``ops/response.py::build_lm_from_spread``), then
the M-byte zero tail that dead and off-image features read.

Port-only kernels: the JAX package computes both in XLA, with no Pallas
kernel. On a CPU tensor each wrapper runs its plain twin; on a CUDA
tensor it makes one launch and no torch op, or raises. ``lm_split``
chooses, from T alone, the cells of a cell row that one block of the
linear-memory kernel owns.
"""

from __future__ import annotations

import torch

from ..filters import pyr_down_u8_plain
from ..response import build_lm_from_spread
from . import build
from .frontend import T_MAX

LM_RUN = 16     # pyramid.cu: cells a thread stores at once
LM_TILE = 4096  # pyramid.cu: T*T*XC cells a block at most


def lm_split(T: int) -> int:
    """XC, the cells of a cell row that one block owns: the most that
    keep T*T*XC within LM_TILE, a multiple of LM_RUN (at least one
    run)."""
    return max(LM_RUN, LM_TILE // (T * T) // LM_RUN * LM_RUN)


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def pyr_down(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 [..., H, W] -> [..., H//2, W//2] (cv::pyrDown)."""
    _check_device(imgs)
    if imgs.dtype != torch.uint8 or imgs.dim() < 2:
        raise ValueError(f"expected uint8 [..., H, W] frames, got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("frames must be contiguous")
    if imgs.device.type == "cpu":
        return pyr_down_u8_plain(imgs)
    H, W = imgs.shape[-2:]
    out = torch.empty((*imgs.shape[:-2], H // 2, W // 2), dtype=torch.uint8,
                      device=imgs.device)
    if out.numel():
        build.check(build.library().sbm_pyr_down(
            imgs.data_ptr(), out.data_ptr(), imgs.numel() // (H * W), H, W,
            build.stream_ptr(imgs.device)), "sbm_pyr_down")
        pyr_down.launches += 1
    return out


pyr_down.launches = 0


def linear_memories_plain(sp: torch.Tensor, T: int,
                          n_ori: int = 8) -> torch.Tensor:
    """Plain twin: build_lm_from_spread's [B, n_ori, T*T, M] flattened,
    then M zero bytes."""
    lm = build_lm_from_spread(sp, T, n_ori)
    B, M = lm.shape[0], lm.shape[-1]
    return torch.cat([lm.reshape(B, -1), lm.new_zeros((B, M))], dim=1)


def linear_memories(sp: torch.Tensor, T: int, n_ori: int = 8) -> torch.Tensor:
    """[B, H, W] spread planes (uint8 for 8 orientations, uint16 for 16) ->
    [B, n_ori*T*T*M + M] uint8 linear memories with their zero tail."""
    _check_device(sp)
    if n_ori not in (8, 16):
        raise ValueError(f"n_ori={n_ori}: 8 or 16 orientations")
    want = torch.uint8 if n_ori == 8 else torch.uint16
    if sp.dtype != want or sp.dim() != 3:
        raise ValueError(f"expected {want} [B, H, W] spread planes for "
                         f"{n_ori} orientations, got {sp.dtype} "
                         f"{tuple(sp.shape)}")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"T={T} outside 1..{T_MAX}")
    B, H, W = sp.shape
    if H % T or W % T:
        raise ValueError(f"{W}x{H} is not a multiple of T={T}")
    if not sp.is_contiguous():
        raise ValueError("spread planes must be contiguous")
    if sp.device.type == "cpu":
        return linear_memories_plain(sp, T, n_ori)
    M = (H // T) * (W // T)
    out = torch.empty((B, n_ori * T * T * M + M), dtype=torch.uint8,
                      device=sp.device)
    if out.numel():
        build.check(build.library().sbm_linear_memories(
            sp.data_ptr(), out.data_ptr(), B, H, W, T, lm_split(T), n_ori,
            build.stream_ptr(sp.device)), "sbm_linear_memories")
        linear_memories.launches += 1
    return out


linear_memories.launches = 0
