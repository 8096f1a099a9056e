"""Kernel 9: map-window candidate refinement, ``csrc/map_refine.cu``.

``map_refine(Sfull, W, slot, wx, wy, live)`` reads each candidate's 16x16
window out of the unmasked score maps ``Sfull [B, D, M]`` of the distinct
candidate templates -- cell (rr, cc) at the flat index
``slot*M + (wy+rr)*W + wx+cc``, clipped to the frame's ``D*M`` maps -- and
returns the first-max cell ``best`` and its value ``raw``, both ``[B, C]``
int32. It replaces the TPU kernel ``shape_based_matching_tpu/ops/pallas/
refine_pallas.py::_map_window_kernel`` and the argmax of its epilogue.
Candidates with ``live`` False or ``slot < 0`` do no work and report 0, 0.

On a CPU tensor the wrapper runs ``map_refine_plain``; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build


def map_refine_plain(Sfull: torch.Tensor, W: int, slot: torch.Tensor,
                     wx: torch.Tensor, wy: torch.Tensor, live: torch.Tensor):
    """Plain twin: one [B, C, 256] gather and an argmax."""
    B, D, M = Sfull.shape
    rr = torch.arange(16, device=Sfull.device)
    cell = (rr[:, None] * W + rr[None, :]).reshape(-1)
    base = slot.long() * M + wy.long() * W + wx.long()
    idx = (base[..., None] + cell).clamp_(0, D * M - 1)       # [B, C, 256]
    patch = torch.gather(Sfull.reshape(B, -1), 1,
                         idx.reshape(B, -1)).view(idx.shape)
    live = live & (slot >= 0)
    patch = torch.where(live[..., None], patch, torch.zeros_like(patch))
    raw, best = patch.max(dim=2)  # ties -> first index (strict > in C++)
    return best.to(torch.int32), raw.to(torch.int32)


def map_refine(Sfull: torch.Tensor, W: int, slot: torch.Tensor,
               wx: torch.Tensor, wy: torch.Tensor, live: torch.Tensor):
    """Sfull [B, D, M] int32; slot, wx, wy [B, C] int32 (the candidate's
    map row and window origin on the grid of width W); live [B, C] bool
    -> (best [B, C] int32, raw [B, C] int32)."""
    if Sfull.dim() != 3 or Sfull.dtype != torch.int32:
        raise ValueError("Sfull must be [B, D, M] int32")
    B, D, M = Sfull.shape
    for t, name, dtype in ((slot, "slot", torch.int32),
                           (wx, "wx", torch.int32), (wy, "wy", torch.int32),
                           (live, "live", torch.bool)):
        if t.dtype != dtype or t.dim() != 2 or t.shape != slot.shape \
                or t.shape[0] != B:
            raise ValueError(f"{name}: expected {dtype} [B, C], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != Sfull.device:
            raise ValueError(f"{name} is on {t.device}, Sfull on "
                             f"{Sfull.device}")
    if D == 0 or not 0 < W <= M:
        raise ValueError(f"W={W} does not fit {D} maps of {M} cells")
    if Sfull.device.type == "cpu":
        return map_refine_plain(Sfull, W, slot, wx, wy, live)
    if Sfull.device.type != "cuda":
        raise ValueError(f"unsupported device {Sfull.device}")
    if not Sfull.is_contiguous():
        raise ValueError("Sfull must be contiguous")
    slot, wx, wy, live = (t.contiguous() for t in (slot, wx, wy, live))
    C = slot.shape[1]
    best = torch.empty((B, C), dtype=torch.int32, device=Sfull.device)
    raw = torch.empty_like(best)
    if B == 0 or C == 0:
        return best, raw
    lib = build.library()
    build.check(lib.sbm_map_refine(
        Sfull.data_ptr(), D, M, W, slot.data_ptr(), wx.data_ptr(),
        wy.data_ptr(), live.data_ptr(), best.data_ptr(), raw.data_ptr(), B,
        C, build.stream_ptr(Sfull.device)), "sbm_map_refine")
    map_refine.launches += 1
    return best, raw


map_refine.launches = 0
