"""Kernel 9: the map route's refine step, ``csrc/map_refine.cu``.

``map_refine(Sfull, slot_of_k, width, height, nfeat, T, size_wh, k, x, y,
valid, threshold)`` refines every candidate of B frames from the unmasked
level maps ``Sfull [B, D, M]`` of the distinct candidate templates
(``slot_of_k [K]`` maps a template to its map row, -1 for none): the
doubled candidate's window origin under the border clamp, the 16x16
window of its template's map -- cell (rr, cc) at the flat index
``slot*M + (wy+rr)*W + wx+cc``, clipped to the frame's ``D*M`` cells --,
the first-max cell, the float32 score and the threshold. It returns
``(k, x, y, score, valid)``, each ``[B, C]``, as the JAX package's
``refine_from_maps`` does. Candidates that are not valid, or whose
template has no map, read nothing, take the best cell 0 at score 0 and
come out invalid. It replaces the TPU function
``shape_based_matching_tpu/ops/pallas/refine_pallas.py::
_refine_from_maps_pallas``: its kernel ``_map_window_kernel`` and the XLA
work around it (origin, slot lookup, argmax, score epilogue).

The bank comes as its three ``[K]`` int32 fields, and ``threshold`` as a
0-d float32 tensor on the frames' device that the kernel reads itself:
nothing on this path reads the device from the host. Every ``k`` must lie
in ``[0, K)``, as the candidate extraction gives it.

On a CPU tensor the wrapper runs ``map_refine_plain``; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..window import window_origin, window_result
from . import build


def window_cells(Sfull: torch.Tensor, slot_of_k: torch.Tensor,
                 width: torch.Tensor, height: torch.Tensor, T: int, size_wh,
                 k: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 valid: torch.Tensor):
    """The window origin (wx, wy), the live mask (valid with a map) and
    the flat index [B, C, 256] of every window cell in its frame's maps,
    clipped to the frame's D*M cells."""
    B, D, M = Sfull.shape
    W = size_wh[0] // T
    wx, wy = window_origin(width, height, T, size_wh, k, x, y)
    slot = slot_of_k[k]
    live = valid & (slot >= 0)
    rr = torch.arange(16, device=Sfull.device)
    cell = (rr[:, None] * W + rr[None, :]).reshape(-1)
    base = slot.long() * M + wy.long() * W + wx.long()
    idx = (base[..., None] + cell).clamp_(0, D * M - 1)
    return wx, wy, live, idx


def map_refine_plain(Sfull: torch.Tensor, slot_of_k: torch.Tensor,
                     width: torch.Tensor, height: torch.Tensor,
                     nfeat: torch.Tensor, T: int, size_wh, k: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                     threshold: torch.Tensor):
    """Plain twin: the window origin, the slot lookup, one [B, C, 256]
    gather and its first max, the score epilogue."""
    B = Sfull.shape[0]
    wx, wy, live, idx = window_cells(Sfull, slot_of_k, width, height, T,
                                     size_wh, k, x, y, valid)
    patch = torch.gather(Sfull.reshape(B, -1), 1,
                         idx.reshape(B, -1)).view(idx.shape)
    patch = torch.where(live[..., None], patch, torch.zeros_like(patch))
    raw, best = patch.max(dim=2)  # ties -> first index (strict > in C++)
    return window_result(nfeat, T, k, wx, wy, best.to(torch.int32),
                         raw.to(torch.int32), live, threshold)


def map_refine(Sfull: torch.Tensor, slot_of_k: torch.Tensor,
               width: torch.Tensor, height: torch.Tensor,
               nfeat: torch.Tensor, T: int, size_wh, k: torch.Tensor,
               x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
               threshold: torch.Tensor):
    """Sfull [B, D, M] int32 with M = (w/T)(h/T); slot_of_k, width,
    height, nfeat [K] int32; k, x, y [B, C] int32 (the candidates of the
    level above); valid [B, C] bool; threshold 0-d float32 -> (k, x, y
    [B, C] int32, score [B, C] float32, valid [B, C] bool)."""
    if Sfull.dim() != 3 or Sfull.dtype != torch.int32:
        raise ValueError("Sfull must be [B, D, M] int32")
    B, D, M = Sfull.shape
    w_img, h_img = size_wh
    W = w_img // T
    if D == 0 or not T > 0 or W * (h_img // T) != M:
        raise ValueError(f"{D} maps of {M} cells do not fit a {w_img}x"
                         f"{h_img} level at T={T}")
    dev = Sfull.device
    K = slot_of_k.shape[0] if slot_of_k.dim() == 1 else -1
    for t, name in ((slot_of_k, "slot_of_k"), (width, "width"),
                    (height, "height"), (nfeat, "nfeat")):
        if t.dtype != torch.int32 or t.shape != (K,) or t.device != dev:
            raise ValueError(f"{name}: expected int32 [K] on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    shape = k.shape
    for t, name, dtype in ((k, "k", torch.int32), (x, "x", torch.int32),
                           (y, "y", torch.int32),
                           (valid, "valid", torch.bool)):
        if t.dtype != dtype or t.shape != shape or len(shape) != 2 \
                or shape[0] != B or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} [B, C] on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if threshold.dtype != torch.float32 or threshold.dim() != 0 \
            or threshold.device != dev:
        raise ValueError(f"threshold must be a 0-d float32 tensor on {dev}")
    if dev.type == "cpu":
        return map_refine_plain(Sfull, slot_of_k, width, height, nfeat, T,
                                size_wh, k, x, y, valid, threshold)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not Sfull.is_contiguous():
        raise ValueError("Sfull must be contiguous")
    ins = [t.contiguous() for t in (slot_of_k, width, height, nfeat, k, x, y,
                                    valid)]
    C = shape[1]
    outs = tuple(torch.empty((B, C), dtype=dtype, device=dev)
                 for dtype in (torch.int32, torch.int32, torch.int32,
                               torch.float32, torch.bool))
    if B == 0 or C == 0:
        return outs
    lib = build.library()
    build.check(lib.sbm_map_refine(
        Sfull.data_ptr(), D, M, W, *(t.data_ptr() for t in ins),
        threshold.data_ptr(), *(t.data_ptr() for t in outs), T, w_img,
        h_img, B, C, build.stream_ptr(dev)), "sbm_map_refine")
    map_refine.launches += 1
    return outs


map_refine.launches = 0
