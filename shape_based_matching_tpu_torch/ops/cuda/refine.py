"""Kernel 3: windowed candidate refinement, ``csrc/refine.cu``.

``refine_windows(lmflat, bank, T, size_wh, k, wx, wy, live)`` scores each
candidate's 16x16 window of the fine level straight from the linear
memories and returns the first-max cell ``best`` and its raw score
``raw``, both ``[B, C]`` int32. It replaces the TPU kernel
``shape_based_matching_tpu/ops/pallas/refine_pallas.py::_window_kernel``
and the argmax of its epilogue. Candidates with ``live`` False do no work
and report 0, 0.

On a CPU tensor the wrapper runs ``refine_windows_plain``; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build


def refine_windows_plain(lmflat: torch.Tensor, bank, T: int, size_wh,
                         k: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                         live: torch.Tensor):
    """Plain twin: gather [B, C, N, 256] window bytes and sum over N."""
    w_img, h_img = size_wh
    W = w_img // T
    M = W * (h_img // T)
    B, Lf = lmflat.shape
    # flat address of each feature at its candidate's window origin; dead
    # slots and features off the image address the zero tail L = Lf - M
    fx = bank.fx[k] + (wx * T)[..., None]
    fy = bank.fy[k] + (wy * T)[..., None]
    inb = (bank.valid[k] & (fx >= 0) & (fx < w_img)
           & (fy >= 0) & (fy < h_img))
    plane = bank.label[k] * (T * T) + (fy % T) * T + (fx % T)
    base = plane * M + torch.div(fy, T, rounding_mode="floor") * W \
        + torch.div(fx, T, rounding_mode="floor")
    base = torch.where(inb, base, torch.full_like(base, Lf - M))
    rr = torch.arange(16, device=lmflat.device)
    cell = (rr[:, None] * W + rr[None, :]).reshape(-1)
    idx = (base[..., None].long() + cell).clamp_(max=Lf - 1)  # [B,C,N,256]
    g = torch.gather(lmflat, 1, idx.reshape(B, -1)).view(idx.shape)
    patch = g.to(torch.int32).sum(dim=2, dtype=torch.int32)      # [B,C,256]
    patch = torch.where(live[..., None], patch, torch.zeros_like(patch))
    raw, best = patch.max(dim=2)  # ties -> first index (strict > in C++)
    return best.to(torch.int32), raw.to(torch.int32)


def refine_windows(lmflat: torch.Tensor, bank, T: int, size_wh,
                   k: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                   live: torch.Tensor):
    """lmflat [B, L + M] uint8; bank a LevelBank on the same device;
    k, wx, wy [B, C] int32 (template, window origin on the T-grid);
    live [B, C] bool -> (best [B, C] int32, raw [B, C] int32)."""
    if lmflat.dim() != 2 or lmflat.dtype != torch.uint8:
        raise ValueError("lmflat must be [B, L + M] uint8")
    B, Lf = lmflat.shape
    for t, name, dtype in ((k, "k", torch.int32), (wx, "wx", torch.int32),
                           (wy, "wy", torch.int32),
                           (live, "live", torch.bool)):
        if t.dtype != dtype or t.dim() != 2 or t.shape[0] != B:
            raise ValueError(f"{name}: expected {dtype} [B, C], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != lmflat.device:
            raise ValueError(f"{name} is on {t.device}, lmflat on "
                             f"{lmflat.device}")
    if lmflat.device.type == "cpu":
        return refine_windows_plain(lmflat, bank, T, size_wh, k, wx, wy,
                                    live)
    if lmflat.device.type != "cuda":
        raise ValueError(f"unsupported device {lmflat.device}")
    if not lmflat.is_contiguous():
        raise ValueError("lmflat must be contiguous")
    K, N = bank.fx.shape
    for name in ("fx", "fy", "label", "valid"):
        t = getattr(bank, name)
        if (tuple(t.shape) != (K, N) or not t.is_contiguous()
                or t.device != lmflat.device):
            raise ValueError(f"bank.{name} must be a contiguous [K, N] "
                             f"tensor on {lmflat.device}")
    w_img, h_img = size_wh
    if Lf != (8 * T * T + 1) * (w_img // T) * (h_img // T):
        raise ValueError(f"lmflat length {Lf} does not match {size_wh} at "
                         f"T={T}")
    k, wx, wy, live = (t.contiguous() for t in (k, wx, wy, live))
    C = k.shape[1]
    best = torch.empty((B, C), dtype=torch.int32, device=lmflat.device)
    raw = torch.empty_like(best)
    if B == 0 or C == 0:
        return best, raw
    lib = build.library()
    build.check(lib.sbm_refine_windows(
        lmflat.data_ptr(), Lf, bank.fx.data_ptr(),
        bank.fy.data_ptr(), bank.label.data_ptr(), bank.valid.data_ptr(),
        k.data_ptr(), wx.data_ptr(), wy.data_ptr(), live.data_ptr(),
        best.data_ptr(), raw.data_ptr(), B, C, N, w_img, h_img, T,
        build.stream_ptr(lmflat.device)), "sbm_refine_windows")
    refine_windows.launches += 1
    return best, raw


refine_windows.launches = 0
