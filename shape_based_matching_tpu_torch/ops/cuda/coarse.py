"""Kernel 2: counted coarse scoring, ``csrc/coarse.cu``.

``coarse_scores(lmflat, off, pos, rmin, M)`` returns
``S[b, k, j] = sum_n lmflat[b, off[k, n] + j]`` for every cell j < M as
``[B, K, M]`` int32, and ``cnt[b, k]``, the number of cells with
``j < pos[k]`` and ``S >= rmin[k]``, as ``[B, K]`` int32. It replaces the
TPU kernel ``shape_based_matching_tpu/ops/pallas/similarity_pallas.py::
_make_rotate_kernel`` in its counted form.

On a CPU tensor the wrapper runs ``coarse_scores_plain``; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build


def coarse_scores_plain(lmflat: torch.Tensor, off: torch.Tensor,
                        pos: torch.Tensor, rmin: torch.Tensor, M: int):
    """Plain twin: one sliding-window gather per feature slot."""
    B = lmflat.shape[0]
    K, N = off.shape
    S = torch.zeros((B, K, M), dtype=torch.int32, device=lmflat.device)
    # windows[b, o] = lmflat[b, o:o+M] as a view (no copy)
    windows = lmflat.unfold(1, M, 1)
    for n in range(N):
        S += windows[:, off[:, n].long()].to(torch.int32)
    j = torch.arange(M, device=lmflat.device)
    live = (j[None, :] < pos[:, None]) & (S >= rmin[:, None])
    return S, live.sum(dim=2, dtype=torch.int32)


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def coarse_scores(lmflat: torch.Tensor, off: torch.Tensor,
                  pos: torch.Tensor, rmin: torch.Tensor, M: int):
    """lmflat [B, L + M] uint8 (linear memories + zero tail), off [K, N]
    int32 flat offsets (L for dead slots), pos/rmin [K] int32 ->
    (S [B, K, M] int32, cnt [B, K] int32)."""
    if lmflat.dim() != 2:
        raise ValueError("lmflat must be [B, L + M]")
    B, Lf = lmflat.shape
    K, N = off.shape
    _check(lmflat, "lmflat", torch.uint8, (B, Lf))
    for t, name, shape in ((off, "off", (K, N)), (pos, "pos", (K,)),
                           (rmin, "rmin", (K,))):
        _check(t, name, torch.int32, shape)
        if t.device != lmflat.device:
            raise ValueError(f"{name} is on {t.device}, lmflat on "
                             f"{lmflat.device}")
    if lmflat.device.type == "cpu":
        return coarse_scores_plain(lmflat, off, pos, rmin, M)
    if lmflat.device.type != "cuda":
        raise ValueError(f"unsupported device {lmflat.device}")
    if not 0 < M <= Lf:
        raise ValueError(f"M={M} does not fit lmflat of length {Lf}")
    S = torch.empty((B, K, M), dtype=torch.int32, device=lmflat.device)
    cnt = torch.zeros((B, K), dtype=torch.int32, device=lmflat.device)
    if B == 0 or K == 0:
        return S, cnt
    lib = build.library()
    build.check(lib.sbm_coarse_scores(
        lmflat.data_ptr(), Lf, off.data_ptr(), pos.data_ptr(),
        rmin.data_ptr(), S.data_ptr(), cnt.data_ptr(), B, K, N, M,
        build.stream_ptr(lmflat.device)), "sbm_coarse_scores")
    coarse_scores.launches += 1
    return S, cnt


coarse_scores.launches = 0
