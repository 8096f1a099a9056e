"""Kernels 2 and 4: coarse scoring, ``csrc/coarse.cu``.

``coarse_scores(lmflat, off, pos, rmin, M)`` returns
``S[b, k, j] = sum_n lmflat[b, off[k, n] + j]`` for every cell j < M as
``[B, K, M]`` int32, and ``cnt[b, k]``, the number of cells with
``j < pos[k]`` and ``S >= rmin[k]``, as ``[B, K]`` int32.
``coarse_maps(lmflat, off, M)`` is the same launch with the count off: the
unmasked maps ``S`` alone. They replace the TPU kernel
``shape_based_matching_tpu/ops/pallas/similarity_pallas.py::
_make_rotate_kernel`` in its counted and uncounted forms, and the wide
kernel ``_make_wide_kernel`` (banks of 64 or more slots): the int32 sums
have no feature limit, so one kernel serves every bank width.

On a CPU tensor each wrapper runs its plain twin (``coarse_scores_plain``,
``coarse_maps_plain``); on a CUDA tensor it launches the kernel or raises.
``coarse_split`` chooses, from the shapes alone, how many slot groups the
kernel spreads over blocks (see ``csrc/coarse.cu``).
"""

from __future__ import annotations

import torch

from . import build


def coarse_maps_plain(lmflat: torch.Tensor, off: torch.Tensor, M: int):
    """Plain twin of ``coarse_maps``: one sliding-window gather per
    feature slot."""
    B = lmflat.shape[0]
    K, N = off.shape
    S = torch.zeros((B, K, M), dtype=torch.int32, device=lmflat.device)
    # windows[b, o] = lmflat[b, o:o+M] as a view (no copy)
    windows = lmflat.unfold(1, M, 1)
    for n in range(N):
        S += windows[:, off[:, n].long()].to(torch.int32)
    return S


def count_live(S: torch.Tensor, pos: torch.Tensor, rmin: torch.Tensor):
    """cnt [B, K]: cells of S [B, K, M] with j < pos[k] and S >= rmin[k]."""
    j = torch.arange(S.shape[2], device=S.device)
    live = (j[None, :] < pos[:, None]) & (S >= rmin[:, None])
    return live.sum(dim=2, dtype=torch.int32)


def coarse_scores_plain(lmflat: torch.Tensor, off: torch.Tensor,
                        pos: torch.Tensor, rmin: torch.Tensor, M: int):
    """Plain twin of ``coarse_scores``."""
    S = coarse_maps_plain(lmflat, off, M)
    return S, count_live(S, pos, rmin)


SM_COUNT = 132        # streaming multiprocessors of one H100 SXM
FULL_BLOCKS = 8 * SM_COUNT  # 256-thread blocks the card holds at once
TILE = 1024           # cells per block of coarse.cu (256 threads x 4)
MIN_GROUP_SLOTS = 64  # fewest slots worth a block of their own


def coarse_split(B: int, K: int, N: int, M: int) -> tuple[int, int]:
    """(G, chunk): coarse.cu sums slots [g * chunk, min(N, (g + 1) *
    chunk)) in slot group g < G. G = 1 when B * K * ceil(M / TILE) blocks
    already fill the card (FULL_BLOCKS), or when N is too short to
    share; otherwise the fewest groups that fill it, each of at least
    MIN_GROUP_SLOTS slots."""
    blocks = B * K * -(-M // TILE)
    if blocks >= FULL_BLOCKS or N < 2 * MIN_GROUP_SLOTS:
        return 1, max(N, 1)
    G = min(-(-FULL_BLOCKS // blocks), N // MIN_GROUP_SLOTS)
    chunk = -(-N // G)
    return -(-N // chunk), chunk


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_args(lmflat, off, M, pos=None, rmin=None) -> None:
    if lmflat.dim() != 2:
        raise ValueError("lmflat must be [B, L + M]")
    B, Lf = lmflat.shape
    K, N = off.shape
    _check(lmflat, "lmflat", torch.uint8, (B, Lf))
    args = ((off, "off", (K, N)),)
    if pos is not None:
        args += ((pos, "pos", (K,)), (rmin, "rmin", (K,)))
    for t, name, shape in args:
        _check(t, name, torch.int32, shape)
        if t.device != lmflat.device:
            raise ValueError(f"{name} is on {t.device}, lmflat on "
                             f"{lmflat.device}")
    if lmflat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lmflat.device}")
    if not 0 < M <= Lf:
        raise ValueError(f"M={M} does not fit lmflat of length {Lf}")


def _launch(lmflat, off, M, pos=None, rmin=None):
    """Launch coarse.cu on checked CUDA tensors; the count is off when
    pos is None. Returns (S, cnt or None)."""
    B, Lf = lmflat.shape
    K, N = off.shape
    G, chunk = coarse_split(B, K, N, M)
    # a split launch adds its partial sums into a zeroed S
    S = (torch.zeros if G > 1 else torch.empty)(
        (B, K, M), dtype=torch.int32, device=lmflat.device)
    cnt = None if pos is None else torch.zeros(
        (B, K), dtype=torch.int32, device=lmflat.device)
    if B == 0 or K == 0:
        return S, cnt
    lib = build.library()
    build.check(lib.sbm_coarse_scores(
        lmflat.data_ptr(), Lf, off.data_ptr(),
        None if pos is None else pos.data_ptr(),
        None if rmin is None else rmin.data_ptr(), S.data_ptr(),
        None if cnt is None else cnt.data_ptr(), B, K, N, M, G, chunk,
        build.stream_ptr(lmflat.device)), "sbm_coarse_scores")
    return S, cnt


def coarse_scores(lmflat: torch.Tensor, off: torch.Tensor,
                  pos: torch.Tensor, rmin: torch.Tensor, M: int):
    """lmflat [B, L + M] uint8 (linear memories + zero tail), off [K, N]
    int32 flat offsets (L for dead slots), pos/rmin [K] int32 ->
    (S [B, K, M] int32, cnt [B, K] int32)."""
    _check_args(lmflat, off, M, pos, rmin)
    if lmflat.device.type == "cpu":
        return coarse_scores_plain(lmflat, off, pos, rmin, M)
    S, cnt = _launch(lmflat, off, M, pos, rmin)
    coarse_scores.launches += 1
    return S, cnt


def coarse_maps(lmflat: torch.Tensor, off: torch.Tensor, M: int):
    """lmflat [B, L + M] uint8, off [K, N] int32 -> the unmasked maps
    S [B, K, M] int32 (coarse.cu with the count off)."""
    _check_args(lmflat, off, M)
    if lmflat.device.type == "cpu":
        return coarse_maps_plain(lmflat, off, M)
    S, _ = _launch(lmflat, off, M)
    coarse_maps.launches += 1
    return S


coarse_scores.launches = 0
coarse_maps.launches = 0
