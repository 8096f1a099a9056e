"""Counted candidate extraction, ``csrc/extract.cu``.

``extract_counted(S, cnt, positions, rmin, t4n, T, W, C)`` takes the
coarse scores ``S [B, K, M]`` int32 (template-indexed rows, as
``coarse_scores`` and ``chain_scores`` return them), the live counts
``cnt [B, K]`` int32 (cells with ``j < positions[k]`` and ``S >=
rmin[k]``), ``positions``, ``rmin`` [K] int32 and ``t4n`` [K] float32,
and returns the first C candidates of each frame, ``(k, x, y, score,
valid)`` each ``[B, C]``, and ``n_above [B]``, the exact candidate count.
Slot i of a frame belongs to the template whose inclusive count prefix
first exceeds i; its rank r in that template picks the r-th live cell,
or, past the live cells, the quirk cell ``clip(pos, 0, M) + (r - live)``
at score 0 (cells past the positions of a template whose ``rmin <= 0``:
the reference scans a zero-initialized similarity Mat,
line2Dup.cpp:1190-1216). Slots at or past ``n_above`` take template K-1
under the same formulas, invalid.

It replaces the TPU package's XLA extraction
(``shape_based_matching_tpu/ops/similarity.py::_extract_counted_core``;
no Pallas kernel). On a CUDA tensor a call is two launches and no torch
op: ``count_prefix`` (the count prefix, ``n_above`` and the work list of
the templates that own slots below C) and the extraction, which walks
the listed rows in segments of ``SEG_CELLS`` cells spread over the card.
The plain twin ``extract_counted_plain`` gathers a whole score row per
slot, ``[B, chunk, M]`` int32 twice, a chunk of slots at a time.

On a CPU tensor the wrappers run the twins; on a CUDA tensor they launch
the kernels or raise. The kernels' results equal the twins' on every
output and every slot.
"""

from __future__ import annotations

import torch

from . import build

SEG_CELLS = 8192  # csrc/extract.cu's SEG: cells of a row's segment
REC = 8           # int32 words of a work record


def _prefix(cnt: torch.Tensor, positions: torch.Tensor, rmin: torch.Tensor,
            M: int):
    """Per frame and template: the candidate count bcnt (live cells, plus
    the quirk cells past the positions where rmin <= 0) and its inclusive
    prefix over the templates (int32). The twin's prefix."""
    pos = positions
    qcnt = torch.where(rmin <= 0, M - pos.clamp(0, M), torch.zeros_like(pos))
    bcnt = cnt + qcnt[None, :]                                  # [B, K]
    return bcnt, bcnt.cumsum(dim=1, dtype=torch.int32)


def _levels(M: int) -> int:
    """Segments of the longest row: the extraction's look-back levels."""
    return max(1, -(-M // SEG_CELLS))


def _prefix_launch(cnt: torch.Tensor, positions: torch.Tensor,
                   rmin: torch.Tensor, t4n: torch.Tensor, M: int, C: int):
    """Launch the prefix kernel (B > 0, CUDA tensors): returns n_above [B],
    the scratch holding work [B, K, REC], meta [B, 2] and status [B, L, K]
    int32 in that order, the three parts' addresses and the stream."""
    B, K = cnt.shape
    L = _levels(M)
    dev = cnt.device
    n_above = torch.empty(B, dtype=torch.int32, device=dev)
    buf = torch.empty(B * K * REC + 2 * B + B * L * K, dtype=torch.int32,
                      device=dev)
    work = buf.data_ptr()  # first: 16-byte aligned records
    meta = work + 4 * B * K * REC
    status = meta + 8 * B
    stream = build.stream_ptr(dev)
    ins = [t.contiguous() for t in (cnt, positions, rmin, t4n)]
    build.check(build.library().sbm_extract_prefix(
        *(t.data_ptr() for t in ins), n_above.data_ptr(), work, meta, status,
        B, K, M, C, L, stream), "sbm_extract_prefix")
    count_prefix.launches += 1
    return n_above, buf, (work, meta, status), stream


def count_prefix_plain(cnt: torch.Tensor, positions: torch.Tensor,
                       rmin: torch.Tensor, t4n: torch.Tensor, M: int,
                       C: int):
    """Plain twin of the prefix kernel: n_above [B] and, per frame, the
    work list ``work[b, :meta[b, 0]]``: the templates whose slot range
    ``[excl, incl)`` meets ``[0, C)`` (template K-1 while ``excl < C``:
    it owns the slots past n_above), in template order, each a record
    ``(k, excl, incl, cnt, clip(pos, 0, M), rmin, t4n bits, 0)``; ``meta[b,
    1]``, the extraction's ticket, and the look-back words ``status[b, :,
    :meta[b, 0]]`` are 0. Returns (n_above, work, meta, status); work
    rows past the list are 0 here."""
    B, K = cnt.shape
    dev = cnt.device
    bcnt, incl = _prefix(cnt, positions, rmin, M)
    excl = incl - bcnt
    last = torch.arange(K, device=dev) == K - 1
    need = torch.where(last, C, incl.clamp(max=C)) - excl
    take = (excl < C) & (need > 0)
    rec = torch.stack([
        torch.arange(K, dtype=torch.int32, device=dev).expand(B, K), excl,
        incl, cnt, positions.clamp(0, M).expand(B, K),
        rmin.expand(B, K), t4n.view(torch.int32).expand(B, K),
        torch.zeros((B, K), dtype=torch.int32, device=dev)], dim=2)
    # listed records first, in template order (a stable sort on ~take)
    order = torch.sort((~take).to(torch.int8), dim=1, stable=True)[1]
    nwork = take.sum(dim=1, dtype=torch.int32)
    work = torch.where((torch.arange(K, device=dev)[None] < nwork[:, None])
                       [..., None], rec.gather(1, order[..., None].expand(
                           B, K, REC)), 0)
    meta = torch.stack([nwork, torch.zeros_like(nwork)], dim=1)
    status = torch.zeros((B, _levels(M), K), dtype=torch.int32, device=dev)
    return incl[:, -1].contiguous(), work, meta, status


def count_prefix(cnt: torch.Tensor, positions: torch.Tensor,
                 rmin: torch.Tensor, t4n: torch.Tensor, M: int, C: int):
    """The prefix kernel: (n_above, work, meta, status) as
    ``count_prefix_plain`` gives them, but work rows past each frame's list
    unset, and the look-back words set only where rows have more than one
    segment (the only ones the extraction reads). One launch on a CUDA
    tensor, none for B = 0."""
    B, K = cnt.shape
    if cnt.device.type == "cpu":
        return count_prefix_plain(cnt, positions, rmin, t4n, M, C)
    if cnt.device.type != "cuda":
        raise ValueError(f"unsupported device {cnt.device}")
    L = _levels(M)
    if B == 0:
        n_above, buf = (torch.empty(0, dtype=torch.int32, device=cnt.device)
                        for _ in range(2))
    else:
        n_above, buf, _, _ = _prefix_launch(cnt, positions, rmin, t4n, M, C)
    n = B * K * REC
    return (n_above, buf[:n].view(B, K, REC),
            buf[n:n + 2 * B].view(B, 2), buf[n + 2 * B:].view(B, L, K))


count_prefix.launches = 0

# score-row cells that the twin gathers at once: a chunk of slots holds
# at most this many [B, chunk, M] cells
_PLAIN_CELLS = 1 << 28


def extract_counted_plain(S: torch.Tensor, cnt: torch.Tensor,
                          positions: torch.Tensor, rmin: torch.Tensor,
                          t4n: torch.Tensor, T: int, W: int, C: int):
    """Plain twin: a searchsorted over the count prefix, then each slot's
    whole score row gathered and ranked by a cumulative sum, in chunks of
    slots of at most ``_PLAIN_CELLS`` gathered cells (every slot is
    independent of the others, so the chunks change no bit)."""
    B, K, M = S.shape
    bcnt, incl = _prefix(cnt, positions, rmin, M)
    step = max(1, _PLAIN_CELLS // max(1, B * M))
    parts = [_plain_slots(S, cnt, positions, rmin, t4n, T, W, bcnt, incl,
                          s, min(C, s + step))
             for s in range(0, max(C, 1), step)]
    return (*(torch.cat(p, dim=1) for p in zip(*parts)), incl[:, -1])


def _plain_slots(S, cnt, pos, rmin, t4n, T, W, bcnt, incl, s0, s1):
    """The twin's (k, x, y, score, valid) [B, s1 - s0] of slots s0..s1-1."""
    B, K, M = S.shape
    dev = S.device
    slots = torch.arange(s0, s1, dtype=torch.int32, device=dev) \
        .expand(B, s1 - s0)
    k = torch.searchsorted(incl, slots.contiguous(), right=True)
    got = k < K
    k = k.clamp(max=K - 1)
    r = slots - (incl - bcnt).gather(1, k)                      # rank
    lcnt = cnt.gather(1, k)
    is_quirk = r >= lcnt

    rows = S[torch.arange(B, device=dev)[:, None], k]           # [B, c, M]
    j = torch.arange(M, dtype=torch.int32, device=dev)
    live = (j < pos[k][..., None]) & (rows >= rmin[k][..., None])
    ranks = live.to(torch.int32).cumsum(dim=2, dtype=torch.int32)
    j_live = torch.searchsorted(ranks, r[..., None].contiguous(),
                                right=True)[..., 0].clamp(max=M - 1)
    raw_live = rows.gather(2, j_live[..., None])[..., 0]

    jq = pos[k].clamp(0, M) + (r - lcnt)
    jj = torch.where(is_quirk, jq, j_live.to(torch.int32))
    raw = torch.where(is_quirk, torch.zeros_like(raw_live), raw_live)
    sc = (raw * 100).to(torch.float32) / t4n[k]
    offset = T // 2 + (T % 2 - 1)
    x = torch.remainder(jj, W) * T + offset
    y = torch.div(jj, W, rounding_mode="floor") * T + offset
    return k.to(torch.int32), x, y, sc, got


def _check(S, cnt, positions, rmin, t4n, T, W, C) -> None:
    if S.dim() != 3 or S.dtype != torch.int32:
        raise ValueError("S must be [B, K, M] int32")
    B, K, M = S.shape
    if K == 0 or M == 0:
        raise ValueError(f"S [B, K, M] needs K > 0 and M > 0, got "
                         f"{tuple(S.shape)}")
    if not (T > 0 and W > 0 and C >= 0):
        raise ValueError(f"T={T}, W={W}, C={C}: need T, W > 0, C >= 0")
    for t, name, dtype, shape in ((cnt, "cnt", torch.int32, (B, K)),
                                  (positions, "positions", torch.int32, (K,)),
                                  (rmin, "rmin", torch.int32, (K,)),
                                  (t4n, "t4n", torch.float32, (K,))):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != S.device:
            raise ValueError(f"{name}: expected {dtype} {shape} on "
                             f"{S.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if S.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {S.device}")


def extract_counted(S: torch.Tensor, cnt: torch.Tensor,
                    positions: torch.Tensor, rmin: torch.Tensor,
                    t4n: torch.Tensor, T: int, W: int, C: int):
    """S [B, K, M] int32, cnt [B, K] int32, positions/rmin [K] int32, t4n
    [K] float32 -> (k, x, y [B, C] int32, score [B, C] float32, valid
    [B, C] bool, n_above [B] int32)."""
    _check(S, cnt, positions, rmin, t4n, T, W, C)
    if S.device.type == "cpu":
        return extract_counted_plain(S, cnt, positions, rmin, t4n, T, W, C)
    if not S.is_contiguous():
        raise ValueError("S must be contiguous")
    B, K, M = S.shape
    if M >= 1 << 30:  # the look-back words hold counts below 2^30
        raise ValueError(f"M={M}: the kernel takes rows below 2^30 cells")
    if B > 65535:  # a grid dimension of the one-segment launch
        raise ValueError(f"B={B}: the kernel takes at most 65,535 frames")
    dev = S.device
    outs = tuple(torch.empty((B, C), dtype=dtype, device=dev)
                 for dtype in (torch.int32, torch.int32, torch.int32,
                               torch.float32, torch.bool))
    if B == 0:
        return (*outs, torch.empty(0, dtype=torch.int32, device=dev))
    # the scratch stays referenced until the extraction is queued
    n_above, scratch, parts, stream = _prefix_launch(cnt, positions, rmin,
                                                     t4n, M, C)
    if C == 0:
        return (*outs, n_above)
    vec = int(M % 4 == 0 and S.data_ptr() % 16 == 0)
    build.check(build.library().sbm_extract_counted(
        S.data_ptr(), *parts, *(t.data_ptr() for t in outs), B, K, M, C, T,
        W, _levels(M), vec, stream), "sbm_extract_counted")
    extract_counted.launches += 1
    return (*outs, n_above)


extract_counted.launches = 0
