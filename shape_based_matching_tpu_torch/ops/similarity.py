"""Batched template similarity on the match path, in PyTorch.

* Coarse level: ``S[k, j] = sum_n LMflat[off[k, n] + j]`` for all K
  templates and all M decimated positions (kernel 2, ``ops/cuda/coarse``),
  with the reference's flat-offset addressing, row wrap included
  (line2Dup.cpp:782-858).
* Candidate extraction: every cell with ``j < positions[k]`` and
  ``f32(S*100) / f32(4*nfeat) > threshold``, template-major and
  j-ascending, the first ``cand_cap`` of them, plus the exact count
  ``n_above``; with a threshold low enough that a zero score passes, the
  cells past ``positions`` count too, at score 0 (the reference scans a
  zero-initialized similarity Mat, line2Dup.cpp:1190-1216). Static shapes:
  no host sync inside the step.
* Refinement: the 16x16 local similarity around each doubled candidate
  (kernel 3, ``ops/cuda/refine``), border clamp, first-max argmax and the
  float ``raw*100/(4*nfeat)`` score (line2Dup.cpp:1221-1293).

Semantics and every returned bit follow the JAX package's
``ops/similarity.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.coarse import coarse_scores, coarse_scores_plain
from .cuda.refine import refine_windows


class LevelBank(NamedTuple):
    """Padded per-pyramid-level template bank: K templates x N slots."""

    fx: torch.Tensor      # [K, N] int32 feature x (template frame)
    fy: torch.Tensor      # [K, N] int32 feature y
    label: torch.Tensor   # [K, N] int32 orientation bin 0..7
    valid: torch.Tensor   # [K, N] bool
    nfeat: torch.Tensor   # [K] int32 true feature count
    width: torch.Tensor   # [K] int32 cropped template width at this level
    height: torch.Tensor  # [K] int32


def pack_level_bank(templates, device="cpu") -> LevelBank:
    """Pack per-template dicts {'features': [(x, y, label), ...],
    'width': int, 'height': int} of one pyramid level into a LevelBank."""
    K = len(templates)
    N = max(max((len(t["features"]) for t in templates), default=1), 1)
    fx = torch.zeros((K, N), dtype=torch.int32)
    fy = torch.zeros((K, N), dtype=torch.int32)
    lb = torch.zeros((K, N), dtype=torch.int32)
    va = torch.zeros((K, N), dtype=torch.bool)
    for k, t in enumerate(templates):
        feats = t["features"]
        if feats:
            f = torch.tensor([tuple(v[:3]) for v in feats],
                             dtype=torch.int32)
            n = f.shape[0]
            fx[k, :n], fy[k, :n], lb[k, :n] = f[:, 0], f[:, 1], f[:, 2]
            va[k, :n] = True
    nf = torch.tensor([len(t["features"]) for t in templates],
                      dtype=torch.int32)
    w = torch.tensor([t["width"] for t in templates], dtype=torch.int32)
    h = torch.tensor([t["height"] for t in templates], dtype=torch.int32)
    return LevelBank(*(a.to(device) for a in (fx, fy, lb, va, nf, w, h)))


def _flat_offsets(bank: LevelBank, T: int, W: int, M: int,
                  size_wh) -> torch.Tensor:
    """[K, N] int32 flat offset of each feature; dead or off-image slots
    address the zero tail L = 8*T*T*M (accessLinearMemory,
    line2Dup.cpp:782-805)."""
    w_img, h_img = size_wh
    L = 8 * T * T * M
    inb = (bank.valid & (bank.fx >= 0) & (bank.fx < w_img)
           & (bank.fy >= 0) & (bank.fy < h_img))
    plane = bank.label * (T * T) + (bank.fy % T) * T + (bank.fx % T)
    off = plane * M + torch.div(bank.fy, T, rounding_mode="floor") * W \
        + torch.div(bank.fx, T, rounding_mode="floor")
    return torch.where(inb, off, torch.full_like(off, L)).to(torch.int32)


def _positions(bank: LevelBank, T: int, W: int, H: int) -> torch.Tensor:
    """Valid template positions per template (line2Dup.cpp:816-825); may
    be <= 0 for templates larger than the frame."""
    wf = torch.div(bank.width - 1, T, rounding_mode="floor") + 1
    hf = torch.div(bank.height - 1, T, rounding_mode="floor") + 1
    return ((H - hf) * W + (W - wf) + 1).to(torch.int32)


def _rmin_for_threshold(nfeat: torch.Tensor, threshold: torch.Tensor):
    """Smallest integer raw score with ``f32(raw*100) / f32(4*nfeat) >
    threshold`` per template (probing the f32 formula around the real
    boundary), and the f32 normalizer 4*nfeat. `threshold` is a float32
    0-d tensor."""
    t4n = (4 * nfeat).to(torch.float32)
    approx = threshold * t4n / torch.tensor(100.0, dtype=torch.float32,
                                             device=t4n.device)
    base = torch.floor(approx).to(torch.int32) - 1
    probes = (base[:, None] + torch.arange(4, dtype=torch.int32,
                                           device=t4n.device)).clamp(min=0)
    ok = (probes * 100).to(torch.float32) / t4n[:, None] > threshold
    big = torch.full_like(probes, 1 << 30)
    rmin = torch.where(ok, probes, big).min(dim=1).values
    return rmin, t4n


def coarse_similarity(lmflat: torch.Tensor, bank: LevelBank, T: int,
                      size_wh, mask_positions: bool = True):
    """Plain scores of all K templates over all M positions of one frame.

    lmflat: [8*T*T*M + M] uint8. Returns (S [K, M] int32, zeroed past
    `positions` when mask_positions, positions [K] int32)."""
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    off = _flat_offsets(bank, T, W, M, size_wh)
    positions = _positions(bank, T, W, H)
    S, _ = coarse_scores_plain(lmflat[None], off, positions,
                               torch.zeros_like(positions), M)
    S = S[0]
    if mask_positions:
        j = torch.arange(M, device=S.device)
        S = torch.where(j[None, :] < positions[:, None], S,
                        torch.zeros_like(S))
    return S, positions


def extract_candidates_counted(S: torch.Tensor, cnt: torch.Tensor,
                               positions: torch.Tensor, rmin: torch.Tensor,
                               t4n: torch.Tensor, T: int, W: int, C: int):
    """The first C candidates of each frame from the coarse scores and the
    kernel's per-template live counts.

    S [B, K, M] int32, cnt [B, K] int32 (cells with j < positions and
    S >= rmin). Returns (k, x, y, score, valid) each [B, C] and n_above
    [B], the exact candidate count. Slot i of a frame belongs to the
    template whose inclusive count prefix first exceeds i; its rank r in
    that template picks the r-th live cell, or, past the live cells, the
    quirk cell clip(pos, 0, M) + (r - live) at score 0."""
    B, K, M = S.shape
    dev = S.device
    pos = positions
    quirk = rmin <= 0
    qcnt = torch.where(quirk, M - pos.clamp(0, M), torch.zeros_like(pos))
    bcnt = cnt + qcnt[None, :]                                  # [B, K]
    incl = bcnt.cumsum(dim=1, dtype=torch.int32)
    n_above = incl[:, -1]
    slots = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C)
    k = torch.searchsorted(incl, slots.contiguous(), right=True)
    got = k < K
    k = k.clamp(max=K - 1)
    r = slots - (incl - bcnt).gather(1, k)                      # rank
    lcnt = cnt.gather(1, k)
    is_quirk = r >= lcnt

    rows = S[torch.arange(B, device=dev)[:, None], k]           # [B, C, M]
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
    return k.to(torch.int32), x, y, sc, got, n_above


def coarse_extract(lmflat: torch.Tensor, bank: LevelBank, T: int, size_wh,
                   threshold: torch.Tensor, cand_cap: int):
    """Coarse scoring (kernel 2) + counted candidate extraction for B
    frames. lmflat [B, 8*T*T*M + M] uint8. Returns (k, x, y, score, valid)
    each [B, cand_cap] and n_above [B]."""
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    off = _flat_offsets(bank, T, W, M, size_wh)
    positions = _positions(bank, T, W, H)
    rmin, t4n = _rmin_for_threshold(bank.nfeat, threshold)
    S, cnt = coarse_scores(lmflat, off, positions, rmin, M)
    return extract_candidates_counted(S, cnt, positions, rmin, t4n, T, W,
                                      cand_cap)


def refine_candidates(lmflat: torch.Tensor, bank: LevelBank, T: int,
                      size_wh, k: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor, valid: torch.Tensor,
                      threshold: torch.Tensor):
    """One pyramid refinement step for all candidates of B frames
    (matchClass candidate loop, line2Dup.cpp:1221-1293): doubling, border
    clamp, 16x16 local similarity (kernel 3), first-max argmax, threshold.
    Invalid candidates do no work; their outputs are don't-care values
    with valid False. Returns (k, x, y, score, valid), each [B, C]."""
    w_img, h_img = size_wh
    border = 8 * T
    offset = T // 2 + (T % 2 - 1)
    nfeat_k = bank.nfeat[k].to(torch.float32)
    max_x = w_img - bank.width[k] - border
    max_y = h_img - bank.height[k] - border
    cx = torch.minimum((x * 2 + 1).clamp(min=border), max_x)
    cy = torch.minimum((y * 2 + 1).clamp(min=border), max_y)
    wx = (torch.div(cx, T, rounding_mode="floor") - 8).to(torch.int32)
    wy = (torch.div(cy, T, rounding_mode="floor") - 8).to(torch.int32)
    best, raw = refine_windows(lmflat, bank, T, size_wh, k, wx, wy, valid)
    sim = raw.to(torch.float32) * 100.0 / (4.0 * nfeat_k)
    nx = (wx + best % 16) * T + offset
    ny = (wy + torch.div(best, 16, rounding_mode="floor")) * T + offset
    return k, nx, ny, sim, valid & (sim >= threshold)
