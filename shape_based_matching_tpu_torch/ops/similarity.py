"""Batched template similarity on the match path, in PyTorch.

* Coarse level: ``S[k, j] = sum_n LMflat[off[k, n] + j]`` for all K
  templates and all M decimated positions (kernel 2, ``ops/cuda/coarse``,
  or for a dense bank with a chain plan the delta chain, kernel 7,
  ``ops/cuda/chain``), with the reference's flat-offset addressing, row
  wrap included (line2Dup.cpp:782-858).
* Candidate extraction: every cell with ``j < positions[k]`` and
  ``f32(S*100) / f32(4*nfeat) > threshold``, template-major and
  j-ascending, the first ``cand_cap`` of them, plus the exact count
  ``n_above``; with a threshold low enough that a zero score passes, the
  cells past ``positions`` count too, at score 0 (the reference scans a
  zero-initialized similarity Mat, line2Dup.cpp:1190-1216). Static shapes:
  no host sync inside the step. On the card one kernel walks each
  template's row once (``ops/cuda/extract``), in no memory beyond its
  ``[B, cand_cap]`` results.
* Refinement: the 16x16 local similarity around each doubled candidate
  (kernel 3, ``ops/cuda/refine``), border clamp, first-max argmax and the
  float ``raw*100/(4*nfeat)`` score (line2Dup.cpp:1221-1293); or, for
  many candidates, a window of the full level maps of the distinct
  candidate templates (kernel 4 ``coarse_maps``), then the whole step in
  one launch of kernel 9 (``ops/cuda/map_refine``), exact under the
  border clamp; past ``_MAP_SLAB`` distinct templates the maps are built
  and read one slab of templates at a time. The window origin and the
  score epilogue of both routes live in ``ops/window``.

Semantics and every returned bit follow the JAX package's
``ops/similarity.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .chain_plan import ChainPlan
from .cuda.chain import chain_scores
from .cuda.coarse import coarse_maps, coarse_scores
from .cuda.extract import extract_counted
from .cuda.map_refine import map_refine
from .cuda.refine import refine_windows
from .window import window_origin, window_result

# distinct-template buckets of the map route (a bank of K templates adds K)
_D_BUCKETS = (16, 64, 256, 1024)
# the most distinct templates whose level maps the map route holds at once
_MAP_SLAB = 1024


class LevelBank(NamedTuple):
    """Padded per-pyramid-level template bank: K templates x N slots."""

    fx: torch.Tensor      # [K, N] int32 feature x (template frame)
    fy: torch.Tensor      # [K, N] int32 feature y
    label: torch.Tensor   # [K, N] int32 orientation bin 0..n_ori-1
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


def _flat_offsets(bank: LevelBank, T: int, W: int, M: int, size_wh,
                  n_ori: int = 8) -> torch.Tensor:
    """[K, N] int32 flat offset of each feature; dead or off-image slots
    address the zero tail L = n_ori*T*T*M (accessLinearMemory,
    line2Dup.cpp:782-805)."""
    w_img, h_img = size_wh
    L = n_ori * T * T * M
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
    approx = threshold * t4n / torch.full((), 100.0, dtype=torch.float32,
                                           device=t4n.device)
    base = torch.floor(approx).to(torch.int32) - 1
    probes = (base[:, None] + torch.arange(4, dtype=torch.int32,
                                           device=t4n.device)).clamp(min=0)
    ok = (probes * 100).to(torch.float32) / t4n[:, None] > threshold
    big = torch.full_like(probes, 1 << 30)
    rmin = torch.where(ok, probes, big).min(dim=1).values
    return rmin, t4n


def coarse_similarity(lmflat: torch.Tensor, bank: LevelBank, T: int,
                      size_wh, mask_positions: bool = True, n_ori: int = 8):
    """Scores of all K templates over all M positions of one frame (kernel
    4, ``coarse_maps``).

    lmflat: [n_ori*T*T*M + M] uint8. Returns (S [K, M] int32, zeroed past
    `positions` when mask_positions, positions [K] int32)."""
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    off = _flat_offsets(bank, T, W, M, size_wh, n_ori)
    positions = _positions(bank, T, W, H)
    S = coarse_maps(lmflat[None], off, M)[0]
    if mask_positions:
        j = torch.arange(M, device=S.device)
        S = torch.where(j[None, :] < positions[:, None], S,
                        torch.zeros_like(S))
    return S, positions


def coarse_route(bank: LevelBank, T: int, size_wh, n_ori: int = 8,
                 chain: bool = False) -> str:
    """Which TPU kernel row ``coarse_extract`` serves for this (bank,
    frame), under the JAX package's labels (its ``coarse_route``), so that
    a recorded time can be tagged with the kernel that made it:

    * ``'chain'``: `chain` is set, the class has a chain plan at this
      frame size -- ``chain.cu`` (rows 6-7), one block per segment of at
      most ``SEG_TEMPLATES`` templates (``ops/cuda/chain.segment_plan``).
    * ``'packed4'``: at most 63 slots (``N * 4 <= 255``) -- ``coarse.cu``
      (row 3) in one packed-lane run per 4 cells, and one slot group
      (``coarse_split`` gives G = 1 below 128 slots), the count fused.
    * ``'wide'``: 64 slots or more -- ``coarse.cu`` (row 5), its lanes
      widened every 63 slots; ``coarse_split`` spreads the slots over
      G > 1 groups of blocks when the grid would not fill the card, and
      the count then runs as a second pass over S.

    The port never returns the TPU-only ``'cells'`` and ``'packed2'``.
    Where the JAX package returns ``'cells'`` (past its 36 MiB VMEM gate,
    or past 16383 slots), the port returns what it runs there: coarse.cu
    has neither limit. So `T`, `size_wh` and `n_ori` change no label here;
    they keep the JAX package's signature."""
    del T, size_wh, n_ori
    if chain:
        return "chain"
    return "packed4" if int(bank.fx.shape[1]) * 4 <= 255 else "wide"


def coarse_extract(lmflat: torch.Tensor, bank: LevelBank, T: int, size_wh,
                   threshold: torch.Tensor, cand_cap: int,
                   chain: ChainPlan | None = None, n_ori: int = 8):
    """Coarse scoring (kernel 2, or kernel 7 when `chain`, the bank's
    plan at this frame size, is given) + counted candidate extraction for
    B frames. lmflat [B, n_ori*T*T*M + M] uint8. Returns (k, x, y, score,
    valid) each [B, cand_cap] and n_above [B]. Any feature count works:
    the scores are int32 and ``_rmin_for_threshold`` is exact far past the
    reference's 8191-feature cap."""
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    positions = _positions(bank, T, W, H)
    rmin, t4n = _rmin_for_threshold(bank.nfeat, threshold)
    if chain is not None:
        S, cnt = chain_scores(lmflat, chain, positions, rmin)
    else:
        S, cnt = coarse_scores(
            lmflat, _flat_offsets(bank, T, W, M, size_wh, n_ori), positions,
            rmin, M)
    return extract_counted(S, cnt, positions, rmin, t4n, T, W, cand_cap)


def refine_candidates(lmflat: torch.Tensor, bank: LevelBank, T: int,
                      size_wh, k: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor, valid: torch.Tensor,
                      threshold: torch.Tensor, n_ori: int = 8):
    """One pyramid refinement step for all candidates of B frames
    (matchClass candidate loop, line2Dup.cpp:1221-1293): doubling, border
    clamp, 16x16 local similarity (kernel 3), first-max argmax, threshold.
    Invalid candidates do no work; their outputs are don't-care values
    with valid False. Returns (k, x, y, score, valid), each [B, C]."""
    wx, wy = window_origin(bank.width, bank.height, T, size_wh, k, x, y)
    best, raw = refine_windows(lmflat, bank, T, size_wh, k, wx, wy, valid,
                               n_ori)
    return window_result(bank.nfeat, T, k, wx, wy, best, raw, valid,
                         threshold)


def distinct_templates(k: torch.Tensor, valid: torch.Tensor, K: int,
                       D: int):
    """The distinct template ids among the valid candidates of every frame
    (k, valid [B, C]), in ascending order: slots [D] int32 with K as
    fill, slot_of_k [K] int32 (-1 for a template without a slot, which
    invalidates its candidates when n_distinct > D), and n_distinct, a
    0-d int32 tensor (similarity.py:1021-1036 of the JAX package)."""
    idx = torch.where(valid, k, torch.zeros_like(k)).reshape(-1).long()
    present = torch.zeros(K, dtype=torch.int32, device=k.device) \
        .scatter_reduce(0, idx, valid.reshape(-1).to(torch.int32), "amax")
    incl = present.cumsum(0, dtype=torch.int32)
    n_distinct = incl[-1]
    slots = torch.searchsorted(
        incl, torch.arange(D, dtype=torch.int32, device=k.device),
        right=True).to(torch.int32)
    rank = incl - 1
    slot_of_k = torch.where((present > 0) & (rank < D), rank,
                            torch.full_like(rank, -1))
    return slots, slot_of_k, n_distinct


def gather_bank(bank: LevelBank, slots: torch.Tensor) -> LevelBank:
    """Sub-bank for the given template slots (id K -> an all-invalid row
    of width and height 1)."""
    K = bank.fx.shape[0]
    safe = slots.clamp(max=K - 1).long()
    live = slots < K
    one = torch.ones_like(bank.width[safe])
    return LevelBank(
        fx=bank.fx[safe], fy=bank.fy[safe], label=bank.label[safe],
        valid=bank.valid[safe] & live[:, None], nfeat=bank.nfeat[safe],
        width=torch.where(live, bank.width[safe], one),
        height=torch.where(live, bank.height[safe], one))


def refine_from_maps(Sfull: torch.Tensor, slot_of_k: torch.Tensor,
                     bank: LevelBank, T: int, size_wh, k: torch.Tensor,
                     x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                     threshold: torch.Tensor):
    """One pyramid refinement step from full level maps: `Sfull` [B, D, M]
    holds the UNMASKED maps of the distinct candidate templates
    (slot_of_k [K] maps a template to its row). Under the border clamp no
    feature is dropped and every linear-memory read stays in its plane,
    so the 16x16 local similarity is exactly a window of the map. One
    launch of kernel 9 does the whole step: window origin, slot, window,
    first max, score, threshold. Candidates whose template has no slot
    come out invalid. Returns (k, x, y, score, valid), each [B, C]."""
    return map_refine(Sfull, slot_of_k, bank.width, bank.height, bank.nfeat,
                      T, size_wh, k, x, y, valid, threshold)


def refine_by_maps(lmflat: torch.Tensor, bank: LevelBank, T: int, size_wh,
                   k: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   valid: torch.Tensor, threshold: torch.Tensor,
                   n_ori: int = 8):
    """The map route of a refine step (``_refine_level`` of the JAX
    package's detector): the distinct candidate templates, with one host
    read of their count to pick the smallest D of (16, 64, 256, 1024, K)
    that holds them all, so no candidate loses its map; their unmasked
    level maps (kernel 4); the refine step from them (kernel 9).

    Past ``_MAP_SLAB`` distinct templates (D = K) the maps are built one
    slab of at most ``_MAP_SLAB`` templates at a time, each slab's refine
    step keeping the candidates whose template lies in it, so the maps
    take one slab's memory, ``[B, _MAP_SLAB, M]`` int32, not ``[B, K,
    M]``. The bits are those of the maps of all D templates wherever the
    map route is exact (a bank that is not pathological, so every window
    lies inside its template's map): a candidate whose template is in the
    slab reads the same window, and an invalid candidate reads nothing in
    any slab, so the first slab supplies it."""
    K = bank.fx.shape[0]
    slots, slot_of_k, n_distinct = distinct_templates(k, valid, K, K)
    n = int(n_distinct)
    D = next((d for d in _D_BUCKETS if n <= d < K), K)
    if D <= _MAP_SLAB or n == 0:
        return _refine_slab(lmflat, bank, T, size_wh, k, x, y, valid,
                            threshold, n_ori, slots[:D], slot_of_k)
    out = None
    for s0 in range(0, n, _MAP_SLAB):
        s1 = min(s0 + _MAP_SLAB, n)
        in_slab = (slot_of_k >= s0) & (slot_of_k < s1)
        part = _refine_slab(lmflat, bank, T, size_wh, k, x, y, valid,
                            threshold, n_ori, slots[s0:s1],
                            torch.where(in_slab, slot_of_k - s0,
                                        torch.full_like(slot_of_k, -1)))
        if out is None:
            out = part
            continue
        take = valid & in_slab[k]
        out = tuple(torch.where(take, p, o) for p, o in zip(part, out))
    return out


def _refine_slab(lmflat: torch.Tensor, bank: LevelBank, T: int, size_wh,
                 k: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 valid: torch.Tensor, threshold: torch.Tensor, n_ori: int,
                 slots: torch.Tensor, slot_of_k: torch.Tensor):
    """The level maps of the templates `slots` (kernel 4) and the refine
    step from them (kernel 9); `slot_of_k` gives each template's row in
    them, -1 for none. The maps are freed on return."""
    w_img, h_img = size_wh
    W, M = w_img // T, (w_img // T) * (h_img // T)
    sub = gather_bank(bank, slots)
    Sfull = coarse_maps(lmflat, _flat_offsets(sub, T, W, M, size_wh, n_ori),
                        M)
    return refine_from_maps(Sfull, slot_of_k, bank, T, size_wh, k, x, y,
                            valid, threshold)
