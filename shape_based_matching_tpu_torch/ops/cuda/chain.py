"""Kernels 6 and 7: delta-chain coarse scoring, ``csrc/chain.cu``.

``chain_scores(lmflat, plan, pos, rmin)`` returns what
``coarse_scores(lmflat, off, pos, rmin, plan.M)`` returns for the bank the
plan was made from -- ``S [B, K, M]`` int32 and ``cnt [B, K]`` int32 --
but reaches each template's scores from its predecessor's through the
plan's signed delta slots (``ops/chain_plan.py``). It replaces the TPU
kernel ``shape_based_matching_tpu/ops/pallas/similarity_pallas.py::
_make_chain_kernel`` in its counted form.

The kernel walks segments of at most ``SEG_TEMPLATES`` templates of one
program, longest first, each from a start row of its own
(``segment_plan``; ``plan_to_device`` attaches them).

On a CPU tensor the wrapper runs ``chain_scores_plain``; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..chain_plan import ChainPlan
from . import build
from .coarse import count_live

_CHUNK_CELLS = 1 << 24  # cells of D the plain twin holds at once
SEG_TEMPLATES = 32  # Z: templates per segment (tools/tune_torch_split.py)


def chain_segments(prog_start, Z: int) -> np.ndarray:
    """Segments of at most Z templates, cut from each program from its
    base on, as [NSEG, 3] int32 (k0, k1, base) in template order. A pure
    function of the plan's shapes."""
    ps = np.asarray(prog_start, np.int64)
    per = -(-np.diff(ps) // Z)  # segments per program
    base = np.repeat(ps[:-1], per)
    k0 = base + Z * (np.arange(per.sum()) - np.repeat(np.cumsum(per) - per,
                                                       per))
    k1 = np.minimum(k0 + Z, np.repeat(ps[1:], per))
    return np.stack([k0, k1, base], axis=1).astype(np.int32)


def segment_plan(plan: ChainPlan, Z: int = SEG_TEMPLATES) -> ChainPlan:
    """`plan` (host arrays) with the kernel's segments attached: ``segs``
    [NSEG, 4] int32 (k0, k1, pre_begin, pre_end), longest walk first (start
    codes plus own slots plus templates; ties in template order), and
    ``pre``, the start codes. A segment's start row is S of template
    k0 - 1 (none at a base): the offsets of the net multiset of its
    program's slots before k0 -- that template's own feature offsets, all
    added -- rather than those slots themselves (up to 256 signed ones:
    at Z=32, 47,246 slot visits in all against 31,580, and 25% more time
    at B=1)."""
    slots = np.asarray(plan.slots)
    ss = np.asarray(plan.slot_start, np.int64)
    seg = chain_segments(plan.prog_start, Z)
    starts, cur, upto = [], Counter(), 0
    for k0, base in zip(seg[:, 0].tolist(), seg[:, 2].tolist()):
        if k0 == base:
            cur, upto = Counter(), ss[base]
        for code in slots[upto:ss[k0]].tolist():  # walk on to k0
            cur[~code if code < 0 else code] += -1 if code < 0 else 1
        upto = ss[k0]
        starts.append(list((+cur).elements()))
    lens = np.asarray([len(x) for x in starts], np.int64)
    pre = np.asarray([o for x in starts for o in x] or [0], np.int32)
    bounds = np.stack([np.cumsum(lens) - lens, np.cumsum(lens)], axis=1)
    cost = (lens + ss[seg[:, 1]] - ss[seg[:, 0]] + seg[:, 1] - seg[:, 0])
    order = np.argsort(-cost, kind="stable")
    segs = np.concatenate([seg[:, :2], bounds], axis=1)[order]
    return plan._replace(segs=np.ascontiguousarray(segs, np.int32),
                         pre=pre)


def plan_to_device(plan: ChainPlan, device) -> ChainPlan:
    """Upload a host plan's arrays, with its segments (``segment_plan``
    unless attached), as int32 tensors on `device`."""
    if plan.segs is None:
        plan = segment_plan(plan)
    return plan._replace(**{f: torch.as_tensor(getattr(plan, f),
                                               dtype=torch.int32,
                                               device=device)
                            for f in ("prog_start", "slot_start", "slots",
                                      "segs", "pre")})


def chain_scores_plain(lmflat: torch.Tensor, plan: ChainPlan,
                       pos: torch.Tensor, rmin: torch.Tensor):
    """Plain twin that executes the plan: signed slot gathers summed per
    template (D), then a running sum over each program (one chain)."""
    B = lmflat.shape[0]
    M = plan.M
    K = plan.slot_start.numel() - 1
    dev = lmflat.device
    windows = lmflat.unfold(1, M, 1)  # windows[b, o] = lmflat[b, o:o+M]
    codes = plan.slots.long()
    neg = codes < 0
    off = torch.where(neg, ~codes, codes)
    sign = (1 - 2 * neg.to(torch.int32))[None, :, None]
    owner = torch.repeat_interleave(torch.arange(K, device=dev),
                                    plan.slot_start[1:] - plan.slot_start[:-1])
    S = torch.empty((B, K, M), dtype=torch.int32, device=dev)
    starts = plan.prog_start.tolist()
    first = plan.slot_start.tolist()
    i = 0
    while i < len(starts) - 1:  # a chunk of whole programs
        j = i + 1
        while (j < len(starts) - 1 and B * M * max(
                first[starts[j + 1]] - first[starts[i]],
                starts[j + 1] - starts[i]) <= _CHUNK_CELLS):
            j += 1
        ka, kb = starts[i], starts[j]
        sa, sb = first[ka], first[kb]
        D = torch.zeros((B, kb - ka, M), dtype=torch.int32, device=dev)
        D.index_add_(1, owner[sa:sb] - ka,
                     windows[:, off[sa:sb]].to(torch.int32) * sign[:, sa:sb])
        for p in range(i, j):  # running sum, restarting at each base
            S[:, starts[p]:starts[p + 1]] = D[:, starts[p] - ka:
                                             starts[p + 1] - ka].cumsum(
                dim=1, dtype=torch.int32)
        i = j
    return S, count_live(S, pos, rmin)


def chain_scores(lmflat: torch.Tensor, plan: ChainPlan, pos: torch.Tensor,
                 rmin: torch.Tensor):
    """lmflat [B, L + M] uint8 (linear memories + zero tail); plan a
    ChainPlan of int32 tensors on lmflat's device, made for this frame
    size; pos/rmin [K] int32 -> (S [B, K, M] int32, cnt [B, K] int32)."""
    if lmflat.dim() != 2 or lmflat.dtype != torch.uint8:
        raise ValueError("lmflat must be [B, L + M] uint8")
    B, Lf = lmflat.shape
    M = plan.M
    if Lf != plan.L + M:
        raise ValueError(f"plan made for L + M = {plan.L + M}, lmflat has "
                         f"{Lf}")
    K = plan.slot_start.shape[0] - 1
    for t, name, shape in ((pos, "pos", (K,)), (rmin, "rmin", (K,)),
                           (plan.prog_start, "plan.prog_start", None),
                           (plan.slot_start, "plan.slot_start", None),
                           (plan.slots, "plan.slots", None)):
        if (t.dtype != torch.int32 or t.dim() != 1
                or (shape and tuple(t.shape) != shape)):
            raise ValueError(f"{name}: expected int32 {shape or '1-d'}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != lmflat.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {lmflat.device}")
    if lmflat.device.type == "cpu":
        return chain_scores_plain(lmflat, plan, pos, rmin)
    if lmflat.device.type != "cuda":
        raise ValueError(f"unsupported device {lmflat.device}")
    if not lmflat.is_contiguous():
        raise ValueError("lmflat must be contiguous")
    segs, pre = plan.segs, plan.pre
    if (segs is None or segs.device != lmflat.device
            or segs.dtype != torch.int32 or segs.dim() != 2
            or segs.shape[1] != 4 or not segs.is_contiguous()
            or pre.device != lmflat.device or pre.dtype != torch.int32
            or not pre.is_contiguous()):
        raise ValueError("plan.segs/plan.pre: expected int32 [NSEG, 4] and "
                         "[NP] on the device (plan_to_device)")
    S = torch.empty((B, K, M), dtype=torch.int32, device=lmflat.device)
    cnt = torch.zeros((B, K), dtype=torch.int32, device=lmflat.device)
    if B == 0 or K == 0:
        return S, cnt
    lib = build.library()
    build.check(lib.sbm_chain_scores(
        lmflat.data_ptr(), Lf, plan.slot_start.data_ptr(),
        plan.slots.data_ptr(), segs.data_ptr(), pre.data_ptr(),
        pos.data_ptr(), rmin.data_ptr(), S.data_ptr(), cnt.data_ptr(), B,
        segs.shape[0], K, M, build.stream_ptr(lmflat.device)),
        "sbm_chain_scores")
    chain_scores.launches += 1
    return S, cnt


chain_scores.launches = 0
