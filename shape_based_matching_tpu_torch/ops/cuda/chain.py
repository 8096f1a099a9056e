"""Kernels 6 and 7: delta-chain coarse scoring, ``csrc/chain.cu``.

``chain_scores(lmflat, plan, pos, rmin)`` returns what
``coarse_scores(lmflat, off, pos, rmin, plan.M)`` returns for the bank the
plan was made from -- ``S [B, K, M]`` int32 and ``cnt [B, K]`` int32 --
but reaches each template's scores from its predecessor's through the
plan's signed delta slots (``ops/chain_plan.py``). It replaces the TPU
kernel ``shape_based_matching_tpu/ops/pallas/similarity_pallas.py::
_make_chain_kernel`` in its counted form.

On a CPU tensor the wrapper runs ``chain_scores_plain``; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..chain_plan import ChainPlan
from . import build
from .coarse import count_live

_CHUNK_CELLS = 1 << 24  # cells of D the plain twin holds at once


def plan_to_device(plan: ChainPlan, device) -> ChainPlan:
    """Upload a host plan's arrays as int32 tensors on `device`."""
    return plan._replace(**{f: torch.as_tensor(getattr(plan, f),
                                               dtype=torch.int32,
                                               device=device)
                            for f in ("prog_start", "slot_start", "slots")})


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
    S = torch.empty((B, K, M), dtype=torch.int32, device=lmflat.device)
    cnt = torch.zeros((B, K), dtype=torch.int32, device=lmflat.device)
    P = plan.prog_start.shape[0] - 1
    if B == 0 or K == 0:
        return S, cnt
    lib = build.library()
    build.check(lib.sbm_chain_scores(
        lmflat.data_ptr(), Lf, plan.prog_start.data_ptr(),
        plan.slot_start.data_ptr(), plan.slots.data_ptr(), pos.data_ptr(),
        rmin.data_ptr(), S.data_ptr(), cnt.data_ptr(), B, P, K, M,
        build.stream_ptr(lmflat.device)), "sbm_chain_scores")
    chain_scores.launches += 1
    return S, cnt


chain_scores.launches = 0
