"""Delta-chain plans for dense template banks, built on the host in numpy.

A dense rotation sweep (the reference's ``addTemplate_rotate``
enumeration, line2Dup.cpp:1409-1451) makes neighbouring templates share
most of their coarse-level feature slots. Integer sums are exact in any
order, so template k's scores follow from template k-1's,

    S_k = S_{k-1} + sum(added slots) - sum(removed slots),

bit for bit equal to scoring k from scratch. A plan cuts the bank, in
template order, into programs. Each program is one chain: its first
template is a base (all its slots, added) and every later one a delta.
``ops/cuda/chain.py`` runs one program per CUDA block row.

**When to chain** is the JAX package's decision
(``shape_based_matching_tpu/ops/pallas/chain_plan.py::plan_chain``), so
both packages take the chain on the same banks and frame sizes:

* a template is a delta iff ``|adds| + |subs| < nfeat`` against the
  template before it, else a base; a template with no valid feature
  counts ``nf = 0``; an exact duplicate is an empty delta;
* the bank chains iff ``K >= 256`` and the chain's slot visits, counted
  as the JAX kernel pays them (sub-steps of 4 slots, programs of 64
  sub-steps), stay within 0.6 of the plain kernel's (0.45 for banks whose
  byte lanes overflow into u16, none past that), and the JAX kernel's
  preshifted planes fit its VMEM.

**The plan** is the port's own: a slot is a flat offset into ``lmflat``,
``plane*M + (fy//T)*W + fx//T``, or ``L`` (the zero tail) for a dead or
off-image feature, stored as ``off`` when added and ``~off`` (= -1 - off)
when removed. A program breaks where the JAX rule rebases and wherever its
slots would pass ``SLOT_BUDGET``.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np

CHAIN_MAX_RATIO = 0.6
_MIN_K = 256
# the JAX kernel's cost accounting, for the engage decision only
_JAX_SUBSTEP = 4
_JAX_PROGRAM = 64
_JAX_VMEM = 36 * 2**20
# Slots per program. The 10,000-template bank at a 512^2 coarse level
# plans into 231 programs: with 4 tiles of 1024 cells, 924 blocks, 7 for
# each of the H100's 132 SMs. A larger budget means fewer bases (less
# work) but fewer blocks.
SLOT_BUDGET = 256


class ChainPlan(NamedTuple):
    """A bank's chain plan at one frame size (numpy arrays on the host, or
    torch tensors once uploaded)."""

    prog_start: object  # [P + 1] int32: first template of each program
    slot_start: object  # [K + 1] int32: first slot of each template
    slots: object       # [NS] int32: off (added) or ~off (removed)
    M: int              # cells of the coarse level
    L: int              # offset of the zero tail, n_ori*T*T*M
    # the CUDA kernel's segments (ops/cuda/chain.py::segment_plan)
    segs: object = None  # [NSEG, 4] int32: k0, k1, pre_begin, pre_end
    pre: object = None   # [NP] int32: start codes of the segments


def _jax_engages(n_base, n_delta, is_delta, n_slots: int, W: int, M: int,
                 C: int) -> bool:
    """plan_chain's engage rule: JAX's packing gates and its padded slot
    cost against the plain kernel's live slots."""
    K = len(n_base)
    if K < _MIN_K:
        return False
    if n_slots * 4 <= 255:
        max_ratio = CHAIN_MAX_RATIO
    elif n_slots * 4 <= 65535:
        max_ratio = min(CHAIN_MAX_RATIO, 0.45)
    else:
        return False
    m_pad = -(-(M + max(W, 1)) // 4096) * 4096
    if 4 * (C + 1) * m_pad > _JAX_VMEM:
        return False
    steps = cur = 0
    for k in range(K):
        need = max(1, -(-(n_delta[k] if is_delta[k] else n_base[k])
                        // _JAX_SUBSTEP))
        if cur + need > _JAX_PROGRAM:
            steps += cur
            cur = 0
            need = max(1, -(-n_base[k] // _JAX_SUBSTEP))
        cur += need
    steps += cur
    plain = int(np.sum(n_base))
    return plain > 0 and steps * _JAX_SUBSTEP <= max_ratio * plain


def plan_chain(bank, T: int, size_wh, n_ori: int = 8) -> ChainPlan | None:
    """A chain plan for the coarse level of `bank` (fields fx, fy, label,
    valid, nfeat as numpy arrays; valid features first, as
    ``pack_level_bank`` lays them out) at frame size ``(w, h)`` with
    `n_ori` orientation planes, or None when the bank does not profit."""
    w_img, h_img = int(size_wh[0]), int(size_wh[1])
    W, H = w_img // T, h_img // T
    M = W * H
    C = n_ori * T * T  # planes of the linear memories
    L = C * M
    fx, fy = np.asarray(bank.fx), np.asarray(bank.fy)
    lab, val = np.asarray(bank.label), np.asarray(bank.valid)
    K, n_slots = fx.shape
    inb = val & (fx >= 0) & (fx < w_img) & (fy >= 0) & (fy < h_img)
    off = np.where(inb, (lab * (T * T) + (fy % T) * T + fx % T) * M
                   + (fy // T) * W + fx // T, L)
    nf = np.where(val.any(axis=1), np.asarray(bank.nfeat), 0).astype(int)

    feats = [Counter(off[k, :nf[k]].tolist()) for k in range(K)]
    adds = [Counter()] + [feats[k] - feats[k - 1] for k in range(1, K)]
    subs = [Counter()] + [feats[k - 1] - feats[k] for k in range(1, K)]
    n_delta = [sum(a.values()) + sum(s.values()) for a, s in zip(adds, subs)]
    is_delta = [k > 0 and n_delta[k] < nf[k] for k in range(K)]
    if not _jax_engages(nf, n_delta, is_delta, n_slots, W, M, C):
        return None

    prog_start, slot_start, slots = [], [], []
    used = 0  # slots of the current program
    for k in range(K):
        if is_delta[k] and used + n_delta[k] <= SLOT_BUDGET:
            new = list(adds[k].elements()) + [~o for o in subs[k].elements()]
        else:
            prog_start.append(k)
            used = 0
            new = list(feats[k].elements())
        slot_start.append(len(slots))
        slots.extend(new)
        used += len(new)
    prog_start.append(K)
    slot_start.append(len(slots))
    return ChainPlan(np.asarray(prog_start, np.int32),
                     np.asarray(slot_start, np.int32),
                     np.asarray(slots, np.int32), M, L)


def plan_chain_sharded(bank, n_shards: int, T: int, size_wh,
                       n_ori: int = 8) -> list | None:
    """Chain plans for a bank split into `n_shards` equal template slices
    (the mesh's ``templ`` axis): ``plan_chain`` of each slice, or None
    when K is not a multiple of n_shards or when any slice declines. The
    all-or-nothing rule is the JAX package's
    (``ops/pallas/chain_plan.py::plan_chain_sharded``), so both packages
    score the same slices with the same coarse kernel. JAX pads every
    slice's plan to the longest and re-bases its output rows, which one
    SPMD program needs; here each shard launches its own plan."""
    fields = [np.asarray(f) for f in bank]
    K = fields[0].shape[0]
    if K % n_shards:
        return None
    k_loc = K // n_shards
    plans = []
    for s in range(n_shards):
        part = type(bank)(*(f[s * k_loc:(s + 1) * k_loc] for f in fields))
        plan = plan_chain(part, T, size_wh, n_ori)
        if plan is None:
            return None
        plans.append(plan)
    return plans
