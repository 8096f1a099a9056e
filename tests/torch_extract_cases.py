"""Inputs of the counted candidate extraction (``ops/cuda/extract``) for
its tests: random score rows with seeded edge cases, rows whose live
cells, quirk slots and slots past n_above straddle the kernel's segment
edges, and the chain route's rows of the committed 10,000-template bank.

Used by ``tests/test_torch_extract.py`` (CPU: the kernel's replay against
the plain twin) and ``tests/test_torch_cuda.py`` (the kernel against the
twin on the card). Imports neither JAX nor the JAX package.
"""

import numpy as np
import torch

from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.ops import similarity as tsim
from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
from shape_based_matching_tpu_torch.ops.cuda.coarse import count_live
from shape_based_matching_tpu_torch.ops.cuda.extract import (
    _prefix as _extract_prefix)
from shape_based_matching_tpu_torch.utils import synthetic as tsyn

# name: (seed, B, K, M, threshold, C, positions, overstate, T, W)
EXTRACT_CASES = {
    # several chunks a row, ranks across chunk edges, overflow
    "overflow": (1, 1, 12, 3000, 70.0, 900, None, 0, 4, 60),
    # C past n_above: template K-1 fills the rest, invalid
    "past_end": (2, 2, 9, 700, 90.0, 5000, None, 0, 8, 35),
    # a threshold below 0 (rmin <= 0; at 0 rmin is 1): the quirk cells
    # past the positions, valid at score 0
    "quirk": (3, 2, 7, 260, -1.0, 1500, None, 0, 4, 13),
    "quirk_far": (4, 1, 6, 100, -5.0, 900, None, 0, 4, 10),
    # templates with no positions, and one with every cell
    "no_positions": (5, 1, 8, 500, 60.0, 400,
                     [0, -4, 500, 37, -1, 499, 0, 260], 0, 4, 25),
    "batch3": (6, 3, 15, 1100, 75.0, 700, None, 0, 4, 44),
    # counts above the live cells: ranks past them read cell M-1
    "overstated": (7, 2, 10, 400, 80.0, 500, None, 3, 4, 20),
    # M a multiple of 4 (the kernel's 16-byte loads)
    "aligned": (8, 2, 11, 1024, 65.0, 1300, None, 0, 4, 32),
    # one template: it owns every slot, those past n_above too
    "one_template": (9, 2, 1, 777, 70.0, 400, None, 0, 4, 37),
}


def extract_case(name: str):
    """(S, cnt, positions, rmin, t4n, T, W, C) of a case, CPU tensors:
    random rows over M cells (cells past the positions not zeroed, as the
    chain route leaves them), nfeat 1-20 with template 1 empty (nfeat 0,
    where K > 1), rmin and t4n from the threshold, and the live counts
    (raised by `overstate` on every third template)."""
    seed, B, K, M, threshold, C, positions, overstate, T, W = \
        EXTRACT_CASES[name]
    rng = np.random.RandomState(seed)
    S = torch.from_numpy(rng.randint(0, 60, (B, K, M)).astype(np.int32))
    nfeat = rng.randint(1, 21, K).astype(np.int32)
    if K > 1:
        nfeat[1] = 0
    pos = torch.from_numpy((rng.randint(-3, M + 1, K) if positions is None
                            else np.asarray(positions)).astype(np.int32))
    rmin, t4n = tsim._rmin_for_threshold(torch.from_numpy(nfeat),
                                         torch.tensor(np.float32(threshold)))
    cnt = count_live(S, pos, rmin)
    cnt[:, ::3] += overstate
    return S, cnt, pos, rmin, t4n, T, W, C


def chain_rows(device):
    """The chain route's coarse level on `device`: the committed
    10,000-template bank planned at a 512^2 frame (coarse 256^2, T=8) and
    two synthetic frames' linear memories. Returns (lmflat, plan, bank,
    positions, W)."""
    det = Detector(num_features=63, T=(4, 8), device=device)
    det.class_templates["c"] = tsyn.load_bank_cache(
        tsyn.bank_cache_path(10000, 63))
    frames = np.stack([tsyn.synthetic_scene(
        512, 512, tsyn.synthetic_shape_image(256, 0), n_instances=1, seed=s)
        for s in (1, 2)])
    lms, sizes, _, _ = det._prepare(frames, None, 60.0, ["c"])
    plan = det._get_chain("c", sizes[-1])
    assert plan is not None
    bank = det._get_banks("c")[-1]
    W = H = 32
    return lms[-1], plan, bank, tsim._positions(bank, 8, W, H), W


def chain_case(rows, threshold: float, C: int):
    """(S, cnt, positions, rmin, t4n, T, W, C) of the chain rows at
    `threshold`."""
    lmflat, plan, bank, pos, W = rows
    rmin, t4n = tsim._rmin_for_threshold(
        bank.nfeat, torch.full((), threshold, dtype=torch.float32,
                               device=lmflat.device))
    S, cnt = chain_scores(lmflat, plan, pos, rmin)
    return S, cnt, pos, rmin, t4n, 8, W, C


CHAIN_CASES = ((60.0, 256), (60.0, 4096), (-1.0, 2000))


# name: (seed, cap rule, odd M). "cap": the cap cuts frame 0's template 1
# two live cells past its first segment edge; "all": every candidate
# (template 2's quirk slots straddle its segments, template 4's count
# overstates its row); "past": the cap past n_above, so template K-1's
# slots past n_above fill several groups of the closed form
STRADDLE_CASES = {
    "cap_in_edge": (21, "cap", False),
    "quirk_edge": (22, "all", False),
    "past_end_odd": (23, "past", True),
}


def straddle_case(name: str, seg: int):
    """(S, cnt, positions, rmin, t4n, T, W, C), CPU tensors, of rows of M =
    2.5 `seg` cells (3 more for odd M) over K = 6 templates and B = 2
    frames: scores below rmin = 30 but for a run of live cells across each
    segment edge (`seg`, 2 `seg`) and four random ones; template 2 has
    rmin 0 (every cell below its positions live, the rest quirk cells),
    positions end near the edges, template 3 has t4n 0 (inf and NaN
    scores)."""
    seed, cap, odd = STRADDLE_CASES[name]
    rng = np.random.RandomState(seed)
    B, K, T, W = 2, 6, 4, 64
    M = 2 * seg + seg // 2 + (3 if odd else 0)
    S = rng.randint(0, 30, (B, K, M)).astype(np.int32)
    for b in range(B):
        for k in range(K):
            for edge in (seg, 2 * seg):
                S[b, k, edge - 3 - b:edge + 3] = rng.randint(30, 60, 6 + b)
            S[b, k, rng.randint(0, M, 4)] = rng.randint(30, 60, 4)
    pos = np.array([M, seg + 7, seg + 5, 2 * seg, M - 5, 2 * seg + 1],
                   np.int32)
    rmin = np.array([30, 30, 0, 30, 30, 30], np.int32)
    t4n = rng.uniform(50.0, 300.0, K).astype(np.float32)
    t4n[3] = 0.0
    S, pos, rmin, t4n = (torch.from_numpy(a) for a in (S, pos, rmin, t4n))
    cnt = count_live(S, pos, rmin)
    if cap == "all":
        cnt[:, 4] += 3
    _, incl = _extract_prefix(cnt, pos, rmin, M)
    if cap == "cap":
        live = torch.nonzero((S[0, 1] >= 30) & (torch.arange(M) < pos[1]))
        C = int(incl[0, 0]) + int((live < seg).sum()) + 2
    elif cap == "all":
        C = int(incl[:, -1].max())
    else:
        C = int(incl[:, -1].max()) + 3 * seg // 4 + 17
    return S, cnt, pos, rmin, t4n, T, W, C
