"""Inputs of the counted candidate extraction (``ops/cuda/extract``) for
its tests: random score rows with seeded edge cases, and the chain
route's rows of the committed 10,000-template bank.

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
}


def extract_case(name: str):
    """(S, cnt, positions, rmin, t4n, T, W, C) of a case, CPU tensors:
    random rows over M cells (cells past the positions not zeroed, as the
    chain route leaves them), nfeat 1-20 with template 1 empty (nfeat 0),
    rmin and t4n from the threshold, and the live counts (raised by
    `overstate` on every third template)."""
    seed, B, K, M, threshold, C, positions, overstate, T, W = \
        EXTRACT_CASES[name]
    rng = np.random.RandomState(seed)
    S = torch.from_numpy(rng.randint(0, 60, (B, K, M)).astype(np.int32))
    nfeat = rng.randint(1, 21, K).astype(np.int32)
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
