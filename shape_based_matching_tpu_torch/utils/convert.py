"""Carry template state into the port's tensors.

The template bank plays the part of a model's weights: the JAX package
and the port must score the identical bank, so the tests build it once and
hand it to both, either as a JAX ``LevelBank`` turned into numpy arrays or
as the template pyramids themselves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.similarity import LevelBank, pack_level_bank

_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool, torch.int32,
           torch.int32, torch.int32)


def level_bank_from_numpy(fields, device="cpu") -> LevelBank:
    """The seven LevelBank fields (fx, fy, label, valid, nfeat, width,
    height) as numpy arrays, e.g. ``[np.asarray(f) for f in jax_bank]``,
    -> the port's LevelBank on `device`."""
    if len(fields) != len(LevelBank._fields):
        raise ValueError(f"expected {len(LevelBank._fields)} fields, got "
                         f"{len(fields)}")
    return LevelBank(*(torch.tensor(np.asarray(f), dtype=dt, device=device)
                       for f, dt in zip(fields, _DTYPES)))


def pyramids_to_banks(pyramids, levels: int, device="cpu",
                      n_ori: int = 8) -> list:
    """One LevelBank per pyramid level from a class's template pyramids
    (the counterpart of the JAX Detector._get_banks), of any feature count:
    a level's bank is as wide as its widest template. Raises when a
    feature's orientation label does not fit `n_ori` planes, since its
    offset would address another template's plane."""
    banks = []
    for l in range(levels):
        banks.append(pack_level_bank(
            [{"features": [(f.x, f.y, f.label) for f in tp[l].features],
              "width": tp[l].width, "height": tp[l].height}
             for tp in pyramids], device=device))
        labels = banks[-1].label[banks[-1].valid]
        if labels.numel() and not (0 <= int(labels.min())
                                   and int(labels.max()) < n_ori):
            raise ValueError(f"level {l}: feature labels outside 0..{n_ori - 1}"
                             f" (bank for another orientation count?)")
    return banks
