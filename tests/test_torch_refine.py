"""The port's window refinement against the JAX package, bit for bit.

ops/similarity.refine_candidates runs the plain twin of the CUDA refine
kernel on CPU tensors. It must equal the JAX refine_candidates on every
valid candidate, and the JAX Pallas window kernel (interpret mode, with
skip_invalid as the match path runs it) on every candidate -- including
pathological banks, whose templates are wider than image - 16T so the
border clamp inverts and features fall off the image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_matching_tpu.ops import similarity as jsim
from shape_based_matching_tpu.ops.pallas.refine_pallas import (
    refine_windows_pallas)
from shape_based_matching_tpu_torch.ops import similarity as tsim
from shape_based_matching_tpu_torch.utils.convert import (
    level_bank_from_numpy)


def _templates(rng, n_templates, n_feat, size):
    out = []
    for _ in range(n_templates):
        n = int(rng.randint(*n_feat))
        feats = [(int(rng.randint(0, size + 1)), int(rng.randint(0, size + 1)),
                  int(rng.randint(0, 8))) for _ in range(n)]
        out.append({"features": feats, "width": size, "height": size})
    return out


def _check(seed, T, hw, templates, threshold, window=True, n_cand=40):
    """Every case pads its bank to 11 templates x 64 slots, so the
    interpreted Pallas kernel compiles once per T."""
    rng = np.random.RandomState(seed)
    templates = (templates * 11)[:11]
    W, H = hw // T, hw // T
    M = W * H
    lm = rng.randint(0, 5, (8, T * T, M)).astype(np.uint8)
    lmflat = np.concatenate([lm.reshape(-1), np.zeros(M, np.uint8)])
    jbank = jsim.pack_level_bank(templates, n_pad=64)
    tbank = level_bank_from_numpy([np.asarray(f) for f in jbank])
    k = rng.randint(0, len(templates), n_cand).astype(np.int32)
    x = rng.randint(0, hw // 2, n_cand).astype(np.int32)
    y = rng.randint(0, hw // 2, n_cand).astype(np.int32)
    valid = rng.rand(n_cand) > 0.2
    thr = np.float32(threshold)

    got = tsim.refine_candidates(
        torch.from_numpy(lmflat[None]), tbank, T, (hw, hw),
        *(torch.from_numpy(a[None]) for a in (k, x, y, valid)),
        torch.tensor(thr))
    got = [g[0].numpy() for g in got]
    got[3] = got[3].view(np.uint32)

    jargs = (jnp.asarray(k), jnp.asarray(x), jnp.asarray(y),
             jnp.asarray(valid), jnp.float32(thr))
    exact = [np.asarray(a) for a in jsim.refine_candidates(
        jnp.asarray(lmflat), jbank, T, (hw, hw), *jargs)]
    exact[3] = exact[3].view(np.uint32)
    names = ("k", "x", "y", "sim", "valid")
    for g, e, name in zip(got, exact, names):
        np.testing.assert_array_equal(g[valid], e[valid],
                                      err_msg=f"{name} vs exact")
    if window:
        win = [np.asarray(a) for a in refine_windows_pallas(
            jnp.asarray(lm), jbank, T, (hw, hw), *jargs, interpret=True,
            skip_invalid=True)]
        win[3] = win[3].view(np.uint32)
        for g, w, name in zip(got, win, names):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} vs window")
    np.testing.assert_array_equal(got[4], exact[4])
    return got


@pytest.mark.parametrize("T", [4, 8])
def test_refine_equals_jax(T):
    """T=8 is held to refine_candidates only (the window kernel's
    interpret-mode compile is the costly part of this file)."""
    rng = np.random.RandomState(T)
    got = _check(T, T, 32 * T, _templates(rng, 11, (5, 64), 40), 45.0,
                 window=T == 4)
    assert got[4].any()


def test_refine_pathological_bank():
    """Templates wider than image - 16T (100 > 128 - 64)."""
    rng = np.random.RandomState(3)
    _check(3, 4, 128, _templates(rng, 4, (30, 50), 100), 55.0)


def test_refine_edge_features():
    """fx == width / fy == height with T | width: the flat read continues
    into the next linear-memory row, and past the last plane into the
    zero tail."""
    templates = [{"features": [(64, 64, 3), (0, 0, 1), (64, 0, 5),
                               (0, 64, 7)], "width": 64, "height": 64}]
    _check(4, 4, 128, templates, 10.0)
