"""The port's coarse scoring and counted candidate extraction against the
JAX package, bit for bit.

The plain twin of the CUDA coarse kernel (ops/cuda/coarse.coarse_scores on
CPU tensors) and the extraction around it must give the JAX package's
scores, candidate sets in the same template-major order, the same float32
scores and the exact above-threshold count -- including the flat-offset
edge cases (features off the image, fx == width overreads, a template
with no features) and the negative-threshold quirk cells.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_matching_tpu.ops import similarity as jsim
from shape_based_matching_tpu.ops.pallas.similarity_pallas import (
    coarse_words_pallas_counted)
from shape_based_matching_tpu_torch.ops import similarity as tsim
from shape_based_matching_tpu_torch.ops.cuda.coarse import coarse_scores
from shape_based_matching_tpu_torch.utils.convert import (
    level_bank_from_numpy)


def _case(seed, T=4, hw=(96, 64), K=13, n_max=40):
    """Random linear memories and a random bank with edge cases: features
    off the image, fx == width / fy == height (flat reads past the row),
    oversized templates, and an empty template."""
    rng = np.random.RandomState(seed)
    w_img, h_img = hw
    M = (w_img // T) * (h_img // T)
    lm = rng.choice(np.array([0, 0, 3, 4], np.uint8), (8, T * T, M))
    lmflat = np.concatenate([lm.reshape(-1), np.zeros(M, np.uint8)])
    templates = []
    for i in range(K):
        wt, ht = int(rng.randint(4, 40)) // T * T, int(rng.randint(4, 40))
        if i == 3:
            wt, ht = w_img + 8, 12  # wider than the frame: positions <= 0
        n = int(rng.randint(1, n_max))
        feats = [(int(rng.randint(-6, wt + 1)), int(rng.randint(0, ht + 1)),
                  int(rng.randint(0, 8))) for _ in range(n)]
        feats[0] = (wt, ht, 2)  # the crop puts the max feature on the edge
        if i == 5:
            feats = []
        templates.append({"features": feats, "width": wt, "height": ht})
    jbank = jsim.pack_level_bank(templates)
    tbank = level_bank_from_numpy([np.asarray(f) for f in jbank])
    return lm, lmflat, jbank, tbank


@pytest.mark.parametrize("T,hw", [(4, (96, 64)), (8, (128, 72))])
@pytest.mark.parametrize("mask_positions", [True, False])
def test_coarse_similarity_equals_jax(T, hw, mask_positions):
    lm, lmflat, jbank, tbank = _case(T, T, hw)
    S_j, pos_j = jsim.coarse_similarity(jnp.asarray(lmflat), jbank, T, hw,
                                        mask_positions=mask_positions)
    S_t, pos_t = tsim.coarse_similarity(torch.from_numpy(lmflat), tbank, T,
                                        hw, mask_positions=mask_positions)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(S_t.numpy(), np.asarray(S_j))


def _assert_same_candidates(got, want):
    k, x, y, sc, valid, n_above = (a.numpy() for a in got)
    wk, wx, wy, wsc, wvalid, wn = (np.asarray(a) for a in want)
    assert int(n_above) == int(wn)
    np.testing.assert_array_equal(valid, wvalid)
    v = wvalid
    for a, b in ((k, wk), (x, wx), (y, wy)):
        np.testing.assert_array_equal(a[v], b[v])
    np.testing.assert_array_equal(sc[v].view(np.uint32),
                                  wsc[v].view(np.uint32))


@pytest.mark.parametrize("threshold,cap", [
    (60.0, 512),    # all candidates fit
    (40.0, 16),     # overflow: the first 16 in template-major order
    (-5.0, 700),    # quirk cells: every cell past positions passes at 0
    (-5.0, 64),
])
def test_counted_extraction_equals_jax(threshold, cap):
    T, hw = 4, (96, 64)
    lm, lmflat, jbank, tbank = _case(7, T, hw)
    want = jsim.coarse_extract_dispatch(
        jnp.asarray(lm), jnp.asarray(lmflat), jbank, T, hw,
        jnp.float32(threshold), cap, use_pallas=False)
    got = tsim.coarse_extract(torch.from_numpy(lmflat[None]), tbank, T, hw,
                              torch.tensor(threshold), cap)
    assert int(want[5]) > 0
    _assert_same_candidates([a[0] for a in got], want)


def test_counted_extraction_batched_equals_per_frame():
    T, hw = 4, (96, 64)
    _, f0, _, tbank = _case(1, T, hw)
    _, f1, _, _ = _case(2, T, hw)
    thr = torch.tensor(45.0)
    both = tsim.coarse_extract(torch.from_numpy(np.stack([f0, f1])), tbank,
                               T, hw, thr, 96)
    for b, f in enumerate((f0, f1)):
        one = tsim.coarse_extract(torch.from_numpy(f[None]), tbank, T, hw,
                                  thr, 96)
        for a, o in zip(both, one):
            assert torch.equal(a[b], o[0])


def test_kernel_counts_equal_pallas_counted_interpret():
    """The per-template live counts the coarse kernel returns equal the
    counts of the JAX packed counted kernel (run in interpret mode)."""
    T, hw = 4, (64, 64)
    lm, lmflat, jbank, tbank = _case(5, T, hw, K=9)
    thr = jnp.float32(50.0)
    rmin, _ = jsim._rmin_for_threshold(jbank.nfeat, thr)
    words, kcnt, positions, unit = coarse_words_pallas_counted(
        jnp.asarray(lm), jbank, T, hw, rmin, interpret=True)
    W, H = hw[0] // T, hw[1] // T
    off = tsim._flat_offsets(tbank, T, W, W * H, hw)
    pos = tsim._positions(tbank, T, W, H)
    S, cnt = coarse_scores(torch.from_numpy(lmflat[None]), off, pos,
                           torch.tensor(np.asarray(rmin)), W * H)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(positions))
    np.testing.assert_array_equal(cnt[0].numpy(), np.asarray(kcnt))
    assert int(cnt.sum()) > 0
