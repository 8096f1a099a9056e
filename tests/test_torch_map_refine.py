"""The port's map route of the refine step against the JAX package, bit
for bit.

distinct_templates and gather_bank must equal JAX's, overflow (more
distinct templates than D) included; the unmasked level maps of the
distinct templates (coarse_maps) must equal JAX's coarse_similarity with
mask_positions=False; refine_from_maps, whose CPU path runs the plain twin
of the map-window kernel, must equal JAX's refine_from_maps and its Pallas
map-window kernel (interpret mode); and on a bank that is not
pathological the map route must equal the window route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_matching_tpu.ops import similarity as jsim
from shape_based_matching_tpu.ops.pallas.refine_pallas import (
    refine_from_maps_pallas)
from shape_based_matching_tpu_torch.ops import similarity as tsim
from shape_based_matching_tpu_torch.ops.cuda.coarse import coarse_maps
from shape_based_matching_tpu_torch.utils.convert import (
    level_bank_from_numpy)

T, HW = 4, 128
K = 23


def _bank(seed, size=40):
    rng = np.random.RandomState(seed)
    templates = []
    for i in range(K):
        n = int(rng.randint(5, 64))
        feats = [(int(rng.randint(0, size + 1)), int(rng.randint(0, size + 1)),
                  int(rng.randint(0, 8))) for _ in range(n)]
        templates.append({"features": [] if i == 4 else feats,
                          "width": size, "height": size})
    jbank = jsim.pack_level_bank(templates, n_pad=64)
    return jbank, level_bank_from_numpy([np.asarray(f) for f in jbank])


def _candidates(rng, n_cand, ks):
    k = rng.choice(ks, n_cand).astype(np.int32)
    x = rng.randint(0, HW // 2, n_cand).astype(np.int32)
    y = rng.randint(0, HW // 2, n_cand).astype(np.int32)
    valid = rng.rand(n_cand) > 0.2
    return k, x, y, valid


@pytest.mark.parametrize("n_templates,D", [(5, 16), (15, 8), (23, 23)])
def test_distinct_templates_and_gather_bank_equal_jax(n_templates, D):
    rng = np.random.RandomState(n_templates)
    jbank, tbank = _bank(1)
    ks = rng.choice(K, n_templates, replace=False)
    k, _, _, valid = _candidates(rng, 50, ks)
    want = jsim.distinct_templates(jnp.asarray(k), jnp.asarray(valid), K, D)
    got = tsim.distinct_templates(torch.from_numpy(k[None]),
                                  torch.from_numpy(valid[None]), K, D)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (int(got[2]) > D) == (n_templates == 15)
    for g, w in zip(tsim.gather_bank(tbank, got[0]),
                    jsim.gather_bank(jbank, want[0])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _maps_case(seed, threshold, D=None):
    rng = np.random.RandomState(seed)
    W = HW // T
    M = W * W
    lm = rng.randint(0, 5, (8, T * T, M)).astype(np.uint8)
    lmflat = np.concatenate([lm.reshape(-1), np.zeros(M, np.uint8)])
    jbank, tbank = _bank(seed)
    k, x, y, valid = _candidates(rng, 60, np.arange(K))
    D = D or K
    thr = np.float32(threshold)
    jk, jvalid = jnp.asarray(k), jnp.asarray(valid)
    slots, slot_of_k, _ = jsim.distinct_templates(jk, jvalid, K, D)
    Sj, _ = jsim.coarse_similarity(jnp.asarray(lmflat),
                                   jsim.gather_bank(jbank, slots), T,
                                   (HW, HW), mask_positions=False)
    jargs = (Sj, slot_of_k, jbank, T, (HW, HW), jk, jnp.asarray(x),
             jnp.asarray(y), jvalid, jnp.float32(thr))
    flat_t = torch.from_numpy(lmflat[None])
    cand_t = [torch.from_numpy(a[None]) for a in (k, x, y, valid)]
    return jargs, flat_t, tbank, cand_t, torch.tensor(thr), D


def _host(result):
    out = [a[0].numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
           for a in result]
    out[3] = out[3].view(np.uint32)
    return out


def _assert_equal(got, want):
    valid = want[4]
    np.testing.assert_array_equal(got[4], valid)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[valid], w[valid])


@pytest.mark.parametrize("seed,threshold,D", [(3, 50.0, None),
                                              (4, 70.0, None),
                                              (5, 50.0, 8)])
def test_refine_from_maps_equals_jax(seed, threshold, D):
    """D=8 holds fewer than the candidates' distinct templates: the
    candidates without a map come out invalid in both packages."""
    jargs, flat, tbank, cand, thr, D = _maps_case(seed, threshold, D)
    slots, slot_of_k, _ = tsim.distinct_templates(cand[0], cand[3], K, D)
    sub = tsim.gather_bank(tbank, slots)
    W = HW // T
    Sfull = coarse_maps(flat, tsim._flat_offsets(sub, T, W, W * W,
                                                 (HW, HW)), W * W)
    np.testing.assert_array_equal(Sfull[0].numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(slot_of_k.numpy(), np.asarray(jargs[1]))
    got = _host(tsim.refine_from_maps(Sfull, slot_of_k, tbank, T, (HW, HW),
                                      *cand, thr))
    assert got[4].any()
    _assert_equal(got, _host(jsim.refine_from_maps(*jargs)))
    _assert_equal(got, _host(refine_from_maps_pallas(*jargs,
                                                     interpret=True)))
    if D == K:
        _assert_equal(got, _host(tsim.refine_by_maps(
            flat, tbank, T, (HW, HW), *cand, thr)))


def test_map_route_equals_window_route():
    """Templates of 40 px at 128^2 and T=4 are not pathological (40 <
    128 - 64): every window is a window of the full map."""
    _, flat, tbank, cand, thr, _ = _maps_case(6, 45.0)
    maps = _host(tsim.refine_by_maps(flat, tbank, T, (HW, HW), *cand, thr))
    window = _host(tsim.refine_candidates(flat, tbank, T, (HW, HW), *cand,
                                          thr))
    assert maps[4].any()
    _assert_equal(maps, window)
