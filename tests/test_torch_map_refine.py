"""The port's map route of the refine step against the JAX package, bit
for bit.

distinct_templates and gather_bank must equal JAX's, overflow (more
distinct templates than D) included; the unmasked level maps of the
distinct templates (coarse_maps) must equal JAX's coarse_similarity with
mask_positions=False; refine_from_maps, whose CPU path runs the plain twin
of the map-window kernel, must equal JAX's refine_from_maps and its Pallas
map-window kernel (interpret mode); and on a bank that is not
pathological the map route must equal the window route. The edge cases
hold the plain twin of the fused map-refine kernel (window origin, slot,
window, first max, score, threshold) to JAX on every live candidate:
origins clamped at both borders, templates wider than the level less 16T
(a negative clamp bound, so the origin's division must floor), templates
without a map (slot -1), empty templates (nfeat 0: a NaN score, never
valid) and tied windows (the first max wins).
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
from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
    map_refine_plain)
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


# edge cases of the map refine step: (template side range, slots dropped,
# map values range, threshold)
_EDGES = {
    "clamped": ((40, 41), 0, (-3, 40), 50.0),
    "wide": ((97, 111), 0, (-3, 40), 50.0),
    "no_slot": ((30, 60), 4, (-3, 40), 50.0),
    "ties": ((30, 60), 0, (0, 3), 1.0),
}


def _edge_case(name, B=2, C=48, K=12):
    """Maps, bank and candidates of one edge case: random maps (all zero
    for the empty templates 2 and 7, as real maps are), slot -1 for the
    dropped templates, candidates over the whole level above."""
    (lo, hi), n_drop, (vlo, vhi), thr = _EDGES[name]
    rng = np.random.RandomState(sorted(_EDGES).index(name) + 20)
    W = HW // T
    width = rng.randint(lo, hi, K).astype(np.int32)
    height = rng.randint(lo, hi, K).astype(np.int32)
    nfeat = rng.randint(1, 64, K).astype(np.int32)
    nfeat[[2, 7]] = 0
    has = np.ones(K, bool)
    has[rng.choice([i for i in range(K) if i not in (2, 7)], n_drop,
                   replace=False)] = False
    slot_of_k = np.where(has, np.cumsum(has) - 1, -1).astype(np.int32)
    D = int(has.sum())
    Sfull = rng.randint(vlo, vhi, (B, D, W * W)).astype(np.int32)
    Sfull[:, slot_of_k[[2, 7]]] = 0
    k = rng.randint(0, K, (B, C)).astype(np.int32)
    x = rng.randint(0, HW // 2, (B, C)).astype(np.int32)
    y = rng.randint(0, HW // 2, (B, C)).astype(np.int32)
    valid = rng.rand(B, C) > 0.2
    one = np.ones((K, 1), np.int32)
    fields = (one, one, one, one.astype(bool), nfeat, width, height)
    return Sfull, slot_of_k, fields, k, x, y, valid, np.float32(thr)


def _assert_live_equal(got, want, live):
    """valid and k on every candidate; x, y and the score bits on every
    live one (valid with a map: both sides read the same window), a NaN
    score where the other side has one (the bits of a NaN may differ)."""
    gk, gx, gy, gs, gv = got
    wk, wx, wy, ws, wv = want
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gx[live], wx[live])
    np.testing.assert_array_equal(gy[live], wy[live])
    gs, ws = gs[live], ws[live]
    nan = np.isnan(gs)
    np.testing.assert_array_equal(nan, np.isnan(ws))
    np.testing.assert_array_equal(gs[~nan].view(np.uint32),
                                  ws[~nan].view(np.uint32))


@pytest.mark.parametrize("name", sorted(_EDGES))
def test_map_refine_plain_edges_equal_jax(name):
    Sfull, slot_of_k, fields, k, x, y, valid, thr = _edge_case(name)
    tbank = level_bank_from_numpy(fields)
    jbank = jsim.LevelBank(*(jnp.asarray(f) for f in fields))
    got = [a.numpy() for a in map_refine_plain(
        torch.from_numpy(Sfull), torch.from_numpy(slot_of_k), tbank.width,
        tbank.height, tbank.nfeat, T, (HW, HW), *(torch.from_numpy(a) for a
                                                 in (k, x, y, valid)),
        torch.tensor(thr))]
    via_entry = tsim.refine_from_maps(
        torch.from_numpy(Sfull), torch.from_numpy(slot_of_k), tbank, T,
        (HW, HW), *(torch.from_numpy(a) for a in (k, x, y, valid)),
        torch.tensor(thr))
    for a, b in zip(via_entry, got):
        np.testing.assert_array_equal(a.numpy(), b)
    live = valid & (slot_of_k[k] >= 0)
    for b in range(Sfull.shape[0]):
        jargs = (jnp.asarray(Sfull[b]), jnp.asarray(slot_of_k), jbank, T,
                 (HW, HW), *(jnp.asarray(a[b]) for a in (k, x, y, valid)),
                 jnp.float32(thr))
        mine = [a[b] for a in got]
        _assert_live_equal(mine, [np.asarray(a) for a in
                                  jsim.refine_from_maps(*jargs)], live[b])
        # JAX's Pallas kernel clamps a window that starts outside the maps
        # where its plain function clips cell by cell; JAX gives it only
        # banks whose windows lie inside (no "wide" template)
        if name != "wide":
            _assert_live_equal(mine, [np.asarray(a) for a in
                                      refine_from_maps_pallas(
                                          *jargs, interpret=True)], live[b])
    # the case covers what it names
    cx = np.minimum(np.maximum(2 * x + 1, 8 * T),
                    HW - fields[5][k] - 8 * T)
    ok = got[4]
    assert ok.any() and not ok.all()
    empty = live & (fields[4][k] == 0)
    assert empty.any()
    if name != "wide":  # an empty template's window reads its zero map
        assert not ok[empty].any() and np.isnan(got[3][empty]).all()
    if name == "clamped":
        assert (cx[live] == 8 * T).any() and (
            cx[live] == HW - fields[5][k][live] - 8 * T).any()
    if name == "wide":
        assert ((cx[live] < 0) & (cx[live] % T != 0)).any()
    if name == "no_slot":
        assert (valid & (slot_of_k[k] < 0)).any()
        assert not ok[slot_of_k[k] < 0].any()
    if name == "ties":  # windows whose maximum is in more than one cell
        W = HW // T
        cy = np.minimum(np.maximum(2 * y + 1, 8 * T),
                        HW - fields[6][k] - 8 * T)
        rr = np.arange(16)
        idx = (slot_of_k[k][..., None] * W * W
               + (cy // T - 8)[..., None] * W + (cx // T - 8)[..., None]
               + (rr[:, None] * W + rr[None, :]).reshape(-1))
        win = np.take_along_axis(Sfull.reshape(Sfull.shape[0], -1),
                                 idx.reshape(idx.shape[0], -1), 1
                                 ).reshape(idx.shape)
        n_max = (win == win.max(-1, keepdims=True)).sum(-1)
        assert (n_max[live & (fields[4][k] > 0)] > 1).all()
