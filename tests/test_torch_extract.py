"""Counted candidate extraction and the slabbed map route, on the CPU.

* ``csrc/extract.cu`` replayed block by block from the source's
  constants (``tests/torch_csrc.py``): the (template, frame) blocks that
  meet the first C slots, each walking its score row in chunks of CHUNK
  cells, ranking the flags of a chunk as the ballots and the warp totals
  do, writing the ranks below min(cnt, C - excl), then the count's
  fallback cell and the quirk and past-the-end slots in closed form. The
  replay must write every slot and equal ``extract_counted_plain`` bit
  for bit, on quirk templates (rmin <= 0), overflow (n_above > C), slots
  past n_above, templates with no positions, B = 3, counts that
  overstate the row, empty templates (a NaN score) and the chain route's
  rows (cells past the positions not zeroed). The twin's chunks of
  slots change no bit. The twin itself is held to
  the JAX package's extraction by
  ``tests/test_torch_coarse.py::test_counted_extraction_equals_jax``.
* ``refine_by_maps`` with the level maps built in slabs (``_MAP_SLAB``
  patched to 16 and 64) on a bank with more distinct candidate templates
  than one slab: every output of every candidate equals the unslabbed
  call (the invalid candidates come from the first slab), the valid ones
  equal the JAX package's map path (``coarse_similarity`` +
  ``refine_from_maps``), and no slab's maps hold more than ``_MAP_SLAB``
  templates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_matching_tpu.ops import similarity as jsim
from shape_based_matching_tpu_torch.ops import similarity as tsim
from shape_based_matching_tpu_torch.ops.cuda import extract as extract_mod
from shape_based_matching_tpu_torch.ops.cuda.extract import (
    extract_counted, extract_counted_plain)
from shape_based_matching_tpu_torch.utils.convert import (
    level_bank_from_numpy)
from tests.torch_csrc import constants
from tests.torch_extract_cases import (CHAIN_CASES, EXTRACT_CASES,
                                       chain_case, chain_rows, extract_case)

KC = constants("extract.cu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replay(S, cnt, pos, rmin, t4n, T, W, C):
    """extract.cu's blocks on numpy arrays; unwritten slots keep k = -1."""
    B, K, M = S.shape
    THREADS, WARPS, CELLS, CHUNK = (KC[n] for n in ("THREADS", "WARPS",
                                                    "CELLS", "CHUNK"))
    assert THREADS == 32 * WARPS and CHUNK == THREADS * CELLS
    qcnt = np.where(rmin <= 0, M - np.clip(pos, 0, M), 0).astype(np.int32)
    bcnt = cnt + qcnt[None]
    incl = np.cumsum(bcnt, axis=1, dtype=np.int32)
    excl = incl - bcnt
    off = T // 2 + (T % 2 - 1)
    out = [np.full((B, C), -1, np.int32), np.zeros((B, C), np.int32),
           np.zeros((B, C), np.int32), np.zeros((B, C), np.float32),
           np.zeros((B, C), bool)]

    def put(b, slot, k, j, raw, hi):
        out[0][b, slot] = k
        out[1][b, slot] = (j % W) * T + off
        out[2][b, slot] = (j // W) * T + off
        with np.errstate(invalid="ignore", divide="ignore"):
            out[3][b, slot] = (np.float32(np.int32(raw) * 100)
                               / np.float32(t4n[k]))
        out[4][b, slot] = slot < hi

    lane = np.arange(32)
    for b in range(B):
        for k in range(K):
            e, hi = int(excl[b, k]), int(incl[b, k])
            need = (C if k == K - 1 else min(hi, C)) - e
            if e >= C or need <= 0:
                continue
            lcnt = int(cnt[b, k])
            pc = min(max(int(pos[k]), 0), M)
            target = min(lcnt, need)
            row = S[b, k]
            found, j0 = 0, 0
            while found < target and j0 < pc:
                # thread t = 32 w + l owns cells j0 + CELLS t + q
                cells = (j0 + CELLS * (32 * np.arange(WARPS)[:, None]
                                       + lane[None]))[..., None] \
                    + np.arange(CELLS)
                v = np.where(cells < pc, row[np.minimum(cells, M - 1)], 0)
                f = (cells < pc) & (v >= rmin[k])          # [WARPS, 32, 4]
                per_lane = f.sum(2)
                below = np.cumsum(per_lane, 1) - per_lane  # ballots + popc
                total = per_lane.sum(1)                    # warp_total
                rank = (found + (np.cumsum(total) - total)[:, None] + below
                        )[..., None] + np.cumsum(f, 2) - f
                for r, j in zip(rank[f & (rank < target)],
                                cells[f & (rank < target)]):
                    put(b, e + r, k, int(j), row[j], hi)
                found += int(total.sum())
                j0 += CHUNK
            for r in range(found, target):
                put(b, e + r, k, M - 1, row[M - 1], hi)
            for r in range(max(lcnt, 0), need):
                put(b, e + r, k, pc + (r - lcnt), 0, hi)
    return out


def _assert_bitwise(got, want):
    """k, x, y, valid exactly; the score's bits where it is a number, NaN
    where the other is NaN."""
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[i], want[i])
    gs, ws = got[3], want[3]
    nan = np.isnan(ws)
    np.testing.assert_array_equal(np.isnan(gs), nan)
    np.testing.assert_array_equal(gs[~nan].view(np.uint32),
                                  ws[~nan].view(np.uint32))


def _check_replay(S, cnt, pos, rmin, t4n, T, W, C):
    want = [a.numpy() for a in extract_counted_plain(S, cnt, pos, rmin, t4n,
                                                     T, W, C)]
    # the CPU dispatch runs the twin
    via = extract_counted(S, cnt, pos, rmin, t4n, T, W, C)
    for a, w in zip(via, want):
        np.testing.assert_array_equal(
            np.ascontiguousarray(a.numpy()).view(np.uint8),
            np.ascontiguousarray(w).view(np.uint8))
    got = _replay(S.numpy(), cnt.numpy(), pos.numpy(), rmin.numpy(),
                  t4n.numpy(), T, W, C)
    assert (got[0] >= 0).all(), "the replay left a slot unwritten"
    _assert_bitwise(got, want[:5])
    return want


@pytest.mark.parametrize("name", list(EXTRACT_CASES))
def test_extract_replay_equals_plain(name):
    S, cnt, pos, rmin, t4n, T, W, C = extract_case(name)
    k, x, y, sc, valid, n_above = _check_replay(S, cnt, pos, rmin, t4n, T,
                                                W, C)
    assert (n_above > 0).all() and valid.any()
    for b, n in enumerate(n_above.tolist()):  # valid exactly below n_above
        assert valid[b, :n].all() and not valid[b, n:].any()
    if name == "overflow":
        assert (n_above > C).all()
    if name == "past_end":
        assert (n_above < C).all() and (k[~valid] == S.shape[1] - 1).all()
    if name.startswith("quirk"):  # quirk cells are valid at score 0
        assert (valid & (sc == 0)).any()
    if name == "no_positions":
        assert not np.isin(k[valid], np.nonzero(pos.numpy() <= 0)[0]).any()
    if name == "overstated":  # a rank past the row's live cells: cell M-1
        M, off = S.shape[2], T // 2 + (T % 2 - 1)
        assert (valid & (x == ((M - 1) % W) * T + off)
                & (y == ((M - 1) // W) * T + off)).any()


@pytest.mark.parametrize("name", list(EXTRACT_CASES))
def test_plain_twin_slot_chunks_change_no_bit(monkeypatch, name):
    """The twin gathers its score rows a chunk of slots at a time; chunks
    of 1 and of 7 slots give the one-chunk result bit for bit, n_above
    included."""
    args = extract_case(name)
    B, _, M = args[0].shape
    whole = extract_counted_plain(*args)
    for slots in (1, 7):
        monkeypatch.setattr(extract_mod, "_PLAIN_CELLS", slots * B * M)
        got = extract_counted_plain(*args)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(
                np.ascontiguousarray(g.numpy()).view(np.uint8),
                np.ascontiguousarray(w.numpy()).view(np.uint8))


@pytest.fixture(scope="module")
def dense_rows():
    return chain_rows("cpu")


@pytest.mark.parametrize("threshold,C", CHAIN_CASES)
def test_extract_replay_equals_plain_on_chain_rows(dense_rows, threshold, C):
    S, cnt, pos, rmin, t4n, T, W, C = chain_case(dense_rows, threshold, C)
    j = torch.arange(S.shape[2])
    assert bool(((j[None, :] >= pos[:, None]) & (S[0] > 0)).any())
    _, _, _, _, valid, n_above = _check_replay(S, cnt, pos, rmin, t4n, T, W,
                                               C)
    assert valid.any() and (n_above > 0).all()
    if threshold < 0:
        assert (n_above > C).all()


# the slabbed map route: a 128^2 level at T=4 and 40-pixel templates (not
# pathological: 40 < 128 - 16 * 4)
T, HW, K_MAPS = 4, 128, 150


def _maps_bank(seed):
    rng = np.random.RandomState(seed)
    templates = []
    for i in range(K_MAPS):
        feats = [(int(rng.randint(0, 41)), int(rng.randint(0, 41)),
                  int(rng.randint(0, 8)))
                 for _ in range(int(rng.randint(5, 64)))]
        templates.append({"features": [] if i % 37 == 4 else feats,
                          "width": 40, "height": 40})
    jbank = jsim.pack_level_bank(templates, n_pad=64)
    return jbank, level_bank_from_numpy([np.asarray(f) for f in jbank])


def _maps_inputs(seed, B, C):
    rng = np.random.RandomState(seed)
    M = (HW // T) ** 2
    lm = rng.randint(0, 5, (B, 8 * T * T * M)).astype(np.uint8)
    lmflat = np.concatenate([lm, np.zeros((B, M), np.uint8)], axis=1)
    k = rng.randint(0, K_MAPS, (B, C)).astype(np.int32)
    x = rng.randint(0, HW // 2, (B, C)).astype(np.int32)
    y = rng.randint(0, HW // 2, (B, C)).astype(np.int32)
    valid = rng.rand(B, C) > 0.2
    return lmflat, k, x, y, valid


def _run(tbank, lmflat, k, x, y, valid, thr):
    return [a.numpy() for a in tsim.refine_by_maps(
        torch.from_numpy(lmflat), tbank, T, (HW, HW),
        *(torch.from_numpy(a) for a in (k, x, y, valid)),
        torch.tensor(np.float32(thr)))]


@pytest.mark.parametrize("slab", [16, 64])
def test_slabbed_map_route_equals_unslabbed_and_jax(monkeypatch, slab):
    jbank, tbank = _maps_bank(11)
    lmflat, k, x, y, valid = _maps_inputs(12, 2, 300)
    thr = 40.0
    n = len(np.unique(k[valid]))
    assert n > 64 and tsim._MAP_SLAB >= K_MAPS
    whole = _run(tbank, lmflat, k, x, y, valid, thr)

    built = []
    maps = tsim.coarse_maps

    def record(lm, off, M):
        built.append(off.shape[0])
        return maps(lm, off, M)

    monkeypatch.setattr(tsim, "coarse_maps", record)
    monkeypatch.setattr(tsim, "_MAP_SLAB", slab)
    got = _run(tbank, lmflat, k, x, y, valid, thr)
    assert built == [min(slab, n - s) for s in range(0, n, slab)]
    # every candidate, the invalid ones (from the first slab) included
    for g, w in zip(got, whole):
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    ok = got[4]
    assert ok.any() and (valid & ~ok).any() and (~valid).any()
    assert len(np.unique(k[ok])) > slab  # valid results from several slabs
    # the JAX package's map path, frame by frame, on the valid candidates
    for b in range(2):
        jk, jvalid = jnp.asarray(k[b]), jnp.asarray(valid[b])
        slots, slot_of_k, _ = jsim.distinct_templates(jk, jvalid, K_MAPS,
                                                      K_MAPS)
        Sj, _ = jsim.coarse_similarity(
            jnp.asarray(lmflat[b]), jsim.gather_bank(jbank, slots), T,
            (HW, HW), mask_positions=False)
        want = [np.asarray(a) for a in jsim.refine_from_maps(
            Sj, slot_of_k, jbank, T, (HW, HW), jk, jnp.asarray(x[b]),
            jnp.asarray(y[b]), jvalid, jnp.float32(thr))]
        np.testing.assert_array_equal(ok[b], want[4])
        live = want[4]
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[b][live], w[live])
        np.testing.assert_array_equal(got[3][b][live].view(np.uint32),
                                      want[3][live].view(np.uint32))


def test_map_route_below_one_slab_is_one_build(monkeypatch):
    """At most _MAP_SLAB distinct templates: one build of the D bucket's
    maps, as before the slabs."""
    _, tbank = _maps_bank(13)
    lmflat, k, x, y, valid = _maps_inputs(14, 1, 100)
    k = k % 40
    built = []
    maps = tsim.coarse_maps
    monkeypatch.setattr(tsim, "coarse_maps", lambda lm, off, M: (
        built.append(off.shape[0]), maps(lm, off, M))[1])
    monkeypatch.setattr(tsim, "_MAP_SLAB", 64)
    _run(tbank, lmflat, k, x, y, valid, 40.0)
    assert built == [64]
