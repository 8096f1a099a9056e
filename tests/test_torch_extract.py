"""Counted candidate extraction and the slabbed map route, on the CPU.

* ``csrc/extract.cu`` replayed from the source's constants
  (``tests/torch_csrc.py``). The prefix kernel: the count prefix in tiles
  of P_TILE templates with a carried total, n_above and the work list,
  which must equal ``count_prefix_plain`` and, template for template,
  the twin's ``_prefix`` and its searchsorted ownership of the slots
  below C. The extraction: tickets taken segment-major per frame, each a
  (listed template, segment of SEG cells): the closed-form slots dealt
  in THREADS-slot groups over the row's segments, the peek at the
  previous segment's look-back word, the early stop, the ballots of
  LOADS chunks behind one barrier, the AGG / INC words and the look-back,
  and the ranks an overstated count leaves (cell M-1) in the last
  segment. Two schedules: one ticket at a time (every peek finds its
  predecessor's inclusive count, and no segment that starts past the
  row's last taken live cell is read), and batches of tickets in flight
  whose peeks see only earlier batches and whose look-backs run last
  ticket first (through AGG words). Either must write every slot once
  and equal ``extract_counted_plain`` bit for bit: on quirk templates
  (rmin <= 0), overflow (n_above > C), slots past n_above, templates with
  no positions, B = 3, K = 1, counts that overstate the row, empty
  templates (a NaN score), the chain route's rows (cells past the
  positions not zeroed), C = 0, and rows whose live cells, quirk slots
  and slots past n_above straddle segment edges (the segment patched
  small, and once at its real size). The twin's chunks of slots change
  no bit. The twin itself is held to the JAX package's extraction by
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
    SEG_CELLS, _prefix, count_prefix, count_prefix_plain, extract_counted,
    extract_counted_plain)
from shape_based_matching_tpu_torch.utils.convert import (
    level_bank_from_numpy)
from tests.torch_csrc import constants
from tests.torch_extract_cases import (CHAIN_CASES, EXTRACT_CASES,
                                       STRADDLE_CASES, chain_case,
                                       chain_rows, extract_case,
                                       straddle_case)

KC = constants("extract.cu")
# a small segment for the replay: one warp, one load (128 cells)
SMALL = {"threads": 32, "loads": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefix_replay(cnt, pos, rmin, t4n, M, C):
    """prefix_kernel on numpy arrays: per frame, tiles of P_TILE
    templates, each thread's P_ITEMS in order after the block's exclusive
    prefix and the carried total (uint32, so int32 wraps as cumsum's).
    Returns (n_above [B], work [B, K, REC] (unset rows -1), nwork [B])."""
    B, K = cnt.shape
    P_TILE, REC = KC["P_TILE"], KC["REC"]
    assert P_TILE == KC["P_THREADS"] * KC["P_ITEMS"]
    pc = np.clip(pos, 0, M)
    bc = (cnt.astype(np.int64) + np.where(rmin <= 0, M - pc, 0)[None]) \
        .astype(np.uint32)
    n_above = np.zeros(B, np.int32)
    work = np.full((B, K, REC), -1, np.int32)
    nwork = np.zeros(B, np.int32)
    for b in range(B):
        carry, listed = np.uint32(0), 0
        for k0 in range(0, K, P_TILE):
            tile = bc[b, k0:k0 + P_TILE]
            incl = (carry + np.cumsum(tile, dtype=np.uint32)).view(np.int32)
            excl = (incl.view(np.uint32) - tile).view(np.int32)
            carry = np.uint32(incl.view(np.uint32)[-1])
            for q in range(len(tile)):
                k = k0 + q
                e, hi = int(excl[q]), int(incl[q])
                if k == K - 1:
                    n_above[b] = hi
                need = (C if k == K - 1 else min(hi, C)) - e
                if e < C and need > 0:
                    work[b, listed] = (k, e, hi, cnt[b, k], pc[k], rmin[k],
                                       t4n[k:k + 1].view(np.int32)[0], 0)
                    listed += 1
        nwork[b] = listed
    return n_above, work, nwork


def _replay(S, cnt, pos, rmin, t4n, T, W, C, threads=None, loads=None,
            inflight=1):
    """extract.cu's two kernels on numpy arrays, `inflight` tickets at a
    time (see the module's docstring). Returns the outputs (unwritten
    slots keep k = -1), the writes of each slot, the segments each
    (frame, template) read, and counts of the paths taken: segments that
    skipped their read, that read before their exclusive count was
    known, and AGG words a look-back passed."""
    B, K, M = S.shape
    THREADS = threads or KC["THREADS"]
    LOADS = loads or KC["LOADS"]
    CELLS, WARPS = KC["CELLS"], THREADS // 32
    CHUNK, SEG = THREADS * CELLS, THREADS * CELLS * LOADS
    if threads is None and loads is None:
        assert KC["SEG"] == SEG == SEG_CELLS and KC["WARPS"] == WARPS
    L = max(1, -(-M // SEG))
    n_above, work, nwork = _prefix_replay(cnt, pos, rmin, t4n, M, C)
    off = T // 2 + (T % 2 - 1)
    out = [np.full((B, C), -1, np.int32), np.zeros((B, C), np.int32),
           np.zeros((B, C), np.int32), np.zeros((B, C), np.float32),
           np.zeros((B, C), bool)]
    writes = np.zeros((B, C), np.int32)
    reads: dict = {}
    paths = {"skipped": 0, "speculative": 0, "agg_hops": 0}

    def put(b, slot, k, j, raw, tn, hi):
        out[0][b, slot] = k
        out[1][b, slot] = (j % W) * T + off
        out[2][b, slot] = (j // W) * T + off
        with np.errstate(invalid="ignore", divide="ignore"):
            out[3][b, slot] = np.float32(np.int32(raw) * 100) / tn
        out[4][b, slot] = slot < hi
        writes[b, slot] += 1

    lane = np.arange(32)
    # cell of (load q, warp, lane, cell c) relative to the segment's start
    rel = (np.arange(LOADS)[:, None, None] * CHUNK
           + CELLS * (32 * np.arange(WARPS)[:, None] + lane))[..., None] \
        + np.arange(CELLS)
    status: dict = {}  # (b, segment, record) -> (INC?, count)
    for b in range(B):
        nw = int(nwork[b])
        for t0 in range(0, nw * L, inflight):
            seen = dict(status)  # the words a peek of this batch finds
            blocks = []
            for t in range(t0, min(nw * L, t0 + inflight)):
                s, i = divmod(t, nw)
                k, e, hi, lcnt, pc, rm, tnb, _ = (int(v) for v in work[b, i])
                tn = np.int32(tnb).view(np.float32)
                nseg = max(1, -(-pc // SEG))
                if s >= nseg:
                    continue
                need = (C if k == K - 1 else min(hi, C)) - e
                target = min(lcnt, need)
                r0 = max(lcnt, 0)
                for g in range(r0 + s * THREADS, need, nseg * THREADS):
                    for r in range(g, min(g + THREADS, need)):
                        put(b, e + r, k, pc + (r - lcnt), 0, tn, hi)
                w = (True, 0) if s == 0 else seen.get((b, s - 1, i))
                ex = w[1] if w and w[0] else -1
                walk = ex < 0 or ex < target
                paths["skipped"] += not walk
                paths["speculative"] += ex < 0
                row, lo = S[b, k], s * SEG
                total, blk = 0, None
                if walk:
                    reads.setdefault((b, k), []).append(s)
                    cells = lo + rel
                    inside = cells < min(pc, lo + SEG)
                    v = np.where(inside, row[np.minimum(cells, M - 1)], 0)
                    f = inside & (v >= rm)                  # [LOADS, W, 32, 4]
                    per_lane = f.sum(-1)
                    below = np.cumsum(per_lane, -1) - per_lane  # ballots, popc
                    wt = per_lane.sum(-1)                        # s_wt
                    total = int(wt.sum())
                    blk = (cells, f, below, wt)
                status[(b, s, i)] = (ex >= 0, ex + total if ex >= 0 else total)
                blocks.append((s, i, k, e, hi, lcnt, tn, nseg, target, ex,
                               walk, total, blk, row))
            for (s, i, k, e, hi, lcnt, tn, nseg, target, ex, walk, total, blk,
                 row) in reversed(blocks):
                if ex < 0:  # look back through AGG words to an INC one
                    ex, p = 0, s - 1
                    while True:
                        inc, val = status[(b, p, i)]
                        ex += val
                        if inc:
                            break
                        paths["agg_hops"] += 1
                        p -= 1
                    status[(b, s, i)] = (True, ex + total)
                if walk and ex < target:
                    cells, f, below, wt = blk
                    chunk = wt.sum(1)
                    base = ex + np.cumsum(chunk) - chunk
                    before = np.cumsum(wt, 1) - wt
                    rank = (base[:, None, None] + before[..., None] + below
                            )[..., None] + np.cumsum(f, -1) - f
                    take = f & (rank < target)
                    for r, j in zip(rank[take], cells[take]):
                        put(b, e + int(r), k, int(j), row[j], tn, hi)
                if s == nseg - 1 and ex + total < target:
                    for r in range(ex + total, target):
                        put(b, e + r, k, M - 1, row[M - 1], tn, hi)
    return out, writes, reads, paths


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


def _expected_reads(S, cnt, pos, rmin, C, work, nwork, seg):
    """Per listed (frame, template): the segments up to the one holding
    the row's last taken live cell (every segment where the count
    overstates the row, none where nothing is to be taken)."""
    B, K, M = S.shape
    want = {}
    for b in range(B):
        for k, e, hi, lcnt, pc, rm, _, _ in work[b, :nwork[b]]:
            need = (C if k == K - 1 else min(hi, C)) - e
            target = min(lcnt, need)
            live = np.nonzero((np.arange(M) < pc) & (S[b, k] >= rm))[0]
            nseg = max(1, -(-pc // seg))
            if target <= 0:
                continue
            last = (live[target - 1] // seg if target <= len(live)
                    else nseg - 1)
            want[(b, int(k))] = list(range(last + 1))
    return want


def _check_replay(S, cnt, pos, rmin, t4n, T, W, C, **small):
    want = [a.numpy() for a in extract_counted_plain(S, cnt, pos, rmin, t4n,
                                                     T, W, C)]
    # the CPU dispatch runs the twin
    via = extract_counted(S, cnt, pos, rmin, t4n, T, W, C)
    for a, w in zip(via, want):
        np.testing.assert_array_equal(
            np.ascontiguousarray(a.numpy()).view(np.uint8),
            np.ascontiguousarray(w).view(np.uint8))
    args = [a.numpy() for a in (S, cnt, pos, rmin, t4n)]
    n_above, work, nwork = _prefix_replay(*args[1:], S.shape[2], C)
    np.testing.assert_array_equal(n_above, want[5])
    seg = (small.get("threads") or KC["THREADS"]) * KC["CELLS"] * (
        small.get("loads") or KC["LOADS"])
    paths = {}
    for inflight in (1, 64):
        got, writes, reads, paths[inflight] = _replay(
            *args, T, W, C, inflight=inflight, **small)
        assert (writes == 1).all(), "a slot unwritten or written twice"
        _assert_bitwise(got, want[:5])
        expected = _expected_reads(*args[:4], C, work, nwork, seg)
        if inflight == 1:  # the early stop, to the segment
            assert reads == expected
        else:  # speculative segments read more, never less
            assert all(set(v) <= set(reads.get(r, ()))
                       for r, v in expected.items())
    assert paths[1]["speculative"] == 0  # one at a time: every peek hits
    return want, paths


@pytest.mark.parametrize("name", list(EXTRACT_CASES))
def test_extract_replay_equals_plain(name):
    S, cnt, pos, rmin, t4n, T, W, C = extract_case(name)
    (k, x, y, sc, valid, n_above), _ = _check_replay(S, cnt, pos, rmin,
                                                     t4n, T, W, C)
    _check_replay(S, cnt, pos, rmin, t4n, T, W, C, **SMALL)
    assert (n_above > 0).all() and valid.any()
    for b, n in enumerate(n_above.tolist()):  # valid exactly below n_above
        assert valid[b, :n].all() and not valid[b, n:].any()
    if name == "overflow":
        assert (n_above > C).all()
    if name in ("past_end", "one_template"):
        assert (n_above < C).all() and (k[~valid] == S.shape[1] - 1).all()
    if name.startswith("quirk"):  # quirk cells are valid at score 0
        assert (valid & (sc == 0)).any()
    if name == "no_positions":
        assert not np.isin(k[valid], np.nonzero(pos.numpy() <= 0)[0]).any()
    if name == "overstated":  # a rank past the row's live cells: cell M-1
        M, off = S.shape[2], T // 2 + (T % 2 - 1)
        assert (valid & (x == ((M - 1) % W) * T + off)
                & (y == ((M - 1) // W) * T + off)).any()


@pytest.mark.parametrize("name", list(STRADDLE_CASES))
def test_extract_replay_equals_plain_across_segment_edges(name):
    """Rows of 2.5 segments (the replay's segment patched to 128 cells):
    the cap cutting a run of live cells two cells past an edge, quirk
    slots dealt over two segments, an overstated count in a row of three
    segments, and slots past n_above in several closed-form groups."""
    seg = 32 * KC["CELLS"]
    S, cnt, pos, rmin, t4n, T, W, C = straddle_case(name, seg)
    (k, x, y, sc, valid, n_above), paths = _check_replay(
        S, cnt, pos, rmin, t4n, T, W, C, **SMALL)
    # in flight, segments read before their predecessors were done and
    # looked back through AGG words
    assert paths[64]["speculative"] and paths[64]["agg_hops"]
    M, off = S.shape[2], T // 2 + (T % 2 - 1)
    j = (y - off) // T * W + (x - off) // T
    if name == "cap_in_edge":  # frame 0's last slot: template 1, past seg
        assert (n_above > C).all() and k[0, -1] == 1 and j[0, -1] >= seg
        assert paths[1]["skipped"]  # a segment past the last taken cell
    if name == "quirk_edge":
        assert (n_above == C).any() and (valid & (k == 2) & (j >= seg + 5)
                                         & (sc == 0)).any()
        assert (valid & (k == 4) & (j == M - 1)).any()
    if name == "past_end_odd":
        assert (~valid).sum() > 2 * 32 and (k[~valid] == 5).all()


def test_extract_replay_across_a_real_segment_edge():
    """The cap inside a run of live cells across the first edge of the
    kernel's own segment size (SEG cells)."""
    S, cnt, pos, rmin, t4n, T, W, C = straddle_case("cap_in_edge",
                                                    SEG_CELLS)
    (k, x, y, _, valid, n_above), _ = _check_replay(S, cnt, pos, rmin, t4n,
                                                    T, W, C)
    off = T // 2 + (T % 2 - 1)
    assert (n_above > C).all() and valid.all() and k[0, -1] == 1
    assert (y[0, -1] - off) // T * W + (x[0, -1] - off) // T >= SEG_CELLS


def test_zero_slots_still_count():
    """C = 0 with B > 0: no slot, n_above from the prefix all the same."""
    S, cnt, pos, rmin, t4n, T, W, _ = extract_case("batch3")
    got = extract_counted(S, cnt, pos, rmin, t4n, T, W, 0)
    assert all(a.shape == (3, 0) for a in got[:5])
    n_above, work, meta, _ = count_prefix(cnt, pos, rmin, t4n, S.shape[2], 0)
    assert torch.equal(got[5], n_above) and (n_above > 0).all()
    assert torch.equal(n_above, _prefix(cnt, pos, rmin, S.shape[2])[1][:, -1])
    assert (meta == 0).all()  # nothing listed
    out, writes, reads, _ = _replay(*(a.numpy() for a in (S, cnt, pos, rmin,
                                                       t4n)), T, W, 0)
    assert writes.size == 0 and not reads


def _prefix_cases():
    cases = [(n, extract_case(n)) for n in EXTRACT_CASES]
    cases += [(n, straddle_case(n, 32 * KC["CELLS"])) for n in STRADDLE_CASES]
    S, cnt, pos, rmin, t4n, T, W, _ = extract_case("batch3")
    return cases + [("batch3 C=0", (S, cnt, pos, rmin, t4n, T, W, 0)),
                    ("batch3 C=1", (S, cnt, pos, rmin, t4n, T, W, 1))]


def test_prefix_plain_equals_the_twins_ownership():
    """count_prefix_plain (the CPU dispatch of count_prefix) against the
    prefix kernel's replay and the twin: n_above is _prefix's last column;
    the listed templates are exactly those the twin's searchsorted gives
    the slots below C, in order, with the twin's excl, incl and counts;
    the ticket and the listed look-back words are 0."""
    for name, (S, cnt, pos, rmin, t4n, T, W, C) in _prefix_cases():
        M = S.shape[2]
        n_above, work, meta, status = count_prefix(cnt, pos, rmin, t4n, M, C)
        bcnt, incl = _prefix(cnt, pos, rmin, M)
        excl = incl - bcnt
        assert torch.equal(n_above, incl[:, -1]), name
        r_above, r_work, r_n = _prefix_replay(
            *(a.numpy() for a in (cnt, pos, rmin, t4n)), M, C)
        np.testing.assert_array_equal(r_above, n_above.numpy())
        np.testing.assert_array_equal(r_n, meta[:, 0].numpy())
        assert (meta[:, 1] == 0).all() and (status == 0).all()
        assert status.shape == (S.shape[0], -(-M // SEG_CELLS), S.shape[1])
        slots = torch.arange(C, dtype=torch.int32).expand(S.shape[0], C)
        owner = torch.searchsorted(incl, slots.contiguous(), right=True) \
            .clamp(max=S.shape[1] - 1)
        for b in range(S.shape[0]):
            n = int(meta[b, 0])
            np.testing.assert_array_equal(r_work[b, :n], work[b, :n].numpy())
            ks = work[b, :n, 0].long()
            assert ks.tolist() == sorted(set(owner[b].tolist())), name
            assert torch.equal(work[b, :n, 1], excl[b, ks])
            assert torch.equal(work[b, :n, 2], incl[b, ks])
            assert torch.equal(work[b, :n, 3], cnt[b, ks])
            assert torch.equal(work[b, :n, 4], pos[ks].clamp(0, M))
            assert torch.equal(work[b, :n, 6], t4n[ks].view(torch.int32))
            assert n <= min(S.shape[1], C)


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
    (_, _, _, _, valid, n_above), _ = _check_replay(S, cnt, pos, rmin, t4n,
                                                    T, W, C)
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
