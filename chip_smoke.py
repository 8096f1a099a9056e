"""Drive the PyTorch port's match path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each reported on its own line:
1. the device: torch's name for it and nvidia-smi's name and power limit;
2. build the CUDA kernels from ``shape_based_matching_tpu_torch/csrc``;
3. each kernel of the flagship path against its plain PyTorch twin on the
   card, bitwise, at the path's shapes (1024x1024 frames, the committed
   1000-template x 63-feature rotation bank, T=(4, 8)), the level maps
   and the map refine step (kernel 9: window origin, window, first max,
   score and threshold in one launch; every output of every candidate,
   a NaN score against a NaN) at the shapes of the frame's overflow
   re-run (cap 1024, map route), where ``refine_from_maps`` must be one
   launch (its counter; torch.profiler's device kernels where it records
   them);
4. the flagship path: ``Detector(device="cuda")`` matches the flagship
   frame (B=1) and a batch of 8 frames; the launch counters of its
   kernels (level maps, map refine, the extraction and its prefix
   included) must rise,
   the B=1 list must equal the committed JAX golden, and each frame of
   the batch must equal its own B=1 match;
5. warm timings from CUDA events: each kernel against its twin (the
   frontend at both levels, B=1 and B=8, held bitwise at B=8 too), the
   window route against the map route at the re-run's cap, and the
   end-to-end ms/frame at B=1 and frames/s at B=8;
6. the dense-bank path: the committed 10,000-template bank on the same
   frame. Its chain plan and the kernel's segments (count, longest
   walk); the chain kernel against its twin (B=1 and B=8) and against
   coarse.cu from scratch, the window at cap 256, the level maps and the
   map refine step against their twins, all bitwise at the path's
   shapes; the B=1 match (chain at the coarse level, overflow re-run at a
   cap of 4096 through the map route) must equal its JAX golden and raise
   the counters of the chain, level-map and map refine kernels; timings
   of each kernel against its twin, the chain against coarse.cu, the
   window route against the map route at caps 1024, 4096 and 16384, and
   end to end at B=1;
7. the input modes: the frontend kernel against its twin, bitwise, at
   1024x1024 (the flagship frame and noise, T=4 and T=8) in six modes --
   color 8-orientation, gray 16, color 16, masked gray 8, masked color
   16, with the quantized plane -- then seven paths, each a
   ``Detector(device="cuda").match``: a masked frame, 16 orientations on
   a gray frame, the wide banks 1000 x 128, 1000 x 256 (dense) and
   8 x 8191 (dense), 16 orientations on the compiled C++ experiment's BGR
   frame, and 8 orientations on a BGR frame. On each path its kernels
   (frontend at both levels, coarse.cu -- the wide route's counterpart at
   1000 x 142 and 8 x 3073 coarse slots --, window refine) are held
   against their twins bitwise; the match list must equal its JAX golden
   (the C++ golden under the contract of tests/test_golden_16ori.py for
   the experiment's frame), the counters of its kernels must rise, and
   the match is timed (mean of 10 warm calls between CUDA events). Where
   the frame overflows the cap of 256, the re-run's level-0 kernels (the
   window at its cap, or the level maps and the map refine step) are held
   against their twins and timed too;
8. training: every committed bench_banks/ snapshot trained on the card
   (the base ``add_template``, then ``add_templates_rotate``, each
   timed) equals its snapshot field for field, and the flagship frame
   matched with the port-trained rot1000x63 bank equals the e2e1000
   golden through the path's kernels;
9. the compiled C++ reference's trainings (case1, case0, jabil) on the
   card equal their goldens;
10. ``add_templates`` on 64 frames, gray under masks and BGR, equals 64
   ``add_template`` calls, theta bits included (frames/s of both);
11. the multi-class match: the registry {bench: rot1000x63, wide:
   rot1000x128, dense: rot10000x63}, trained by phase 8, on the flagship
   frame in one merged step. Its coarse route (the planner's own
   decision on the merged bank), re-run cap and refine routes; its
   kernels against their twins at the merged shapes; its launches; B=1
   equal to the union of the single-class lists, its bench and dense
   parts equal to their goldens, B=8 equal to B=1, ``as_matches=False``
   at B=8 equal to the list path's entries; timings at B=1 (merged and
   class by class) and B=8. The seconds of phases 8-11 are printed;
12. the production path (match, then sim2 ICP pose refinement): the
   committed 1000 x 128 bank on ``synthetic_scene(1024, 1024, ...,
   n_instances=4, seed=7)`` at threshold 85, top 32 candidates, 12
   iterations, radius 8, cap 256. The edge field on the card against its
   CPU twin (edge, has, off bitwise) and the octant of every integer
   gradient against the CPU's; the path's kernels against their twins;
   ``Detector.match_icp`` against ``tests/goldens/
   torch_port_production_icp.json`` (match keys bitwise and in order,
   poses within JAX's host-vs-packed tolerance) with its launches, and
   the same call on the CPU against the golden; the
   sync contract (no synchronizing call at a ``match_icp_async``
   dispatch, each of its stages returning while the card still runs a
   kernel queued before it, the card's launch queue depth, one download
   per ``result()`` and per ``match_icp``); ``csrc/icp.cu`` against its
   plain twin on the production call's candidates (poses, inliers and
   valid bit for bit, one launch and no other kernel, the device and
   queued ms of both);
   ``match_refine_batch`` against ``refine_matches_icp``; ms/frame of
   the edge field, the ICP at 64 candidates, match + refine, match_icp,
   a 3-frame match_icp_async loop and match_refine_batch at B=1 and B=8;
   device kernels, device time and idle share of a call;
13. patch_2843: the frontend's opencv_contrib #2843 mode against its
   twin in eight modes (gray / BGR, 8 / 16 orientations, with and without
   a mask), ``Detector(patch_2843=True)`` on the flagship frame against
   its JAX golden through the kernels, and the frontend's default and
   patch modes timed side by side. The seconds of phases 12-13 are
   printed;
14. the CLI and the model directory, in a temporary directory: phase 8's
   rot1000x63, rot1000x128 and rot10000x63 written as a model directory
   and loaded by ``get_instance`` (seconds to write and read each class;
   equal field for field; the flagship and dense goldens from disk),
   ``cli match`` on the flagship frame and the production stream as PNGs
   (rot1000x63, and rot1000x128 with --icp: lines equal to the in-memory
   path's, poses within the production tolerance, the CSV's stage ms
   beside the in-memory match), ``cli train`` of a 12-render sweep equal
   to ``add_templates``, ``train-db`` and ``match-db`` on a synthetic tag
   database, ``--trace DIR info`` (a small configuration) and ``info
   --dispatch``; each path
   launches every kernel it needs. The phase's seconds are printed;
15. the sharded paths (``parallel/``, ``match --spatial-shards``, the
   examples) on the card, every shard round-robin on it: a 4096^2 frame
   on 4 row tiles (rot1000x63 and rot10000x63) equal to the whole frame's
   match, with the tile's kernels against their twins; 8 flagship frames
   over meshes (1, 4), (2, 2), (4, 1) and the dense bank over (1, 4),
   each frame equal to its own match; the 64-frame training sweep on 4
   shards equal to ``add_templates``; the production tier on 4 shards
   equal to per-frame ``match_refine_batch`` bit for bit; ``cli match
   --spatial-shards 4`` equal to ``cli match``; the four examples. Each
   path's launches; one-card timings and peak memory (``sharded_phase``);
16. the oracle: the port on the card against its copy of the scalar NumPy
   oracle (``shape_based_matching_tpu_torch/oracle/reference.py``), apart
   from the JAX goldens: ``Detector.match`` against ``match_class`` on
   the flagship, wide1000x128, masked360, e2e360_16ori and color1000
   (distinct (template, x, y, float32 bits)), each path's linear
   memories and every template's coarse scores and live counts against
   the oracle's (chain.cu on the dense bank, coarse.cu's wide route on
   1000 x 142 and 8 x 3073 slots), the flagship's spread planes, and
   ``tests/test_fuzz_parity.py``'s randomized scenes (``oracle_phase``);
17. the overflow re-run's memory: ``csrc/extract.cu`` (its prefix kernel
   and its extraction, one launch each a call) against its twin on every
   output and slot (the flagship's step and re-run, the quirk cells, B=8
   overflowing frames, the dense bank's chain rows, the wide1000x256
   bank's row-5 rows), timed at the flagship's step (B=1 and B=8) and
   re-run, the chain rows and the 4096^2 re-runs' caps (the whole call,
   each kernel's device time and the device kernels a call from
   torch.profiler, the twins, bounds and shares), the device kernels of
   one ``coarse_extract`` call, and ``torch.nonzero`` on the 4096^2
   frame's live mask as a yardstick; then ``Detector.match`` with
   rot10000x63 at the default cap on phase 15's 4096^2 frame at
   thresholds 85 and 60 and on the flagship frame at 60 (the last two
   with more distinct candidate templates than one slab; the 4096^2
   frame at 60 past the 65,536 bucket), each re-run through the map
   route's slabs: extract.cu against its twin on the run's S at every
   cap it uses, its kernels' launches, its list equal to the one at a
   cap that holds every candidate, its peak device memory at most 8 GB,
   and ms and peak GB of both runs (``overflow_phase``);
18. the entry points (``entry_phase``): ``entry.entry(n)``'s
   flagship match step at 360, 1000 and 10,000 templates on the card,
   each one's kernels launched and its match sets equal to the same step
   on CPU tensors bit for bit, with its warm ms; ``entry.dryrun_multichip
   (4)`` over the visible card(s); ``python -m
   shape_based_matching_tpu_torch.bench --metric NAME`` for e2e1000,
   fps_b8, e2e10000 and production_device, each its own process, exit 0
   and a finite positive value.

Every kernel record carries its bound: the larger of the bytes it must
move over 3.35 TB/s and the operations it does over 67e12 per second
(the H100's float32 rate outside the tensor cores, used for every scalar
integer and float operation, so the bound is a floor), computed from this
run's inputs.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero without that line; so does a machine without CUDA. The
full report goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
GOLDEN = os.path.join(GOLDENS, "torch_port_e2e1000_matches.json")
DENSE_GOLDEN = os.path.join(GOLDENS, "torch_port_e2e10000_matches.json")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
THRESHOLD = 85.0
T_LEVELS = (4, 8)
BATCH = 8
DEVICE = "cuda"


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    """Warm mean ms per call: `iters` calls queued between two CUDA
    events, one synchronize."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _counted(kernels, fn):
    """fn()'s result and the launches it made: every kernel's launch count
    set to 0 just before it, and read just after."""
    for kern in kernels:
        kern.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {kern.__name__: kern.launches for kern in kernels}


def _routes(det) -> dict:
    """The refine levels a detector ran per route since its counters were
    last cleared."""
    return {r: det.counters[f"refine.{r}"] for r in ("window", "maps")}


def _i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint16:  # few operators take uint16 on the card
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    return t.to(torch.int64)


def _max_abs_err(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        err = max(err, int((_i64(a) - _i64(b)).abs().max().item())
                  if a.numel() else 0)
    return err


PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_S = 67e12      # H100 SXM float32 outside the tensor cores


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time for `nbytes` of traffic and
    `ops` scalar operations on the card."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _frontend_work(B, H, W, channels, n_ori, T, masked, with_quant):
    """Bytes and operations of the fused frontend: each input pixel read
    once (channels, mask), each output written once (1 or 2 bytes, twice
    with the quantized plane). Per pixel and channel: the separable 7-tap
    blur (26), Sobel (16), |grad|^2 (3), the channel pick (2 per extra
    channel); then fastAtan2 (20), bucket (2), vote (9 adds and n_ori
    compares), threshold and mask (2), separable T x T OR (2(T-1))."""
    px = B * H * W
    out_b = 1 if n_ori == 8 else 2
    nbytes = px * (channels + int(masked) + out_b * (1 + int(with_quant)))
    ops = px * (channels * 45 + 2 * (channels - 1) + 33 + n_ori
                + 2 * (T - 1))
    return nbytes, ops


def _coarse_work(lmflat, off, M, counted):
    """coarse.cu: lmflat read once, offsets, S (and pos, rmin, cnt)
    written once; one add per in-image feature slot and cell (slots that
    address the zero tail add nothing), two compares per cell counted."""
    B, Lf = lmflat.shape
    K = off.shape[0]
    live = int((off < Lf - M).sum())
    nbytes = B * Lf + off.numel() * 4 + B * K * M * 4
    ops = B * live * M
    if counted:
        nbytes += K * 8 + B * K * 4
        ops += 2 * B * K * M
    return nbytes, ops


def _refine_work(lmflat, bank, k, live):
    """Window refine: the 256 window bytes of each live feature of each
    live candidate (at most the whole lmflat), its slot (13 bytes) and the
    candidate's arguments and results (21 bytes); 256 adds per live
    feature and 256 compares per live candidate."""
    B, Lf = lmflat.shape
    feats = int(bank.valid[k][live].sum())
    n = int(live.sum())
    nbytes = min(B * Lf, feats * 256) + feats * 13 + k.numel() * 21
    return nbytes, feats * 256 + n * 256


def _map_refine_work(mr_args: tuple):
    """The map route's refine step: per candidate its k, x, y, valid, its
    template's slot and three bank words (29 bytes) and five results (17
    bytes), and the threshold; the map cells that the live windows cover,
    each once (neighbouring windows share cells). 256 compares per live
    candidate, about 20 operations of origin and score epilogue per
    candidate."""
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        window_cells)

    Sfull, slot_of_k, width, height, _, T, size_wh, k, x, y, valid, _ = \
        mr_args
    _, _, live, idx = window_cells(Sfull, slot_of_k, width, height, T,
                                   size_wh, k, x, y, valid)
    B, D, M = Sfull.shape
    frame = torch.arange(B, device=idx.device)[:, None, None] * (D * M)
    cells = torch.unique((idx + frame)[live]).numel()
    return (cells * 4 + k.numel() * 46 + 4,
            int(live.sum()) * 256 + k.numel() * 20)


def _refine_err(got, want) -> float:
    """max_abs_err of a refine step's (k, x, y, score, valid) against its
    twin's: the integers exactly; the score bit for bit where neither is
    NaN, NaN where the other is (inf where that fails)."""
    err = _max_abs_err([(g, w) for i, (g, w) in enumerate(zip(got, want))
                        if i != 3])
    gs, ws = got[3], want[3]
    nan = torch.isnan(gs)
    if not torch.equal(nan, torch.isnan(ws)) or not torch.equal(
            gs[~nan].view(torch.int32), ws[~nan].view(torch.int32)):
        return float("inf")
    return float(err)


def _chain_work(lmflat, plan, K, M):
    """Chain: lmflat and the plan read once, S and cnt written once; one
    add per slot visit and cell, two compares per cell counted."""
    B, Lf = lmflat.shape
    n_slots = plan.slots.numel()
    nbytes = (B * Lf + (n_slots + plan.slot_start.numel()
                        + plan.prog_start.numel()) * 4 + K * 8
              + B * K * M * 4 + B * K * 4)
    return nbytes, B * n_slots * M + 2 * B * K * M


def _keys(matches):
    return [[m.template_id, m.x, m.y,
             int(np.float32(m.similarity).view(np.uint32))]
            for m in matches]


def _class_keys(matches):
    return [[m.class_id] + k for m, k in zip(matches, _keys(matches))]


def _scene(cfg):
    from shape_based_matching_tpu_torch.utils.synthetic import (
        synthetic_scene, synthetic_shape_image)

    return synthetic_scene(cfg["height"], cfg["width"],
                           synthetic_shape_image(256, 0),
                           n_instances=cfg["n_instances"],
                           seed=cfg["scene_seed"])


def _map_route_check(lms: tuple, banks: list, sizes: list, thr, cap: int,
                     plan=None, n_ori: int = 8) -> dict:
    """The map route of an overflow re-run at candidate cap `cap`, step by
    step as ``refine_by_maps`` takes it on frame 0 of `lms`: the coarse
    candidates (through the chain `plan` when given), their distinct
    templates and D bucket, the level-0 maps (kernel 4) and the map
    window (kernel 9), each kernel held against its twin. Returns the
    errors, the shapes and each kernel's arguments."""
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_maps_plain)
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine, map_refine_plain)
    from shape_based_matching_tpu_torch.ops.similarity import (
        _D_BUCKETS, _flat_offsets, coarse_extract, distinct_templates,
        gather_bank)

    k, x, y, _, valid, n_above = coarse_extract(
        lms[1], banks[1], T_LEVELS[1], sizes[1], thr, cap, plan, n_ori)
    T0, (w0, h0) = T_LEVELS[0], sizes[0]
    W0, M0 = w0 // T0, (w0 // T0) * (h0 // T0)
    K = banks[0].fx.shape[0]
    slots, slot_of_k, n_distinct = distinct_templates(k, valid, K, K)
    n = int(n_distinct)
    D = next((d for d in _D_BUCKETS if n <= d < K), K)
    off0 = _flat_offsets(gather_bank(banks[0], slots[:D]), T0, W0, M0,
                         sizes[0], n_ori)
    maps_args = (lms[0], off0, M0)
    maps = coarse_maps(*maps_args)
    maps_err = _max_abs_err([(maps, coarse_maps_plain(*maps_args))])
    b0 = banks[0]
    mr_args = (maps, slot_of_k, b0.width, b0.height, b0.nfeat, T0, sizes[0],
               k, x, y, valid, thr)
    mr_err = _refine_err(map_refine(*mr_args), map_refine_plain(*mr_args))
    live = valid & (slot_of_k[k] >= 0)
    shape = (f"D={D} ({n} distinct of {min(int(n_above[0]), cap)} "
             f"candidates) N={off0.shape[1]} M={M0}")
    print(f"K4 level maps vs plain at cap {cap}: max_abs_err {maps_err}, "
          f"{shape}")
    print(f"K9 map refine vs plain at cap {cap}: max_abs_err {mr_err} "
          f"(k, x, y, score bits, valid of every candidate), C={cap}, "
          f"{int(live.sum())} live")
    device_ms = _one_launch(mr_args, b0)
    return {"maps_err": maps_err, "mr_err": mr_err, "D": D,
            "mr_device_ms": device_ms,
            "n_distinct": n, "n_above": int(n_above[0]),
            "maps_args": maps_args, "mr_args": mr_args,
            "mr_work": _map_refine_work(mr_args),
            "maps_shape": shape, "mr_shape": f"C={cap}, D={D}"}


def _one_launch(mr_args: tuple, bank) -> float | None:
    """refine_from_maps on the map route's arguments is one launch of
    kernel 9 a call: its counter rises by one a call, and torch.profiler
    sees no device kernel but kernel 9, at most one a call. Returns the
    kernel's mean device time in ms from the profiler (None where it
    records no device work: not measured). Raises otherwise."""
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine)
    from shape_based_matching_tpu_torch.ops.similarity import (
        refine_from_maps)
    from shape_based_matching_tpu_torch.utils.profiling import (
        CALLS, device_kernels)

    Sfull, slot_of_k, _, _, _, *rest = mr_args
    before = map_refine.launches
    kern = device_kernels(
        lambda: refine_from_maps(Sfull, slot_of_k, bank, *rest))
    if map_refine.launches != before + 1 + CALLS:
        raise AssertionError("refine_from_maps did not launch kernel 9 once "
                             "a call")
    names = sorted({name for name, _ in kern})
    # the profiler may miss a kernel at the edge of its window (seen: 19 of
    # 20), never invent one: at most one a call, all of them kernel 9
    if len(kern) > CALLS or len(names) > 1 or (
            names and "map_refine_kernel" not in names[0]):
        raise AssertionError(f"refine_from_maps ran {len(kern)} device "
                             f"kernels in {CALLS} calls: {names}")
    device_ms = sum(ms for _, ms in kern) / len(kern) if kern else None
    print(f"refine_from_maps: one launch of kernel 9 a call (counter); "
          f"device kernels a call (torch.profiler): "
          f"{names if kern else 'not measured'}, device time "
          f"{'not measured' if device_ms is None else f'{device_ms:.4f} ms'}")
    return device_ms


def _route_ms(lms: tuple, banks: list, sizes: list, thr, cap: int, plan,
              iters: int) -> dict:
    """Warm ms of the two refine routes of level 0 on the same candidates
    (frame 0 of `lms`, cap `cap`): the window (kernel 8) and the map route
    (distinct templates with their host read, gather, kernel 4, kernel
    9)."""
    from shape_based_matching_tpu_torch.ops.similarity import (
        coarse_extract, refine_by_maps, refine_candidates)

    k, x, y, _, valid, _ = coarse_extract(
        lms[1], banks[1], T_LEVELS[1], sizes[1], thr, cap, plan)
    args = (lms[0], banks[0], T_LEVELS[0], sizes[0], k, x, y, valid, thr)
    return {"cap": cap, "live": int(valid.sum()),
            "window_ms": _time_ms(lambda: refine_candidates(*args), iters),
            "map_ms": _time_ms(lambda: refine_by_maps(*args), iters)}


def _print_routes(name: str, routes: list, card: str) -> None:
    for r in routes:
        print(f"time {name} refine at cap {r['cap']} ({r['live']} live): "
              f"window route {r['window_ms']:.4f} ms, map route "
              f"{r['map_ms']:.4f} ms on {card}")


def _record(fn, src: str, replaces: str, err: int, launches: dict,
            path: str, ms: float, plain_ms: float, work: tuple,
            shape: str) -> dict:
    """One kernel's JSON record. No single PyTorch call computes any of
    the port's kernels' functions, so library_ms is null."""
    bound_ms, bound_by = _bound(*work)
    return {"name": fn.__name__, "route": "cuda",
            "source": "shape_based_matching_tpu_torch/csrc/" + src,
            "replaces": "shape_based_matching_tpu/ops/pallas/" + replaces,
            "path": path, "shape": shape, "launches": launches[fn.__name__],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _add_device_ms(records: list, mr: dict) -> None:
    """Kernel 9's records also carry its device time from the profiler
    (``_one_launch``; the queued call time ``ms`` includes the host's)."""
    for r in records:
        if r["name"] == "map_refine":
            r["device_ms"] = mr["mr_device_ms"]


def dense_phase(card: str) -> tuple[list, dict]:
    """Phase 6: the dense 10,000-template bank. Returns the kernels'
    records and the phase's report."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.cuda.chain import (
        chain_scores, chain_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_maps_plain, coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.extract import (
        count_prefix, extract_counted)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread)
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine, map_refine_plain)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows, refine_windows_plain)
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold, coarse_extract)
    from shape_based_matching_tpu_torch.ops.window import window_origin
    from shape_based_matching_tpu_torch.utils.synthetic import (
        load_bank_cache)

    golden = json.load(open(DENSE_GOLDEN))
    cfg = golden["config"]
    pyramids = load_bank_cache(os.path.join(ROOT, cfg["bank"]))
    if pyramids is None or len(pyramids) != cfg["num_templates"]:
        raise AssertionError(f"bank {cfg['bank']} missing or stale")
    scene = _scene(cfg)
    dev = torch.device(DEVICE)
    det = Detector(num_features=cfg["num_features"], T=tuple(cfg["T"]),
                   device=DEVICE)
    cid = golden["class_id"]
    det.class_templates[cid] = pyramids
    banks = det._get_banks(cid)
    sizes = det._level_sizes(scene.shape)
    thr = torch.tensor(THRESHOLD, dtype=torch.float32, device=dev)

    # 1. the chain plan
    t0 = time.perf_counter()
    plan = det._get_chain(cid, sizes[1])
    plan_s = time.perf_counter() - t0
    if plan is None:
        raise AssertionError("the planner declined the 10,000-template bank")
    P = plan.prog_start.numel() - 1
    visits, plain_visits = plan.slots.numel(), int(banks[1].nfeat.sum())
    segs = plan.segs.cpu().numpy()
    ss = plan.slot_start.cpu().numpy()
    walks = segs[:, 3] - segs[:, 2] + ss[segs[:, 1]] - ss[segs[:, 0]]
    n_seg, longest = len(segs), int(walks.max())
    longest_t = int((segs[:, 1] - segs[:, 0]).max())
    print(f"dense: chain plan {P} programs, {visits} slot visits against "
          f"{plain_visits} plain ({visits / plain_visits:.4f}), planned "
          f"and uploaded in {plan_s:.3f} s; {n_seg} segments, longest walk "
          f"{longest} slot visits ({int(segs[0, 3] - segs[0, 2])} start "
          f"codes) and at most {longest_t} templates, "
          f"{int(walks.sum())} slot visits in all")

    # 2. kernels against their twins, bitwise, at the path's shapes
    lms = _batch_pyramid(torch.from_numpy(scene[None]).to(dev),
                         det.T_at_level, det.pyramid_levels,
                         det.weak_threshold)
    T1, (w1, h1) = T_LEVELS[1], sizes[1]
    W1, H1 = w1 // T1, h1 // T1
    M1 = W1 * H1
    pos = _positions(banks[1], T1, W1, H1)
    rmin, _ = _rmin_for_threshold(banks[1].nfeat, thr)
    off1 = _flat_offsets(banks[1], T1, W1, M1, sizes[1])
    chain_args = (lms[1], plan, pos, rmin)
    S, cnt = chain_scores(*chain_args)
    chain_err = _max_abs_err(zip((S, cnt), chain_scores_plain(*chain_args)))
    scratch_err = _max_abs_err(zip((S, cnt), coarse_scores(
        lms[1], off1, pos, rmin, M1)))
    print(f"K7 chain vs plain: max_abs_err {chain_err}; vs coarse.cu from "
          f"scratch: max_abs_err {scratch_err}; K={off1.shape[0]} "
          f"N={off1.shape[1]} M={M1}, candidates above threshold "
          f"{int(cnt.sum())}")
    k, x, y, _, valid, _ = coarse_extract(lms[1], banks[1], T1, sizes[1],
                                          thr, 256, plan)
    wx, wy = window_origin(banks[0].width, banks[0].height,
                           T_LEVELS[0], sizes[0], k, x, y)
    k3_args = (lms[0], banks[0], T_LEVELS[0], sizes[0], k, wx, wy, valid)
    k3_err = _max_abs_err(zip(refine_windows(*k3_args),
                              refine_windows_plain(*k3_args)))
    N0 = banks[0].fx.shape[1]
    print(f"K8 refine vs plain at cap 256: max_abs_err {k3_err}, "
          f"{int(valid.sum())} live, N={N0}")
    cap = 4096
    mr = _map_route_check(lms, banks, sizes, thr, cap, plan)
    # the chain at B=8, as match_batch gives it eight frames
    batch = np.stack([_scene({**cfg, "scene_seed": cfg["scene_seed"] + i})
                      for i in range(BATCH)])
    lms8 = _batch_pyramid(torch.from_numpy(batch).to(dev), det.T_at_level,
                          det.pyramid_levels, det.weak_threshold)
    chain8_args = (lms8[1], plan, pos, rmin)
    chain8_err = _max_abs_err(zip(chain_scores(*chain8_args),
                                  chain_scores_plain(*chain8_args)))
    print(f"K7 chain vs plain at B={BATCH}: max_abs_err {chain8_err}")
    if (chain_err or scratch_err or k3_err or mr["maps_err"]
            or mr["mr_err"] or chain8_err):
        raise AssertionError("a dense-path kernel disagrees")

    # 3. the dense path through the kernels
    kernels = (quant_spread, chain_scores, refine_windows, coarse_maps,
               map_refine, extract_counted, count_prefix, coarse_scores)
    det.counters.clear()
    got, launches = _counted(kernels, lambda: det.match(scene, THRESHOLD))
    print(f"dense path: launches {launches}; refine routes "
          f"{_routes(det)}; {len(got)} matches")
    if not all(launches[fn.__name__] for fn in kernels[:-1]) \
            or launches["coarse_scores"]:
        raise AssertionError(f"the dense path missed a kernel or scored "
                             f"from scratch: {launches}")
    if _keys(got) != golden["matches"]:
        raise AssertionError(f"dense B=1 differs from the JAX golden: "
                             f"{len(got)} vs {len(golden['matches'])}")
    print(f"dense path: B=1 equals the JAX golden ({len(got)} matches, "
          f"(tid, x, y, f32 bits))")

    # 4. timings
    iters = 20
    table = (
        (chain_scores, "chain.cu", "similarity_pallas.py:572", chain_err,
         lambda: chain_scores(*chain_args),
         lambda: chain_scores_plain(*chain_args),
         f"K={off1.shape[0]} M={M1}, {visits} slots",
         _chain_work(lms[1], plan, off1.shape[0], M1)),
        (refine_windows, "refine.cu", "refine_pallas.py:67", k3_err,
         lambda: refine_windows(*k3_args),
         lambda: refine_windows_plain(*k3_args),
         f"C=256 N={N0} ({int(valid.sum())} live)",
         _refine_work(lms[0], banks[0], k, valid)),
        (coarse_maps, "coarse.cu", "similarity_pallas.py:431",
         mr["maps_err"], lambda: coarse_maps(*mr["maps_args"]),
         lambda: coarse_maps_plain(*mr["maps_args"]), mr["maps_shape"],
         _coarse_work(*mr["maps_args"], counted=False)),
        (map_refine, "map_refine.cu", "refine_pallas.py:154", mr["mr_err"],
         lambda: map_refine(*mr["mr_args"]),
         lambda: map_refine_plain(*mr["mr_args"]), mr["mr_shape"],
         mr["mr_work"]),
    )
    records = []
    for fn, src, replaces, err, kern, plain, shape, work in table:
        ms = _time_ms(kern, iters)
        plain_ms = _time_ms(plain, max(iters // 5, 2))
        records.append(_record(fn, src, replaces, err, launches, "dense",
                               ms, plain_ms, work, shape))
        print(f"time dense {fn.__name__} [{shape}]: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {records[-1]['bound_ms']:.4f}"
              f" ms ({records[-1]['bound_by']}) on {card}")
    _add_device_ms(records, mr)
    chain8_ms = _time_ms(lambda: chain_scores(*chain8_args), iters)
    chain8_plain_ms = _time_ms(lambda: chain_scores_plain(*chain8_args), 2)
    records.append(_record(
        chain_scores, "chain.cu", "similarity_pallas.py:572", chain8_err,
        launches, f"dense B={BATCH}", chain8_ms, chain8_plain_ms,
        _chain_work(lms8[1], plan, off1.shape[0], M1),
        f"B={BATCH} K={off1.shape[0]} M={M1}, {visits} slots"))
    print(f"time dense chain_scores [B={BATCH}]: kernel {chain8_ms:.4f} ms, "
          f"plain {chain8_plain_ms:.4f} ms, bound "
          f"{records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']}) "
          f"on {card}")
    scratch_ms = _time_ms(lambda: coarse_scores(lms[1], off1, pos, rmin, M1),
                          iters)
    routes = [_route_ms(lms, banks, sizes, thr, c, plan, iters)
              for c in (1024, 4096, 16384)]
    e2e_ms = _time_ms(lambda: det.match(scene, THRESHOLD), iters)
    print(f"time dense coarse: chain {records[0]['ms']:.4f} ms, coarse.cu "
          f"from scratch {scratch_ms:.4f} ms on {card}")
    _print_routes("dense", routes, card)
    print(f"time e2e B=1 1024^2 x 10000 templates: {e2e_ms:.4f} ms/frame "
          f"on {card}")
    report = {"chain_programs": P, "chain_slot_visits": visits,
              "chain_segments": n_seg, "chain_longest_walk": longest,
              "chain_longest_templates": longest_t,
              "chain_segment_visits": int(walks.sum()),
              "plain_slot_visits": plain_visits, "plan_seconds": plan_s,
              "launches": launches, "n_matches_b1": len(got),
              "coarse_from_scratch_ms": scratch_ms, "routes": routes,
              "e2e_b1_ms": e2e_ms, "n_above": mr["n_above"],
              "n_distinct": mr["n_distinct"], "D": mr["D"]}
    return records, report


# frontend modes held against the twin: (color, n_ori, masked, with_quant)
K1_MODES = {
    "color8": (True, 8, False, False),
    "gray16": (False, 16, False, False),
    "color16": (True, 16, False, False),
    "masked_gray8": (False, 8, True, False),
    "masked_color16": (True, 16, True, False),
    "with_quant": (False, 8, False, True),
}
# the paths of phase 7, in order: golden name (tests/goldens/
# torch_port_<name>_matches.json), or "case16" for the compiled C++
# experiment's frame and match list
MODE_PATHS = ("masked360", "e2e360_16ori", "wide1000x128", "wide1000x256",
              "wide8191", "case16", "color1000")


def _bgr(f: np.ndarray) -> np.ndarray:
    return np.stack([f, np.roll(f, 1, axis=-1), 255 - f], axis=-1)


def _upload(frame: np.ndarray, mask, dev):
    """One [H, W] or BGR [H, W, 3] frame (and [H, W] mask) as the
    detector holds it: [1, H, W] or planar [1, 3, H, W] uint8 on `dev`."""
    t = torch.from_numpy(np.ascontiguousarray(frame[None])).to(dev)
    if t.dim() == 4:
        t = t.permute(0, 3, 1, 2).contiguous()
    return t, (None if mask is None
               else torch.from_numpy(np.ascontiguousarray(mask[None]))
               .to(dev))


def k1_modes(scene: np.ndarray, weak: float, card: str) -> dict:
    """Phase 7a: the frontend kernel against its twin in every mode, on the
    flagship frame and noise at 1024^2, T=4 and T=8; each mode timed at
    B=1, T=4."""
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)

    dev = torch.device(DEVICE)
    noise = np.random.RandomState(7).randint(0, 256, scene.shape,
                                             dtype=np.uint8)
    gray = np.stack([scene, noise])
    masks = torch.from_numpy(np.stack([
        (np.random.RandomState(s).rand(*scene.shape) > 0.25).astype(
            np.uint8) * 255 for s in (4, 5)])).to(dev)
    out = {}
    for mode, (color, n_ori, masked, wq) in K1_MODES.items():
        frames = torch.from_numpy(_bgr(gray) if color else gray).to(dev)
        if color:
            frames = frames.permute(0, 3, 1, 2).contiguous()
        m = masks if masked else None
        err = 0
        for T in (4, 8):
            got = quant_spread(frames, weak, T, n_ori, m, wq)
            want = quant_spread_plain(frames, weak, T, n_ori, m, wq)
            err = max(err, _max_abs_err(zip(got if wq else (got,),
                                            want if wq else (want,))))
        one, m1 = frames[:1], (None if m is None else m[:1])
        ms = _time_ms(lambda: quant_spread(one, weak, 4, n_ori, m1, wq), 30)
        plain_ms = _time_ms(
            lambda: quant_spread_plain(one, weak, 4, n_ori, m1, wq), 5)
        bound_ms, bound_by = _bound(*_frontend_work(
            1, *scene.shape, 3 if color else 1, n_ori, 4, masked, wq))
        out[mode] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 frontend {mode} vs plain: max_abs_err {err} (1024^2, "
              f"scene + noise, T=4 and T=8); time at B=1 T=4: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}) on {card}")
    if any(r["max_abs_err"] for r in out.values()):
        raise AssertionError("a frontend mode disagrees with its twin")
    return out


def _case16_parity(ours, golden) -> None:
    """tests/test_golden_16ori.py's contract: every C++ match is ours, and
    every extra of ours shares a golden (x, y, similarity) -- the C++
    dedup drops same-position matches of other templates at random."""
    ours_set = {(m.x, m.y, m.template_id, round(m.similarity, 3))
                for m in ours}
    golden_set = {(m["x"], m["y"], m["template_id"],
                   round(m["similarity"], 3)) for m in golden}
    missing = golden_set - ours_set
    golden_pos = {(g[0], g[1], g[3]) for g in golden_set}
    bad = [e for e in ours_set - golden_set
           if (e[0], e[1], e[3]) not in golden_pos]
    if missing or bad:
        raise AssertionError(f"case16 differs from the C++ golden: missing "
                             f"{sorted(missing)[:5]}, unexplained extras "
                             f"{bad[:5]}")


def _mode_path(name: str):
    """(Detector kwargs, class id, pyramids, frame, mask, threshold, check)
    of a phase-7 path; check(matches) raises unless the list is right."""
    from shape_based_matching_tpu_torch.models.template import (
        Feature, Template)
    from shape_based_matching_tpu_torch.utils.synthetic import (
        config_frame, load_bank_cache)
    from tests.golden_utils import load_json, load_mat

    if name == "case16":
        pyramids = [[Template(
            width=t["width"], height=t["height"], tl_x=t["tl_x"],
            tl_y=t["tl_y"], pyramid_level=t["pyramid_level"],
            features=[Feature(x, y, lb) for x, y, lb in t["features"]])
            for t in tp]
            for tp in load_json("case16_train_templates.json")["templates"]]
        want = load_json("case16_matches.json")["matches"]
        kwargs = {"num_features": 63, "T": (4, 8), "weak_threshold": 10.0,
                  "strong_threshold": 55.0, "num_orientations": 16}
        return (kwargs, "test", pyramids, load_mat("case16_img.bin"), None,
                30.0, lambda got: _case16_parity(got, want))
    golden = json.load(open(os.path.join(
        GOLDENS, f"torch_port_{name}_matches.json")))
    cfg = golden["config"]
    pyramids = load_bank_cache(os.path.join(ROOT, cfg["bank"]))
    if pyramids is None or len(pyramids) != cfg["num_templates"]:
        raise AssertionError(f"bank {cfg['bank']} missing or stale")
    frame, mask = config_frame(cfg)
    kwargs = {"num_features": cfg["num_features"], "T": tuple(cfg["T"]),
              "num_orientations": cfg["num_orientations"]}

    def check(got):
        if _keys(got) != golden["matches"]:
            raise AssertionError(f"{name}: B=1 differs from the JAX golden: "
                                 f"{len(got)} vs {len(golden['matches'])} "
                                 f"matches")

    return (kwargs, golden["class_id"], pyramids, frame, mask,
            cfg["threshold"], check)


def mode_path_phase(name: str, card: str) -> tuple[list, dict]:
    """Phase 7b, one path: its kernels against their twins at the path's
    shapes, the match through the kernels (counters, golden), timings.
    Returns the path's kernel records and its report."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import (
        _CAND_BUCKETS, _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_maps_plain, coarse_scores, coarse_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.extract import (
        count_prefix, extract_counted)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine, map_refine_plain)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows, refine_windows_plain)
    from shape_based_matching_tpu_torch.ops.cuda.pyramid import (
        linear_memories, pyr_down)
    from shape_based_matching_tpu_torch.ops.filters import resize_nearest
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold, coarse_extract)
    from shape_based_matching_tpu_torch.ops.window import window_origin

    kwargs, cid, pyramids, frame, mask, threshold, check = _mode_path(name)
    dev = torch.device(DEVICE)
    det = Detector(**kwargs, device=DEVICE)
    det.class_templates[cid] = pyramids
    banks = det._get_banks(cid)
    n_ori, weak, T = det.num_orientations, det.weak_threshold, det.T_at_level
    color, masked = frame.ndim == 3, mask is not None
    mode = (f"{'masked ' if masked else ''}{'color' if color else 'gray'} "
            f"{n_ori}-ori")
    sizes = det._level_sizes(frame.shape[:2])
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    frames, masks = _upload(frame, mask, dev)
    if det._get_chain(cid, sizes[-1]) is not None:
        raise AssertionError(f"{name}: the planner took the chain, JAX "
                             f"declines this bank")

    # kernels against their twins at the path's shapes
    half = pyr_down(frames)
    half_m = None if masks is None else resize_nearest(masks,
                                                       half.shape[-2:])
    k1_err = max(_max_abs_err([(quant_spread(f, weak, t, n_ori, m),
                                quant_spread_plain(f, weak, t, n_ori, m))])
                 for f, m, t in ((frames, masks, T[0]),
                                 (half, half_m, T[1])))
    lms = _batch_pyramid(frames, T, det.pyramid_levels, weak, n_ori, masks)
    T1, (w1, h1) = T[1], sizes[1]
    W1, H1 = w1 // T1, h1 // T1
    M1 = W1 * H1
    off = _flat_offsets(banks[1], T1, W1, M1, sizes[1], n_ori)
    pos = _positions(banks[1], T1, W1, H1)
    rmin, _ = _rmin_for_threshold(banks[1].nfeat, thr)
    k2_args = (lms[1], off, pos, rmin, M1)
    S, cnt = coarse_scores(*k2_args)
    k2_err = _max_abs_err(zip((S, cnt), coarse_scores_plain(*k2_args)))
    k, x, y, _, valid, n_above = coarse_extract(
        lms[1], banks[1], T1, sizes[1], thr, 256, None, n_ori)
    wx, wy = window_origin(banks[0].width, banks[0].height,
                           T[0], sizes[0], k, x, y)
    k3_args = (lms[0], banks[0], T[0], sizes[0], k, wx, wy, valid, n_ori)
    k3_err = _max_abs_err(zip(refine_windows(*k3_args),
                              refine_windows_plain(*k3_args[:-1])))
    K, N = off.shape
    N0 = banks[0].fx.shape[1]
    print(f"{name}: K1 frontend ({mode}) vs plain max_abs_err {k1_err} at "
          f"{frame.shape[1]}x{frame.shape[0]} and its half, T={T}; coarse "
          f"K={K} N={N} M={M1} vs plain max_abs_err {k2_err} "
          f"({int(cnt.sum())} above threshold); window refine N={N0} "
          f"vs plain max_abs_err {k3_err} ({int(valid.sum())} live)")
    if k1_err or k2_err or k3_err:
        raise AssertionError(f"{name}: a kernel disagrees with its twin")

    # the path through the kernels
    kernels = (quant_spread, coarse_scores, refine_windows, coarse_maps,
               map_refine, extract_counted, count_prefix, pyr_down,
               linear_memories, chain_scores)
    det.counters.clear()
    got, launches = _counted(kernels, lambda: det.match(frame, threshold,
                                                        mask=mask))
    routes = _routes(det)
    print(f"{name}: launches {launches}; refine routes {routes}; "
          f"{len(got)} matches")
    need = ["quant_spread", "coarse_scores", "refine_windows",
            "extract_counted", "count_prefix", "pyr_down", "linear_memories"]
    if routes.get("maps"):
        need += ["coarse_maps", "map_refine"]
    if not all(launches[n] for n in need) or launches["chain_scores"]:
        raise AssertionError(f"{name}: a kernel of the path was not "
                             f"launched, or the chain was: {launches}")
    check(got)
    print(f"{name}: the match list equals its "
          f"{'C++' if name == 'case16' else 'JAX'} golden ({len(got)} "
          f"matches)")

    # timings, the overflow re-run's level-0 kernels included
    e2e_ms = _time_ms(lambda: det.match(frame, threshold, mask=mask), 10)
    rerun = ()
    if int(n_above[0]) > 256:
        re_cap = next(c for c in _CAND_BUCKETS if c >= int(n_above[0]))
        if routes.get("maps"):
            mr = _map_route_check(lms, banks, sizes, thr, re_cap, None,
                                  n_ori)
            rerun = (
                (coarse_maps, "coarse.cu", "similarity_pallas.py:431",
                 mr["maps_err"], lambda: coarse_maps(*mr["maps_args"]),
                 lambda: coarse_maps_plain(*mr["maps_args"]),
                 mr["maps_shape"],
                 _coarse_work(*mr["maps_args"], counted=False)),
                (map_refine, "map_refine.cu", "refine_pallas.py:154",
                 mr["mr_err"], lambda: map_refine(*mr["mr_args"]),
                 lambda: map_refine_plain(*mr["mr_args"]), mr["mr_shape"],
                 mr["mr_work"]))
        else:
            rk, rx, ry, _, rvalid, _ = coarse_extract(
                lms[1], banks[1], T1, sizes[1], thr, re_cap, None, n_ori)
            rwx, rwy = window_origin(banks[0].width, banks[0].height,
                                     T[0], sizes[0], rk, rx, ry)
            re_args = (lms[0], banks[0], T[0], sizes[0], rk, rwx, rwy,
                       rvalid, n_ori)
            rerun = ((refine_windows, "refine.cu", "refine_pallas.py:67",
                      _max_abs_err(zip(refine_windows(*re_args),
                                       refine_windows_plain(*re_args[:-1]))),
                      lambda: refine_windows(*re_args),
                      lambda: refine_windows_plain(*re_args[:-1]),
                      f"C={re_cap} N={N0} ({int(rvalid.sum())} live)",
                      _refine_work(lms[0], banks[0], rk, rvalid)),)
        print(f"{name}: overflow re-run at cap {re_cap}: "
              + ", ".join(f"{r[0].__name__} [{r[6]}] vs plain max_abs_err "
                          f"{r[3]}" for r in rerun))
        if any(r[3] for r in rerun):
            raise AssertionError(f"{name}: a re-run kernel disagrees with "
                                 f"its twin")
    table = (
        (quant_spread, "frontend.cu", "frontend_pallas.py:108",
         k1_err, lambda: quant_spread(frames, weak, T[0], n_ori, masks),
         lambda: quant_spread_plain(frames, weak, T[0], n_ori, masks),
         f"{mode} {frame.shape[1]}x{frame.shape[0]} T={T[0]}",
         _frontend_work(1, *frame.shape[:2], 3 if color else 1, n_ori,
                        T[0], masked, False)),
        (coarse_scores, "coarse.cu",
         "similarity_pallas.py:175" if N > 63 else "similarity_pallas.py:55",
         k2_err, lambda: coarse_scores(*k2_args),
         lambda: coarse_scores_plain(*k2_args), f"K={K} N={N} M={M1}",
         _coarse_work(lms[1], off, M1, counted=True)),
        (refine_windows, "refine.cu", "refine_pallas.py:67", k3_err,
         lambda: refine_windows(*k3_args),
         lambda: refine_windows_plain(*k3_args[:-1]),
         f"C=256 N={N0} ({int(valid.sum())} live)",
         _refine_work(lms[0], banks[0], k, valid)),
    ) + rerun
    records = []
    for fn, src, replaces, err, kern, plain, shape, work in table:
        ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 3)
        records.append(_record(fn, src, replaces, err, launches, name, ms,
                               plain_ms, work, shape))
        print(f"time {name} {fn.__name__} [{shape}]: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound "
              f"{records[-1]['bound_ms']:.4f} ms "
              f"({records[-1]['bound_by']}) on {card}")
    if routes.get("maps") and rerun:
        _add_device_ms(records, mr)
    print(f"time e2e {name} B=1 ({mode}, {len(pyramids)} templates, "
          f"{frame.shape[1]}x{frame.shape[0]}): {e2e_ms:.4f} ms/frame on "
          f"{card}")
    return records, {"launches": launches, "refine_routes": routes,
                     "n_matches": len(got), "n_above": int(n_above[0]),
                     "coarse_K": K, "coarse_N": N, "M": M1, "level0_N": N0,
                     "e2e_b1_ms": e2e_ms}


# the committed bench_banks/ snapshots, trained in the port by phase 8:
# name -> build_rotated_detector's arguments
SNAPSHOTS = {
    "rot1000x63": dict(num_templates=1000, num_features=63),
    "rot10000x63": dict(num_templates=10000, num_features=63),
    "rot360x63": dict(num_templates=360, num_features=63),
    "rot360x63 ori16": dict(num_templates=360, num_features=63, n_ori=16),
    "rot1000x128": dict(num_templates=1000, num_features=128),
    "rot1000x256 dense": dict(num_templates=1000, num_features=256,
                              dense=True),
    "rot8x8191 s768 dense": dict(num_templates=8, num_features=8191,
                                 size=768, dense=True),
}
# phase 11's registry: class id -> snapshot
REGISTRY = {"bench": "rot1000x63", "wide": "rot1000x128",
            "dense": "rot10000x63"}


def _fields(pyramids, theta: bool = True) -> list:
    """Every Template field and every feature (theta as float32 bits)."""
    return [(t.width, t.height, t.tl_x, t.tl_y, t.pyramid_level, t.sscale,
             t.orientation, t.tag_field_id, t.fiducial_src,
             [(f.x, f.y, f.label)
              + ((int(np.float32(f.theta).view(np.uint32)),) if theta
                 else ()) for f in t.features])
            for tp in pyramids for t in tp]


def train_phase(card: str) -> tuple[dict, dict]:
    """Phase 8: train every committed snapshot in the port on the card,
    as ``build_rotated_detector`` does (the base ``add_template`` on the
    star or block-noise image under a full mask, then
    ``add_templates_rotate``), each timed; each bank must equal its
    snapshot field for field. Then the flagship frame is matched with the
    port-trained rot1000x63 bank: the list must equal the e2e1000
    golden, through the path's kernels. Returns the trained detectors
    and the report."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread)
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows)
    from shape_based_matching_tpu_torch.utils.synthetic import (
        bank_cache_path, load_bank_cache, synthetic_block_noise_image,
        synthetic_shape_image)

    warm = Detector(device=DEVICE)  # the torch ops' first launches
    warm.add_template(synthetic_shape_image(64, 0), "warm")
    trained, report = {}, {}
    for name, args in SNAPSHOTS.items():
        K, nf = args["num_templates"], args["num_features"]
        size, dense = args.get("size", 256), args.get("dense", False)
        n_ori = args.get("n_ori", 8)
        img = (synthetic_block_noise_image(size, seed=0) if dense
               else synthetic_shape_image(size, 0))
        det = Detector(num_features=nf, T=T_LEVELS, num_orientations=n_ori,
                       device=DEVICE)
        t0 = time.perf_counter()
        if det.add_template(img, "bench", np.full_like(img, 255)) != 0:
            raise AssertionError(f"train {name}: the base template failed")
        t1 = time.perf_counter()
        det.add_templates_rotate("bench", 0, [i * 360.0 / K
                                              for i in range(1, K)],
                                 (size / 2.0, size / 2.0))
        t2 = time.perf_counter()
        path = bank_cache_path(K, nf, T_LEVELS, size, 0, dense, n_ori)
        want = load_bank_cache(path)
        if want is None or _fields(det.class_templates["bench"], False) \
                != _fields(want, False):
            raise AssertionError(f"train {name}: differs from "
                                 f"{os.path.basename(path)}")
        n_feat = sum(len(t.features) for t in det.get_templates("bench", 0))
        print(f"train {name}: base add_template ({size}^2, {n_feat} "
              f"features over {len(T_LEVELS)} levels) {t1 - t0:.4f} s, "
              f"add_templates_rotate ({K - 1} angles) {t2 - t1:.4f} s; "
              f"equals {os.path.basename(path)} field for field, on {card}")
        report[name] = {"base_s": t1 - t0, "rotate_s": t2 - t1,
                        "templates": K}
        trained[name] = det

    golden = json.load(open(GOLDEN))
    det = trained["rot1000x63"]
    kernels = (quant_spread, coarse_scores, refine_windows, coarse_maps,
               map_refine)
    got, launches = _counted(
        kernels, lambda: det.match(_scene(golden["config"]), THRESHOLD))
    if not all(launches.values()):
        raise AssertionError(f"trained flagship: a kernel was not launched: "
                             f"{launches}")
    if _keys(got) != golden["matches"]:
        raise AssertionError("the port-trained rot1000x63 bank's flagship "
                             "list differs from the e2e1000 golden")
    print(f"train: the port-trained rot1000x63 bank matches the flagship "
          f"frame as the e2e1000 golden ({len(got)} matches); launches "
          f"{launches}")
    report["flagship_launches"] = launches
    return trained, report


def _golden_tuples(templates) -> list:
    """Geometry and sorted feature set of each template pyramid, as
    tests/test_golden_training.py compares them."""
    return [[(t["width"], t["height"], t["tl_x"], t["tl_y"],
              t["pyramid_level"], sorted(tuple(f) for f in t["features"]))
             for t in tp] for tp in templates]


def _port_tuples(det, cid: str) -> list:
    return _golden_tuples([[{
        "width": t.width, "height": t.height, "tl_x": t.tl_x,
        "tl_y": t.tl_y, "pyramid_level": t.pyramid_level,
        "features": [(f.x, f.y, f.label) for f in t.features]}
        for t in tp] for tp in det.class_templates[cid]])


def cpp_golden_phase(card: str) -> dict:
    """Phase 9: the compiled C++ reference's trainings on the card (case1:
    a masked BGR frame and 7 rotations; case0: 10 scales through the
    shape-info producer; jabil: the 12-template angle x scale sweep with
    weak 100, strong 200); each must equal
    tests/goldens/<case>_train_templates.json."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.shape_info import (
        ShapeInfoProducer)
    from tests.golden_utils import load_json, load_mat

    report = {}
    t0 = time.perf_counter()
    det = Detector(num_features=128, T=T_LEVELS, device=DEVICE)
    img = load_mat("case1_train_img.bin")
    det.add_template(img, "case1", load_mat("case1_train_mask.bin"))
    for a in range(45, 360, 45):
        det.add_template_rotate("case1", 0, float(a),
                                (img.shape[1] / 2.0, img.shape[0] / 2.0))
    report["case1"] = (det, time.perf_counter() - t0)

    t0 = time.perf_counter()
    det = Detector(num_features=150, T=T_LEVELS, device=DEVICE)
    img = load_mat("case0_train_img.bin")
    producer = ShapeInfoProducer(img)
    m255 = np.full(img.shape[:2], 255, np.uint8)
    for i in range(1, 11):
        msk = (producer.transform(m255, 0, i / 10.0) > 0) * np.uint8(255)
        det.add_template(producer.transform(img, 0, i / 10.0), "case0",
                         msk, num_features=int(150 * i / 10.0))
    report["case0"] = (det, time.perf_counter() - t0)

    t0 = time.perf_counter()
    det = Detector(num_features=150, T=T_LEVELS, weak_threshold=100.0,
                   strong_threshold=200.0, device=DEVICE)
    shapes = ShapeInfoProducer(load_mat("jabil_fid_img.bin"))
    shapes.angle_range, shapes.angle_step = [0.0, 270.0], 90.0
    shapes.scale_range, shapes.scale_step = [0.9, 1.1], 0.1
    for info in shapes.produce_infos():
        det.add_template(shapes.src_of(info), "jabil", shapes.mask_of(info),
                         info.scale, info.angle, 3, "fid.png")
    report["jabil"] = (det, time.perf_counter() - t0)

    out = {}
    for case, (det, sec) in report.items():
        want = _golden_tuples(load_json(f"{case}_train_templates.json")
                              ["templates"])
        if _port_tuples(det, case) != want:
            raise AssertionError(f"{case}: training differs from the C++ "
                                 f"golden")
        print(f"train {case}: {len(want)} templates equal the C++ golden "
              f"in {sec:.4f} s on {card}")
        out[case] = {"templates": len(want), "seconds": sec}
    return out


def sweep_phase(card: str) -> dict:
    """Phase 10: add_templates on 64 same-shaped frames (the star at
    256^2, seeds 0-63), gray under masks and BGR, against 64 add_template
    calls: the same ids and templates, theta bits included. Times both on
    the host clock (frames/s, training included)."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.utils.synthetic import (
        synthetic_shape_image)

    gray = np.stack([synthetic_shape_image(256, s) for s in range(64)])
    masks = np.stack([(np.random.RandomState(s).rand(256, 256) > 0.1)
                      .astype(np.uint8) * 255 for s in range(64)])
    out = {}
    for mode, frames, msk in (("gray masked", gray, masks),
                              ("bgr", _bgr(gray), None)):
        bat = Detector(num_features=63, T=T_LEVELS, device=DEVICE)
        bat.add_templates(frames[:2], "warm", None if msk is None
                          else msk[:2])
        t0 = time.perf_counter()
        ids = bat.add_templates(frames, "c", msk)
        t1 = time.perf_counter()
        seq = Detector(num_features=63, T=T_LEVELS, device=DEVICE)
        seq_ids = [seq.add_template(f, "c", None if msk is None else m)
                   for f, m in zip(frames, msk if msk is not None
                                   else [None] * 64)]
        t2 = time.perf_counter()
        if ids != seq_ids or _fields(bat.class_templates["c"]) != \
                _fields(seq.class_templates["c"]):
            raise AssertionError(f"sweep {mode}: add_templates differs from "
                                 f"64 add_template calls")
        fps, fps1 = 64 / (t1 - t0), 64 / (t2 - t1)
        print(f"sweep {mode}: add_templates on 64 frames equals 64 "
              f"add_template calls (theta bits included; "
              f"{sum(i >= 0 for i in ids)} trained): {fps:.1f} frames/s "
              f"batched, {fps1:.1f} frames/s one by one, on {card}")
        out[mode] = {"fps_batched": fps, "fps_single": fps1,
                     "trained": sum(i >= 0 for i in ids)}
    return out


def multiclass_phase(trained: dict, card: str) -> tuple[list, dict]:
    """Phase 11: the registry {bench: rot1000x63, wide: rot1000x128,
    dense: rot10000x63}, trained by phase 8, on the flagship frame at
    threshold 85, in ONE merged step (cap min(256 * 3, 4096)) and its
    re-run. Its kernels against their twins at the merged bank's shapes;
    the merged bank's coarse route, re-run cap and refine routes; the
    path's launches; B=1 equal to the union of the three single-class
    lists and, per class, bench and dense equal to the e2e1000 and
    e2e10000 goldens; B=8 equal to B=1 frame by frame; as_matches=False at
    B=8 (cap 16384, which holds every candidate) with the list path's
    valid entries. Timed at B=1 and B=8."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import (
        _CAND_BUCKETS, _MERGED_MAX_CAP, _batch_pyramid, _sort_dedup)
    from shape_based_matching_tpu_torch.ops.cuda.chain import (
        chain_scores, chain_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_maps_plain, coarse_scores, coarse_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread)
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine, map_refine_plain)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows, refine_windows_plain)
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold, coarse_extract)
    from shape_based_matching_tpu_torch.ops.window import window_origin

    dev = torch.device(DEVICE)
    golden = json.load(open(GOLDEN))
    dense_golden = json.load(open(DENSE_GOLDEN))
    cfg = golden["config"]
    scene = _scene(cfg)
    batch = np.stack([_scene({**cfg, "scene_seed": cfg["scene_seed"] + i})
                      for i in range(BATCH)])
    det = Detector(num_features=63, T=T_LEVELS, device=DEVICE)
    for cid, snap in REGISTRY.items():
        det.class_templates[cid] = trained[snap].class_templates["bench"]
    group = tuple(sorted(REGISTRY))
    t0 = time.perf_counter()
    banks = det._get_banks(group)
    sizes = det._level_sizes(scene.shape)
    plan = det._get_chain(group, sizes[1])
    setup_s = time.perf_counter() - t0
    cap = min(256 * len(REGISTRY), _MERGED_MAX_CAP)
    thr = torch.tensor(THRESHOLD, dtype=torch.float32, device=dev)
    lms = _batch_pyramid(torch.from_numpy(scene[None]).to(dev),
                         det.T_at_level, det.pyramid_levels,
                         det.weak_threshold)
    T1, (w1, h1) = T_LEVELS[1], sizes[1]
    W1, H1 = w1 // T1, h1 // T1
    M1 = W1 * H1
    K, N = banks[1].fx.shape
    N0 = banks[0].fx.shape[1]
    pos = _positions(banks[1], T1, W1, H1)
    rmin, _ = _rmin_for_threshold(banks[1].nfeat, thr)
    off = _flat_offsets(banks[1], T1, W1, M1, sizes[1])
    if plan is not None:
        route = (f"delta chain ({plan.prog_start.numel() - 1} programs, "
                 f"{plan.slots.numel()} slot visits against "
                 f"{int(banks[1].nfeat.sum())} plain)")
        c_fn, c_plain, c_src = chain_scores, chain_scores_plain, "chain.cu"
        c_args = (lms[1], plan, pos, rmin)
        c_rep = "similarity_pallas.py:572"
    else:
        route = f"coarse.cu ({N} slots)"
        c_fn, c_plain, c_src = coarse_scores, coarse_scores_plain, \
            "coarse.cu"
        c_args = (lms[1], off, pos, rmin, M1)
        c_rep = ("similarity_pallas.py:175" if N > 63
                 else "similarity_pallas.py:55")
    S, cnt = c_fn(*c_args)
    c_err = _max_abs_err(zip((S, cnt), c_plain(*c_args)))
    k, x, y, _, valid, n_above = coarse_extract(
        lms[1], banks[1], T1, sizes[1], thr, cap, plan)
    wx, wy = window_origin(banks[0].width, banks[0].height, T_LEVELS[0],
                           sizes[0], k, x, y)
    w_args = (lms[0], banks[0], T_LEVELS[0], sizes[0], k, wx, wy, valid)
    w_err = _max_abs_err(zip(refine_windows(*w_args),
                             refine_windows_plain(*w_args)))
    n_above = int(n_above[0])
    re_cap = next((c for c in _CAND_BUCKETS if c >= n_above), n_above)
    print(f"multiclass: merged bank {group} K={K} (coarse N={N}, level-0 "
          f"N={N0}) built and planned in {setup_s:.3f} s; coarse route "
          f"{route}, vs plain max_abs_err {c_err}; window refine at cap "
          f"{cap} vs plain max_abs_err {w_err} ({int(valid.sum())} live); "
          f"{n_above} candidates, re-run cap {re_cap}")
    if c_err or w_err:
        raise AssertionError("multiclass: a kernel disagrees with its twin")
    rerun = ()
    if n_above > cap:
        mr = _map_route_check(lms, banks, sizes, thr, re_cap, plan)
        if mr["maps_err"] or mr["mr_err"]:
            raise AssertionError("multiclass: a re-run kernel disagrees")
        rerun = (
            (coarse_maps, "coarse.cu", "similarity_pallas.py:431",
             mr["maps_err"], lambda: coarse_maps(*mr["maps_args"]),
             lambda: coarse_maps_plain(*mr["maps_args"]), mr["maps_shape"],
             _coarse_work(*mr["maps_args"], counted=False)),
            (map_refine, "map_refine.cu", "refine_pallas.py:154",
             mr["mr_err"], lambda: map_refine(*mr["mr_args"]),
             lambda: map_refine_plain(*mr["mr_args"]), mr["mr_shape"],
             mr["mr_work"]))

    # the path through the kernels
    kernels = (quant_spread, coarse_scores, chain_scores, refine_windows,
               coarse_maps, map_refine)
    det.counters.clear()
    got, launches = _counted(kernels, lambda: det.match(scene, THRESHOLD))
    routes = _routes(det)
    print(f"multiclass: launches {launches}; refine routes {routes}; "
          f"{len(got)} matches")
    need = ["quant_spread", c_fn.__name__, "refine_windows"]
    if routes.get("maps"):
        need += ["coarse_maps", "map_refine"]
    other = "coarse_scores" if plan is not None else "chain_scores"
    if not all(launches[n] for n in need) or launches[other]:
        raise AssertionError(f"multiclass: a kernel of the path was not "
                             f"launched, or another coarse route ran: "
                             f"{launches}")
    singles = {c: det.match(scene, THRESHOLD, class_ids=[c])
               for c in REGISTRY}
    union = _sort_dedup([m for c in REGISTRY for m in singles[c]])
    if _class_keys(got) != _class_keys(union):
        raise AssertionError("multiclass: the merged list differs from the "
                             "union of the single-class lists")
    for cid, g in (("bench", golden), ("dense", dense_golden)):
        if _keys([m for m in got if m.class_id == cid]) != g["matches"]:
            raise AssertionError(f"multiclass: the {cid} part differs from "
                                 f"its golden")
    got8 = det.match_batch(batch, THRESHOLD)
    for i, frame in enumerate(batch):
        if _class_keys(got8[i]) != _class_keys(det.match(frame, THRESHOLD)):
            raise AssertionError(f"multiclass: B=8 frame {i} differs from "
                                 f"its B=1 match")
    packed = det.match_batch(batch, THRESHOLD, cand_cap=16384,
                             as_matches=False)
    for cid, (pk, px, py, psc, pvalid, povf) in packed.items():
        if bool(povf.any()):
            raise AssertionError(f"multiclass: as_matches=False overflowed "
                                 f"at cap 16384 ({cid})")
        rows = torch.stack([pk, px, py, psc.view(torch.int32)], dim=-1)
        rows, pvalid = rows.cpu().numpy(), pvalid.cpu().numpy()
        for b in range(BATCH):
            entries = sorted({tuple(int(v) for v in r)
                              for r in rows[b][pvalid[b]]})
            # similarities are >= 0, so their bits read the same as int32
            lists = sorted(tuple(t[1:]) for t in _class_keys(got8[b])
                           if t[0] == cid)
            if entries != lists:
                raise AssertionError(f"multiclass: as_matches=False {cid} "
                                     f"frame {b} differs from the list path")
    print(f"multiclass: B=1 equals the union of the three single-class "
          f"lists ({len(got)} matches; bench and dense parts equal the "
          f"e2e1000 and e2e10000 goldens); B={BATCH} equals B=1 frame by "
          f"frame; as_matches=False at B={BATCH} (cap 16384) holds the "
          f"list path's entries")

    table = (
        (c_fn, c_src, c_rep, c_err, lambda: c_fn(*c_args),
         lambda: c_plain(*c_args), f"merged K={K} N={N} M={M1}",
         (_chain_work(lms[1], plan, K, M1) if plan is not None
          else _coarse_work(lms[1], off, M1, counted=True))),
        (refine_windows, "refine.cu", "refine_pallas.py:67", w_err,
         lambda: refine_windows(*w_args),
         lambda: refine_windows_plain(*w_args),
         f"C={cap} N={N0} ({int(valid.sum())} live)",
         _refine_work(lms[0], banks[0], k, valid)),
    ) + rerun
    records = []
    for fn, src, replaces, err, kern, plain, shape, work in table:
        ms = _time_ms(kern, 10)
        plain_ms = _time_ms(plain, 2)
        records.append(_record(fn, src, replaces, err, launches,
                               "multiclass", ms, plain_ms, work, shape))
        print(f"time multiclass {fn.__name__} [{shape}]: kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound "
              f"{records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']})"
              f" on {card}")
    if rerun:
        _add_device_ms(records, mr)
    e2e_ms = _time_ms(lambda: det.match(scene, THRESHOLD), 10)
    per_class_ms = _time_ms(lambda: [det.match(scene, THRESHOLD,
                                               class_ids=[c])
                                     for c in REGISTRY], 10)
    b8_ms = _time_ms(lambda: det.match_batch(batch, THRESHOLD), 3)
    print(f"time e2e multiclass B=1 {scene.shape[1]}x{scene.shape[0]} x {K} "
          f"templates in {len(REGISTRY)} classes: "
          f"{e2e_ms:.4f} ms/frame merged, {per_class_ms:.4f} ms for the "
          f"three single-class matches; B={BATCH}: {b8_ms:.4f} ms/batch = "
          f"{BATCH * 1e3 / b8_ms:.1f} frames/s on {card}")
    return records, {"coarse_route": route, "K": K, "coarse_N": N,
                     "level0_N": N0, "cap": cap, "n_above": n_above,
                     "rerun_cap": re_cap, "refine_routes": routes,
                     "launches": launches, "n_matches": len(got),
                     "setup_s": setup_s, "e2e_b1_ms": e2e_ms,
                     "per_class_b1_ms": per_class_ms,
                     "b8_ms": b8_ms, "fps_b8": BATCH * 1e3 / b8_ms}


PRODUCTION_GOLDEN = os.path.join(GOLDENS, "torch_port_production_icp.json")
PATCH_GOLDEN = os.path.join(GOLDENS,
                            "torch_port_e2e1000_patch2843_matches.json")
# the golden's pose contract (JAX's host-vs-packed tolerance,
# tests/test_icp.py): |d dtheta| deg, |d dscale|, |d tx|, |d ty| px
POSE_TOL = {"dtheta_deg": 1e-3, "dscale": 1e-4, "tx": 1e-2, "ty": 1e-2}
STREAM_SEEDS = (7, 11, 13)  # bench.py's production_stream frames


def _pose_check(got: list, entries: list, what: str) -> dict:
    """Match keys equal and in order, valid and inliers equal, poses
    within POSE_TOL. Returns the largest deviation of each pose field;
    raises otherwise."""
    keys = [[r["match"].template_id, r["match"].x, r["match"].y,
             int(np.float32(r["match"].similarity).view(np.uint32))]
            for r in got]
    if keys != [e["match"] for e in entries]:
        raise AssertionError(f"{what}: the match keys differ from the "
                             f"golden ({len(got)} vs {len(entries)})")
    dev = {f: 0.0 for f in (*POSE_TOL, "rmse")}
    for r, e in zip(got, entries):
        if r["valid"] != e["valid"] or r["inliers"] != e["inliers"]:
            raise AssertionError(f"{what}: valid/inliers differ at "
                                 f"{e['match']}")
        for f in dev:
            dev[f] = max(dev[f], abs(r[f] - e[f]))
    bad = {f: v for f, v in dev.items() if f in POSE_TOL
           and v >= POSE_TOL[f]}
    if bad:
        raise AssertionError(f"{what}: poses past the tolerance: {bad}")
    return dev


SLEEP_CYCLES = 1_000_000_000  # torch.cuda._sleep: about 0.5 s on the card


def _behind_sleep(fn) -> tuple[float, bool]:
    """(host ms of fn(), whether the card was still running a sleep kernel
    queued before it when it returned): a call that waits for the card
    returns only after the sleep ends."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    busy = not done.query()
    torch.cuda.synchronize()
    return ms, busy


def _launch_queue_depth(limit: int = 4096) -> int | None:
    """Kernel launches the host can queue behind a running kernel before a
    launch blocks (None: none of `limit` blocked)."""
    x = torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    depth = None
    for i in range(limit):
        t0 = time.perf_counter()
        x.add_(1)
        if time.perf_counter() - t0 > 0.05:
            depth = i
            break
    torch.cuda.synchronize()
    return depth


def _sync_contract(det, cid: str, frames: list, cfg: dict) -> dict:
    """match_icp_async on device-resident frames dispatches without
    waiting for the card: no synchronizing call under torch's sync debug
    mode "error", and each stage of the dispatch (the class step, the
    edge field, the candidate selection with the ICP, the packing) leaves
    the card still running a sleep kernel queued before it. (The whole
    dispatch queues more launches than the card's launch queue holds, so
    behind a long kernel it waits for room: the queue depth and that wait
    are reported.) Each .result() and a warm match_icp then make one
    synchronizing call, the download, on a frame that does not overflow
    the cap (an overflowing one takes the two-download fallback)."""
    from shape_based_matching_tpu_torch.models.icp import (
        _pack_refined, edge_nearest_field, refine_packed_candidates)
    from shape_based_matching_tpu_torch.utils.profiling import (
        sync_calls as _syncs)

    kw = dict(top_c=cfg["top_c"], iters=cfg["iters"], radius=cfg["radius"],
              cand_cap=cfg["cand_cap"])
    thr = cfg["threshold"]
    for f in frames:  # warm: banks, plans, allocator
        det.match_icp_async(f, thr, **kw).result()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [det.match_icp_async(f, thr, **kw) for f in frames]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    f = frames[0]
    k, x, y, sc, valid, ovf = det.match_batch(
        f[None], thr, cand_cap=cfg["cand_cap"], as_matches=False)[cid]
    field = edge_nearest_field(f, det.weak_threshold, cfg["radius"])
    bank0 = det._get_banks(cid)[0]
    refined = refine_packed_candidates(
        field[0], field[1], field[3], field[4], bank0.fx, bank0.fy,
        bank0.valid, k[0], x[0], y[0], sc[0], valid[0], top_c=cfg["top_c"],
        iters=cfg["iters"], radius=cfg["radius"])
    stages = {
        "match_batch": lambda: det.match_batch(
            f[None], thr, cand_cap=cfg["cand_cap"], as_matches=False),
        "edge_field": lambda: edge_nearest_field(f, det.weak_threshold,
                                                 cfg["radius"]),
        # the ICP loop repeats one body: half the steps keep the stage
        # under the launch queue's depth
        "select_and_icp": lambda: refine_packed_candidates(
            field[0], field[1], field[3], field[4], bank0.fx, bank0.fy,
            bank0.valid, k[0], x[0], y[0], sc[0], valid[0],
            top_c=cfg["top_c"], iters=cfg["iters"] // 2,
            radius=cfg["radius"]),
        "pack": lambda: _pack_refined(*refined, ovf[0]),
    }
    probes = {name: _behind_sleep(fn) for name, fn in stages.items()}
    waited = [name for name, (_, busy) in probes.items() if not busy]
    depth = _launch_queue_depth()
    whole_ms, whole_busy = _behind_sleep(
        lambda: det.match_icp_async(f, thr, **kw))
    if waited:
        raise AssertionError(f"match_icp_async's stages {waited} waited "
                             f"for the card")
    overflow = []
    per_result = []
    for fr, h in zip(frames, handles):
        overflow.append(bool(det.match_batch(
            fr[None], thr, as_matches=False,
            cand_cap=cfg["cand_cap"])[cid][5][0]))
        got, n = _syncs(h.result)
        if h.result() is not got:
            raise AssertionError("MatchIcpHandle.result() is not memoized")
        per_result.append(n)
    _, n_icp = _syncs(lambda: det.match_icp(f, thr, **kw))
    bad = [n for n, o in zip(per_result, overflow) if not o and n != 1]
    if bad or (not overflow[0] and n_icp != 1):
        raise AssertionError(f"downloads: .result() {per_result} (overflow "
                             f"{overflow}), match_icp {n_icp}")
    print(f"sync contract: {len(frames)} match_icp_async dispatches under "
          f"sync debug mode 'error' made no synchronizing call; behind a "
          f"sleep kernel every stage returned with the card still busy ("
          + ", ".join(f"{n} {ms:.2f} ms" for n, (ms, _) in probes.items())
          + f"); the launch queue held {depth} launches behind it, and the "
          f"whole dispatch returned in {whole_ms:.1f} ms (card still busy: "
          f"{whole_busy}); synchronizing calls per .result() {per_result} "
          f"(cap {cfg['cand_cap']} overflow {overflow}: an overflowing "
          f"frame takes match + refine_matches_icp), warm match_icp "
          f"{n_icp}")
    return {"dispatch_syncs": 0,
            "stages_behind_sleep_ms": {n: ms for n, (ms, _) in
                                       probes.items()},
            "launch_queue_depth": depth,
            "dispatch_behind_sleep_ms": whole_ms,
            "dispatch_behind_sleep_busy": whole_busy,
            "result_syncs": per_result, "overflow": overflow,
            "match_icp_syncs": n_icp}


def _icp_kernel_check(det, frame, thr_f: float, kw: dict,
                      card: str) -> tuple[dict, dict]:
    """icp.cu against its plain twin on the inputs of one production
    match_icp (32 candidates of the 1000 x 128 bank, 12 steps): poses,
    inliers and valid flags equal bit for bit, one launch a call and no
    other device kernel; the kernel's and the twin's device ms (profiler)
    and queued ms (CUDA events) a call, and its roofline bound."""
    from portbench.metrics.roofline import icp_refine_work
    from shape_based_matching_tpu_torch.models import icp
    from shape_based_matching_tpu_torch.utils.profiling import (
        CALLS, device_work)

    seen = []
    real = icp.icp_refine_points
    icp.icp_refine_points = lambda *a, **k: seen.append((a, k)) or real(
        *a, **k)
    try:
        det.match_icp(frame, thr_f, **kw)
    finally:
        icp.icp_refine_points = real
    (args, k), = seen

    def kernel():
        return icp.icp_refine_points(*args, **k)

    def twin():
        return icp.icp_refine_points_plain(*args, **k)

    got, want = kernel(), twin()
    differ = int((got.inliers != want.inliers).sum()
                 + (got.valid != want.valid).sum())
    for f in POSE_TOL:
        differ += int((getattr(got, f).view(torch.int32)
                       != getattr(want, f).view(torch.int32)).sum())
    queued, kern = device_work(kernel)
    names = {n for n, _ in kern}
    if differ or queued != CALLS or any("icp_kernel" not in n
                                        for n in names):
        raise AssertionError(f"icp.cu: {differ} fields differ from the "
                             f"twin, {queued / CALLS} launches a call, "
                             f"kernels {names}")
    twin_queued, twin_kern = device_work(twin)
    C, N = args[4].shape[:2]
    points = int(args[6].sum())
    work = icp_refine_work(points, k["iters"], C)
    ms, plain_ms = _time_ms(kernel, 50), _time_ms(twin, 10)
    dev_ms = sum(t for _, t in kern) / CALLS
    twin_dev_ms = sum(t for _, t in twin_kern) / CALLS
    bound_ms = max(work[0] / PEAK_BYTES_S, work[1] / PEAK_OPS_S) * 1e3
    rep = {"C": C, "N": N, "live_points": points, "iters": k["iters"],
           "kernel_device_ms": dev_ms, "kernel_queued_ms": ms,
           "twin_device_ms": twin_dev_ms, "twin_queued_ms": plain_ms,
           "twin_launches": twin_queued / CALLS, "bound_ms": bound_ms,
           "share_of_bound": bound_ms / dev_ms if dev_ms else None}
    print(f"production: icp.cu equals its twin bit for bit (C={C} N={N}, "
          f"{points} live points, {k['iters']} steps; poses, inliers, "
          f"valid); device ms a call kernel {dev_ms:.5f} / twin "
          f"{twin_dev_ms:.5f} ({rep['twin_launches']:.0f} launches); "
          f"queued ms {ms:.4f} / {plain_ms:.4f}; bound {bound_ms:.6f} ms "
          f"on {card}")
    record = {"name": "icp_steps", "route": "cuda",
              "source": "shape_based_matching_tpu_torch/csrc/icp.cu",
              "replaces": "shape_based_matching_tpu/models/icp.py "
                          "_icp_refine_points_impl (XLA)",
              "path": "production", "shape": f"C={C} N={N} iters="
                                             f"{k['iters']}",
              "launches": 1, "max_abs_err": differ, "ms": ms,
              "plain_ms": plain_ms, "device_ms": dev_ms,
              "bound_ms": bound_ms,
              "bound_by": "bytes" if work[0] / PEAK_BYTES_S
              >= work[1] / PEAK_OPS_S else "operations", "library_ms": None}
    return record, rep


def production_phase(card: str) -> tuple[list, dict]:
    """Phase 12: the production path at full width (bench.py's production
    cells): the committed 1000 x 128 bank, synthetic_scene(1024, 1024,
    ..., n_instances=4, seed=7), threshold 85, top_c 32, 12 iterations,
    radius 8, cand_cap 256. The edge field on the card against its CPU
    twin (edge, has, off bitwise), the octant on every integer gradient
    against the CPU's; match_icp against the production_icp golden (keys
    bitwise and in order, poses within POSE_TOL) through the path's
    kernels, each held against its twin; the sync contract;
    match_refine_batch against refine_matches_icp; timings and the device
    kernels a call."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import (
        Match, _batch_pyramid)
    from shape_based_matching_tpu_torch.models.icp import (
        edge_nearest_field, icp_refine_points, match_refine_batch, octant,
        refine_matches_icp)
    from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_scores, coarse_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)
    from shape_based_matching_tpu_torch.ops.cuda.icp import icp_steps
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows, refine_windows_plain)
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold, coarse_extract)
    from shape_based_matching_tpu_torch.ops.window import window_origin
    from shape_based_matching_tpu_torch.utils.profiling import (
        CALLS, device_kernels)
    from shape_based_matching_tpu_torch.utils.synthetic import (
        config_frame, load_bank_cache, synthetic_scene,
        synthetic_shape_image)

    golden = json.load(open(PRODUCTION_GOLDEN))
    cfg = golden["config"]
    cid = golden["class_id"]
    pyramids = load_bank_cache(os.path.join(ROOT, cfg["bank"]))
    if pyramids is None or len(pyramids) != cfg["num_templates"]:
        raise AssertionError(f"bank {cfg['bank']} missing or stale")
    det = Detector(num_features=cfg["num_features"], T=tuple(cfg["T"]),
                   device=DEVICE)
    det.class_templates[cid] = pyramids
    banks = det._get_banks(cid)
    dev = torch.device(DEVICE)
    frame, _ = config_frame(cfg)
    src = torch.from_numpy(frame).to(dev)
    thr_f, weak, radius = cfg["threshold"], det.weak_threshold, cfg["radius"]
    kw = dict(top_c=cfg["top_c"], iters=cfg["iters"], radius=radius,
              cand_cap=cfg["cand_cap"])

    # the edge field and the octant against the CPU
    fc = edge_nearest_field(src, weak, radius)
    fh = edge_nearest_field(src.cpu(), weak, radius)
    field_exact = all(torch.equal(fc[i].cpu(), fh[i]) for i in (0, 2, 3))
    field_dev = {n: float((fc[i].cpu() - fh[i]).abs().max())
                 for n, i in (("normal", 1), ("subpix", 4))}
    g = torch.arange(-1020, 1021, dtype=torch.float32)
    gx, gy = (t.reshape(-1) for t in torch.meshgrid(g, g, indexing="ij"))
    oct_exact = torch.equal(octant(gx.to(dev), gy.to(dev)).cpu(),
                            octant(gx, gy))
    print(f"production: edge field on the card vs its CPU twin: edge, has, "
          f"off bitwise {field_exact} ({int(fc[2].sum())} edge pixels); "
          f"normal max |d| {field_dev['normal']:.3g}, subpix "
          f"{field_dev['subpix']:.3g}; octant of all {gx.numel()} integer "
          f"gradients in [-1020, 1020]^2 equal to the CPU's: {oct_exact}")
    if not (field_exact and oct_exact):
        raise AssertionError("the edge field or the octant differs from "
                             "the CPU")

    # kernels against their twins at the path's shapes
    thr = torch.full((), thr_f, dtype=torch.float32, device=dev)
    sizes = det._level_sizes(frame.shape)
    T = det.T_at_level
    lms = _batch_pyramid(src[None], T, det.pyramid_levels, weak)
    k1_err = _max_abs_err([(quant_spread(src[None], weak, T[0]),
                            quant_spread_plain(src[None], weak, T[0]))])
    T1, (w1, h1) = T[1], sizes[1]
    W1, H1 = w1 // T1, h1 // T1
    M1 = W1 * H1
    off = _flat_offsets(banks[1], T1, W1, M1, sizes[1])
    rmin, _ = _rmin_for_threshold(banks[1].nfeat, thr)
    k2_args = (lms[1], off, _positions(banks[1], T1, W1, H1), rmin, M1)
    k2_err = _max_abs_err(zip(coarse_scores(*k2_args),
                              coarse_scores_plain(*k2_args)))
    k, x, y, _, valid, n_above = coarse_extract(
        lms[1], banks[1], T1, sizes[1], thr, cfg["cand_cap"])
    wx, wy = window_origin(banks[0].width, banks[0].height, T[0], sizes[0],
                           k, x, y)
    k3_args = (lms[0], banks[0], T[0], sizes[0], k, wx, wy, valid)
    k3_err = _max_abs_err(zip(refine_windows(*k3_args),
                              refine_windows_plain(*k3_args)))
    K, N = off.shape
    N0 = banks[0].fx.shape[1]
    print(f"production: K1 frontend vs plain max_abs_err {k1_err}; coarse "
          f"K={K} N={N} M={M1} {k2_err}; window refine C={cfg['cand_cap']} "
          f"N={N0} {k3_err} ({int(valid.sum())} live, n_above "
          f"{int(n_above[0])})")
    if k1_err or k2_err or k3_err:
        raise AssertionError("production: a kernel disagrees with its twin")

    # the path through the kernels: match_icp against the golden
    kernels = (quant_spread, coarse_scores, refine_windows, coarse_maps,
               map_refine, chain_scores, icp_steps)
    det.match_icp(frame, thr_f, **kw)  # warm
    got, launches = _counted(kernels,
                             lambda: det.match_icp(frame, thr_f, **kw))
    need = ["quant_spread", "coarse_scores", "refine_windows", "icp_steps"]
    if golden["overflow"]:
        need += ["coarse_maps", "map_refine"]
    if (not all(launches[n] for n in need) or launches["chain_scores"]
            or launches["icp_steps"] != 1):
        raise AssertionError(f"production: a kernel of the path was not "
                             f"launched, or the chain was, or icp.cu not "
                             f"once: {launches}")
    pose_dev = _pose_check(got, golden["entries"], "match_icp")
    print(f"production: match_icp equals the production_icp golden "
          f"({len(got)} entries, {golden['path']} path: cap "
          f"{cfg['cand_cap']} overflow {golden['overflow']}); largest pose "
          f"deviation {pose_dev}; launches {launches}")
    icp_record, icp_report = _icp_kernel_check(det, frame, thr_f, kw, card)
    cpu = Detector(num_features=cfg["num_features"], T=tuple(cfg["T"]),
                   device="cpu")
    cpu.class_templates[cid] = pyramids
    cpu_dev = _pose_check(cpu.match_icp(frame, thr_f, **kw),
                          golden["entries"], "match_icp on the CPU")
    print(f"production: match_icp on the CPU (plain twins) equals the "
          f"golden too; largest pose deviation {cpu_dev}")

    # the sync contract, on device-resident frames
    templ = synthetic_shape_image(256, 0)
    stream = [torch.from_numpy(synthetic_scene(
        cfg["height"], cfg["width"], templ, n_instances=cfg["n_instances"],
        seed=s)).to(dev) for s in STREAM_SEEDS]
    sync = _sync_contract(det, cid, stream, cfg)

    # match_refine_batch against refine_matches_icp on its live rows
    out = match_refine_batch(det, src[None], thr_f, **kw)[cid][0]
    live = torch.isfinite(out["score"]).cpu().numpy()
    rows = np.nonzero(live)[0]
    want = refine_matches_icp(det, src, [
        Match(int(out["x"][i]), int(out["y"][i]), float(out["score"][i]),
              cid, int(out["k"][i])) for i in rows], iters=cfg["iters"],
        radius=radius)
    icp = {f: getattr(out["icp"], f).cpu().numpy()
           for f in ("dtheta_deg", "dscale", "tx", "ty", "valid")}
    if icp["valid"][~live].any():
        raise AssertionError("match_refine_batch: a dead row is valid")
    mrb_dev = {f: 0.0 for f in POSE_TOL}
    for i, w in zip(rows, want):
        if bool(icp["valid"][i]) != w["valid"]:
            raise AssertionError("match_refine_batch: valid differs")
        for f in POSE_TOL:
            mrb_dev[f] = max(mrb_dev[f], abs(float(icp[f][i]) - w[f]))
    if any(v >= POSE_TOL[f] for f, v in mrb_dev.items()):
        raise AssertionError(f"match_refine_batch vs refine_matches_icp: "
                             f"{mrb_dev}")
    print(f"production: match_refine_batch agrees with refine_matches_icp "
          f"on its {len(rows)} live rows (largest deviation {mrb_dev}); "
          f"{int((~live).sum())} dead rows invalid")

    # timings: mean of warm calls between CUDA events
    rng = np.random.RandomState(6)  # bench.py _measure_icp's shapes
    icp_frame = torch.from_numpy(synthetic_scene(
        1024, 1024, templ, n_instances=4, seed=5)).to(dev)
    pts = torch.from_numpy(rng.rand(64, 63, 2).astype(np.float32)
                           * 48).to(dev)
    origins = torch.from_numpy(rng.randint(64, 900, (64, 2)).astype(
        np.float32)).to(dev)
    pv = torch.ones((64, 63), dtype=torch.bool, device=dev)
    field = edge_nearest_field(icp_frame, 30.0, 8)
    batch8 = torch.stack(stream + [torch.from_numpy(synthetic_scene(
        cfg["height"], cfg["width"], templ, n_instances=cfg["n_instances"],
        seed=s)).to(dev) for s in (8, 9, 10, 12, 14)])

    def stream_loop():
        prev = None
        for f in stream:
            h = det.match_icp_async(f, thr_f, **kw)
            if prev is not None:
                prev.result()
            prev = h
        prev.result()

    timed = {
        "edge_field": (lambda: edge_nearest_field(src, weak, radius), 10, 1),
        "icp_64": (lambda: icp_refine_points(*field[:2], field[3], field[4],
                                             pts, origins, pv, iters=10,
                                             radius=8), 10, 1),
        "match_then_refine": (lambda: refine_matches_icp(
            det, src, det.match(src, thr_f)[:cfg["top_c"]],
            iters=cfg["iters"], radius=radius), 10, 1),
        "match_icp": (lambda: det.match_icp(src, thr_f, **kw), 10, 1),
        "match_icp_async_3": (stream_loop, 5, len(stream)),
        "match_refine_batch_b1": (lambda: match_refine_batch(
            det, src[None], thr_f, **kw), 10, 1),
        "match_refine_batch_b8": (lambda: match_refine_batch(
            det, batch8, thr_f, **kw), 3, 8),
    }
    times, kernels_a_call, busy_ms = {}, {}, {}
    for name, (fn, iters, frames) in timed.items():
        times[name] = _time_ms(fn, iters) / frames
    for name in ("edge_field", "icp_64", "match_icp"):
        kern = device_kernels(timed[name][0])
        kernels_a_call[name] = len(kern) / CALLS
        busy_ms[name] = sum(ms for _, ms in kern) / CALLS
    idle = {n: 1 - busy_ms[n] / times[n] for n in busy_ms}
    print("time production (ms/frame, mean of warm calls between CUDA "
          "events): " + ", ".join(f"{n} {v:.4f}" for n, v in times.items())
          + f" on {card}")
    print(f"production: device kernels a call (torch.profiler, {CALLS} "
          f"calls) {kernels_a_call}, their device ms a call {busy_ms}, "
          f"idle share of the timed call {idle}")

    table = (
        (quant_spread, "frontend.cu", "frontend_pallas.py:108", k1_err,
         lambda: quant_spread(src[None], weak, T[0]),
         lambda: quant_spread_plain(src[None], weak, T[0]),
         f"1024^2 T={T[0]}", _frontend_work(1, 1024, 1024, 1, 8, T[0],
                                            False, False)),
        (coarse_scores, "coarse.cu", "similarity_pallas.py:55", k2_err,
         lambda: coarse_scores(*k2_args),
         lambda: coarse_scores_plain(*k2_args), f"K={K} N={N} M={M1}",
         _coarse_work(lms[1], off, M1, counted=True)),
        (refine_windows, "refine.cu", "refine_pallas.py:67", k3_err,
         lambda: refine_windows(*k3_args),
         lambda: refine_windows_plain(*k3_args),
         f"C={cfg['cand_cap']} N={N0} ({int(valid.sum())} live)",
         _refine_work(lms[0], banks[0], k, valid)),
    )
    records = []
    for fn, srcf, replaces, err, kern, plain, shape, work in table:
        ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 3)
        records.append(_record(fn, srcf, replaces, err, launches,
                               "production", ms, plain_ms, work, shape))
    records.append(icp_record)
    return records, {
        "icp_steps": icp_report,
        "field_exact": field_exact, "field_dev": field_dev,
        "octant_exact": oct_exact, "pose_dev": pose_dev,
        "cpu_pose_dev": cpu_dev,
        "overflow": golden["overflow"], "launches": launches,
        "sync": sync, "match_refine_batch_dev": mrb_dev, "ms": times,
        "device_kernels_a_call": kernels_a_call, "device_busy_ms": busy_ms,
        "idle_share": idle, "n_entries": len(got)}


# phase 13's frontend modes: (color, n_ori, masked)
PATCH_MODES = {f"{'color' if c else 'gray'}{n}{'_masked' if m else ''}":
               (c, n, m) for c in (False, True) for n in (8, 16)
               for m in (False, True)}


def patch_phase(scene: np.ndarray, card: str) -> tuple[list, dict]:
    """Phase 13: patch_2843. The frontend's patch mode against its twin,
    bitwise, in the eight modes at 1024^2 (the flagship frame and noise,
    T=4 and T=8), with the count of spread pixels the patch changes; a
    Detector(patch_2843=True) match of the flagship frame through the
    kernels against its JAX golden, and whether that list differs from
    e2e1000's; the kernel's default and patch modes timed side by side."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows)
    from shape_based_matching_tpu_torch.utils.synthetic import (
        load_bank_cache)

    dev = torch.device(DEVICE)
    weak = 30.0
    noise = np.random.RandomState(7).randint(0, 256, scene.shape,
                                             dtype=np.uint8)
    gray = np.stack([scene, noise])
    masks = torch.from_numpy(np.stack([
        (np.random.RandomState(s).rand(*scene.shape) > 0.25).astype(
            np.uint8) * 255 for s in (4, 5)])).to(dev)
    modes = {}
    for mode, (color, n_ori, masked) in PATCH_MODES.items():
        frames = torch.from_numpy(_bgr(gray) if color else gray).to(dev)
        if color:
            frames = frames.permute(0, 3, 1, 2).contiguous()
        m = masks if masked else None
        err, changed = 0, 0
        for T in (4, 8):
            got = quant_spread(frames, weak, T, n_ori, m, patch_2843=True)
            err = max(err, _max_abs_err([(got, quant_spread_plain(
                frames, weak, T, n_ori, m, patch_2843=True))]))
            changed += int((_i64(got) != _i64(quant_spread(
                frames, weak, T, n_ori, m))).sum())
        modes[mode] = {"max_abs_err": err, "changed_pixels": changed}
    print("K1 frontend patch_2843 vs plain (1024^2, scene + noise, T=4 "
          "and T=8): " + ", ".join(
              f"{k} err {v['max_abs_err']} ({v['changed_pixels']} spread "
              f"pixels differ from the default mode)"
              for k, v in modes.items()))
    if any(v["max_abs_err"] for v in modes.values()):
        raise AssertionError("a patch_2843 frontend mode disagrees with "
                             "its twin")

    golden = json.load(open(PATCH_GOLDEN))
    cfg = golden["config"]
    det = Detector(num_features=cfg["num_features"], T=tuple(cfg["T"]),
                   patch_2843=True, device=DEVICE)
    det.class_templates[golden["class_id"]] = load_bank_cache(
        os.path.join(ROOT, cfg["bank"]))
    det.match(scene, cfg["threshold"])  # warm
    kernels = (quant_spread, coarse_scores, refine_windows)
    got, launches = _counted(kernels,
                             lambda: det.match(scene, cfg["threshold"]))
    if not all(launches.values()):
        raise AssertionError(f"patch_2843: a kernel was not launched: "
                             f"{launches}")
    if _keys(got) != golden["matches"]:
        raise AssertionError(f"patch_2843: the flagship list differs from "
                             f"its JAX golden ({len(got)} vs "
                             f"{len(golden['matches'])})")
    default = json.load(open(GOLDEN))["matches"]
    differs = _keys(got) != default
    print(f"patch_2843: Detector(patch_2843=True) on the flagship frame "
          f"equals its JAX golden ({len(got)} matches; e2e1000 has "
          f"{len(default)}, lists differ: {differs}); launches {launches}")

    one = torch.from_numpy(scene[None]).to(dev)
    t_default = _time_ms(lambda: quant_spread(one, weak, 4), 30)
    t_patch = _time_ms(lambda: quant_spread(one, weak, 4, patch_2843=True),
                       30)
    plain_ms = _time_ms(lambda: quant_spread_plain(one, weak, 4,
                                                   patch_2843=True), 5)
    print(f"time quant_spread 1024^2 T=4 B=1: default mode {t_default:.4f} "
          f"ms, patch_2843 mode {t_patch:.4f} ms, patch twin {plain_ms:.4f} "
          f"ms on {card}")
    record = _record(quant_spread, "frontend.cu", "frontend_pallas.py:108",
                     max(v["max_abs_err"] for v in modes.values()),
                     launches, "patch_2843", t_patch, plain_ms,
                     _frontend_work(1, 1024, 1024, 1, 8, 4, False, False),
                     "patch_2843 gray8 1024^2 T=4")
    return [record], {"modes": modes, "launches": launches,
                      "n_matches": len(got), "differs_from_e2e1000": differs,
                      "default_ms": t_default, "patch_ms": t_patch,
                      "patch_plain_ms": plain_ms}


# phase 14: the classes of phase 8 in the model directory, and the frames
# the CLI matches (the flagship frame, then the production stream)
CLI_CLASSES = ("rot1000x63", "rot1000x128", "rot10000x63")
CLI_SEEDS = (3,) + STREAM_SEEDS
# printed-digit rounding of the CLI's icp[...] fields on top of POSE_TOL
CLI_ICP_TOL = (POSE_TOL["tx"] + 5e-3, POSE_TOL["ty"] + 5e-3,
               POSE_TOL["dtheta_deg"] + 5e-4, POSE_TOL["dscale"] + 5e-5)


def _cli(argv: list) -> tuple[list, float]:
    """(printed lines, seconds) of ``cli.main(argv)``, which must return
    0."""
    import io

    from shape_based_matching_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")
    return buf.getvalue().splitlines(), time.perf_counter() - t0


@contextlib.contextmanager
def _read_timer():
    """Seconds each class read inside the block took, file to templates
    (``load_opencv_yaml`` of its file, then ``read_class``), keyed by
    class id: the detector module's two calls, wrapped while the block
    runs."""
    from shape_based_matching_tpu_torch.models import detector as dm

    load, read = dm.load_opencv_yaml, dm.Detector.read_class
    seconds, start = {}, []

    def timed_load(path):
        start.append(time.perf_counter())
        return load(path)

    def timed_read(self, doc, class_id_override=""):
        cid = read(self, doc, class_id_override)
        seconds[cid] = time.perf_counter() - start[-1]
        return cid

    dm.load_opencv_yaml, dm.Detector.read_class = timed_load, timed_read
    try:
        yield seconds
    finally:
        dm.load_opencv_yaml, dm.Detector.read_class = load, read


def _registry(cids, model_dir: str) -> None:
    """The CLI's registry.json for classes trained outside it."""
    with open(os.path.join(model_dir, "registry.json"), "w") as f:
        json.dump({c: {"source_image": "", "fiducial_image": "",
                       "infos": []} for c in cids}, f, indent=2)


def _match_lines(det, cid: str, name: str, frame: np.ndarray,
                 icp: bool) -> tuple[list, list]:
    """What ``cli match --top-k 1000`` prints for a frame, from the
    in-memory path (``Detector.match``, ``nms_boxes`` and, with `icp`,
    ``refine_matches_icp``): the lines without the match time and icp
    fields, and the poses of the lines that carry one."""
    from shape_based_matching_tpu_torch.models.icp import refine_matches_icp
    from shape_based_matching_tpu_torch.utils.nms import nms_boxes

    matches = det.match(frame, THRESHOLD)
    boxes, scores = [], []
    for m in matches:
        t0 = det.get_templates(m.class_id, m.template_id)[0]
        boxes.append((m.x, m.y, t0.width, t0.height))
        scores.append(m.similarity)
    kept = [matches[i] for i in nms_boxes(boxes, scores, 0.0, 0.5)]
    lines = [f"{name}: {len(matches)} matches, {len(kept)} after NMS/verify"]
    poses = []
    refined = refine_matches_icp(det, frame, kept) if icp and kept else []
    for i, m in enumerate(kept):
        lines.append(f"  class={cid} tid={m.template_id} x={m.x} y={m.y} "
                     f"sim={m.similarity:.2f}")
        if refined and refined[i]["valid"]:
            r = refined[i]
            poses.append((r["tx"], r["ty"], r["dtheta_deg"], r["dscale"]))
    return lines, poses


def _parse_match(lines: list) -> tuple[list, list]:
    """cli match's lines without the match time and icp fields, the
    poses of its icp fields, and the CSV path line dropped."""
    import re

    icp = re.compile(r" icp\[x=(\S+) y=(\S+) dtheta=(\S+) dscale=(\S+) "
                     r"rmse=\S+\]")
    out, poses = [], []
    for line in lines:
        if line.startswith("timing summary"):
            continue
        m = icp.search(line)
        if m:
            poses.append(tuple(float(v) for v in m.groups()))
        out.append(re.sub(r" \[match [0-9.]+ ms\]", "", icp.sub("", line)))
    return out, poses


def _csv_stats(path: str) -> dict:
    """{stat: {column: ms}} of the CLI's timing CSV."""
    with open(path) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    cols = rows[0][1:]
    return {r[0]: dict(zip(cols, map(float, r[1:]))) for r in rows[1:]}


def cli_phase(trained: dict, card: str) -> dict:
    """Phase 14: the CLI and the model directory on the card, at full
    width, in a temporary directory.
    1. Persistence: the classes rot1000x63, rot1000x128 and rot10000x63
       trained by phase 8 written in the CLI's layout (save_settings with
       templates_dir and classes, write_classes, registry.json), each
       class written and read timed (the reads inside get_instance);
       get_instance loads them equal field for field (theta is not
       stored), and the loaded detector matches the flagship and dense
       goldens.
    2. ``cli match`` (threshold 85, NMS 0.5, top-k 1000, CSV, annotation)
       on the flagship frame and the production stream as PNGs: on the
       rot1000x63 model directory, and with --icp on the rot1000x128 one.
       Its lines equal the in-memory path's (poses within POSE_TOL and
       the printed digits); its CSV's stage ms beside the in-memory
       Detector.match ms on the same frames.
    3. ``cli train`` of a 4-angle x 3-scale sweep of the flagship template
       image equals add_templates of the same renders; ``train-db`` and
       ``match-db --verify-ccorr 0.5`` on tests/test_db.py's synthetic
       tag database print the in-memory path's lines.
    4. ``--trace DIR info`` (at 256x256, 64 templates) and ``info
       --dispatch`` run; their lines are printed. The launch counters of the kernels are reset before the
       golden matches from disk and each cli match, and each of those
       must launch every kernel of its path."""
    import shutil
    import tempfile

    from shape_based_matching_tpu_torch import Detector, get_instance
    from shape_based_matching_tpu_torch import reset_instance
    from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread)
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows)
    from shape_based_matching_tpu_torch.db import TagDB, make_fiducial_geo
    from shape_based_matching_tpu_torch.models.shape_info import (
        ShapeInfoProducer)
    from shape_based_matching_tpu_torch.utils.imageio import (load_image,
                                                              save_image)
    from shape_based_matching_tpu_torch.utils.nms import nms_boxes
    from shape_based_matching_tpu_torch.utils.synthetic import (
        synthetic_scene, synthetic_shape_image)
    from shape_based_matching_tpu_torch.utils.verify import (
        verify_match_fiducial)
    from shape_based_matching_tpu_torch.utils.yaml_io import (
        class_file_path, dump_opencv_yaml)

    report = {}
    tmp = tempfile.mkdtemp(prefix="sbm_cli_")
    try:
        # 1. persistence
        reg = os.path.join(tmp, "registry")
        os.makedirs(reg)
        det = Detector(num_features=63, T=T_LEVELS, device=DEVICE)
        for cid in CLI_CLASSES:
            det.class_templates[cid] = \
                trained[cid].class_templates["bench"]
        fmt = os.path.join(reg, "%s.yaml.gz")
        write_s = {}
        for cid in CLI_CLASSES:
            t0 = time.perf_counter()
            dump_opencv_yaml(det.write_class(cid), class_file_path(fmt, cid))
            write_s[cid] = time.perf_counter() - t0
        settings = os.path.join(reg, "detector_linemod.yaml")
        det.save_settings(settings, templates_dir=reg, classes=CLI_CLASSES)
        _registry(CLI_CLASSES, reg)
        reset_instance()
        t0 = time.perf_counter()
        with _read_timer() as read_s:
            inst = get_instance(settings, device=DEVICE)
        get_s = time.perf_counter() - t0
        reset_instance()
        if inst.class_ids() != list(CLI_CLASSES):
            raise AssertionError(f"get_instance loaded {inst.class_ids()}")
        for cid in CLI_CLASSES:
            if _fields(inst.class_templates[cid], False) != _fields(
                    det.class_templates[cid], False):
                raise AssertionError(f"{cid}: the loaded templates differ "
                                     f"from the trained ones")
        kernels = (quant_spread, coarse_scores, chain_scores,
                   refine_windows, coarse_maps, map_refine)
        # the kernels each path must launch
        need = {"rot1000x63": {"quant_spread", "coarse_scores",
                               "refine_windows", "coarse_maps",
                               "map_refine"},
                "rot10000x63": {"quant_spread", "chain_scores",
                                "refine_windows", "coarse_maps",
                                "map_refine"},
                "rot1000x128": {"quant_spread", "coarse_scores",
                                "refine_windows"}}

        def launched(run, cid: str, what: str):
            out, counts = _counted(kernels, run)
            if any(not counts[k] for k in need[cid]):
                raise AssertionError(f"{what}: a kernel of the path was not "
                                     f"launched: {counts}")
            report.setdefault("launches", {})[what] = counts
            return out

        lists = {}
        for cid, gpath in (("rot1000x63", GOLDEN),
                           ("rot10000x63", DENSE_GOLDEN)):
            golden = json.load(open(gpath))
            got = launched(lambda: inst.match(_scene(golden["config"]),
                                              THRESHOLD, [cid]),
                           cid, f"{cid} from disk")
            if _keys(got) != golden["matches"]:
                raise AssertionError(f"{cid} loaded from disk: the flagship "
                                     f"list differs from "
                                     f"{os.path.basename(gpath)}")
            lists[cid] = len(got)
        sizes = {c: os.path.getsize(class_file_path(fmt, c))
                 for c in CLI_CLASSES}
        for cid in CLI_CLASSES:
            print(f"model dir: {cid} ({len(det.class_templates[cid])} "
                  f"templates, {sizes[cid] / 1e6:.2f} MB gzipped): write "
                  f"{write_s[cid]:.3f} s, read {read_s[cid]:.3f} s")
        print(f"model dir: get_instance {get_s:.3f} s for the 3 classes; "
              f"equal field for field; from disk the flagship list equals "
              f"the e2e1000 golden ({lists['rot1000x63']} matches) and the "
              f"dense one e2e10000 ({lists['rot10000x63']}) on {card}")
        report["persistence"] = {"write_s": write_s, "read_s": read_s,
                                 "get_instance_s": get_s, "bytes": sizes,
                                 "golden_matches": lists}

        # 2. cli match
        frames_dir = os.path.join(tmp, "frames")
        os.makedirs(frames_dir)
        templ = synthetic_shape_image(256, 0)
        frames = {}
        for seed in CLI_SEEDS:
            name = f"seed{seed:02d}.png"
            frames[name] = synthetic_scene(1024, 1024, templ, n_instances=4,
                                           seed=seed)
            save_image(frames[name], os.path.join(frames_dir, name))
        if (load_image(os.path.join(frames_dir, "seed03.png"), gray=True)
                != frames["seed03.png"]).any():
            raise AssertionError("a frame changed through its PNG")
        report["match"] = {}
        for cid, icp in (("rot1000x63", False), ("rot1000x128", True)):
            md = os.path.join(tmp, cid)
            os.makedirs(md)
            shutil.copy(class_file_path(fmt, cid),
                        class_file_path(os.path.join(md, "%s.yaml.gz"), cid))
            det.save_settings(os.path.join(md, "detector_linemod.yaml"),
                              templates_dir=md, classes=[cid])
            _registry([cid], md)
            csv = os.path.join(tmp, f"{cid}.csv")
            lines, secs = launched(lambda: _cli(
                ["--device", DEVICE, "match", "--model-dir", md,
                 "--test-dir", frames_dir, "--threshold", str(THRESHOLD),
                 "--nms", "0.5", "--top-k", "1000", "--csv", csv,
                 "--annotate", os.path.join(tmp, f"out_{cid}"), "--gray"]
                + (["--icp"] if icp else [])), cid, f"cli match {cid}")
            got, got_poses = _parse_match(lines)
            mem = Detector(num_features=trained[cid].num_features,
                           T=T_LEVELS, device=DEVICE)
            mem.class_templates[cid] = det.class_templates[cid]
            want, want_poses = [], []
            for name, frame in frames.items():
                w, p = _match_lines(mem, cid, name, frame, icp)
                want += w
                want_poses += p
            if got != want:
                raise AssertionError(f"cli match on {cid}: its lines differ "
                                     f"from the in-memory path's")
            if len(got_poses) != len(want_poses) or any(
                    abs(a - b) > t for g, w in zip(got_poses, want_poses)
                    for a, b, t in zip(g, w, CLI_ICP_TOL)):
                raise AssertionError(f"cli match --icp on {cid}: poses past "
                                     f"the tolerance")
            mem_ms = [_time_ms(lambda: mem.match(frame, THRESHOLD), 5)
                      for frame in frames.values()]
            stats = _csv_stats(csv)
            kept = sum(1 for l in got if l.startswith("  class="))
            print(f"cli match {cid}{' --icp' if icp else ''}: "
                  f"{len(frames)} frames, {kept} kept lines equal the "
                  f"in-memory path's ({len(got_poses)} icp poses within "
                  f"POSE_TOL), {secs:.2f} s; per frame ms mean (min-max): "
                  + ", ".join(f"{k} {stats['mean'][k]:.3f} "
                              f"({stats['min'][k]:.3f}-{stats['max'][k]:.3f})"
                              for k in stats["mean"])
                  + f"; in-memory Detector.match warm "
                  f"{np.mean(mem_ms):.3f} ({min(mem_ms):.3f}-"
                  f"{max(mem_ms):.3f}) on {card}; launches "
                  f"{report['launches'][f'cli match {cid}']}")
            report["match"][cid] = {"icp": icp, "seconds": secs,
                                    "kept_lines": kept,
                                    "icp_poses": len(got_poses),
                                    "csv": stats, "memory_ms": mem_ms}

        # 3. train, train-db, match-db
        templ_path = os.path.join(tmp, "templ.png")
        save_image(templ, templ_path)
        md = os.path.join(tmp, "sweep")
        lines, secs = _cli(["--device", DEVICE, "train", "--model-dir", md,
                            "--class-id", "sweep", "--image", templ_path,
                            "--angles", "0,90,180,270", "--scales",
                            "0.9:1.1:0.1", "--gray"])
        mem = Detector(device=DEVICE)
        full = np.full(templ.shape, 255, np.uint8)
        for scale in (0.9, 1.0, 1.1):
            angles = (0.0, 90.0, 180.0, 270.0)
            mem.add_templates(
                np.stack([ShapeInfoProducer.transform(templ, a, scale)
                          for a in angles]), "sweep",
                np.stack([(ShapeInfoProducer.transform(full, a, scale) > 0)
                          * np.uint8(255) for a in angles]),
                sscales=[scale] * 4, orientations=list(angles),
                fiducial_src=os.path.join(md, "sweep.fid.png"))
        disk = Detector(device=DEVICE)
        disk.read_classes(["sweep"], os.path.join(md, "%s.yaml.gz"))
        if _fields(disk.class_templates["sweep"], False) != _fields(
                mem.class_templates["sweep"], False):
            raise AssertionError("cli train: the class file differs from "
                                 "add_templates of the same renders")
        print(f"cli train: 12-render sweep ({mem.num_templates()} "
              f"templates) equals add_templates of the same renders field "
              f"for field, {secs:.2f} s")

        dbdir = os.path.join(tmp, "db")
        os.makedirs(os.path.join(dbdir, "frames"))
        fid_shape = synthetic_shape_image(96, seed=0)
        model_img = np.zeros((192, 192), np.uint8)
        model_img[32:128, 48:144] = fid_shape
        model_path = os.path.join(dbdir, "tag_model.png")
        save_image(model_img, model_path)
        db = TagDB(os.path.join(dbdir, "tags.sqlite"))
        db.add_tag_field(3, "field0", 3)
        db.add_tag_model(42, "m42", model_path, [(3, make_fiducial_geo(
            48 / 192, 32 / 192, 96 / 192, 96 / 192, (192, 192)))])
        db.close()
        scene = synthetic_scene(256, 256, fid_shape, n_instances=2, seed=5)
        save_image(scene, os.path.join(dbdir, "frames", "scene.png"))
        mdir = os.path.join(dbdir, "model_images")
        _, tdb_s = _cli(["--device", DEVICE, "train-db", "--db", db.path,
                         "--model-dir", mdir, "--num-features", "48",
                         "--weak", "30", "--strong", "60", "--angles", "0",
                         "--scales", "1.0"])
        reset_instance()
        lines, mdb_s = _cli(["--device", DEVICE, "match-db", "--db", db.path,
                             "--model-dir", mdir, "--test-dir",
                             os.path.join(dbdir, "frames"), "--threshold",
                             "80", "--verify-ccorr", "0.5", "--gray"])
        reset_instance()
        fid_path = os.path.join(dbdir, "tag_model.3.png")
        mem = Detector(num_features=48, weak_threshold=30.0,
                       strong_threshold=60.0, device=DEVICE)
        mem.add_template(model_img[32:128, 48:144], "42",
                         np.full((96, 96), 255, np.uint8), sscale=1.0,
                         orientation=0.0, tag_field_id=3,
                         fiducial_src=fid_path)
        matches = mem.match(scene, 80.0)
        boxes = [(m.x, m.y, mem.get_templates("42", m.template_id)[0].width,
                  mem.get_templates("42", m.template_id)[0].height)
                 for m in matches]
        fid = load_image(fid_path, gray=True)
        kept = []
        for i in nms_boxes(boxes, [m.similarity for m in matches], 0.0, 0.5):
            m = matches[i]
            t0 = mem.get_templates("42", m.template_id)[0]
            if verify_match_fiducial(scene, (m.x, m.y), t0, fid, 0.5,
                                     device=DEVICE)[0]:
                kept.append(m)
        want = [f"scene.png: {len(matches)} matches, {len(kept)} after "
                f"NMS/verify"] + [
            f"  model=m42 class=42 tid={m.template_id} x={m.x} y={m.y} "
            f"sim={m.similarity:.2f} scale=1.00 angle=0" for m in kept]
        got, _ = _parse_match(lines)
        if got != want or not kept:
            raise AssertionError(f"cli match-db: {got} differs from the "
                                 f"in-memory path's {want}")
        print(f"cli train-db {tdb_s:.2f} s, match-db --verify-ccorr 0.5 "
              f"{mdb_s:.2f} s: {len(kept)} kept lines equal the in-memory "
              f"path's")
        report["train_db"] = {"train_db_s": tdb_s, "match_db_s": mdb_s,
                              "kept": len(kept)}

        # 4. info
        trace = os.path.join(tmp, "trace")
        for name, argv in (("trace", ["--trace", trace, "info", "--size",
                                      "256x256", "--templates", "64"]),
                           ("dispatch", ["info", "--dispatch"])):
            lines, _ = _cli(["--device", DEVICE] + argv)
            for line in lines:
                print(f"cli info ({name}) | {line}")
            report[f"info_{name}"] = lines
        if not os.path.getsize(os.path.join(trace, "trace.json")):
            raise AssertionError("cli --trace wrote an empty trace")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report


# phase 15: the sharded paths on one card, their shards round-robin
HUGE = 4096                       # the huge frame's side
SHARDS = 4                        # shards of every sharded path
HUGE_EDGES = (1024, 2048, 3072)   # 4 bands' edges: instances centred there
MESH_SHAPES = ((1, 4), (2, 2), (4, 1))
PRODUCTION_SEEDS = tuple(range(7, 15))


def _host_ms(fn, iters: int) -> float:
    """Warm mean ms per call on the host clock, each call synchronized
    (the sharded paths end in a download or a synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _peak_gb(fn) -> float:
    """Peak device memory (GB) that torch allocated during fn()."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def _cap_holding(n: int) -> int:
    """The smallest multiple of 1024 that holds n candidates: a cap at
    which no frame or tile overflows, so the sharded and whole-frame runs
    compare with no re-run (phase 17 runs the dense frame's re-run at the
    65,536 bucket itself)."""
    return -(-max(n, 1) // 1024) * 1024


def _tile_kernels(det, banks, tile: np.ndarray, cap: int, plan,
                  launches: dict, path: str, card: str) -> list:
    """The kernels of a tile of the spatial path against their twins,
    bitwise, at the tile's shapes: the frontend at both levels, coarse.cu
    (and chain.cu when the tile has a plan) at the coarse level, the
    window at level 0 on the tile's candidates at `cap`. One timed record
    each (the frontend's at level 0)."""
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.cuda.chain import (
        chain_scores, chain_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_scores, coarse_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows, refine_windows_plain)
    from shape_based_matching_tpu_torch.ops.cuda.pyramid import pyr_down
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold, coarse_extract)
    from shape_based_matching_tpu_torch.ops.window import window_origin

    dev = torch.device(DEVICE)
    weak = det.weak_threshold
    full = torch.from_numpy(tile[None]).to(dev)
    half = pyr_down(full)
    fe0 = (full, weak, T_LEVELS[0])
    fe1 = (half, weak, T_LEVELS[1])
    fe_err = _max_abs_err([(quant_spread(*a), quant_spread_plain(*a))
                           for a in (fe0, fe1)])
    lms = _batch_pyramid(full, det.T_at_level, det.pyramid_levels, weak)
    sizes = det._level_sizes(tile.shape)
    T1, (w1, h1) = T_LEVELS[1], sizes[1]
    W1, H1 = w1 // T1, h1 // T1
    M1 = W1 * H1
    thr = torch.full((), THRESHOLD, dtype=torch.float32, device=dev)
    off = _flat_offsets(banks[1], T1, W1, M1, sizes[1])
    pos = _positions(banks[1], T1, W1, H1)
    rmin, _ = _rmin_for_threshold(banks[1].nfeat, thr)
    k2 = (lms[1], off, pos, rmin, M1)
    co_err = _max_abs_err(zip(coarse_scores(*k2), coarse_scores_plain(*k2)))
    k, x, y, _, valid, _ = coarse_extract(lms[1], banks[1], T1, sizes[1],
                                          thr, cap, plan)
    wx, wy = window_origin(banks[0].width, banks[0].height, T_LEVELS[0],
                           sizes[0], k, x, y)
    k3 = (lms[0], banks[0], T_LEVELS[0], sizes[0], k, wx, wy, valid)
    wi_err = _max_abs_err(zip(refine_windows(*k3), refine_windows_plain(*k3)))
    K, N = off.shape
    rows = [
        (quant_spread, "frontend.cu", "frontend_pallas.py:108", fe_err,
         lambda: quant_spread(*fe0), lambda: quant_spread_plain(*fe0),
         f"tile {tile.shape[0]}x{tile.shape[1]} T=4",
         _frontend_work(1, tile.shape[0], tile.shape[1], 1, 8, T_LEVELS[0],
                        False, False)),
        (coarse_scores, "coarse.cu", "similarity_pallas.py:55", co_err,
         lambda: coarse_scores(*k2), lambda: coarse_scores_plain(*k2),
         f"tile K={K} N={N} M={M1}", _coarse_work(lms[1], off, M1, True)),
        (refine_windows, "refine.cu", "refine_pallas.py:67", wi_err,
         lambda: refine_windows(*k3), lambda: refine_windows_plain(*k3),
         f"tile C={cap} N={banks[0].fx.shape[1]} ({int(valid.sum())} live)",
         _refine_work(lms[0], banks[0], k, valid)),
    ]
    if plan is not None:
        ch = (lms[1], plan, pos, rmin)
        ch_err = _max_abs_err(zip(chain_scores(*ch), chain_scores_plain(*ch)))
        rows.append((chain_scores, "chain.cu", "similarity_pallas.py:973",
                     ch_err, lambda: chain_scores(*ch),
                     lambda: chain_scores_plain(*ch),
                     f"tile K={K} M={M1}",
                     _chain_work(lms[1], plan, K, M1)))
    records = []
    for fn, src, replaces, err, kern, plain, shape, work in rows:
        if err:
            raise AssertionError(f"{path}: {fn.__name__} disagrees with its "
                                 f"twin at {shape}: max_abs_err {err}")
        ms = _time_ms(kern, 10)
        plain_ms = _time_ms(plain, 2)
        records.append(_record(fn, src, replaces, err, launches, path, ms,
                               plain_ms, work, shape))
        print(f"time {fn.__name__} [{path}, {shape}]: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound "
              f"{records[-1]['bound_ms']:.4f} ms "
              f"({records[-1]['bound_by']}), equal to its twin, on {card}")
    return records


def sharded_phase(trained: dict, card: str) -> tuple[list, dict]:
    """Phase 15: the sharded paths (``parallel/``) at full width on one
    card, every mesh's shards round-robin on it, each path held to the
    port's single-device result (which earlier phases hold to the JAX
    goldens), with the launch counters zeroed before and read after each.

    1. Spatial: the 4096^2 frame (``synthetic.huge_frame``) on 4 tiles
       with the default halo, on rot1000x63 and rot10000x63 (the planner's
       decision at the tile's coarse size recorded), threshold 85, at a
       cap that holds every tile's candidates (no
       tile may overflow): equal to the whole frame's ``Detector.match``
       (rot1000x63) or ``match_batch``'s first step at a cap that holds
       every candidate (rot10000x63: ``match``'s re-run at the 65,536
       bucket is phase 17's).
       Caps are the smallest multiple of 1024 that holds the candidates
       (``_cap_holding``). The
       tile's kernels against their twins (``_tile_kernels``). Timed:
       whole frame, 2 and 4 tiles (rot1000x63), whole frame and 4 tiles
       (rot10000x63), with each call's peak device memory.
    2. Mesh: the 8 flagship frames (seeds 3-10) on rot1000x63 over
       meshes (1, 4), (2, 2) and (4, 1), and rot10000x63 over (1, 4)
       with a chain plan per slice where the planner engages, at a cap
       that holds every candidate: each frame's list equal to its own
       ``Detector.match``; frames/s of each mesh and of single-device
       ``match_batch``.
    3. Training: phase 10's 64-frame sweep (gray masked, BGR) through
       ``add_templates_sharded`` on 4 shards equal to ``add_templates``.
    4. Production: rot1000x128 on seeds 7-14 through
       ``multichip_refine_step`` on 4 shards equal to per-frame
       ``match_refine_batch`` bit for bit.
    5. ``cli match --spatial-shards 4`` on the 4096^2 frame as a PNG
       prints the lines of ``cli match``; the four examples run.
    On one card the shards run one after another: every time here is a
    one-card time."""
    import io
    import shutil
    import tempfile
    import warnings
    from functools import partial

    from shape_based_matching_tpu_torch import Detector, match_refine_batch
    from shape_based_matching_tpu_torch.examples import (
        deployment_loop, multichip_match, streaming_match,
        train_rotation_bank)
    from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread)
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows)
    from shape_based_matching_tpu_torch.parallel import mesh as pm
    from shape_based_matching_tpu_torch.parallel import spatial as ps
    from shape_based_matching_tpu_torch.utils.imageio import save_image
    from shape_based_matching_tpu_torch.utils.synthetic import (
        huge_frame, synthetic_shape_image)

    kernels = (quant_spread, coarse_scores, chain_scores, refine_windows,
               coarse_maps, map_refine)

    def launched(launches: dict, need: set, what: str) -> None:
        if not all(launches[n] for n in need):
            raise AssertionError(f"{what}: a kernel of {sorted(need)} was "
                                 f"not launched: {launches}")

    def detector(snap: str):
        det = Detector(num_features=63, T=T_LEVELS, device=DEVICE)
        det.class_templates["bench"] = trained[snap].class_templates["bench"]
        return det

    def n_above_whole(det, frames: np.ndarray) -> int:
        """The most candidates of any frame for the whole bank."""
        lms, sizes, thr, _ = det._prepare(frames, None, THRESHOLD,
                                          ["bench"])
        return int(det._step(lms, "bench", thr, sizes, 256)[5].max())

    records, report = [], {}
    frame = huge_frame(HUGE, HUGE_EDGES)

    # 1. spatial
    report["spatial"] = {}
    for snap in ("rot1000x63", "rot10000x63"):
        det = detector(snap)
        banks = det._get_banks("bench")
        cache = partial(det._shard_cached, "bench")
        halo = ps.default_halo(banks, T_LEVELS)
        out = {"halo": halo}
        for n in ((2, SHARDS) if snap == "rot1000x63" else (SHARDS,)):
            m = ps.make_spatial_mesh(n)
            tile_h = HUGE // n + 2 * halo
            t0 = time.perf_counter()
            chains = pm.shard_chains(m, banks[-1], T_LEVELS[-1],
                                     (HUGE // 2, tile_h // 2), 8, False,
                                     cache)
            plan_s = time.perf_counter() - t0
            step = ps.spatial_match_step(m, T_LEVELS, (HUGE, HUGE), n, halo)
            tiles = ps.slice_tiles(frame, n, halo)
            n_above = step(tiles, det.weak_threshold, THRESHOLD,
                           pm.shard_banks(m, banks, False, cache),
                           chains)[5].tolist()
            cap = _cap_holding(max(n_above))
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # no tile may overflow
                got, launches = _counted(
                    kernels, lambda: ps.match_huge_frame(
                        det, frame, THRESHOLD, mesh=m, cand_cap=cap))
            launched(launches, {"quant_spread", "refine_windows",
                                "chain_scores" if chains is not None
                                else "coarse_scores"}, f"spatial {snap}")
            ms = _host_ms(lambda: ps.match_huge_frame(
                det, frame, THRESHOLD, mesh=m, cand_cap=cap), 3)
            gb = _peak_gb(lambda: ps.match_huge_frame(
                det, frame, THRESHOLD, mesh=m, cand_cap=cap))
            out[f"{n}_shards"] = {
                "tile_h": tile_h, "n_above": n_above, "cap": cap,
                "chain": chains is not None, "plan_s": plan_s,
                "launches": launches, "ms": ms, "peak_gb": gb,
                "matches": len(got)}
            if n == SHARDS:
                tile_got, tile_launches = got, launches
                tile_cap, tile_plan = cap, (None if chains is None
                                            else chains[1])
        n_whole = n_above_whole(det, frame[None])
        if snap == "rot1000x63":
            def whole():
                return det.match(frame, THRESHOLD)
        else:
            whole_cap = _cap_holding(n_whole)

            def whole():
                return det.match_batch(frame[None], THRESHOLD, ["bench"],
                                       cand_cap=whole_cap)[0]
        want = whole()
        if not want or _keys(tile_got) != _keys(want):
            raise AssertionError(f"spatial {snap}: the 4 tiles' list "
                                 f"({len(tile_got)}) differs from the whole "
                                 f"frame's ({len(want)})")
        out["whole"] = {"n_above": n_whole, "ms": _host_ms(whole, 3),
                        "peak_gb": _peak_gb(whole), "matches": len(want)}
        records += _tile_kernels(
            det, banks, ps.slice_tiles(frame, SHARDS, halo)[1], tile_cap,
            tile_plan, tile_launches, f"spatial 4096^2 {snap}", card)
        shards = "; ".join(
            f"{n} tiles of {o['tile_h']} rows {o['ms']:.4f} ms, peak "
            f"{o['peak_gb']:.2f} GB (n_above per tile {o['n_above']}, cap "
            f"{o['cap']}, chain {'engaged' if o['chain'] else 'declined'})"
            for n, o in ((n, out[f"{n}_shards"]) for n in (2, SHARDS)
                         if f"{n}_shards" in out))
        print(f"spatial {snap} 4096^2 (halo {halo}): the 4 tiles' list "
              f"equals the whole frame's ({len(want)} matches, n_above "
              f"{n_whole}); whole frame {out['whole']['ms']:.4f} ms, peak "
              f"{out['whole']['peak_gb']:.2f} GB; {shards}; launches "
              f"{tile_launches}; one card ({card})")
        report["spatial"][snap] = out

    # 2. the data x templ mesh
    golden = json.load(open(GOLDEN))
    cfg = golden["config"]
    batch = np.stack([_scene({**cfg, "scene_seed": cfg["scene_seed"] + i})
                      for i in range(BATCH)])
    report["mesh"] = {}
    for snap, shapes in (("rot1000x63", MESH_SHAPES),
                         ("rot10000x63", ((1, SHARDS),))):
        det = detector(snap)
        single = [_keys(det.match(f, THRESHOLD)) for f in batch]
        cap = _cap_holding(n_above_whole(det, batch))
        b8_ms = _host_ms(lambda: det.match_batch(batch, THRESHOLD), 3)
        out = {"cap": cap, "single_b8_fps": BATCH * 1e3 / b8_ms}
        for data, templ in shapes:
            m = pm.make_mesh(data * templ, data=data)
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                got, launches = _counted(
                    kernels, lambda: pm.match_images_sharded(
                        det, batch, THRESHOLD, mesh=m, cand_cap=cap))
            plans = det._sharded.get(("bench", "plans", templ,
                                      (batch.shape[2] // 2,
                                       batch.shape[1] // 2)))
            launched(launches, {"quant_spread", "refine_windows",
                                "chain_scores" if plans is not None
                                else "coarse_scores"},
                     f"mesh {snap} {data}x{templ}")
            if [_keys(g) for g in got] != single:
                raise AssertionError(f"mesh {snap} {data}x{templ}: a "
                                     f"frame's list differs from its match")
            ms = _host_ms(lambda: pm.match_images_sharded(
                det, batch, THRESHOLD, mesh=m, cand_cap=cap), 3)
            out[f"{data}x{templ}"] = {"fps": BATCH * 1e3 / ms,
                                      "chain": plans is not None,
                                      "launches": launches}
            print(f"mesh {snap} {data}x{templ}: 8 frames equal their "
                  f"single-device lists ({sum(map(len, single))} matches, "
                  f"cap {cap}, chain "
                  f"{'engaged' if plans is not None else 'declined'}); "
                  f"{BATCH * 1e3 / ms:.1f} frames/s against "
                  f"{out['single_b8_fps']:.1f} single-device B=8; launches "
                  f"{launches}; one card ({card})")
        report["mesh"][snap] = out

    # 3. training
    gray = np.stack([synthetic_shape_image(256, s) for s in range(64)])
    masks = np.stack([(np.random.RandomState(s).rand(256, 256) > 0.1)
                      .astype(np.uint8) * 255 for s in range(64)])
    report["train"] = {}
    for mode, frames, msk in (("gray masked", gray, masks),
                              ("bgr", _bgr(gray), None)):
        local = Detector(num_features=63, T=T_LEVELS, device=DEVICE)
        t0 = time.perf_counter()
        ids = local.add_templates(frames, "c", msk)
        t1 = time.perf_counter()
        shard = Detector(num_features=63, T=T_LEVELS, device=DEVICE)
        got = pm.add_templates_sharded(shard, frames, "c", msk,
                                       mesh=pm.make_mesh(SHARDS))
        t2 = time.perf_counter()
        if got != ids or _fields(shard.class_templates["c"]) != _fields(
                local.class_templates["c"]):
            raise AssertionError(f"sharded training {mode}: differs from "
                                 f"add_templates")
        report["train"][mode] = {"fps_local": 64 / (t1 - t0),
                                 "fps_sharded": 64 / (t2 - t1)}
        print(f"train {mode}: add_templates_sharded on {SHARDS} shards "
              f"equals add_templates on 64 frames (theta bits included): "
              f"{64 / (t2 - t1):.1f} frames/s against {64 / (t1 - t0):.1f}; "
              f"one card ({card})")

    # 4. the production tier
    det = detector("rot1000x128")
    banks = det._get_banks("bench")
    cache = partial(det._shard_cached, "bench")
    frames = np.stack([_scene({**cfg, "scene_seed": s})
                       for s in PRODUCTION_SEEDS])
    m = pm.make_mesh(SHARDS)
    step = pm.multichip_refine_step(m, T_LEVELS, frames.shape[1:],
                                    cand_cap=256, top_c=32, iters=12,
                                    radius=8)
    placed = pm.shard_banks(m, banks, False, cache)
    chains = pm.shard_chains(m, banks[-1], T_LEVELS[-1],
                             (frames.shape[2] // 2, frames.shape[1] // 2), 8,
                             False, cache)

    def tier():
        return step(frames, det.weak_threshold, THRESHOLD, placed, chains)

    def per_frame():
        return [match_refine_batch(det, frames[b:b + 1], THRESHOLD, top_c=32,
                                   iters=12, radius=8, cand_cap=256)
                ["bench"][0] for b in range(len(frames))]

    got, launches = _counted(kernels, tier)
    launched(launches, {"quant_spread", "coarse_scores", "refine_windows"},
             "production tier")
    for b, r in enumerate(per_frame()):
        for i, (g, w) in enumerate(zip(got, [*r["icp"], r["k"], r["x"],
                                             r["y"], r["score"]])):
            if w.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g[b], w):
                raise AssertionError(f"production tier: frame {b} output "
                                     f"{i} differs from match_refine_batch")
    tier_ms, loop_ms = _host_ms(tier, 3), _host_ms(per_frame, 3)
    report["production"] = {"ms": tier_ms, "per_frame_ms": loop_ms,
                            "refined": int(got[6].sum()),
                            "launches": launches}
    print(f"production tier on {SHARDS} shards: seeds 7-14 equal per-frame "
          f"match_refine_batch bit for bit ({int(got[6].sum())} refined); "
          f"{tier_ms / len(frames):.4f} ms a frame against "
          f"{loop_ms / len(frames):.4f} one frame at a time; launches "
          f"{launches}; one card ({card})")

    # 5. the CLI and the examples
    tmp = tempfile.mkdtemp(prefix="sbm_sharded_")
    try:
        det = detector("rot1000x63")
        reg = os.path.join(tmp, "registry")
        os.makedirs(os.path.join(tmp, "frames"))
        det.write_classes(os.path.join(reg, "%s.yaml.gz"))
        det.save_settings(os.path.join(reg, "detector_linemod.yaml"),
                          templates_dir=reg, classes=["bench"])
        _registry(["bench"], reg)
        save_image(frame, os.path.join(tmp, "frames", "huge.png"))
        argv = ["--device", DEVICE, "match", "--model-dir", reg,
                "--test-dir", os.path.join(tmp, "frames"), "--threshold",
                str(THRESHOLD), "--nms", "0.5", "--top-k", "1000", "--gray"]
        single, single_s = _cli(argv)
        (sharded, sharded_s), launches = _counted(
            kernels, lambda: _cli(argv + ["--spatial-shards", str(SHARDS)]))
        launched(launches, {"quant_spread", "coarse_scores",
                            "refine_windows"}, "cli --spatial-shards")
        if _parse_match(sharded)[0] != _parse_match(single)[0]:
            raise AssertionError("cli match --spatial-shards 4 prints other "
                                 "lines than cli match")
        print(f"cli match --spatial-shards {SHARDS} on the 4096^2 PNG prints "
              f"the lines of cli match ({len(single)} lines; "
              f"{sharded_s:.1f} s and {single_s:.1f} s a process call); "
              f"launches {launches}")
        report["cli"] = {"lines": len(single), "sharded_s": sharded_s,
                         "single_s": single_s, "launches": launches}

        def examples():
            out = {}
            for name, run in (
                    ("train_rotation_bank", lambda: train_rotation_bank.main(
                        os.path.join(tmp, "bank"), device=DEVICE)),
                    ("streaming_match", lambda: streaming_match.main(
                        2, device=DEVICE)),
                    ("deployment_loop", lambda: deployment_loop.main(
                        3, device=DEVICE)),
                    ("multichip_match", lambda: multichip_match.main(
                        SHARDS, device=DEVICE))):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    run()
                out[name] = buf.getvalue().splitlines()
            return out

        lines, launches = _counted(kernels, examples)
        launched(launches, {"quant_spread", "coarse_scores",
                            "refine_windows"}, "examples")
        for name, ls in lines.items():
            for line in ls:
                print(f"example {name}: {line}")
        report["examples"] = {"lines": lines, "launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return records, report


# phase 16: the port against its copy of the scalar oracle
# (shape_based_matching_tpu_torch/oracle/reference.py): golden name of each
# path that Detector.match runs against oracle.match_class, and of each
# bank held to oracle.similarity at the score level alone
ORACLE_MATCH_PATHS = ("e2e1000", "wide1000x128", "masked360",
                      "e2e360_16ori", "color1000")
ORACLE_SCORE_PATHS = ("e2e10000", "wide1000x256", "wide8191")
FUZZ_LOW_THRESHOLD = 20.0  # tests/test_torch_fuzz_parity.py's


def _launched(launches: dict, names, what: str) -> None:
    if not all(launches[n] for n in names):
        raise AssertionError(f"{what}: a kernel was not launched: "
                             f"{launches}")


def _oracle_line(what: str, n: int, unit: str, oracle_s: float,
                 card_s: float, extra: str = "") -> dict:
    print(f"oracle {what}: equal, {n} {unit}, host oracle {oracle_s:.2f} s, "
          f"card {card_s:.3f} s{extra}")
    return {"equal": True, unit: n, "oracle_s": oracle_s, "card_s": card_s}


def _lm_check(lmflats: tuple, lms: list, what: str) -> int:
    """The card's flat linear memories of one frame, level by level,
    against the oracle's [n_ori, T*T, M] (and the zero tail). Returns the
    bytes compared."""
    n = 0
    for l, (flat, lm) in enumerate(zip(lmflats, lms)):
        host = flat[0].cpu().numpy()
        want = np.concatenate([lm.reshape(-1),
                               np.zeros(lm.shape[-1], np.uint8)])
        if not np.array_equal(host, want):
            raise AssertionError(f"{what}: level {l} linear memories "
                                 f"differ from the oracle's")
        n += host.size
    return n


def _score_check(det, cid: str, lmflat, lm, size, threshold: float,
                 what: str) -> dict:
    """Every template's coarse scores on the card (chain.cu when the class
    has a chain plan at this size, else coarse.cu) against
    oracle.similarity over the cells the oracle scores (j < positions),
    and each live count against the oracle's cells at or above rmin."""
    from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
    from shape_based_matching_tpu_torch.ops.cuda.coarse import coarse_scores
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold)
    from shape_based_matching_tpu_torch.oracle import reference as oracle
    from tests.torch_fuzz import oracle_tps

    bank = det._get_banks(cid)[-1]
    T = det.T_at_level[-1]
    W, H = size[0] // T, size[1] // T
    M = W * H
    pos = _positions(bank, T, W, H)
    thr = torch.full((), threshold, dtype=torch.float32, device=DEVICE)
    rmin, _ = _rmin_for_threshold(bank.nfeat, thr)
    plan = det._get_chain(cid, size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if plan is not None:
        S, cnt = chain_scores(lmflat, plan, pos, rmin)
    else:
        S, cnt = coarse_scores(lmflat, _flat_offsets(
            bank, T, W, M, size, det.num_orientations), pos, rmin, M)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    S, cnt = S[0].cpu().numpy(), cnt[0].cpu().numpy()
    pos, rmin = pos.cpu().numpy(), rmin.cpu().numpy()
    t0 = time.perf_counter()
    cells = 0
    for k, tp in enumerate(oracle_tps(det, cid)):
        t = tp[-1]
        p = min(int(pos[k]), M)
        if p <= 0:  # larger than the frame: no cell (the oracle's slice
            if cnt[k]:  # arithmetic takes no such template)
                raise AssertionError(f"{what}: template {k} has no "
                                     f"position but counts {cnt[k]}")
            continue
        want = oracle.similarity(lm, t["features"],
                                 (t["width"], t["height"]), size,
                                 T).reshape(-1).astype(np.int64)
        if not np.array_equal(S[k, :p], want[:p]) or \
                int(cnt[k]) != int((want[:p] >= rmin[k]).sum()):
            raise AssertionError(f"{what}: template {k}'s scores or live "
                                 f"count differ from oracle.similarity")
        cells += p
    route = "chain.cu" if plan is not None else "coarse.cu"
    return _oracle_line(f"{what} scores ({route}, K={S.shape[0]}, "
                        f"N={bank.fx.shape[1]})", cells, "cells",
                        time.perf_counter() - t0, card_s)


def oracle_phase(card: str) -> dict:
    """Phase 16: the port on the card against its copy of the scalar
    oracle (``oracle/reference.py``), independent of the JAX goldens.

    1. ``Detector.match`` against ``oracle.match_class`` as distinct
       (template, x, y, float32 bits) sets on the flagship (rows 1, 3, 8;
       its re-run at cap 1024 takes the map route, rows 4 and 9),
       wide1000x128, masked360, e2e360_16ori and color1000; on each path
       the card's linear memories at both levels and every template's
       coarse scores and live counts against the oracle's, and on the
       flagship the frontend's spread planes at both levels.
    2. At the score level alone: the dense 10,000-template bank's
       chain.cu scores and counts on the flagship frame (rows 6-7), and
       coarse.cu's wide route on 1000 x 142 and 8 x 3073 coarse slots
       (row 5), against oracle.similarity for every template.
    3. ``tests/test_fuzz_parity.py``'s eight randomized scenes and its
       merged three-class case on the card against ``match_class``.
    Any inequality raises. Prints one line per check: equal, the matches
    or cells compared, the host oracle's seconds and the card's (host
    clock around the synchronized card work)."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import _batch_pyramid
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import quant_spread
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import map_refine
    from shape_based_matching_tpu_torch.ops.cuda.refine import refine_windows
    from shape_based_matching_tpu_torch.ops.response import to_i32
    from shape_based_matching_tpu_torch.oracle import reference as oracle
    from tests import torch_fuzz

    dev = torch.device(DEVICE)
    kernels = (quant_spread, coarse_scores, refine_windows, coarse_maps,
               map_refine)
    out = {}
    t_phase = time.perf_counter()
    for name in ORACLE_MATCH_PATHS + ORACLE_SCORE_PATHS:
        kwargs, cid, pyramids, frame, mask, threshold, _ = _mode_path(name)
        det = Detector(**kwargs, device=DEVICE)
        det.class_templates[cid] = pyramids
        n_ori, T = det.num_orientations, det.T_at_level
        frames, masks = _upload(frame, mask, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lmflats = _batch_pyramid(frames, T, det.pyramid_levels,
                                 det.weak_threshold, n_ori, masks)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lms, sizes = oracle.build_lm_pyramid(frame, det.weak_threshold, T,
                                             n_ori=n_ori, mask=mask)
        pyr_s = time.perf_counter() - t0
        out[f"{name}_lm"] = _oracle_line(
            f"{name} linear memories (frontend.cu, both levels)",
            _lm_check(lmflats, lms, name), "bytes", pyr_s, card_s)
        out[f"{name}_scores"] = _score_check(det, cid, lmflats[-1], lms[-1],
                                             sizes[-1], threshold, name)
        if name == "e2e1000":  # the frontend's spread planes, rows 1-2
            img, t_sp, card_s = frame, 0.0, 0.0
            for l, T_l in enumerate(T):
                if l:
                    img = oracle.pyr_down_u8(img)
                t0 = time.perf_counter()
                want = oracle.spread(oracle.quantized_orientations(
                    img, det.weak_threshold, n_ori)[1], T_l)
                t_sp += time.perf_counter() - t0
                level = _upload(img, None, dev)[0]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = quant_spread(level, det.weak_threshold, T_l, n_ori)
                torch.cuda.synchronize()
                card_s += time.perf_counter() - t0
                if not np.array_equal(
                        to_i32(got[0]).cpu().numpy().astype(want.dtype),
                        want):
                    raise AssertionError(f"{name}: level {l} spread plane "
                                         f"differs from the oracle's")
            out["e2e1000_spread"] = _oracle_line(
                f"{name} spread planes (frontend.cu, 1024^2 T=4, 512^2 T=8)",
                frame.size + img.size, "pixels", t_sp, card_s)
        if name not in ORACLE_MATCH_PATHS:
            continue
        for fn in kernels:
            fn.launches = 0
        det.counters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = det.match(frame, threshold, mask=mask)
        card_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in kernels}
        t0 = time.perf_counter()
        want = torch_fuzz.oracle_matches(det, (lms, sizes), threshold)
        oracle_s = time.perf_counter() - t0
        got_set = torch_fuzz.port_keys(got)
        want_set = torch_fuzz.oracle_keys(want)
        if got_set != want_set:
            raise AssertionError(
                f"{name}: Detector.match differs from oracle.match_class: "
                f"{len(got_set)} vs {len(want_set)} matches, "
                f"{sorted(set(got_set) ^ set(want_set))[:5]}")
        _launched(launches, ("quant_spread", "coarse_scores")
                  + (("coarse_maps", "map_refine") if name == "e2e1000"
                     else ()), name)
        if name == "e2e1000" and not det.counters["refine.maps"]:
            raise AssertionError("e2e1000: the re-run did not take the map "
                                 "route")
        out[name] = _oracle_line(
            f"{name} Detector.match vs match_class", len(got_set),
            "matches", oracle_s, card_s,
            f" (oracle list {len(want)}, launches {launches}, refine "
            f"routes {_routes(det)})")
    for seed, variant in torch_fuzz.FUZZ_CASES + ((77, "merged"),):
        if variant == "merged":
            det, scene = torch_fuzz.merged_case(DEVICE)
            mask, threshold, cids = None, torch_fuzz.MERGED_THRESHOLD, None
        else:
            det, scene, mask, threshold = torch_fuzz.fuzz_case(seed, variant,
                                                               DEVICE)
            cids = ["fuzz"]
        t0 = time.perf_counter()
        pyramid = torch_fuzz.oracle_pyramid(det, scene, mask)
        pyr_s = time.perf_counter() - t0
        # the case's threshold, and 20: every list non-empty, re-runs
        for thr in (threshold, FUZZ_LOW_THRESHOLD):
            for fn in kernels:
                fn.launches = 0
            t0 = time.perf_counter()
            got = torch_fuzz.port_keys(det.match(scene, thr, cids,
                                                 mask=mask))
            card_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in kernels}
            t0 = time.perf_counter()
            want = torch_fuzz.oracle_keys(torch_fuzz.oracle_matches(
                det, pyramid, thr, cids))
            oracle_s = time.perf_counter() - t0 + pyr_s
            if got != want:
                raise AssertionError(f"fuzz {seed} {variant} thr {thr}: "
                                     f"Detector.match differs from "
                                     f"oracle.match_class")
            _launched(launches, ("quant_spread", "coarse_scores"),
                      f"fuzz {seed} {variant}")
            out[f"fuzz_{seed}_{variant}_{thr:g}"] = _oracle_line(
                f"fuzz {seed} {variant} {scene.shape[:2]} thr {thr}",
                len(got), "matches", oracle_s, card_s,
                f" (launches {launches})")
            pyr_s = 0.0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"oracle phase: every check equal on {card}")
    return out


def _extract_work(args: tuple, out: tuple, meta: torch.Tensor):
    """extract_kernel: each template's S row up to its last taken live cell
    (from the slots' ranks: a slot below the template's live count is a
    live cell), the listed templates' work records (32 bytes each) and
    the frames' meta words read once, 17 bytes a slot written once; a
    compare and a ballot per walked cell and about 20 operations a slot.
    The counts, the [K] inputs and n_above are the prefix kernel's."""
    from shape_based_matching_tpu_torch.ops.cuda.extract import _prefix

    S, cnt, pos, rmin, _, T, W, C = args
    B, K, M = S.shape
    k, x, y, _, _, _ = out
    bcnt, incl = _prefix(cnt, pos, rmin, M)
    excl = incl - bcnt
    kk = k.long()
    r = torch.arange(C, device=S.device)[None] - excl.gather(1, kk)
    live = r < cnt.gather(1, kk)
    off = T // 2 + (T % 2 - 1)
    jj = torch.div(y - off, T, rounding_mode="floor") * W \
        + torch.div(x - off, T, rounding_mode="floor")
    row = (torch.arange(B, device=S.device)[:, None] * K + kk)[live]
    walked = torch.zeros(B * K, dtype=torch.int64, device=S.device) \
        .scatter_reduce(0, row, (jj[live] + 1).long(), "amax")
    cells = int(walked.sum())
    listed = int(meta[:, 0].sum())
    return (cells * 4 + listed * 32 + B * 8 + B * C * 17,
            cells * 2 + B * C * 20)


def _prefix_work(args: tuple, work: torch.Tensor, meta: torch.Tensor):
    """prefix_kernel: cnt, positions and rmin read once, t4n of the listed
    templates (each distinct template once); n_above, the 32-byte work
    records, the meta words and, where rows have more than one segment,
    L look-back words a listed template written once; about 20
    operations a template and frame."""
    from shape_based_matching_tpu_torch.ops.cuda.extract import _levels

    S = args[0]
    B, K, M = S.shape
    n = meta[:, 0].tolist()
    listed = sum(n)
    distinct = torch.cat([work[b, :nb, 0] for b, nb in enumerate(n)]) \
        .unique().numel() if listed else 0
    L = _levels(M)
    return (B * K * 4 + K * 8 + distinct * 4 + B * 4
            + listed * (32 + (4 * L if L > 1 else 0)) + B * 8, B * K * 20)


def _kernels_a_call(fn) -> tuple[float, dict, dict]:
    """Device work a call of `fn` queues (kernels, memsets and copies: the
    host-side CUDA calls that torch.profiler records over CALLS calls,
    ``utils/profiling.device_work``), and each recorded device kernel's
    mean device ms and events, by name. The device-side records can miss
    a window's first kernels, the host-side ones do not. Raises where the
    profiler records no device kernel."""
    from shape_based_matching_tpu_torch.utils.profiling import (
        CALLS, device_work)

    queued, kern = device_work(fn)
    if not kern:
        raise AssertionError("torch.profiler recorded no device kernel")
    events: dict = {}
    for name, ms in kern:
        name = name.split("(", 1)[0] if not name.startswith("(") \
            else name.split("::", 1)[1].split("(", 1)[0]
        events.setdefault(name, []).append(ms)
    return (queued / CALLS, {n: sum(v) / len(v) for n, v in events.items()},
            {n: len(v) for n, v in events.items()})


# phase 17: the single-device overflow re-run at the 65,536 bucket, and
# extract.cu against its twin. EXTRACT_CHECKS are shapes off the re-runs'
# path: (label, class snapshot or mode path, frames, threshold, cap);
# "flagship" is the e2e1000 frame, "batch" its 8 seeds
EXTRACT_CHECKS = (
    ("flagship step", "rot1000x63", "flagship", THRESHOLD, 256),
    ("flagship re-run", "rot1000x63", "flagship", THRESHOLD, 1024),
    ("quirk (threshold -5)", "rot1000x63", "flagship", -5.0, 4096),
    (f"flagship B={BATCH}", "rot1000x63", "batch", THRESHOLD, 256),
    ("dense 1024^2 (chain rows)", "rot10000x63", "flagship", THRESHOLD,
     4096),
    ("wide1000x256 (row-5 rows)", "wide1000x256", None, None, 256),
)
# the checks at which extract.cu is also timed, and the flagship path's
# (phase 4's launches) among them
EXTRACT_TIMED = ("flagship step", f"flagship B={BATCH}", "flagship re-run",
                 "dense 1024^2 (chain rows)")
EXTRACT_FLAGSHIP = ("flagship step", f"flagship B={BATCH}",
                    "flagship re-run")
MAX_RERUN_GB = 8.0  # an overflow re-run's peak device memory, at most
# the overflow re-runs of Detector.match with rot10000x63: (label, frame,
# threshold, held to phase 15's tiles, more distinct candidate templates
# than one slab). The 4096^2 frame has 16,460 candidates over 661
# templates at 85 and 88,074 over 3,752 at 60 (past the 65,536 bucket:
# cap = n_above); the flagship frame 19,008 over 2,755 at 60 (chain rows).
# extract.cu is timed at the 4096^2 re-runs' caps
OVERFLOW_RUNS = (("4096^2 rot10000x63", "huge", THRESHOLD, True, False),
                 ("4096^2 rot10000x63 at 60", "huge", 60.0, False, True),
                 ("1024^2 rot10000x63 at 60", "flagship", 60.0, False, True))
OVERFLOW_TIMED = tuple(r[0] for r in OVERFLOW_RUNS[:2])


def _extract_err(got, want) -> float:
    """max_abs_err of extract_counted's six outputs against the twin's:
    the integers and n_above exactly, the score bit for bit (NaN where
    the twin's is NaN)."""
    return max(_refine_err(got[:5], want[:5]),
               _max_abs_err([(got[5], want[5])]))


def overflow_phase(trained: dict, card: str, tiles_matches: int | None,
                   path_launches: dict | None = None) -> tuple[list, dict]:
    """Phase 17: the overflow re-run's memory (ROADMAP C.1) and the
    extraction's two kernels.

    1. extract.cu against its twin, every output of every slot, at
       ``EXTRACT_CHECKS``' shapes: the flagship's first step (cap 256)
       and its re-run (cap 1024), the quirk cells (threshold -5: at 0
       rmin is 1 and no cell is a quirk cell), B=8 frames that overflow,
       the dense bank's chain rows at 1024^2 (cap 4096) and the
       wide1000x256 bank's row-5 rows; each call is the prefix kernel and
       the extraction, one launch each.
    2. ``Detector.match`` with rot10000x63 at the default cap on
       ``OVERFLOW_RUNS``: phase 15's 4096^2 frame at threshold 85 and at
       60, and the flagship frame at 60. Each overflows 256 and re-runs
       at the 65,536 bucket (at 4096^2 and 60, past it: cap = n_above)
       through the map route, its level maps built in slabs of at most
       ``_MAP_SLAB`` templates. extract.cu is first held to its twin on
       the run's own S at every cap the run uses: the first step's 256,
       the re-run's, and the cap that holds every candidate. The
       kernels' counts are zeroed just before the match and read just
       after (one map build and one map refine a slab); the list must
       equal the one at ``_cap_holding(n_above)`` with no re-run (and,
       at 4096^2 and 85, phase 15's 4 tiles' count), and the re-run's
       peak device memory must stay under ``MAX_RERUN_GB``. Peak GB and
       ms of both runs, the re-run cap, n_distinct, D, the slabs and the
       planner's decision are printed.
    3. The extraction's records at ``EXTRACT_TIMED``' shapes and the
       4096^2 re-runs' caps (65,536 at 85; n_above at 60): the whole
       ``extract_counted`` call and ``count_prefix`` alone (CUDA events,
       queued calls), each kernel's device ms and the device kernels a
       call (torch.profiler), the twins, bounds and shares; the device
       kernels of one ``coarse_extract`` call on the flagship; and, as a
       yardstick the port never calls, ``torch.nonzero`` on the 4096^2
       frame's precomputed [B, K, M] live mask (CUB's stream compaction
       of the same cells)."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import _CAND_BUCKETS
    from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.extract import (
        _prefix, count_prefix, count_prefix_plain, extract_counted,
        extract_counted_plain)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import quant_spread
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import map_refine
    from shape_based_matching_tpu_torch.ops.cuda.refine import refine_windows
    from shape_based_matching_tpu_torch.ops.similarity import (
        _D_BUCKETS, _MAP_SLAB, _flat_offsets, _positions,
        _rmin_for_threshold, coarse_extract, distinct_templates)
    from shape_based_matching_tpu_torch.utils.profiling import CALLS
    from shape_based_matching_tpu_torch.utils.synthetic import huge_frame

    golden = json.load(open(GOLDEN))
    cfg = golden["config"]
    scene = _scene(cfg)
    frames = {"flagship": scene[None],
              "huge": huge_frame(HUGE, HUGE_EDGES)[None],
              "batch": np.stack([_scene({**cfg, "scene_seed":
                                         cfg["scene_seed"] + i})
                                 for i in range(BATCH)])}

    def detector(name: str):
        """(Detector, class id, frames, threshold) of a snapshot trained
        by phase 8, or of a phase-7 mode path."""
        if name in trained:
            det = Detector(num_features=63, T=T_LEVELS, device=DEVICE)
            det.class_templates["bench"] = \
                trained[name].class_templates["bench"]
            return det, "bench", None, None
        kwargs, cid, pyramids, frame, _, thr, _ = _mode_path(name)
        det = Detector(**kwargs, device=DEVICE)
        det.class_templates[cid] = pyramids
        return det, cid, frame[None], thr

    def coarse_args(det, cid: str, batch: np.ndarray, thr: float):
        """extract_counted's arguments but the cap, at the coarse level of
        `batch` (chain.cu where the planner engages, else coarse.cu), the
        largest n_above of its frames, whether the chain engaged, and
        coarse_extract's arguments but the cap."""
        lms, sizes, thr_t, _ = det._prepare(batch, None, thr, [cid])
        bank = det._get_banks(cid)[-1]
        T1, (w1, h1) = det.T_at_level[-1], sizes[-1]
        W1, H1 = w1 // T1, h1 // T1
        pos = _positions(bank, T1, W1, H1)
        rmin, t4n = _rmin_for_threshold(bank.nfeat, thr_t)
        plan = det._get_chain(cid, sizes[-1])
        if plan is not None:
            S, cnt = chain_scores(lms[-1], plan, pos, rmin)
        else:
            S, cnt = coarse_scores(lms[-1], _flat_offsets(
                bank, T1, W1, W1 * H1, sizes[-1], det.num_orientations),
                pos, rmin, W1 * H1)
        n_above = int(_prefix(cnt, pos, rmin, W1 * H1)[1][:, -1].max())
        return ((S, cnt, pos, rmin, t4n, T1, W1), n_above, plan is not None,
                (lms[-1], bank, T1, sizes[-1], thr_t))

    def check(label: str, args: tuple, chain: bool):
        """extract.cu against its twin on every output and slot, the call
        one launch of each kernel; returns the kernel's outputs."""
        before = (count_prefix.launches, extract_counted.launches)
        got = extract_counted(*args)
        torch.cuda.synchronize()
        calls = (count_prefix.launches - before[0],
                 extract_counted.launches - before[1])
        err = _extract_err(got, extract_counted_plain(*args))
        S = args[0]
        shape = (f"B={S.shape[0]} K={S.shape[1]} M={S.shape[2]} "
                 f"C={args[7]} ({'chain' if chain else 'coarse'} rows)")
        n_above = got[5].tolist()
        out["checks"][label] = {"shape": shape, "max_abs_err": err,
                                "n_above": n_above}
        print(f"extract.cu vs plain [{label}, {shape}]: max_abs_err {err} "
              f"(k, x, y, score bits, valid of every slot; n_above "
              f"{n_above}); launches (prefix, extraction) {calls}")
        if err:
            raise AssertionError(f"extract.cu disagrees with its twin at "
                                 f"{label}")
        if calls != (1, 1 if args[7] else 0):
            raise AssertionError(f"extract_counted at {label}: launches "
                                 f"(prefix, extraction) {calls}")
        return got, shape

    def timed(label: str, args: tuple, got: tuple, shape: str,
              launches: dict | None, path: str) -> list:
        """Records of extract_counted and count_prefix at one shape;
        `launches` None: the caller fills them in later."""
        S, cnt, pos, rmin, t4n, _, _, C = args
        M = S.shape[2]
        pre = (cnt, pos, rmin, t4n, M, C)
        n_kern, by_name, events = _kernels_a_call(
            lambda: extract_counted(*args))
        if n_kern != 2 or set(events) != {"prefix_kernel", "extract_kernel"}:
            raise AssertionError(f"extract_counted at {label}: {n_kern} "
                                 f"device kernels a call, recorded {events}:"
                                 f" not the prefix and the extraction alone")
        plain = count_prefix_plain(*pre)
        got_pre = count_prefix(*pre)
        work, meta = got_pre[1], got_pre[2]
        pre_err = max(_max_abs_err([(got_pre[0], plain[0]),
                                    (got_pre[2], plain[2])]),
                      max(_max_abs_err([(got_pre[1][b, :n], plain[1][b, :n])])
                          for b, n in enumerate(plain[2][:, 0].tolist())))
        if pre_err:
            raise AssertionError(f"count_prefix disagrees with its twin at "
                                 f"{label}")
        rows = []
        for fn, kname, work, kern, twin, err in (
                (extract_counted, "extract_kernel",
                 _extract_work(args, got, meta),
                 lambda: extract_counted(*args),
                 lambda: extract_counted_plain(*args), 0),
                (count_prefix, "prefix_kernel",
                 _prefix_work(args, work, meta),
                 lambda: count_prefix(*pre),
                 lambda: count_prefix_plain(*pre), pre_err)):
            ms = _time_ms(kern, 20)
            plain_ms = _time_ms(twin, 2 if fn is extract_counted else 5)
            rec = _record(fn, "extract.cu", "", err, launches or {
                fn.__name__: None}, path, ms, plain_ms, work,
                f"{label}: {shape}")
            rec["replaces"] = "shape_based_matching_tpu/ops/similarity.py:776"
            rec["device_ms"] = dev_ms = by_name[kname]
            rec["device_events"] = events[kname]
            rec["device_kernels_a_call"] = n_kern
            rows.append(rec)
            print(f"time {fn.__name__} [{label}, {shape}]: {ms:.4f} ms a "
                  f"queued call, device {dev_ms:.5f} ms (mean of "
                  f"{events[kname]} events), plain {plain_ms:.4f} ms, bound "
                  f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}), share "
                  f"{rec['bound_ms'] / ms:.3f} of the call, "
                  f"{rec['bound_ms'] / dev_ms:.3f} of the device time; "
                  f"{n_kern} device kernels a call on {card}")
        out["times"][label] = [{k: r[k] for k in (
            "name", "ms", "device_ms", "device_events", "plain_ms",
            "bound_ms", "bound_by", "shape")} for r in rows]
        dev_records.extend(rows)
        return rows

    dev_records, out = [], {"checks": {}, "times": {}}
    for label, name, which, thr, cap in EXTRACT_CHECKS:
        det, cid, own, own_thr = detector(name)
        args, _, chain, ce_args = coarse_args(
            det, cid, frames.get(which, own), own_thr if thr is None else thr)
        got, shape = check(label, (*args, cap), chain)
        if label == "flagship step":
            # the device kernels of one coarse_extract call
            n_ce, ce_names, ce_events = _kernels_a_call(
                lambda: coarse_extract(*ce_args, cap))
            if not {"prefix_kernel", "extract_kernel"} <= set(ce_events):
                raise AssertionError(f"coarse_extract: recorded device "
                                     f"kernels {ce_events}, not the "
                                     f"extraction's")
            out["coarse_extract_kernels"] = {"a_call": n_ce,
                                             "by_name": ce_names,
                                             "events": ce_events}
            print(f"coarse_extract [{label}]: {n_ce} device kernels a call "
                  f"(torch.profiler's host-side records, {CALLS} calls), "
                  f"the extraction's prefix_kernel and extract_kernel among "
                  f"them; recorded events, mean device ms: "
                  + ", ".join(f"{n} {ce_events[n]}, {ms:.4f}" for n, ms
                              in ce_names.items()))
        if label in EXTRACT_TIMED:
            # the launches of the path this shape is on (phases 4 and 6),
            # or of the check alone where the phase runs by itself
            on_path = (path_launches or {}).get(label)
            timed(label, (*args, cap), got, shape, on_path or {
                "extract_counted": 1, "count_prefix": 1},
                  ("dense" if "dense" in label else "flagship")
                  if on_path else f"check {label}")
        del args, got, ce_args

    # the slice's path: the default cap, re-run at the 65,536 bucket
    kernels = (quant_spread, coarse_scores, chain_scores, refine_windows,
               coarse_maps, map_refine, extract_counted, count_prefix)
    det, cid, _, _ = detector("rot10000x63")
    K = det._get_banks(cid)[0].fx.shape[0]
    for label, which, thr, tiles, over_slab in OVERFLOW_RUNS:
        frame = frames[which][0]
        args, n_above, chain, _ = coarse_args(det, cid, frame[None], thr)
        re_cap = next((c for c in _CAND_BUCKETS if c >= n_above), n_above)
        hold_cap = _cap_holding(n_above)
        rows = []
        for cap in (256, re_cap, hold_cap):
            got, shape = check(f"{label} cap {cap}", (*args, cap), chain)
            if cap == re_cap:
                n_distinct = int(distinct_templates(got[0], got[4], K, K)[2])
                if label in OVERFLOW_TIMED:
                    # launches from the match below
                    rows = timed(f"{label} re-run", (*args, cap), got, shape,
                                 None, f"overflow re-run {label}")
                    if label == OVERFLOW_RUNS[0][0]:
                        # the yardstick: CUB's compaction of the live cells
                        # (no name holds S past `del args`: the match's
                        # peak memory below must not count it)
                        mask = (torch.arange(args[0].shape[2],
                                             device=args[0].device)
                                < args[2][:, None]) \
                            & (args[0] >= args[3][:, None])
                        nz_ms = _time_ms(lambda: torch.nonzero(mask), 5)
                        out["nonzero_yardstick"] = {
                            "ms": nz_ms, "cells": int(mask.numel()),
                            "live": int(mask.sum())}
                        print(f"time torch.nonzero yardstick [{shape}, "
                              f"precomputed [B, K, M] live mask, "
                              f"{int(mask.sum())} live]: {nz_ms:.4f} ms on "
                              f"{card} (not called by the port)")
                        del mask
            del got
        del args
        D = next((d for d in _D_BUCKETS if n_distinct <= d < K), K)
        slabs = -(-n_distinct // _MAP_SLAB) if D > _MAP_SLAB else 1
        if over_slab and not (n_distinct > _MAP_SLAB and slabs >= 2):
            raise AssertionError(f"overflow re-run {label}: {n_distinct} "
                                 f"distinct templates, {slabs} slab(s): the "
                                 f"slabs did not engage")
        det.counters.clear()
        got, launches = _counted(kernels, lambda: det.match(frame, thr))
        routes = _routes(det)
        _launched(launches, (
            "quant_spread", "chain_scores" if chain else "coarse_scores",
            "refine_windows", "coarse_maps", "map_refine",
            "extract_counted", "count_prefix"), f"overflow re-run {label}")
        if launches["coarse_maps"] != slabs \
                or launches["map_refine"] != slabs:
            raise AssertionError(f"overflow re-run {label}: {slabs} slabs "
                                 f"expected, launches {launches}")
        for rec in rows:
            rec["launches"] = launches[rec["name"]]

        def default():
            return det.match(frame, thr)

        def holding():
            return det.match_batch(frame[None], thr, [cid],
                                   cand_cap=hold_cap)[0]

        want = holding()
        n_tiles = tiles_matches if tiles else None
        if not got or _keys(got) != _keys(want) or (
                n_tiles is not None and len(got) != n_tiles):
            raise AssertionError(f"overflow re-run {label}: the list "
                                 f"({len(got)}) differs from the one at cap "
                                 f"{hold_cap} ({len(want)}) or phase 15's "
                                 f"tiles ({n_tiles})")
        runs = {"default": {"cap": re_cap, "ms": _host_ms(default, 3),
                            "peak_gb": _peak_gb(default)},
                "holding": {"cap": hold_cap, "ms": _host_ms(holding, 3),
                            "peak_gb": _peak_gb(holding)}}
        if runs["default"]["peak_gb"] > MAX_RERUN_GB:
            raise AssertionError(f"overflow re-run {label} peaked at "
                                 f"{runs['default']['peak_gb']:.2f} GB, "
                                 f"over {MAX_RERUN_GB} GB")
        out[label] = {"n_above": n_above, "rerun_cap": re_cap,
                      "n_distinct": n_distinct, "D": D, "slabs": slabs,
                      "map_slab": _MAP_SLAB, "chain": chain,
                      "launches": launches, "routes": routes,
                      "matches": len(got), "runs": runs}
        print(f"overflow re-run {label} (threshold {thr:g}): n_above "
              f"{n_above}, re-run cap {re_cap}, n_distinct {n_distinct}, D "
              f"{D}, {slabs} slab(s) of at most {_MAP_SLAB}, planner "
              f"{'engaged' if chain else 'declined'}; the list equals the "
              f"cap-{hold_cap} list ({len(got)} matches"
              f"{f'; phase 15 tiles {n_tiles}' if tiles else ''}); "
              f"launches {launches}; refine routes {routes}")
        for name, r in runs.items():
            print(f"time overflow {label} {name} cap {r['cap']}: "
                  f"{r['ms']:.4f} ms (host clock, mean of 3 warm calls), "
                  f"peak {r['peak_gb']:.2f} GB (max_memory_allocated) on "
                  f"{card}")
        del got, want
    err = max(c["max_abs_err"] for c in out["checks"].values())
    for rec in dev_records:  # every check's error, as before
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return dev_records, out


# phase 18: the entry points (shape_based_matching_tpu_torch/entry.py
# and bench.py): the flagship step at each bank size, the metrics run as
# their own processes
ENTRY_TEMPLATES = (360, 1000, 10000)
ENTRY_ITERS = 20
ENTRY_METRICS = ("e2e1000", "fps_b8", "e2e10000", "production_device")
DRYRUN_SHARDS = 4


def entry_phase(card: str) -> dict:
    """Phase 18, the entry points.

    1. ``entry(n)`` for each of ``ENTRY_TEMPLATES`` on the card: its
       step launches the frontend, the coarse kernel of its route
       (chain.cu for the 10,000-template bank, coarse.cu otherwise, never
       both), the count prefix, the extraction and the window refine;
       its ``match_sets`` equal the same step's on CPU tensors (the
       twins) bit for bit; its set size, ``n_above``, coarse route and
       warm ms (mean of ``ENTRY_ITERS`` queued calls between CUDA
       events); its device work a call from torch.profiler
       (``_kernels_a_call``): the queued kernels, memsets and copies, the
       device events recorded and their device ms a call, the share of
       the warm time the device is busy, and the kernels that take most
       of it; the synchronizing CUDA calls torch makes in a call
       (``utils/profiling.sync_calls``).
    2. ``dryrun_multichip(DRYRUN_SHARDS)`` over the visible card(s),
       round-robin: every parity assert, its kernels launched, its ok
       line.
    3. ``python -m shape_based_matching_tpu_torch.bench --metric NAME``
       for each of ``ENTRY_METRICS``, each its own process: exit 0 and a
       finite positive value."""
    from shape_based_matching_tpu_torch.entry import (dryrun_multichip,
                                                      entry, match_sets)
    from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.extract import (
        count_prefix, extract_counted)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows)
    from shape_based_matching_tpu_torch.utils.profiling import (
        CALLS, sync_calls)

    kernels = (quant_spread, coarse_scores, chain_scores, count_prefix,
               extract_counted, refine_windows)
    out = {"steps": {}}
    for n in ENTRY_TEMPLATES:
        fn, args = entry(n)
        res, launches = _counted(kernels, lambda: fn(*args))
        coarse = ("chain_scores" if fn.coarse_route == "chain"
                  else "coarse_scores")
        other = ({"chain_scores", "coarse_scores"} - {coarse}).pop()
        _launched(launches, ("quant_spread", coarse, "count_prefix",
                             "extract_counted", "refine_windows"),
                  f"entry({n})")
        if launches[other]:
            raise AssertionError(f"entry({n}) launched {other}: {launches}")
        got = match_sets(*res[:5])
        cfn, cargs = entry(n, device="cpu")
        cres = cfn(*cargs)
        if got != match_sets(*cres[:5]) or int(res[5][0]) != int(cres[5][0]):
            raise AssertionError(f"entry({n}) on the card differs from the "
                                 f"CPU twins")
        ms = _time_ms(lambda: fn(*args), ENTRY_ITERS)
        queued, dev_ms, events = _kernels_a_call(lambda: fn(*args))
        busy = sum(dev_ms[k] * events[k] for k in dev_ms) / CALLS
        top = sorted(((dev_ms[k] * events[k] / CALLS, k) for k in dev_ms),
                     reverse=True)[:6]
        _, syncs = sync_calls(lambda: fn(*args))
        out["steps"][n] = {"set": len(got[0]), "n_above": int(res[5][0]),
                           "coarse_route": fn.coarse_route,
                           "launches": launches, "ms": ms,
                           "queued_a_call": queued,
                           "device_events": sum(events.values()),
                           "device_ms": busy, "top": top, "syncs": syncs}
        print(f"entry({n}) device work: {queued} kernels, memsets and "
              f"copies queued a call; {sum(events.values())} device events "
              f"recorded over {CALLS} calls, {busy:.4f} ms of device time a "
              f"call, {busy / ms:.1%} of the warm {ms:.4f} ms; {syncs} "
              f"synchronizing calls a call; most: "
              + ", ".join(f"{k} {t:.4f}" for t, k in top) + f" on {card}")
        print(f"entry({n}): {len(got[0])} matches in the set, n_above "
              f"{int(res[5][0])}, coarse route {fn.coarse_route}, launches "
              f"{launches}; equal to the CPU twins bit for bit; warm "
              f"{ms:.4f} ms (mean of {ENTRY_ITERS} queued calls) on {card}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, launches = _counted(kernels,
                               lambda: dryrun_multichip(DRYRUN_SHARDS))
    line = buf.getvalue().strip()
    print(line)
    if not line.startswith("dryrun_multichip ok:"):
        raise AssertionError(f"dryrun_multichip printed {line!r}")
    _launched(launches, ("quant_spread", "coarse_scores", "count_prefix",
                         "extract_counted", "refine_windows"),
              "dryrun_multichip")
    out["dryrun"] = {"line": line, "launches": launches}

    out["bench"] = {}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    for name in ENTRY_METRICS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "shape_based_matching_tpu_torch.bench",
             "--metric", name], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"bench --metric {name} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        value = json.loads(proc.stdout.strip().splitlines()[-1])
        if not (isinstance(value, float) and np.isfinite(value)
                and value > 0):
            raise AssertionError(f"bench --metric {name} gave {value!r}")
        out["bench"][name] = {"value": value, "seconds": seconds}
        print(f"bench --metric {name}: {value!r} ({seconds:.1f} s, its own "
              f"process) on {card}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, ROOT)
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import (
        _CAND_BUCKETS, _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.cuda import build
    from shape_based_matching_tpu_torch.ops.cuda.chain import chain_scores
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_maps_plain, coarse_scores, coarse_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.extract import (
        count_prefix, extract_counted)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)
    from shape_based_matching_tpu_torch.ops.cuda.map_refine import (
        map_refine, map_refine_plain)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows, refine_windows_plain)
    from shape_based_matching_tpu_torch.ops.cuda.pyramid import (
        linear_memories, linear_memories_plain, pyr_down)
    from shape_based_matching_tpu_torch.ops.filters import pyr_down_u8_plain
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold, coarse_extract)
    from shape_based_matching_tpu_torch.ops.window import window_origin
    from shape_based_matching_tpu_torch.utils.synthetic import (
        load_bank_cache, synthetic_scene, synthetic_shape_image)

    dev = torch.device(DEVICE)
    report = {}
    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    card = f"{kind} [{smi}]"
    print(smi)
    print(f"device: {kind} | count "
          f"{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    report["device"] = {"kind": kind, "nvidia_smi": smi}

    # 2. build
    t0 = time.perf_counter()
    path, nvcc_s = build.build()
    build.library()
    print(f"build: {os.path.relpath(path, ROOT)} nvcc {nvcc_s:.1f} s, "
          f"load {time.perf_counter() - t0:.1f} s")
    report["build_seconds"] = nvcc_s

    # the flagship configuration
    golden = json.load(open(GOLDEN))
    cfg = golden["config"]
    pyramids = load_bank_cache(os.path.join(ROOT, cfg["bank"]))
    if pyramids is None or len(pyramids) != cfg["num_templates"]:
        raise AssertionError(f"bank {cfg['bank']} missing or stale")
    templ = synthetic_shape_image(256, 0)
    scene = synthetic_scene(cfg["height"], cfg["width"], templ,
                            n_instances=cfg["n_instances"],
                            seed=cfg["scene_seed"])
    det = Detector(num_features=cfg["num_features"], T=tuple(cfg["T"]),
                   device=DEVICE)
    det.class_templates[golden["class_id"]] = pyramids
    banks = det._get_banks(golden["class_id"])
    thr = torch.tensor(THRESHOLD, dtype=torch.float32, device=dev)

    # 3. kernels against their plain twins, bitwise
    noise = np.random.RandomState(7).randint(0, 256, scene.shape,
                                             dtype=np.uint8)
    full = torch.from_numpy(np.stack([scene, noise])).to(dev)
    half = pyr_down(full)
    k1_err = 0
    for frames in (full, half):
        for T in (4, 8):
            k1_err = max(k1_err, _max_abs_err([(
                quant_spread(frames, det.weak_threshold, T),
                quant_spread_plain(frames, det.weak_threshold, T))]))
    print(f"K1 frontend vs plain: max_abs_err {k1_err} over 1024^2 and "
          f"512^2, scene + noise, T=4 and T=8")
    pd_err = _max_abs_err([(half, pyr_down_u8_plain(full))])
    spreads = [(quant_spread(f, det.weak_threshold, T), T)
               for f, T in ((full, T_LEVELS[0]), (half, T_LEVELS[1]))]
    lm_err = _max_abs_err([(linear_memories(sp, T),
                            linear_memories_plain(sp, T))
                           for sp, T in spreads])
    print(f"pyramid.cu vs plain: pyrDown max_abs_err {pd_err} (1024^2, "
          f"B=2), linear memories {lm_err} (both levels)")

    lms = _batch_pyramid(full[:1], det.T_at_level, det.pyramid_levels,
                         det.weak_threshold)
    sizes = det._level_sizes(scene.shape)
    T1, (w1, h1) = T_LEVELS[1], sizes[1]
    W1, H1 = w1 // T1, h1 // T1
    M1 = W1 * H1
    off = _flat_offsets(banks[1], T1, W1, M1, sizes[1])
    pos = _positions(banks[1], T1, W1, H1)
    rmin, _ = _rmin_for_threshold(banks[1].nfeat, thr)
    k2_args = (lms[1], off, pos, rmin, M1)
    S, cnt = coarse_scores(*k2_args)
    S_p, cnt_p = coarse_scores_plain(*k2_args)
    k2_err = _max_abs_err([(S, S_p), (cnt, cnt_p)])
    print(f"K2 coarse vs plain: max_abs_err {k2_err}, K={off.shape[0]} "
          f"N={off.shape[1]} M={M1}, candidates above threshold "
          f"{int(cnt.sum())}")

    k, x, y, _, valid, n_above = coarse_extract(
        lms[1], banks[1], T1, sizes[1], thr, 256)
    T0 = T_LEVELS[0]
    wx, wy = window_origin(banks[0].width, banks[0].height,
                           T0, sizes[0], k, x, y)
    k3_args = (lms[0], banks[0], T0, sizes[0], k, wx, wy, valid)
    k3_err = _max_abs_err(zip(refine_windows(*k3_args),
                              refine_windows_plain(*k3_args)))
    print(f"K3 refine vs plain: max_abs_err {k3_err}, "
          f"{int(valid.sum())} live of 256 candidates (n_above "
          f"{int(n_above[0])}), N={banks[0].fx.shape[1]}")
    # the frame overflows the cap of 256: its re-run at 1024 takes the
    # map route
    re_cap = next(c for c in _CAND_BUCKETS if c >= int(n_above[0]))
    mr = _map_route_check(lms, banks, sizes, thr, re_cap)
    if (k1_err or k2_err or k3_err or mr["maps_err"] or mr["mr_err"]
            or pd_err or lm_err):
        raise AssertionError("a kernel disagrees with its plain twin")

    # 4. the main path through the kernels
    seeds = [cfg["scene_seed"] + i for i in range(BATCH)]
    batch = np.stack([synthetic_scene(cfg["height"], cfg["width"], templ,
                                      n_instances=cfg["n_instances"],
                                      seed=s) for s in seeds])
    kernels = (quant_spread, coarse_scores, refine_windows, coarse_maps,
               map_refine, extract_counted, count_prefix, pyr_down,
               linear_memories, chain_scores)
    det.counters.clear()
    (got1, got8), launches = _counted(
        kernels, lambda: (det.match(scene, THRESHOLD),
                          det.match_batch(batch, THRESHOLD)))
    print(f"main path: launches {launches}; refine routes "
          f"{_routes(det)}; B=1 {len(got1)} matches, "
          f"B=8 {[len(m) for m in got8]} matches")
    # the planner declines this sparse bank: no chain
    if not all(launches[fn.__name__] for fn in kernels[:-1]) \
            or launches["chain_scores"]:
        raise AssertionError(f"a kernel was not launched, or the chain "
                             f"was: {launches}")
    if _keys(got1) != golden["matches"]:
        raise AssertionError(f"B=1 differs from the JAX golden: "
                             f"{len(got1)} vs {len(golden['matches'])} "
                             f"matches")
    for i, frame in enumerate(batch):
        if _keys(got8[i]) != _keys(det.match(frame, THRESHOLD)):
            raise AssertionError(f"B=8 frame {i} differs from its B=1 "
                                 f"match")
    print(f"main path: B=1 equals the JAX golden ({len(got1)} matches, "
          f"(tid, x, y, f32 bits)); B=8 equals B=1 frame by frame")

    # 5. timings
    iters = 30
    table = (
        (quant_spread, "frontend.cu", "frontend_pallas.py:108", k1_err,
         lambda: quant_spread(full[:1], det.weak_threshold, T0),
         lambda: quant_spread_plain(full[:1], det.weak_threshold, T0),
         "1024^2 T=4", _frontend_work(1, 1024, 1024, 1, 8, T0, False,
                                      False)),
        (quant_spread, "frontend.cu", "frontend_pallas.py:108", k1_err,
         lambda: quant_spread(half[:1], det.weak_threshold, T_LEVELS[1]),
         lambda: quant_spread_plain(half[:1], det.weak_threshold,
                                    T_LEVELS[1]),
         "512^2 T=8", _frontend_work(1, 512, 512, 1, 8, T_LEVELS[1], False,
                                     False)),
        (coarse_scores, "coarse.cu", "similarity_pallas.py:55", k2_err,
         lambda: coarse_scores(*k2_args),
         lambda: coarse_scores_plain(*k2_args),
         f"K={off.shape[0]} N={off.shape[1]} M={M1}",
         _coarse_work(lms[1], off, M1, counted=True)),
        (refine_windows, "refine.cu", "refine_pallas.py:67", k3_err,
         lambda: refine_windows(*k3_args),
         lambda: refine_windows_plain(*k3_args),
         f"C=256 N={banks[0].fx.shape[1]} ({int(valid.sum())} live)",
         _refine_work(lms[0], banks[0], k, valid)),
        (coarse_maps, "coarse.cu", "similarity_pallas.py:431",
         mr["maps_err"], lambda: coarse_maps(*mr["maps_args"]),
         lambda: coarse_maps_plain(*mr["maps_args"]), mr["maps_shape"],
         _coarse_work(*mr["maps_args"], counted=False)),
        (map_refine, "map_refine.cu", "refine_pallas.py:154", mr["mr_err"],
         lambda: map_refine(*mr["mr_args"]),
         lambda: map_refine_plain(*mr["mr_args"]), mr["mr_shape"],
         mr["mr_work"]),
        (pyr_down, "pyramid.cu", "", pd_err, lambda: pyr_down(full[:1]),
         lambda: pyr_down_u8_plain(full[:1]), "1024^2 B=1",
         (1024 * 1024 * 5 // 4, 0)),
        (linear_memories, "pyramid.cu", "", lm_err,
         lambda: linear_memories(spreads[0][0][:1], T0),
         lambda: linear_memories_plain(spreads[0][0][:1], T0),
         "1024^2 T=4 B=1", (1024 * 1024 * (1 + 8) + 65536, 0)),
        (linear_memories, "pyramid.cu", "", lm_err,
         lambda: linear_memories(spreads[1][0][:1], T_LEVELS[1]),
         lambda: linear_memories_plain(spreads[1][0][:1], T_LEVELS[1]),
         "512^2 T=8 B=1", (512 * 512 * (1 + 8) + 4096, 0)),
    )
    # port-only kernels: the JAX package computes these in XLA
    xla = {pyr_down: "shape_based_matching_tpu/ops/filters.py:126",
           linear_memories: "shape_based_matching_tpu/ops/response.py:147"}
    records = []
    for fn, src, replaces, err, kern, plain, shape, work in table:
        ms = _time_ms(kern, iters)
        plain_ms = _time_ms(plain, iters // 5)
        records.append(_record(fn, src, replaces, err, launches, "flagship",
                               ms, plain_ms, work, shape))
        if fn in xla:
            records[-1]["replaces"] = xla[fn]
        print(f"time {fn.__name__} [{shape}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {records[-1]['bound_ms']:.4f} ms "
              f"({records[-1]['bound_by']}) on {card}")
    _add_device_ms(records, mr)
    # the frontend as match_batch runs it: 8 frames, both levels
    frames8 = torch.from_numpy(batch).to(dev)
    for lvl, (fr8, T_l) in enumerate(((frames8, T0),
                                      (pyr_down(frames8), T_LEVELS[1]))):
        args8 = (fr8, det.weak_threshold, T_l)
        err8 = _max_abs_err([(quant_spread(*args8),
                              quant_spread_plain(*args8))])
        side = fr8.shape[-1]
        ms8 = _time_ms(lambda: quant_spread(*args8), iters)
        plain8 = _time_ms(lambda: quant_spread_plain(*args8), 2)
        records.append(_record(
            quant_spread, "frontend.cu", "frontend_pallas.py:108", err8,
            launches, f"flagship B={BATCH}", ms8, plain8,
            _frontend_work(BATCH, side, side, 1, 8, T_l, False, False),
            f"B={BATCH} {side}^2 T={T_l}"))
        print(f"time quant_spread [B={BATCH} {side}^2 T={T_l}]: kernel "
              f"{ms8:.4f} ms, plain {plain8:.4f} ms, bound "
              f"{records[-1]['bound_ms']:.4f} ms "
              f"({records[-1]['bound_by']}), max_abs_err {err8} on {card}")
        if err8:
            raise AssertionError(f"frontend at B={BATCH} level {lvl} "
                                 f"disagrees with its twin")
    routes = [_route_ms(lms, banks, sizes, thr, re_cap, None, iters)]
    _print_routes("flagship", routes, card)
    e2e_ms = _time_ms(lambda: det.match(scene, THRESHOLD), iters)
    per_call = []
    for _ in range(100):  # match() ends in a download, so each call syncs
        t0 = time.perf_counter()
        det.match(scene, THRESHOLD)
        per_call.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = np.percentile(per_call, [50, 90])
    b8_ms = _time_ms(lambda: det.match_batch(batch, THRESHOLD), 10)
    fps = BATCH * 1e3 / b8_ms
    print(f"time e2e B=1 1024^2 x 1000 templates: {e2e_ms:.4f} ms/frame "
          f"(host clock over 100 calls: median {p50:.4f}, p90 {p90:.4f}); "
          f"B=8: {b8_ms:.4f} ms/batch = {fps:.1f} frames/s on {card}")
    report.update(kernels=records, e2e_b1_ms=e2e_ms, e2e_b1_p50_ms=p50,
                  e2e_b1_p90_ms=p90, b8_ms=b8_ms, fps_b8=fps,
                  launches=launches, n_matches_b1=len(got1), routes=routes,
                  rerun_cap=re_cap, n_distinct=mr["n_distinct"], D=mr["D"])

    # 6. the dense-bank path
    dense_records, report["dense"] = dense_phase(card)
    records += dense_records

    # 7. the input modes
    report["k1_modes"] = k1_modes(scene, det.weak_threshold, card)
    report["paths"] = {}
    for name in MODE_PATHS:
        path_records, report["paths"][name] = mode_path_phase(name, card)
        records += path_records

    # 8-11. training and the multi-class match
    t0 = time.perf_counter()
    trained, report["train"] = train_phase(card)
    t1 = time.perf_counter()
    report["train_cpp_goldens"] = cpp_golden_phase(card)
    t2 = time.perf_counter()
    report["train_sweep"] = sweep_phase(card)
    t3 = time.perf_counter()
    mc_records, report["multiclass"] = multiclass_phase(trained, card)
    records += mc_records
    t4 = time.perf_counter()
    report["new_phase_seconds"] = {"train": t1 - t0, "cpp_goldens": t2 - t1,
                                   "sweep": t3 - t2, "multiclass": t4 - t3}
    print(f"seconds: train snapshots {t1 - t0:.1f}, C++ goldens "
          f"{t2 - t1:.1f}, batched sweep {t3 - t2:.1f}, multiclass "
          f"{t4 - t3:.1f}")

    # 12-13. the production refine path and patch_2843
    prod_records, report["production"] = production_phase(card)
    records += prod_records
    t5 = time.perf_counter()
    patch_records, report["patch_2843"] = patch_phase(scene, card)
    records += patch_records
    t6 = time.perf_counter()
    report["phase_seconds_12_13"] = {"production": t5 - t4,
                                     "patch_2843": t6 - t5}
    print(f"seconds: production {t5 - t4:.1f}, patch_2843 {t6 - t5:.1f}")

    # 14. the CLI and the model directory
    report["cli"] = cli_phase(trained, card)
    t7 = time.perf_counter()
    report["phase_seconds_14"] = t7 - t6
    print(f"seconds: cli and model directory {t7 - t6:.1f}")

    # 15. the sharded paths
    sharded_records, report["sharded"] = sharded_phase(trained, card)
    records += sharded_records
    t8 = time.perf_counter()
    report["phase_seconds_15"] = t8 - t7
    print(f"seconds: sharded paths {t8 - t7:.1f}")

    # 16. the oracle
    report["oracle"] = oracle_phase(card)
    t9 = time.perf_counter()
    report["phase_seconds_16"] = t9 - t8
    print(f"seconds: oracle {t9 - t8:.1f}")

    # 17. the overflow re-run's memory
    overflow_records, report["overflow"] = overflow_phase(
        trained, card,
        report["sharded"]["spatial"]["rot10000x63"]["4_shards"]["matches"],
        {**{label: report["launches"] for label in EXTRACT_FLAGSHIP},
         "dense 1024^2 (chain rows)": report["dense"]["launches"]})
    records += overflow_records
    t10 = time.perf_counter()
    report["phase_seconds_17"] = t10 - t9
    print(f"seconds: overflow re-run {t10 - t9:.1f}")

    # 18. the entry points
    report["entry"] = entry_phase(card)
    t11 = time.perf_counter()
    report["phase_seconds_18"] = t11 - t10
    print(f"seconds: entry points {t11 - t10:.1f}")
    report["kernels"] = records
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
