"""Benchmark: the full LINE-2D match step at 1024x1024 on one NVIDIA GPU,
under the JAX package's ``bench.py`` metric names and configurations.

    python -m shape_based_matching_tpu_torch.bench [--device cuda|cpu]
        [--detail PATH] [--metric NAME] [--in-process]

Primary metric: ``match_1024x1024_1000templates_e2e_ms``, the match step
of ``entry(1000)`` (frontend, linear memories, coarse scores with counted
extraction at cap 256 and the window refine, on a device-resident 1024^2
frame; no overflow re-run, no ``Match`` list), against the C++
reference's ~20 ms for 1000 templates on a CPU. The detail metrics
(``_METRICS``) cover the 360- and 10,000-template steps, B=8 throughput,
masks, wide banks, 16 orientations, training, ICP and the production
flows; ``_detail_from_vals`` names every key.

Harness:

* stdout carries exactly one line, the primary's JSON ``{"metric",
  "value", "unit", "vs_baseline"}``, printed and flushed as soon as the
  primary finishes, so a run cut short later still leaves it. The
  primary runs with a timeout (env ``SBM_BENCH_PRIMARY_TIMEOUT_S``,
  default 420 s) and one retry.
* Each metric runs in its own process (``--metric NAME``), so the
  numbers do not depend on the order or on what ran before.
* The detail metrics then run cheapest first (``_DETAIL_ORDER``) under a
  wall-clock budget counted from the primary line (env
  ``SBM_BENCH_BUDGET_S``, default 480 s). A metric that does not fit, or
  fails, is listed under ``skipped``, the reason on stderr.
* The detail file (``--detail``, default
  ``build/bench_torch/BENCH_DETAIL.json`` under the repository root) is
  rewritten after every metric, so a killed run leaves a valid partial
  file. Beside the rounded keys it holds ``values``, every metric's
  unrounded value(s), and ``device``.
* Before the primary, the card's name and power limit (``nvidia-smi
  --query-gpu=name,power.limit``) go to stderr and into ``device``, and
  the kernels are built once: a failed build fails the run.

Timing (``_min_of``): inputs on the device and warmed by one call, then
the best of 3 loops, each a ``torch.cuda.synchronize()``, the queued
iterations, one ``torch.cuda.synchronize()``, on the host clock. The
bench runs on the card unless ``--device cpu`` is given; without CUDA it
raises.

Left out: ``wide1000x256_packed2`` (the TPU-only packed2 coarse route,
forced there by ``SBM_NO_WIDE``), so no ``*_packed2`` key and no
``wide_vs_packed2_speedup_1000t_256f``. ``case1`` (the upstream case1
demo's 361 C++-trained templates on its test frame) needs a checkout of
the reference C++ repository, named by env ``SBM_REFERENCE_DIR``
(its ``test/case1``); without one the metric is None and its keys are
absent.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DETAIL = os.path.join(REPO_ROOT, "build", "bench_torch",
                              "BENCH_DETAIL.json")

# Budget epoch: reset when the primary metric line prints (see main) so
# the detail metrics always get the full budget; initialized here for
# importers (tests) that drive pieces directly.
_T0 = time.monotonic()

BASELINE_1000_MS = 20.0   # reference CPU, ~1000 templates e2e
BASELINE_360_MS = 67.0    # 60 ms response maps + 7 ms / 360-template match


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _min_of(run, iters: int, device: torch.device,
            repeats: int = 3) -> float:
    """Best-of-repeats ms/iter of ``run(iters)``, which queues `iters`
    calls: a synchronize before each loop and one after it, so a loop
    times the device's work and the host's dispatch together."""
    best = float("inf")
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        run(iters)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def _queued(fn):
    """``run(n)`` for ``_min_of``: n calls of fn, queued."""
    def run(n):
        for _ in range(n):
            fn()
    return run


def _bench_detector(num_templates: int, num_features: int, device,
                    **kw):
    """The "bench" class from its committed snapshot (trained where none
    is committed) and the training image."""
    from .utils.synthetic import build_rotated_detector

    return build_rotated_detector(num_templates, num_features, cache=True,
                                  device=device, **kw)


def _frames(templ_img: np.ndarray, seeds, device, n_instances: int = 4):
    """``synthetic_scene(1024, 1024, ...)`` of each seed, [B, H, W] uint8
    on the device."""
    from .utils.synthetic import synthetic_scene

    return torch.from_numpy(np.stack([
        synthetic_scene(1024, 1024, templ_img, n_instances=n_instances,
                        seed=s) for s in seeds])).to(device)


def _measure(num_templates: int, device, iters: int = 30) -> float:
    """ms of ``entry(num_templates)``'s match step (the primary at 1000)."""
    from .entry import entry

    fn, args = entry(num_templates, device=device)
    fn(*args)
    return _min_of(_queued(lambda: fn(*args)), iters, device)


def _measure_throughput(device, num_templates: int = 360, batch: int = 8,
                        iters: int = 10) -> float:
    """Streaming throughput (frames/s): ``Detector.match_batch`` on B
    device-resident frames per call, packed output (no download, no
    ``Match`` objects)."""
    det, templ_img = _bench_detector(num_templates, 63, device)
    frames = _frames(templ_img, range(batch), device)
    det.match_batch(frames, 85.0, as_matches=False)
    return batch / (_min_of(_queued(lambda: det.match_batch(
        frames, 85.0, as_matches=False)), iters, device) / 1e3)


def _measure_masked(device, num_templates: int = 360, iters: int = 40):
    """(masked, unmasked) ms/frame of ``match_batch`` at B=1, the masked
    frame's mask in the frontend kernel."""
    det, templ_img = _bench_detector(num_templates, 63, device)
    frames = _frames(templ_img, [3], device)
    rng = np.random.RandomState(4)
    mask = (rng.rand(1024, 1024) > 0.25).astype(np.uint8) * 255
    masks = torch.from_numpy(mask[None]).to(device)

    def timed(m):
        det.match_batch(frames, 85.0, masks=m, as_matches=False)
        return _min_of(_queued(lambda: det.match_batch(
            frames, 85.0, masks=m, as_matches=False)), iters, device)

    # unmasked through the same match_batch B=1 call for a fair ratio
    return timed(masks), timed(None)


def _measure_wide(device, num_templates: int = 1000,
                  num_features: int = 128, iters: int = 40,
                  dense: bool = False, size: int = 256):
    """(ms/frame, coarse-level feature count, coarse route) of
    ``match_batch`` at B=1 on wide-feature banks, threshold 88.
    `dense` banks are trained on block noise, so a wide template fills
    its feature budget."""
    det, templ_img = _bench_detector(num_templates, num_features, device,
                                     dense=dense, size=size)
    nfeat_coarse = len(det.get_templates("bench", 0)[-1].features)
    frames = _frames(templ_img, [11], device, n_instances=2)
    det.match_batch(frames, 88.0, as_matches=False)
    route = det.coarse_route("bench", (1024, 1024))
    ms = _min_of(_queued(lambda: det.match_batch(frames, 88.0,
                                                 as_matches=False)),
                 iters, device)
    return ms, nfeat_coarse, route


def _measure_e2e_16ori(device, num_templates: int = 360,
                       iters: int = 40) -> float:
    """ms/frame of ``match_batch`` at B=1 with 16 orientations, the
    e2e360 configuration otherwise."""
    det, templ_img = _bench_detector(num_templates, 63, device, n_ori=16)
    frames = _frames(templ_img, [3], device)
    det.match_batch(frames, 85.0, as_matches=False)
    return _min_of(_queued(lambda: det.match_batch(frames, 85.0,
                                                   as_matches=False)),
                   iters, device)


def _measure_train_sweep(device, n_frames: int = 128, size: int = 256):
    """(templates/s, seconds) of ``Detector.add_templates`` on n_frames
    distinct frames, after a warm sweep at its chunk of 64."""
    from .models.detector import Detector
    from .utils.synthetic import synthetic_shape_image

    frames = np.stack([synthetic_shape_image(size, seed=1000 + i)
                       for i in range(n_frames)])
    det = Detector(num_features=63, device=device)
    det.add_templates(frames[:min(64, n_frames)], "warm")
    _sync(device)
    t0 = time.perf_counter()
    ids = det.add_templates(frames, "bench")
    dt = time.perf_counter() - t0
    if not all(i >= 0 for i in ids):
        raise RuntimeError("train_sweep: a frame trained no template")
    return n_frames / dt, dt


def _measure_bank_build(device, num_templates: int = 10000,
                        attempts: int = 2) -> float:
    """Seconds to build the 10k-template bank: one trained template, its
    9999 rotations (line2Dup.cpp:1409-1451) and the banks packed on the
    device, best of `attempts`; trained, never read from the snapshot."""
    from .utils.synthetic import build_rotated_detector

    best = float("inf")
    for _ in range(attempts):
        t0 = time.perf_counter()
        det, _ = build_rotated_detector(num_templates, 63, device=device)
        det._get_banks("bench")
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_icp(device, num_matches: int = 64, iters: int = 20) -> float:
    """ms/frame of the ICP tier alone: the edge field of a 1024^2 frame
    and the batched sim2 refine of `num_matches` candidates."""
    from .models.icp import edge_nearest_field, icp_refine_points

    _, templ_img = _bench_detector(8, 63, device)
    frame = _frames(templ_img, [5], device)[0]
    rng = np.random.RandomState(6)
    pts = torch.from_numpy(
        rng.rand(num_matches, 63, 2).astype(np.float32) * 48).to(device)
    origins = torch.from_numpy(
        rng.randint(64, 900, (num_matches, 2)).astype(np.float32)).to(device)
    pv = torch.ones((num_matches, 63), dtype=torch.bool, device=device)

    def once():
        off, normal, _edge, has, subpix = edge_nearest_field(frame, 30.0, 8)
        return icp_refine_points(off, normal, has, subpix, pts, origins, pv,
                                 iters=10, radius=8)

    once()
    return _min_of(_queued(once), iters, device)


def _production(device, num_templates: int, num_features: int):
    """The production bank (1000 x 128) and its seed-7 frame on the
    device."""
    det, templ_img = _bench_detector(num_templates, num_features, device)
    return det, _frames(templ_img, [7], device)[0]


def _measure_production_batch(device, num_templates: int = 1000,
                              num_features: int = 128,
                              iters: int = 10) -> float:
    """ms/frame of the host-side deployment flow: ``Detector.match``
    (overflow re-run, ``Match`` list), then ``refine_matches_icp`` of
    the first 32 matches."""
    from .models.icp import refine_matches_icp

    det, frame = _production(device, num_templates, num_features)

    def once():
        return refine_matches_icp(det, frame, det.match(frame, 85.0)[:32])

    if not once():
        raise RuntimeError("production_batch found no matches")
    return _min_of(_queued(once), iters, device)


def _measure_production_onecall(device, num_templates: int = 1000,
                                num_features: int = 128,
                                iters: int = 10) -> float:
    """ms/frame of ``Detector.match_icp`` (one download a frame)."""
    det, frame = _production(device, num_templates, num_features)
    if not det.match_icp(frame, 85.0, top_c=32):
        raise RuntimeError("production_onecall found no matches")
    return _min_of(_queued(lambda: det.match_icp(frame, 85.0, top_c=32)),
                   iters, device)


def _measure_production_stream(device, num_templates: int = 1000,
                               num_features: int = 128,
                               iters: int = 10) -> float:
    """ms/frame of a pipelined loop of ``Detector.match_icp_async`` over
    three frames: frame N+1 is dispatched before frame N's result is
    read."""
    det, templ_img = _bench_detector(num_templates, num_features, device)
    frames = list(_frames(templ_img, (7, 11, 13), device))

    def run(n):
        out = []
        prev = None
        for i in range(n):
            h = det.match_icp_async(frames[i % 3], 85.0, top_c=32)
            if prev is not None:
                out.append(prev.result())
            prev = h
        out.append(prev.result())
        return out

    res = run(3)
    if not (res and res[0]):
        raise RuntimeError("production_stream found no matches")
    return _min_of(run, iters, device)


def _measure_production_device(device, num_templates: int = 1000,
                               num_features: int = 128,
                               iters: int = 20) -> float:
    """ms/frame of ``match_refine_batch`` at B=1: packed match output,
    device top-k and batched sim2 ICP with no download."""
    from .models.icp import match_refine_batch

    det, frame = _production(device, num_templates, num_features)
    frames = frame[None]
    out = match_refine_batch(det, frames, 85.0, top_c=32)
    if int(out["bench"][0]["icp"].valid.sum()) == 0:
        raise RuntimeError("production_device refined no matches")
    return _min_of(_queued(lambda: match_refine_batch(
        det, frames, 85.0, top_c=32)), iters, device)


def _load_mat(path: str) -> np.ndarray:
    """A dumped cv::Mat (int32 rows, cols, channels, then uint8 data)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        rows, cols, ch = np.frombuffer(f.read(12), np.int32)
        data = np.frombuffer(f.read(), np.uint8).copy()
    return data.reshape((int(rows), int(cols)) + ((int(ch),) if ch > 1
                                                  else ()))


def _measure_case1(device, iters: int = 40):
    """(ms/frame, device work a call, coarse route) of ``match_batch`` at
    B=1 on the upstream case1 angle demo: its 361 templates x 128
    features trained by the compiled C++ reference, on its test frame,
    threshold 90. None without ``SBM_REFERENCE_DIR``'s ``test/case1``.
    The device work comes from the profiler's host-side records (the
    CUDA calls that queued a kernel, memset or copy, a call) and the
    kernel wrappers' launch counters."""
    ref = os.environ.get("SBM_REFERENCE_DIR", "")
    case1 = os.path.join(ref, "test", "case1")
    img_path = os.path.join(REPO_ROOT, "tests", "goldens", "case1_img.bin.gz")
    if not (ref and os.path.isdir(case1) and os.path.isfile(img_path)):
        return None
    from .models.detector import Detector
    from .ops.cuda import (chain, coarse, extract, frontend, map_refine,
                           refine)
    from .utils.profiling import CALLS, device_work

    det = Detector(num_features=128, T=(4, 8), device=device)
    det.read_classes(["test"], os.path.join(case1, "%s_templ.yaml"))
    img = torch.from_numpy(_load_mat(img_path)).to(device)

    def once():
        return det.match_batch(img[None], 90.0, as_matches=False)

    once()
    ms = _min_of(_queued(once), iters, device)
    kernels = (frontend.quant_spread, coarse.coarse_scores,
               coarse.coarse_maps, chain.chain_scores, extract.count_prefix,
               extract.extract_counted, refine.refine_windows,
               map_refine.map_refine)
    for fn in kernels:
        fn.launches = 0
    once()
    _sync(device)
    counts = {f"launch:{fn.__name__}": fn.launches for fn in kernels
              if fn.launches}
    if device.type == "cuda":
        counts["queued_device_work"] = device_work(once)[0] / CALLS
    return ms, counts, det.coarse_route("test", tuple(img.shape[:2]))


_METRICS = {
    "case1": lambda d: _measure_case1(d),
    "masked360": lambda d: _measure_masked(d, 360),
    "e2e360": lambda d: _measure(360, d),
    "e2e1000": lambda d: _measure(1000, d),
    "e2e10000": lambda d: _measure(10000, d, iters=30),
    "e2e360_16ori": lambda d: _measure_e2e_16ori(d, 360),
    "fps_b8": lambda d: _measure_throughput(d, 360, 8),
    "match1000x128": lambda d: _measure_wide(d, 1000, 128),
    "wide8191": lambda d: _measure_wide(d, 8, 8191, dense=True, size=768),
    "wide1000x256": lambda d: _measure_wide(d, 1000, 256, dense=True,
                                            size=256),
    "train_sweep": lambda d: _measure_train_sweep(d, 128, 256),
    "bank_build_10k": lambda d: _measure_bank_build(d, 10000),
    "icp_refine": lambda d: _measure_icp(d, 64),
    "production_batch": lambda d: _measure_production_batch(d, 1000, 128),
    "production_onecall": lambda d: _measure_production_onecall(d, 1000,
                                                                128),
    "production_stream": lambda d: _measure_production_stream(d, 1000, 128),
    "production_device": lambda d: _measure_production_device(d, 1000, 128),
}

# Detail metrics in cheapest-first order, with a rough cost estimate (s)
# used to decide whether a metric still fits the budget: a metric is
# skipped when the remaining budget is below its estimate, and killed at
# the remaining budget if it overruns anyway.
_DETAIL_ORDER = [
    ("e2e360", 35),
    ("case1", 35),
    ("masked360", 45),
    ("match1000x128", 45),
    ("wide1000x256", 45),
    ("fps_b8", 45),
    ("icp_refine", 40),
    ("e2e360_16ori", 45),
    ("wide8191", 60),
    ("e2e10000", 60),
    ("production_device", 60),
    ("production_onecall", 60),
    ("production_stream", 60),
    ("production_batch", 60),
    ("train_sweep", 60),
    ("bank_build_10k", 90),
]


def _budget_s() -> float:
    return float(os.environ.get("SBM_BENCH_BUDGET_S", "480"))


def _remaining_s() -> float:
    return _budget_s() - (time.monotonic() - _T0)


def _run_metric_subprocess(name: str, device: torch.device,
                           timeout_s: float | None = None):
    """Run one metric in a fresh python process; returns its value(s)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO_ROOT, env.get("PYTHONPATH")) if p)
    out = subprocess.run(
        [sys.executable, "-m", "shape_based_matching_tpu_torch.bench",
         "--metric", name, "--device", device.type],
        capture_output=True, text=True, env=env, timeout=timeout_s,
        cwd=REPO_ROOT)
    if out.returncode != 0:
        raise RuntimeError(f"metric {name} failed:\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _detail_from_vals(vals: dict, skipped: list) -> dict:
    """Assemble BENCH_DETAIL from whichever metrics have finished."""
    detail = {}
    ms_1000 = vals.get("e2e1000")
    if ms_1000 is not None:
        detail["match_1024x1024_1000templates_e2e_ms"] = round(ms_1000, 3)
        detail["vs_baseline_1000"] = round(BASELINE_1000_MS / ms_1000, 2)
        detail["north_star_under_5ms"] = ms_1000 < 5.0

    def put(key, value, digits):
        if value is not None:
            detail[key] = round(value, digits)

    ms_masked, ms_unmasked_b1 = vals.get("masked360") or (None, None)
    put("match_1024x1024_360templates_e2e_ms", vals.get("e2e360"), 3)
    put("match_1024x1024_360templates_masked_e2e_ms", ms_masked, 3)
    put("match_1024x1024_360templates_b1_e2e_ms", ms_unmasked_b1, 3)
    put("match_1024x1024_10000templates_e2e_ms", vals.get("e2e10000"), 3)
    put("throughput_1024x1024_360templates_b8_fps", vals.get("fps_b8"), 1)

    def put_wide(name, key_ms, key_nf, key_route):
        if vals.get(name) is not None:
            ms, nf, route = vals[name]
            detail[key_ms] = round(ms, 3)
            detail[key_nf] = int(nf)
            detail[key_route] = route

    put_wide("match1000x128", "match_1024x1024_1000t_128f_e2e_ms",
             "match_1000t_128f_coarse_nfeat",
             "match_1000t_128f_coarse_route")
    put_wide("wide8191", "match_1024x1024_8t_8191f_e2e_ms",
             "match_8t_8191f_coarse_nfeat",
             "match_8t_8191f_coarse_route")
    put_wide("wide1000x256", "match_1024x1024_1000t_256f_dense_e2e_ms",
             "match_1000t_256f_coarse_nfeat",
             "match_1000t_256f_coarse_route")
    put("match_1024x1024_360templates_16ori_e2e_ms",
        vals.get("e2e360_16ori"), 3)
    if (vals.get("e2e360_16ori") is not None
            and vals.get("e2e360") is not None):
        detail["ratio_16ori_vs_8ori_360t"] = round(
            vals["e2e360_16ori"] / vals["e2e360"], 3)
    put("train_sweep_128x256px_templates_per_s",
        vals["train_sweep"][0] if vals.get("train_sweep") else None, 1)
    put("bank_build_10000templates_s", vals.get("bank_build_10k"), 2)
    put("icp_refine_64matches_1024x1024_e2e_ms", vals.get("icp_refine"), 3)
    put("production_batch_1000t_128f_match_icp_ms",
        vals.get("production_batch"), 3)
    put("production_onecall_1000t_128f_match_icp_ms",
        vals.get("production_onecall"), 3)
    put("production_stream_1000t_128f_match_icp_ms",
        vals.get("production_stream"), 3)
    put("production_device_1000t_128f_match_icp_ms",
        vals.get("production_device"), 3)
    if vals.get("e2e360") is not None:
        detail["vs_baseline_360"] = round(
            BASELINE_360_MS / vals["e2e360"], 2)
    case1 = vals.get("case1")
    if case1 is not None:
        ms, counts, route = case1
        detail["case1_361templates_golden_e2e_ms"] = round(ms, 3)
        detail["case1_dispatch_counts"] = counts
        detail["case1_coarse_route"] = route
    if skipped:
        detail["skipped"] = sorted(skipped)
    return detail


def _device_info(device: torch.device) -> dict:
    """What the numbers ran on: torch's name for the card, the count of
    visible cards and nvidia-smi's name and power limit."""
    if device.type != "cuda":
        return {"kind": "cpu", "count": 0, "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def _write_detail(path: str, vals: dict, skipped: list, info: dict) -> None:
    detail = _detail_from_vals(vals, skipped)
    detail["values"] = vals
    detail["device"] = info
    with open(path, "w") as f:
        json.dump(detail, f, indent=2)


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m shape_based_matching_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--detail", default=DEFAULT_DETAIL,
                    help="where the detail JSON goes")
    ap.add_argument("--metric", choices=sorted(_METRICS),
                    help="run one metric here and print its value(s)")
    ap.add_argument("--in-process", action="store_true",
                    help="run every metric in this process (debugging)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    global _T0
    _T0 = time.monotonic()
    args = _parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on the card and CUDA is not "
                           "available; pass --device cpu for the CPU")

    if args.metric:
        print(json.dumps(_METRICS[args.metric](device)))
        return

    def run(name, timeout_s=None):
        return (_METRICS[name](device) if args.in_process
                else _run_metric_subprocess(name, device, timeout_s))

    info = _device_info(device)
    print(f"bench: device {info}", file=sys.stderr)
    if device.type == "cuda":
        from .ops.cuda import build

        path, nvcc_s = build.build()
        print(f"bench: kernels {os.path.relpath(path, REPO_ROOT)} "
              f"(nvcc {nvcc_s:.1f} s)", file=sys.stderr)

    # 1. the primary metric, then at once the one stdout line
    primary_timeout = (None if args.in_process else float(os.environ.get(
        "SBM_BENCH_PRIMARY_TIMEOUT_S", "420")))
    try:
        ms_1000 = run("e2e1000", primary_timeout)
    except Exception as e:  # noqa: BLE001 -- one retry, then give up
        print(f"bench: primary attempt 1 failed ({str(e)[-500:]}); "
              "retrying", file=sys.stderr)
        ms_1000 = run("e2e1000", primary_timeout)
    print(json.dumps({
        "metric": "match_1024x1024_1000templates_e2e_ms",
        "value": round(ms_1000, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_1000_MS / ms_1000, 2),
    }), flush=True)
    # the detail budget starts here, so a slow primary cannot starve it
    _T0 = time.monotonic()

    # 2. the detail metrics, cheapest first, inside the budget
    vals = {"e2e1000": ms_1000}
    skipped = []
    os.makedirs(os.path.dirname(os.path.abspath(args.detail)),
                exist_ok=True)
    _write_detail(args.detail, vals, skipped, info)
    for name, est_s in _DETAIL_ORDER:
        remaining = _remaining_s()
        if remaining < est_s:
            skipped.append(name)
            print(f"bench: skipping {name} (est {est_s}s, "
                  f"{remaining:.0f}s of budget left)", file=sys.stderr)
        else:
            try:
                t0 = time.monotonic()
                vals[name] = run(name, remaining)
                print(f"bench: {name} took {time.monotonic() - t0:.1f}s "
                      f"(est {est_s}s)", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 -- detail is optional
                skipped.append(name)
                print(f"bench: metric {name} failed, skipping: "
                      f"{str(e)[-1500:]}", file=sys.stderr)
        _write_detail(args.detail, vals, skipped, info)


if __name__ == "__main__":
    main()
