"""Drive the PyTorch port's match path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each reported on its own line:
1. the device: torch's name for it and nvidia-smi's name and power limit;
2. build the CUDA kernels from ``shape_based_matching_tpu_torch/csrc``;
3. each kernel against its plain PyTorch twin on the card, bitwise, at the
   main path's shapes (1024x1024 frames, the committed 1000-template x
   63-feature rotation bank, T=(4, 8));
4. the main path: ``Detector(device="cuda")`` matches the flagship frame
   (B=1) and a batch of 8 frames; every kernel's launch counter must rise,
   the B=1 list must equal the committed JAX golden, and each frame of the
   batch must equal its own B=1 match;
5. warm timings from CUDA events: each kernel against its twin, and the
   end-to-end ms/frame at B=1 and frames/s at B=8.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero without that line; so does a machine without CUDA. The
full report goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens",
                      "torch_port_e2e1000_matches.json")
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


def _max_abs_err(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max().item()) if a.numel() else 0)
    return err


def _keys(matches):
    return [[m.template_id, m.x, m.y,
             int(np.float32(m.similarity).view(np.uint32))]
            for m in matches]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, ROOT)
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.cuda import build
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_scores, coarse_scores_plain)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)
    from shape_based_matching_tpu_torch.ops.cuda.refine import (
        refine_windows, refine_windows_plain)
    from shape_based_matching_tpu_torch.ops.filters import pyr_down_u8
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold, coarse_extract)
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
    half = pyr_down_u8(full)
    k1_err = 0
    for frames in (full, half):
        for T in (4, 8):
            k1_err = max(k1_err, _max_abs_err([(
                quant_spread(frames, det.weak_threshold, T),
                quant_spread_plain(frames, det.weak_threshold, T))]))
    print(f"K1 frontend vs plain: max_abs_err {k1_err} over 1024^2 and "
          f"512^2, scene + noise, T=4 and T=8")

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
    T0, (w0, h0) = T_LEVELS[0], sizes[0]
    cx = torch.minimum((x * 2 + 1).clamp(min=8 * T0),
                       w0 - banks[0].width[k] - 8 * T0)
    cy = torch.minimum((y * 2 + 1).clamp(min=8 * T0),
                       h0 - banks[0].height[k] - 8 * T0)
    wx = (torch.div(cx, T0, rounding_mode="floor") - 8).to(torch.int32)
    wy = (torch.div(cy, T0, rounding_mode="floor") - 8).to(torch.int32)
    k3_args = (lms[0], banks[0], T0, sizes[0], k, wx, wy, valid)
    k3_err = _max_abs_err(zip(refine_windows(*k3_args),
                              refine_windows_plain(*k3_args)))
    print(f"K3 refine vs plain: max_abs_err {k3_err}, "
          f"{int(valid.sum())} live of 256 candidates (n_above "
          f"{int(n_above[0])}), N={banks[0].fx.shape[1]}")
    if k1_err or k2_err or k3_err:
        raise AssertionError("a kernel disagrees with its plain twin")

    # 4. the main path through the kernels
    seeds = [cfg["scene_seed"] + i for i in range(BATCH)]
    batch = np.stack([synthetic_scene(cfg["height"], cfg["width"], templ,
                                      n_instances=cfg["n_instances"],
                                      seed=s) for s in seeds])
    kernels = (quant_spread, coarse_scores, refine_windows)
    for fn in kernels:
        fn.launches = 0
    got1 = det.match(scene, THRESHOLD)
    got8 = det.match_batch(batch, THRESHOLD)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"main path: launches {launches}; B=1 {len(got1)} matches, "
          f"B=8 {[len(m) for m in got8]} matches")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
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
    iters = 50
    pallas = "shape_based_matching_tpu/ops/pallas/"
    csrc = "shape_based_matching_tpu_torch/csrc/"
    table = (
        (quant_spread, "frontend.cu", "frontend_pallas.py:108", k1_err,
         lambda: quant_spread(full[:1], det.weak_threshold, T0),
         lambda: quant_spread_plain(full[:1], det.weak_threshold, T0),
         "1024^2 T=4"),
        (coarse_scores, "coarse.cu", "similarity_pallas.py:55", k2_err,
         lambda: coarse_scores(*k2_args),
         lambda: coarse_scores_plain(*k2_args),
         f"K={off.shape[0]} N={off.shape[1]} M={M1}"),
        (refine_windows, "refine.cu", "refine_pallas.py:67", k3_err,
         lambda: refine_windows(*k3_args),
         lambda: refine_windows_plain(*k3_args),
         f"C=256 N={banks[0].fx.shape[1]}"),
    )
    records = []
    for fn, src, replaces, err, kern, plain, shape in table:
        ms = _time_ms(kern, iters)
        plain_ms = _time_ms(plain, iters // 5)
        print(f"time {fn.__name__} [{shape}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms on {card}")
        records.append({"name": fn.__name__, "route": "cuda",
                        "source": csrc + src, "replaces": pallas + replaces,
                        "launches": launches[fn.__name__],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
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
                  launches=launches, n_matches_b1=len(got1))
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
