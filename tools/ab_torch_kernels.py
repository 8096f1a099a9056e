"""Time the port's pyramid, frontend, chain, extraction and map refine
steps of one checkout on one GPU; or the pyramid and the match of two
checkouts in one process.

    python tools/ab_torch_kernels.py [--root DIR] [--iters 200] [--out FILE]
    python tools/ab_torch_kernels.py --against PARENT [--root DIR]
        [--iters 300] [--out FILE]

Imports ``shape_based_matching_tpu_torch`` from DIR (default: this
repository), builds its kernels, and times, with CUDA events (mean of
`iters` queued launches after 20 warm ones), each kernel held bitwise
against its plain twin first:

* ``_batch_pyramid`` on the flagship frames (1024^2, T = (4, 8), gray 8
  orientations) at B=1 and B=8, held to its CPU run, with its device
  kernels a call and their device time; where the checkout has
  ``csrc/pyramid.cu``, its ``pyr_down`` (1024^2 at B=1 and B=8) and
  ``linear_memories`` (1024^2 at T=4 and 512^2 at T=8, B=1 and B=8), each
  held to its twin;

* ``quant_spread`` (frontend.cu) on the flagship frames: 1024^2 at T=4 and
  their 512^2 pyrDown at T=8, gray 8 orientations at B=1 and B=8, and
  color 8 orientations at 1024^2, B=1; where the checkout has the
  opencv_contrib #2843 mode, gray 8 orientations at 1024^2, B=1 and B=8,
  in that mode too. A digest of each frontend kernel's SASS (cuobjdump;
  instruction count and a hash of the text, keyed by orientations,
  channels and mode) shows whether two checkouts compiled a mode alike;
* ``chain_scores`` (chain.cu) on the 10,000-template bank's coarse level
  (512^2, T=8, K=10000, M=4096) at B=1 and B=8, threshold 85;
* ``extract_counted`` (extract.cu and what the checkout runs around
  it: a torch count prefix and one kernel in older checkouts, two
  kernels where the prefix runs on the card) at the flagship's step
  (rot1000x63, cap 256, B=1 and B=8) and re-run (cap 1024), the dense
  bank's chain rows (cap 4096) and the 4096^2 frame
  (``utils/synthetic.huge_frame``) with rot10000x63 at threshold 85
  (cap 65,536) and 60 (cap = n_above), each held bitwise
  to ``extract_counted_plain`` (a NaN score against a NaN), with the
  device kernels a call and their device time from torch.profiler;
* ``refine_from_maps`` (map_refine.cu and what the checkout runs around
  it) on the overflow re-runs of the map route: the flagship frame with
  the 1000-template bank at cap 1024 and the 10,000-template bank at cap
  4096, their level-0 maps of the distinct candidate templates (D=64 and
  D=1024); then ``refine_by_maps``, the whole map route with its host
  read, on the same candidates. These are held against the window route
  (``refine_candidates``) on every valid candidate, which gives the same
  bits on these banks, so any two checkouts are checked alike. For these
  two, torch.profiler also counts the device kernels a call runs and
  their summed device time; for ``refine_from_maps``, the host clock
  splits a call into the time inside the C entry ``sbm_map_refine``
  (argument conversion and launch) and the Python around it, and times
  the wrapper's five output allocations alone.

The inputs come from fixed seeds and the committed bank, so two checkouts
(for a comparison, run the parent's and this one's in turns, in one chip
call) time the same work. Prints one JSON object and writes it to FILE
when given.

With ``--against PARENT`` the tool instead loads the package of the
checkout at PARENT under another name (a copy in ``build/abpkg/``) beside
DIR's, gives both the same banks, and calls them interleaved one by one
(which side goes first alternates), so the host's drifts in speed fall
on both alike: ``_batch_pyramid`` at B=1 and B=8 (a call and its
device work, on the host clock), ``Detector.match`` of one host frame
with the 1000-template banks of 63 and 128 features at threshold 90, and
``match_batch`` of 8 frames. It prints each side's median and quartiles
of `iters` calls, the ratio of the medians and the median and quartiles
of the per-round ratios, after checking that both sides give the same
buffers and lists.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time_ms(fn, iters: int) -> float:
    for _ in range(20):  # warm: clocks up, caches filled
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


def _profiling():
    """This repository's ``utils/profiling.py``, loaded by its path, so a
    --root checkout that predates it is measured by the same code."""
    spec = importlib.util.spec_from_file_location(
        "_sbm_profiling", os.path.join(REPO, "shape_based_matching_tpu_torch",
                                       "utils", "profiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROFILING = _profiling()


def _device_work(fn) -> dict:
    """Device kernels a call of `fn` runs, their summed device time a call
    and that time by kernel name, from torch.profiler (None where it
    records no device work); also each kernel's events and mean ms an
    event, since the profiler can drop a few events."""
    kern = PROFILING.device_kernels(fn)
    if not kern:
        return {"device_kernels": None, "device_ms": None}
    by_name: dict = {}
    events: dict = {}
    for name, ms in kern:
        by_name[name] = by_name.get(name, 0.0) + ms / PROFILING.CALLS
        events.setdefault(name, []).append(ms)
    return {"device_kernels": len(kern) / PROFILING.CALLS,
            "device_ms": sum(by_name.values()), "device_by_name": by_name,
            "device_events": {n: len(v) for n, v in events.items()},
            "device_mean_ms": {n: sum(v) / len(v)
                               for n, v in events.items()}}


def _host_ms(fn, iters: int) -> float:
    """Host ms a call of `fn` on the host clock: `iters` calls after 20
    warm ones, one synchronize at the end (the queue never fills where the
    device is the faster)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def _host_split(fn, lib, entry: str, iters: int) -> dict:
    """`_host_ms` of `fn`, and the part of it spent inside the C entry
    `entry` of the kernel library `lib` (ctypes' argument conversion and
    the kernel launch); the rest is the Python around it."""
    real = getattr(lib, entry)
    inside = []

    def timed(*a):
        t = time.perf_counter()
        code = real(*a)
        inside.append(time.perf_counter() - t)
        return code

    setattr(lib, entry, timed)
    try:
        host = _host_ms(fn, iters)
    finally:
        setattr(lib, entry, real)
    entry_ms = sum(inside[-iters:]) * 1e3 / iters
    return {"host_ms": host, "entry_ms": entry_ms,
            "python_ms": host - entry_ms}


def _frontend_sass(lib_path: str, nvcc: str) -> dict:
    """{"<orientations>x<channels>[+patch]": {"instructions", "sha"}} of
    every quant_spread_kernel instantiation in the library, from
    cuobjdump's SASS without the function's name line."""
    import hashlib
    import re

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        m = re.search(r"quant_spread_kernelILi(\d+)ELi(\d+)E(?:Lb([01])E)?E",
                      name)
        if m is None:
            continue
        key = f"{m[1]}x{m[2]}" + ("+patch" if m[3] == "1" else "")
        body = body.split("..........")[0]
        out[key] = {"instructions": len(re.findall(r"/\*[0-9a-f]{4,}\*/",
                                                   body)),
                    "sha": hashlib.sha256(body.encode()).hexdigest()[:16]}
    return out


def _same_valid(got, want) -> bool:
    """Two refine steps' (k, x, y, score, valid) agree: valid everywhere,
    the rest (score bits) on the valid candidates."""
    valid = got[4]
    return bool(torch.equal(valid, want[4])) and all(
        torch.equal(g[valid].view(torch.int32) if g.is_floating_point()
                    else g[valid], w[valid].view(torch.int32)
                    if w.is_floating_point() else w[valid])
        for g, w in zip(got[:4], want[:4]))


def _same_extract(got, want) -> bool:
    """extract_counted's six outputs: the integers exactly, the scores'
    bits where a number and NaN where the other is NaN."""
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            nan = torch.isnan(w)
            if not (torch.equal(torch.isnan(g), nan) and torch.equal(
                    g[~nan].view(torch.int32), w[~nan].view(torch.int32))):
                return False
        elif not torch.equal(g, w):
            return False
    return len(got) == len(want) == 6


def _synthetic():
    """This repository's ``utils/synthetic.py``, loaded by its path as a
    module of the imported package (its relative imports resolve there),
    so a --root checkout that predates ``huge_frame`` gets the same
    frame."""
    spec = importlib.util.spec_from_file_location(
        "shape_based_matching_tpu_torch.utils._ab_synthetic",
        os.path.join(REPO, "shape_based_matching_tpu_torch", "utils",
                     "synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(got, want) -> bool:
    pairs = zip(got, want) if isinstance(got, tuple) else ((got, want),)
    return all(torch.equal(g.view(torch.int16) if g.dtype == torch.uint16
                           else g, e.view(torch.int16)
                           if e.dtype == torch.uint16 else e)
               for g, e in pairs)


def _scenes(synthetic, n: int = 8) -> np.ndarray:
    """The flagship frames: n 1024^2 scenes of the star, 4 instances."""
    shape = synthetic.synthetic_shape_image(256, 0)
    return np.stack([synthetic.synthetic_scene(1024, 1024, shape,
                                               n_instances=4, seed=3 + i)
                     for i in range(n)])


def _quartiles(xs: list) -> dict:
    q = statistics.quantiles(xs, n=4)
    return {"median": q[1], "q1": q[0], "q3": q[2]}


def _against(args, root: str) -> dict:
    """Parent (the checkout at --against, its package copied under the
    name sbm_parent) against the checkout at `root` in one process, calls
    interleaved one by one."""
    import shutil

    parent_root = os.path.abspath(args.against)
    dst = os.path.join(REPO, "build", "abpkg")
    if os.path.isdir(os.path.join(dst, "sbm_parent")):
        shutil.rmtree(os.path.join(dst, "sbm_parent"))
    shutil.copytree(os.path.join(parent_root,
                                 "shape_based_matching_tpu_torch"),
                    os.path.join(dst, "sbm_parent"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(1, dst)
    import sbm_parent
    import shape_based_matching_tpu_torch as change

    sides = (sbm_parent, change)
    mods = {}
    for pkg in sides:
        name = pkg.__name__
        __import__(f"{name}.ops.cuda.build", fromlist=["x"]).library()
        mods[name] = (__import__(f"{name}.models.detector", fromlist=["x"]),
                      __import__(f"{name}.utils.synthetic", fromlist=["x"]))
    dev = torch.device("cuda")
    scenes = _scenes(mods["shape_based_matching_tpu_torch"][1])
    frames = torch.from_numpy(scenes).to(dev)

    def detector(pkg, n_features):
        det_mod, syn = mods[pkg.__name__]
        det = pkg.Detector(num_features=n_features, T=(4, 8), device=dev)
        det.class_templates["c"] = syn.load_bank_cache(os.path.join(
            root, "bench_banks", os.path.basename(
                syn.bank_cache_path(1000, n_features))))
        return det

    dets = {nf: [detector(pkg, nf) for pkg in sides] for nf in (63, 128)}

    def keys(lists):
        return [[(m.template_id, m.x, m.y, m.similarity) for m in ms]
                for ms in lists]

    i = [0]

    def frame():  # the next host frame, the same on both sides of a round
        return scenes[i[0] % len(scenes)]

    cases = []
    for B in (1, 8):
        cases.append((f"_batch_pyramid gray8 1024^2 B={B}", [
            lambda m=mods[p.__name__][0], B=B: m._batch_pyramid(
                frames[:B], (4, 8), 2, 30.0) for p in sides],
            lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))))
    for nf in (63, 128):
        cases.append((f"Detector.match rot1000x{nf} thr 90 B=1", [
            lambda d=d: d.match(frame(), 90.0) for d in dets[nf]],
            lambda a, b: keys([a]) == keys([b])))
    cases.append(("Detector.match_batch rot1000x63 thr 90 B=8", [
        lambda d=d: d.match_batch(scenes, 90.0) for d in dets[63]],
        lambda a, b: keys(a) == keys(b)))
    out = []
    for name, fns, same in cases:
        for _ in range(20):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
        identical = True
        times = ([], [])
        for r in range(args.iters):
            i[0] = r
            got = [None, None]
            for w in ((0, 1) if r % 2 else (1, 0)):
                t = time.perf_counter()
                got[w] = fns[w]()
                torch.cuda.synchronize()
                times[w].append((time.perf_counter() - t) * 1e3)
            identical &= bool(same(*got))
        ratios = [c / p for p, c in zip(*times)]
        row = {"case": name, "calls": args.iters, "identical": identical,
               "parent_ms": _quartiles(times[0]),
               "change_ms": _quartiles(times[1]),
               "change_over_parent_of_medians":
                   statistics.median(times[1]) / statistics.median(times[0]),
               "change_over_parent_per_round": _quartiles(ratios)}
        out.append(row)
        print(f"{name}: parent {row['parent_ms']['median']:.4f} ms "
              f"({row['parent_ms']['q1']:.4f}-{row['parent_ms']['q3']:.4f}),"
              f" change {row['change_ms']['median']:.4f} ms "
              f"({row['change_ms']['q1']:.4f}-{row['change_ms']['q3']:.4f});"
              f" change/parent {row['change_over_parent_of_medians']:.4f}, "
              f"identical {identical}")
    return {"parent": parent_root, "rows": out}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--against", help="a parent checkout: time it against "
                    "--root's in one process, calls interleaved")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_kernels: CUDA is not available")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if args.against:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        out = {"root": root, "card": smi, **_against(args, root)}
        print(json.dumps(out))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        if not all(r["identical"] for r in out["rows"]):
            raise SystemExit("the two checkouts disagree")
        return
    import shape_based_matching_tpu_torch as pkg
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.chain_plan import plan_chain
    from shape_based_matching_tpu_torch.ops.cuda import build
    from shape_based_matching_tpu_torch.ops.cuda.chain import (
        chain_scores, chain_scores_plain, plan_to_device)
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread, quant_spread_plain)
    try:
        from shape_based_matching_tpu_torch.ops.cuda.pyramid import pyr_down
    except ImportError:  # a checkout from before csrc/pyramid.cu
        from shape_based_matching_tpu_torch.ops.filters import (
            pyr_down_u8 as pyr_down)
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.ops.cuda.coarse import (
        coarse_maps, coarse_scores)
    from shape_based_matching_tpu_torch.ops.cuda.extract import (
        extract_counted, extract_counted_plain)
    from shape_based_matching_tpu_torch.ops.similarity import (
        _D_BUCKETS, LevelBank, _flat_offsets, _positions,
        _rmin_for_threshold, coarse_extract, distinct_templates, gather_bank,
        refine_by_maps, refine_candidates, refine_from_maps)
    from shape_based_matching_tpu_torch.utils import synthetic
    from shape_based_matching_tpu_torch.utils.convert import (
        pyramids_to_banks)

    if not os.path.abspath(pkg.__file__).startswith(root):
        raise SystemExit(f"imported {pkg.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.library()
    dev = torch.device("cuda")
    frames = torch.from_numpy(_scenes(synthetic)).to(dev)
    half = pyr_down(frames)
    color = torch.stack([frames[:1], frames[:1].roll(1, -1),
                         255 - frames[:1]], dim=1).contiguous()
    rows = []

    def run(kernel, name, fn, plain, check=_same, device=False,
            entry=None):
        same = check(fn(), plain())
        torch.cuda.synchronize()
        ms = _time_ms(fn, args.iters)
        rows.append({"kernel": kernel, "case": name, "bitwise": same,
                     "ms": ms, **(_device_work(fn) if device else {}),
                     **(_host_split(fn, build.library(), entry, args.iters)
                        if entry else {})})
        extra = (f", {rows[-1]['device_kernels']} device kernels and "
                 f"{rows[-1]['device_ms']} device ms a call" if device
                 else "")
        if entry:
            extra += (f", host {rows[-1]['host_ms']:.4f} ms a call, "
                      f"{rows[-1]['entry_ms']:.4f} of it in {entry}")
        print(f"{kernel} {name}: {ms:.4f} ms, bitwise {same}{extra}")

    for B in (1, 8):
        run("_batch_pyramid", f"gray8 1024^2 T=(4, 8) B={B}",
            lambda B=B: _batch_pyramid(frames[:B], (4, 8), 2, 30.0),
            lambda B=B: tuple(t.to(dev) for t in _batch_pyramid(
                frames[:B].cpu(), (4, 8), 2, 30.0)), device=True)
    try:
        from shape_based_matching_tpu_torch.ops.cuda.pyramid import (
            linear_memories, linear_memories_plain)
        from shape_based_matching_tpu_torch.ops.filters import (
            pyr_down_u8_plain)
    except ImportError:  # a checkout from before csrc/pyramid.cu
        linear_memories = None
    if linear_memories is not None:
        for B in (1, 8):
            run("pyramid.cu pyr_down", f"1024^2 B={B}",
                lambda B=B: pyr_down(frames[:B]),
                lambda B=B: pyr_down_u8_plain(frames[:B]), device=True)
        for side, imgs, T in (("1024^2", frames, 4), ("512^2", half, 8)):
            sp = quant_spread(imgs, 30.0, T)
            for B in (1, 8):
                run("pyramid.cu linear_memories", f"{side} T={T} B={B}",
                    lambda sp=sp[:B], T=T: linear_memories(sp, T),
                    lambda sp=sp[:B], T=T: linear_memories_plain(sp, T),
                    device=True)
    for name, imgs, T in (("gray8 1024^2 T=4 B=1", frames[:1], 4),
                          ("color8 1024^2 T=4 B=1", color, 4),
                          ("gray8 1024^2 T=4 B=8", frames, 4),
                          ("gray8 512^2 T=8 B=1", half[:1], 8),
                          ("gray8 512^2 T=8 B=8", half, 8)):
        run("frontend.cu", name,
            lambda imgs=imgs, T=T: quant_spread(imgs, 30.0, T),
            lambda imgs=imgs, T=T: quant_spread_plain(imgs, 30.0, T))
    if "patch_2843" in inspect.signature(quant_spread).parameters:
        for name, imgs in (("gray8 1024^2 T=4 B=1 patch_2843", frames[:1]),
                           ("gray8 1024^2 T=4 B=8 patch_2843", frames)):
            run("frontend.cu", name,
                lambda imgs=imgs: quant_spread(imgs, 30.0, 4,
                                               patch_2843=True),
                lambda imgs=imgs: quant_spread_plain(imgs, 30.0, 4,
                                                     patch_2843=True))
    sass = _frontend_sass(build.library_path(), build._nvcc())
    print("frontend.cu SASS: " + ", ".join(
        f"{k} {v['instructions']} instructions sha {v['sha']}"
        for k, v in sorted(sass.items())))

    pyr = synthetic.load_bank_cache(os.path.join(
        root, "bench_banks", os.path.basename(
            synthetic.bank_cache_path(10000, 63))))
    bank = pyramids_to_banks(pyr, 2)[-1]
    plan = plan_to_device(plan_chain(LevelBank(*(f.numpy() for f in bank)),
                                     8, (512, 512)), dev)
    bank = LevelBank(*(f.to(dev) for f in bank))
    pos = _positions(bank, 8, 64, 64)
    rmin, _ = _rmin_for_threshold(bank.nfeat,
                                  torch.tensor(85.0, device=dev))
    lms = _batch_pyramid(frames, (4, 8), 2, 30.0)
    for B in (1, 8):
        cargs = (lms[1][:B], plan, pos, rmin)
        run("chain.cu", f"K=10000 M=4096 B={B}",
            lambda cargs=cargs: chain_scores(*cargs),
            lambda cargs=cargs: chain_scores_plain(*cargs))
    thr = torch.tensor(85.0, device=dev)
    for n_templates, cap in ((1000, 1024), (10000, 4096)):
        pyr = synthetic.load_bank_cache(os.path.join(
            root, "bench_banks", os.path.basename(
                synthetic.bank_cache_path(n_templates, 63))))
        banks = pyramids_to_banks(pyr, 2, dev)
        chain = plan if n_templates == 10000 else None
        k, x, y, _, valid, _ = coarse_extract(lms[1][:1], banks[1], 8,
                                              (512, 512), thr, cap, chain)
        K = banks[0].fx.shape[0]
        slots, slot_of_k, n_distinct = distinct_templates(k, valid, K, K)
        D = next((d for d in _D_BUCKETS if int(n_distinct) <= d < K), K)
        Sfull = coarse_maps(lms[0][:1], _flat_offsets(
            gather_bank(banks[0], slots[:D]), 4, 256, 65536, (1024, 1024)),
            65536)
        rargs = (banks[0], 4, (1024, 1024), k, x, y, valid, thr)
        window = refine_candidates(lms[0][:1], *rargs)
        case = f"K={n_templates} C={cap} D={D} ({int(valid.sum())} valid)"
        run("refine_from_maps", case,
            lambda Sfull=Sfull, slot_of_k=slot_of_k, rargs=rargs:
            refine_from_maps(Sfull, slot_of_k, *rargs),
            lambda window=window: window, check=_same_valid,
            device=True, entry="sbm_map_refine")
        C = k.shape[1]
        rows[-1]["alloc_ms"] = _host_ms(
            lambda C=C: [torch.empty((1, C), dtype=t, device=dev)
                         for t in (torch.int32, torch.int32, torch.int32,
                                   torch.float32, torch.bool)], args.iters)
        print(f"  five [1, {C}] output allocations: "
              f"{rows[-1]['alloc_ms']:.4f} ms on the host")
        run("refine_by_maps", case,
            lambda rargs=rargs: refine_by_maps(lms[0][:1], *rargs),
            lambda window=window: window, check=_same_valid,
            device=True)

    def extract_args(n_templates, batch, thr):
        """extract_counted's arguments but the cap at the coarse level of
        `batch` (the checkout's chain.cu where its planner engages, else
        coarse.cu) and the largest n_above."""
        det = Detector(num_features=63, T=(4, 8), device=dev)
        det.class_templates["c"] = synthetic.load_bank_cache(os.path.join(
            root, "bench_banks", os.path.basename(
                synthetic.bank_cache_path(n_templates, 63))))
        lms1, sizes, thr_t, _ = det._prepare(batch, None, thr, ["c"])
        lbank = det._get_banks("c")[-1]
        W1, H1 = sizes[-1][0] // 8, sizes[-1][1] // 8
        lpos = _positions(lbank, 8, W1, H1)
        lrmin, t4n = _rmin_for_threshold(lbank.nfeat, thr_t)
        lplan = det._get_chain("c", sizes[-1])
        if lplan is not None:
            S, cnt = chain_scores(lms1[-1], lplan, lpos, lrmin)
        else:
            S, cnt = coarse_scores(lms1[-1], _flat_offsets(
                lbank, 8, W1, W1 * H1, sizes[-1]), lpos, lrmin, W1 * H1)
        n_above = int(extract_counted_plain(S, cnt, lpos, lrmin, t4n, 8,
                                            W1, 0)[5].max())
        return (S, cnt, lpos, lrmin, t4n, 8, W1), n_above

    scenes = frames.cpu().numpy()
    huge = _synthetic().huge_frame()[None]
    for label, n_templates, batch, thr, cap in (
            ("flagship step B=1", 1000, scenes[:1], 85.0, 256),
            ("flagship step B=8", 1000, scenes, 85.0, 256),
            ("flagship re-run", 1000, scenes[:1], 85.0, 1024),
            ("dense 1024^2 chain rows", 10000, scenes[:1], 85.0, 4096),
            ("4096^2 re-run", 10000, huge, 85.0, 65536),
            ("4096^2 at 60 re-run", 10000, huge, 60.0, None)):
        eargs, n_above = extract_args(n_templates, batch, thr)
        eargs = (*eargs, n_above if cap is None else cap)
        S = eargs[0]
        run("extract_counted", f"{label} B={S.shape[0]} K={S.shape[1]} "
            f"M={S.shape[2]} C={eargs[7]} (n_above {n_above})",
            lambda eargs=eargs: extract_counted(*eargs),
            lambda eargs=eargs: extract_counted_plain(*eargs),
            check=_same_extract, device=True)
        del eargs, S
    out = {"root": root, "card": f"{torch.cuda.get_device_name(0)} [{smi}]",
           "rows": rows, "frontend_sass": sass}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not all(r["bitwise"] for r in rows):
        raise SystemExit("a kernel disagrees with its twin")


if __name__ == "__main__":
    main()
