"""Time the launch choices of the port's CUDA kernels on one NVIDIA GPU.

    python tools/tune_torch_split.py [--iters 30]
        [--kernels coarse,refine,chain,frontend]

At the shapes the PyTorch port's match paths give these kernels -- the
flagship (1000 x 32 coarse slots, 256 windows of 63 features, level maps
of 1024 templates of the 10,000-template bank, the frontend at 1024^2 T=4
and 512^2 T=8, B=1 and B=8), the 8 x 8191 bank (8 x 3073 coarse slots,
windows of 9126 features at caps 256 and 1024, on its own frame and
candidates) and the 10,000-template bank's chain (B=1 and B=8) -- each
candidate choice is held against the plain twin bitwise and then timed
with CUDA events (warm mean of `iters` queued launches): slot groups G of
coarse.cu; candidates per block CB and feature groups G of refine.cu
(CB 1 is window_kernel, 8 cluster_kernel); segment length Z and start
of chain.cu; rows per block RS of
frontend.cu. The wrapper's own choice (``coarse_split``,
``refine_split``, ``SEG_TEMPLATES``, ``frontend_split``)
is marked. Prints one line per choice and writes
chiprun_out/tune_torch_split.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _coarse_cases(cs):
    """(name, args of coarse_scores or coarse_maps, counted)."""
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.similarity import (
        _flat_offsets, _positions, _rmin_for_threshold, gather_bank)
    from shape_based_matching_tpu_torch.utils.synthetic import (
        load_bank_cache)

    out = []
    for name in ("e2e1000", "wide8191"):
        kwargs, cid, pyramids, frame, mask, thr, _ = (
            cs._mode_path(name) if name != "e2e1000" else _flagship(cs))
        det = Detector(**kwargs, device="cuda")
        det.class_templates[cid] = pyramids
        banks = det._get_banks(cid)
        sizes = det._level_sizes(frame.shape[:2])
        frames, _ = cs._upload(frame, None, torch.device("cuda"))
        lms = _batch_pyramid(frames, det.T_at_level, det.pyramid_levels,
                             det.weak_threshold)
        T1, (w1, h1) = det.T_at_level[1], sizes[1]
        W1, H1 = w1 // T1, h1 // T1
        off = _flat_offsets(banks[1], T1, W1, W1 * H1, sizes[1])
        pos = _positions(banks[1], T1, W1, H1)
        rmin, _ = _rmin_for_threshold(banks[1].nfeat, torch.tensor(
            float(thr), device="cuda"))
        out.append((f"{name} coarse K={off.shape[0]} N={off.shape[1]}",
                    (lms[1], off, pos, rmin, W1 * H1), True, det, banks,
                    sizes, lms, thr))
    # level maps of 1024 of the 10,000 templates at level 0 of the
    # flagship frame (the dense re-run's D bucket)
    det, lms = out[0][3], out[0][6]
    pyr = load_bank_cache(os.path.join(ROOT, json.load(open(
        cs.DENSE_GOLDEN))["config"]["bank"]))
    det.class_templates["dense"] = pyr
    bank0 = det._get_banks("dense")[0]
    ids = np.sort(np.random.RandomState(0).choice(10000, 1024, False))
    sub = gather_bank(bank0, torch.from_numpy(ids.astype(np.int32)).cuda())
    T0, (w0, h0) = det.T_at_level[0], out[0][5][0]
    off0 = _flat_offsets(sub, T0, w0 // T0, (w0 // T0) * (h0 // T0),
                         (w0, h0))
    out.append(("dense level maps D=1024 N=63",
                (lms[0], off0, (w0 // T0) * (h0 // T0)), False, None, None,
                None, None, None))
    return out


def _flagship(cs):
    golden = json.load(open(cs.GOLDEN))
    cfg = golden["config"]
    from shape_based_matching_tpu_torch.utils.synthetic import (
        load_bank_cache)

    pyramids = load_bank_cache(os.path.join(ROOT, cfg["bank"]))
    return ({"num_features": cfg["num_features"], "T": tuple(cfg["T"])},
            golden["class_id"], pyramids, cs._scene(cfg), None,
            cs.THRESHOLD, None)


def _tune_chain(cs, card: str, iters: int) -> list:
    """chain.cu's segment length Z on the 10,000-template bank at the
    dense frame's coarse level, B=1 and B=8."""
    from shape_based_matching_tpu_torch.models.detector import (
        _batch_pyramid)
    from shape_based_matching_tpu_torch.ops.chain_plan import plan_chain
    from shape_based_matching_tpu_torch.ops.cuda import chain
    from shape_based_matching_tpu_torch.ops.similarity import (
        LevelBank, _positions, _rmin_for_threshold)
    from shape_based_matching_tpu_torch.utils.convert import (
        pyramids_to_banks)
    from shape_based_matching_tpu_torch.utils.synthetic import (
        load_bank_cache)

    cfg = json.load(open(cs.DENSE_GOLDEN))["config"]
    bank = pyramids_to_banks(load_bank_cache(os.path.join(
        ROOT, cfg["bank"])), 2)[-1]
    host = plan_chain(LevelBank(*(f.numpy() for f in bank)), 8, (512, 512))
    bank = LevelBank(*(f.cuda() for f in bank))
    pos = _positions(bank, 8, 64, 64)
    rmin, _ = _rmin_for_threshold(bank.nfeat,
                                  torch.tensor(cs.THRESHOLD, device="cuda"))
    frames = torch.from_numpy(np.stack([cs._scene(
        {**cfg, "scene_seed": cfg["scene_seed"] + i})
        for i in range(cs.BATCH)])).cuda()
    lms = _batch_pyramid(frames, (4, 8), 2, 30.0)
    rows = []
    for B in (1, cs.BATCH):
        lmflat = lms[1][:B]
        want = chain.chain_scores_plain(lmflat, chain.plan_to_device(
            host, "cuda"), pos, rmin)
        for Z in (1, 4, 8, 16, 32, 64, 128):
            seg = chain.segment_plan(host, Z)
            plan = chain.plan_to_device(seg, "cuda")
            got = chain.chain_scores(lmflat, plan, pos, rmin)
            torch.cuda.synchronize()
            same = all(torch.equal(g, e) for g, e in zip(got, want))
            ms = cs._time_ms(lambda: chain.chain_scores(
                lmflat, plan, pos, rmin), iters)
            ss = host.slot_start
            walks = (seg.segs[:, 3] - seg.segs[:, 2]
                     + ss[seg.segs[:, 1]] - ss[seg.segs[:, 0]])
            own = Z == chain.SEG_TEMPLATES
            rows.append({"kernel": "chain.cu", "B": B, "Z": Z,
                         "segments": len(seg.segs),
                         "slot_visits": int(walks.sum()),
                         "longest_walk": int(walks.max()), "own": own,
                         "bitwise": same, "ms": ms})
            print(f"chain B={B} Z={Z}{' (own)' if own else ''}: "
                  f"{len(seg.segs)} segments, {int(walks.sum())} slot "
                  f"visits, longest {int(walks.max())}; bitwise {same} "
                  f"{ms:.4f} ms on {card}")
    return rows


def _tune_frontend(cs, card: str, iters: int) -> list:
    """frontend.cu's rows per block at the flagship's level sizes, B=1
    and B=8, gray and color."""
    from shape_based_matching_tpu_torch.ops.cuda import frontend
    from shape_based_matching_tpu_torch.ops.cuda.pyramid import pyr_down

    own_split = frontend.frontend_split
    cfg = json.load(open(cs.GOLDEN))["config"]
    full = torch.from_numpy(np.stack([cs._scene(
        {**cfg, "scene_seed": cfg["scene_seed"] + i})
        for i in range(cs.BATCH)])).cuda()
    color = torch.stack([full[:1], full[:1].roll(1, -1), 255 - full[:1]],
                        dim=1).contiguous()
    rows = []
    for name, imgs, T in (("gray8 1024^2 T=4", full, 4),
                          ("gray8 512^2 T=8", pyr_down(full), 8),
                          ("color8 1024^2 T=4", color, 4)):
        for B in ((1, cs.BATCH) if imgs.shape[0] > 1 else (1,)):
            x = imgs[:B]
            want = frontend.quant_spread_plain(x, 30.0, T)
            own = own_split(B, *x.shape[-2:], T)
            for RS in sorted({4, 8, 16, 32, 64, own}):
                frontend.frontend_split = lambda *a, rs=RS: rs
                got = frontend.quant_spread(x, 30.0, T)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                ms = cs._time_ms(lambda: frontend.quant_spread(x, 30.0, T),
                                 iters)
                rows.append({"kernel": "frontend.cu", "case": name, "B": B,
                             "RS": RS, "own": RS == own, "bitwise": same,
                             "ms": ms})
                print(f"frontend {name} B={B}: RS={RS}"
                      f"{' (own)' if RS == own else ''} bitwise {same} "
                      f"{ms:.4f} ms on {card}")
            frontend.frontend_split = own_split
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--kernels", default="coarse,refine,chain,frontend")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("tune_torch_split: CUDA is not available")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from shape_based_matching_tpu_torch.ops.cuda import coarse, refine
    from shape_based_matching_tpu_torch.ops.similarity import (
        coarse_extract)
    from shape_based_matching_tpu_torch.ops.window import window_origin

    card = f"{torch.cuda.get_device_name(0)} [{cs._nvidia_smi()}]"
    print(card)
    rows = []
    if "chain" in kernels:
        rows += _tune_chain(cs, card, args.iters)
    if "frontend" in kernels:
        rows += _tune_frontend(cs, card, args.iters)
    own_coarse, own_refine = coarse.coarse_split, refine.refine_split
    cases = _coarse_cases(cs) if kernels & {"coarse", "refine"} else []
    for name, cargs, counted, *_ in (cases if "coarse" in kernels else []):
        lmflat, off = cargs[0], cargs[1]
        B, K, N, M = lmflat.shape[0], *off.shape, cargs[-1]
        fn = coarse.coarse_scores if counted else coarse.coarse_maps
        plain = coarse.coarse_scores_plain if counted \
            else coarse.coarse_maps_plain
        want = plain(*cargs)
        own = own_coarse(B, K, N, M)
        for G in sorted({1, 2, 9, 33, 66, 132, own[0]}):
            if G > 1 and N < 2 * G:
                continue
            chunk = -(-N // G)
            coarse.coarse_split = lambda *a, s=(-(-N // chunk), chunk): s
            got = fn(*cargs)
            torch.cuda.synchronize()
            same = all(torch.equal(g, e) for g, e in zip(
                got if counted else (got,), want if counted else (want,)))
            ms = cs._time_ms(lambda: fn(*cargs), args.iters)
            rows.append({"kernel": "coarse.cu", "case": name, "G": G,
                         "chunk": chunk, "own": (G, chunk) == own,
                         "bitwise": same, "ms": ms})
            mark = " (own)" if rows[-1]["own"] else ""
            print(f"{name}: G={G} chunk={chunk}{mark} bitwise {same} "
                  f"{ms:.4f} ms on {card}")
        coarse.coarse_split = own_coarse

    for name, _, _, det, banks, sizes, lms, thr in (
            cases[:2] if "refine" in kernels else []):
        T = det.T_at_level
        thr_t = torch.tensor(float(thr), device="cuda")
        for cap in (256, 1024):
            k, x, y, _, valid, _ = coarse_extract(
                lms[1], banks[1], T[1], sizes[1], thr_t, cap)
            wx, wy = window_origin(banks[0].width, banks[0].height, T[0],
                                   sizes[0], k, x, y)
            rargs = (lms[0], banks[0], T[0], sizes[0], k, wx, wy, valid)
            want = refine.refine_windows_plain(*rargs)
            N = banks[0].fx.shape[1]
            own = own_refine(N)
            label = (f"{name} window C={cap} N={N} "
                     f"({int(valid.sum())} live)")
            for CB, G in sorted({(1, 1), (8, 1), (8, 10), (8, 19),
                                 (8, 37), own[:2]}):
                if G > 1 and N < 2 * G:
                    continue
                chunk = -(-N // G)
                refine.refine_split = lambda *a, s=(CB, -(-N // chunk),
                                                    chunk): s
                got = refine.refine_windows(*rargs)
                torch.cuda.synchronize()
                same = all(torch.equal(g, e) for g, e in zip(got, want))
                ms = cs._time_ms(lambda: refine.refine_windows(*rargs),
                                 args.iters)
                rows.append({"kernel": "refine.cu", "case": label,
                             "CB": CB, "G": G, "chunk": chunk,
                             "own": (CB, G, chunk) == own,
                             "bitwise": same, "ms": ms})
                print(f"{label}: CB={CB} G={G} chunk={chunk}"
                      f"{' (own)' if rows[-1]['own'] else ''} bitwise "
                      f"{same} {ms:.4f} ms on {card}")
            refine.refine_split = own_refine
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "tune_torch_split.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    if not all(r["bitwise"] for r in rows):
        raise SystemExit("a split choice disagrees with the twin")


if __name__ == "__main__":
    main()
