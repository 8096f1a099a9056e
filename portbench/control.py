"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed in the nearest precision below
the one the configuration states, judged by the same comparison as a run
(``harness.verdict``): the bank with addTemplate_rotate's rotated
coordinates stored in bfloat16 (the C++ stores them in float32), and the
answers: for a match list, the score in bfloat16 (the configuration
states float32); for a ``match_icp`` mix, the ICP's transform, normal
equations, state and poses in bfloat16 over the float32 candidates
(``reference/icp.py``'s ``pose_dtype``). It has to come out as not
correct. Not run by the benchmark's runs. A cell whose configuration
names a deployment module (``portbench/deployments/``) takes its control
from that module's ``reference(..., lower=True)``, judged by the same
comparison.

For a ``match_icp`` mix it also reads faults planted in the reference
put in the program's place, each judged by the same verdict: a refine
that returns its state unchanged (each candidate's LINE-2D origin as its
pose, the reference's inlier counts and flags), the subpixel shifts
zeroed, one step fewer, half the steps, and the flood's largest or its
smallest stride dropped.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

prints, per seed, one JSON line: the whole control's ``correct``, the
bank's mismatch, and for the control's answers (``control``) and each
fault (``fault.<name>``) their ``correct`` with the bank held apart and
each number compared. It runs at the cell's own sizes: its bank, its
pool of frames and as many sampled frames as a run compares.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import frames, harness

SCORE_BELOW = {"float32": "bfloat16"}


def to_bfloat16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), as
    float32."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _judged(cmp: dict) -> dict:
    """``correct`` and each number compared of one set of answers (the
    bank held apart), with the widest pose gaps where there are poses."""
    checks, correct = harness.verdict(cmp, 0, 0)
    out = {"correct": correct}
    out.update({n: c["value"] for n, c in checks.items()})
    out.update({n: cmp[n] for n in harness.POSE_GAPS if n in cmp})
    return out


def _icp_faults(config: dict, traffic: dict, banks: list, pool, sample,
                device, want: dict) -> dict:
    """The faults' answers for the sampled frames, by name."""
    from unittest import mock

    import torch

    from .reference import icp

    def poses(**kw):
        return harness.reference_poses(config, traffic | kw, banks, pool,
                                       sample, device)

    def no_subpixel(frame, weak):
        e, nx, ny, sx, sy = real_edges(frame, weak)
        return e, nx, ny, torch.zeros_like(sx), torch.zeros_like(sy)

    real_edges, real_strides = icp._edges, icp.strides
    iters = int(traffic["iters"])
    out = {"unchanged": {p: {k: (0.0, 1.0, float(k[1]), float(k[2])) + v[4:]
                             for k, v in w.items()} for p, w in want.items()},
           f"steps_{iters - 1}": poses(iters=iters - 1),
           f"steps_{iters // 2}": poses(iters=iters // 2)}
    with mock.patch.object(icp, "_edges", no_subpixel):
        out["no_subpixel"] = poses()
    for drop in (real_strides(int(traffic["radius"]))[0], 1):
        with mock.patch.object(icp, "strides", lambda r: [
                s for s in real_strides(r) if s != drop]):
            out[f"stride_{drop}_dropped"] = poses()
    return out


def _deployment_readings(deployment, config: dict, traffic: dict,
                         seed: int, device: str) -> dict:
    """The control's reading when a deployment module's reference, one
    precision below the configuration's, answers in place of the program
    for the sampled frames of a run."""
    pool, counts = deployment.frame_pool(config, traffic, seed)
    sample = frames.check_sample(traffic, seed, counts)
    want_bank, want = deployment.reference(config, traffic, seed, pool,
                                           sample, device)
    low_bank, got = deployment.reference(config, traffic, seed, pool,
                                         sample, device, lower=True)
    cmp = harness.compare({pos: [(s, 0)] for pos, s in got.items()},
                          {p: 1 for p in sample}, want)
    bank_mismatch = harness.bank_difference(low_bank, want_bank)
    return {"correct": harness.verdict(cmp, 0, bank_mismatch)[1],
            "bank_mismatch": bank_mismatch,
            "matches_in_reference": int(sum(len(s) for s in want.values())),
            "control": _judged(cmp)}


def control_readings(workload: str, seed: int, device: str,
                     root: str = harness.ROOT) -> dict:
    """The control's reading when the bfloat16 reference answers in place
    of the program for the sampled frames of a run of `workload`, and for
    a ``match_icp`` mix the faults' readings."""
    import torch

    spec = harness.load_cell(workload, root)
    config, traffic = spec["config"], spec["traffic"]
    deployment = harness.load_deployment(config, root)
    if deployment is not None:
        return _deployment_readings(deployment, config, traffic, seed, device)
    lower = getattr(torch, SCORE_BELOW[config["score_dtype"]])
    shape = frames.shape_image(config, seed)
    pool = frames.frame_pool(config, traffic, shape, seed)
    sample = frames.check_sample(traffic, seed,
                                 frames.instance_counts(traffic, seed))
    want_bank, banks = harness.reference_bank(config, shape, device)
    low_bank, _ = harness.reference_bank(config, shape, "cpu",
                                         narrow=to_bfloat16)
    due = {p: 1 for p in sample}
    faults = {}
    if traffic["api"] == "match_icp":
        want = harness.reference_poses(config, traffic, banks, pool, sample,
                                       device)
        low = harness.reference_poses(config, traffic, banks, pool, sample,
                                      device, pose_dtype=torch.bfloat16)
        cmp = harness.compare_icp(
            {p: [harness.pose_rows(g)] for p, g in low.items()}, due, want)
        for name, got in _icp_faults(config, traffic, banks, pool, sample,
                                     device, want).items():
            faults["fault." + name] = _judged(harness.compare_icp(
                {p: [harness.pose_rows(g)] for p, g in got.items()}, due,
                want))
    else:
        want = harness.reference_sets(config, banks, pool, sample, device)
        got = harness.reference_sets(config, banks, pool, sample, device,
                                     score_dtype=lower)
        cmp = harness.compare({pos: [(s, 0)] for pos, s in got.items()},
                              due, want)
    bank_mismatch = harness.bank_difference(low_bank, want_bank)
    return {"correct": harness.verdict(cmp, 0, bank_mismatch)[1],
            "bank_mismatch": bank_mismatch,
            "matches_in_reference": int(sum(len(s) for s in want.values())),
            "control": _judged(cmp), **faults}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the comparison's control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        r = control_readings(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
