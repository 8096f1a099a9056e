"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed in the nearest precision below
the one the configuration states, judged by the same comparison as a run:
the match lists with the score in bfloat16 (the configuration states
float32), the bank with addTemplate_rotate's rotated coordinates stored
in bfloat16 (the C++ stores them in float32). It has to come out as not
correct. Not run by the benchmark's runs.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

prints, per seed, one JSON line with each number compared: the control's
reading (its upper end, where it is three times the sound runs' or more,
is what the limit is set below). It runs at the cell's own sizes: its
bank, its pool of frames and as many sampled frames as a run compares.
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


def control_readings(workload: str, seed: int, device: str,
                     root: str = harness.ROOT) -> dict:
    """The numbers compared when the bfloat16 reference answers in place
    of the program for the sampled frames of a run of `workload`."""
    import torch

    spec = harness.load_cell(workload, root)
    config, traffic = spec["config"], spec["traffic"]
    lower = getattr(torch, SCORE_BELOW[config["score_dtype"]])
    shape = frames.shape_image(config, seed)
    pool = frames.frame_pool(config, traffic, shape, seed)
    sample = frames.check_sample(traffic, seed,
                                 frames.instance_counts(traffic, seed))
    want_bank, banks = harness.reference_bank(config, shape, device)
    low_bank, _ = harness.reference_bank(config, shape, "cpu",
                                         narrow=to_bfloat16)
    want = harness.reference_sets(config, banks, pool, sample, device)
    got = harness.reference_sets(config, banks, pool, sample, device,
                                 score_dtype=lower)
    kept = {pos: [(s, 0)] for pos, s in got.items()}
    out = harness.compare(kept, {p: 1 for p in sample}, want)
    out["bank_mismatch"] = harness.bank_difference(low_bank, want_bank)
    out["matches_in_reference"] = int(sum(len(s) for s in want.values()))
    return out


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
