"""The program's own spans over an untraced pass: the spans pass, and the
command that measures it beside a cell's other passes.

A spans pass is one whole pass over the pool with the port's span
recorder on (``utils/profiling.recording``) and torch.profiler off, so a
span's host time is read at the speed the end-to-end metrics run at. The
readers ``portbench/metrics/*_ms_per_frame.py`` and
``candidates_per_frame.py`` read a pass from ``window.spans`` (a
``SpansPass``); where it is absent -- a run of a program without the
recorder, or a harness that runs no spans pass -- they read nothing.

    python3 -m portbench.spans --workload <cell> --seed <n> \
        [--pairs 10] [--side-seconds 1.0]

sets the cell up as a run does, then runs `pairs` pairs of untraced
passes and spans passes, whole passes for at least `side-seconds` a
side, alternating which side goes first; then `pairs` passes in which
every other call records, each call recording in every other pass (the
on-cost call by call, where the host's drifts between seconds cancel);
then the profiled pass of a traced run with the recorder on. It prints
one JSON line: ``metrics`` (the cell's per-layer metrics from the
profiled pass, and each spans-pass reader's median over the pairs),
``tracing`` (the untraced, spans and traced ms a frame, the on-cost as
the median ratio of a pair of sides and of a call's recorded and plain
latencies, ``spans_coverage``, the counters a frame, every span's host
and self ms a frame), ``breakdown`` (the profiled pass's, its idle gaps
named by the innermost span) and ``device``. ``--out FILE`` also
appends it there.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from collections import defaultdict

import numpy as np

from . import frames, harness

# the readers of a spans pass, beside the cell's own
READERS = ("upload_ms_per_frame", "pyramid_host_ms_per_frame",
           "coarse_host_ms_per_frame", "refine_host_ms_per_frame",
           "download_wait_ms_per_frame", "list_ms_per_frame",
           "candidates_per_frame")


class SpansPass:
    """What the readers see of one spans pass.

    frames    frames the pass completed
    seconds   the pass's length on the host clock
    spans     the ``SpanRecord`` s it kept (``utils/profiling``): name,
              start_ns, end_ns, parent index, request, attrs
    counters  the rise of each of ``Detector.counters`` over the pass
    """

    def __init__(self, frames_: int, seconds: float, spans: list,
                 counters: dict):
        self.frames = frames_
        self.seconds = seconds
        self.spans = spans
        self.counters = counters

    def host_s(self, *names: str):
        """Host seconds inside spans of these names; None where the pass
        kept none of them. Spans of one name never nest."""
        ds = [s.end_ns - s.start_ns for s in self.spans if s.name in names]
        return sum(ds) / 1e9 if ds else None

    def coverage(self):
        """The share of the root spans' time that their child spans cover
        (children of one parent run one after another); None without a
        root."""
        roots = {i: s for i, s in enumerate(self.spans) if s.parent < 0}
        covered = sum(s.end_ns - s.start_ns for s in self.spans
                      if s.parent in roots)
        total = sum(s.end_ns - s.start_ns for s in roots.values())
        return covered / total if total else None

    def by_name(self) -> dict:
        """{span name: (host ms a frame, self ms a frame)}: a span's self
        time is its own less its children's."""
        total, own = defaultdict(int), defaultdict(int)
        for s in self.spans:
            d = s.end_ns - s.start_ns
            total[s.name] += d
            own[s.name] += d
            if s.parent >= 0:
                own[self.spans[s.parent].name] -= d
        return {n: (total[n] / self.frames / 1e6, own[n] / self.frames / 1e6)
                for n in total}


def host_ms_per_frame(w, *names: str):
    """Host ms a frame in spans of these names over the spans pass of
    window `w`; None without a pass or without such spans."""
    sp = getattr(w, "spans", None)
    if sp is None or not sp.frames:
        return None
    s = sp.host_s(*names)
    return None if s is None else s / sp.frames * 1e3


def spans_pass(run_pass, det) -> SpansPass | None:
    """Run `run_pass()` (one untraced pass over the pool; it returns the
    frames it completed) with the recorder on; None where the program
    has no recorder."""
    try:
        from shape_based_matching_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    before = dict(getattr(det, "counters", {}))
    t0 = time.perf_counter()
    with recording() as rec:
        n = run_pass()
    seconds = time.perf_counter() - t0
    after = getattr(det, "counters", {})
    return SpansPass(n, seconds, rec.spans,
                     {k: v - before.get(k, 0) for k, v in after.items()})


def _setup(config: dict, traffic: dict, seed: int, device: str):
    """A run's set-up (``harness.run``): the libraries, the bank, the pool,
    one warm pass. Returns the client."""
    import torch

    from shape_based_matching_tpu_torch import Detector

    harness.load_libraries(torch.device(device).type == "cuda")
    shape = frames.shape_image(config, seed)
    det = Detector(num_features=int(config["num_features"]),
                   T=tuple(int(t) for t in config["T"]),
                   weak_threshold=float(config["weak_threshold"]),
                   strong_threshold=float(config["strong_threshold"]),
                   device=device)
    tid = det.add_template(shape, harness.CLASS_ID, np.full_like(shape, 255))
    if tid != 0:
        raise RuntimeError("training the configuration's shape failed")
    det.add_templates_rotate(harness.CLASS_ID, tid,
                             frames.template_angles(config)[1:],
                             (shape.shape[1] / 2.0, shape.shape[0] / 2.0))
    pool = frames.frame_pool(config, traffic, shape, seed)
    client = harness.Client(det, traffic, pool,
                            float(config["match_threshold"]))
    for i in range(client.calls_per_pass):
        client(i)
    return client


def measure(workload: str, seed: int, pairs: int, side_s: float = 1.0,
            device: str = "cuda", root: str = harness.ROOT) -> dict:
    """The command's result for one cell (see the module's docstring)."""
    import torch

    from . import trace as tr

    spec = harness.load_cell(workload, root)
    client = _setup(spec["config"], spec["traffic"], seed, device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()

    def one_pass():
        for i in range(client.calls_per_pass):
            client(i)
        return client.calls_per_pass * client.batch

    def side():
        t0 = time.perf_counter()
        n = one_pass()
        while time.perf_counter() - t0 < side_s:
            n += one_pass()
        return n

    def untraced():
        t0 = time.perf_counter()
        n = side()
        return (time.perf_counter() - t0) / n

    plain, passes = [], []
    for i in range(pairs):
        if i % 2:
            passes.append(spans_pass(side, client.det))
            plain.append(untraced())
        else:
            plain.append(untraced())
            passes.append(spans_pass(side, client.det))
    with_spans = [p.seconds / p.frames for p in passes]

    from shape_based_matching_tpu_torch.utils.profiling import recording

    calls = defaultdict(lambda: ([], []))  # call -> (plain s, recorded s)
    for k in range(pairs):
        for i in range(client.calls_per_pass):
            on = (i + k) % 2
            t0 = time.perf_counter()
            if on:
                with recording(capacity=1024):
                    client(i)
            else:
                client(i)
            calls[i][on].append(time.perf_counter() - t0)
    by_call = [statistics.median(b) / statistics.median(a)
               for a, b in calls.values()]

    records = defaultdict(list)
    with recording():
        w = tr.traced_window(one_pass, records, client.api_span())
    w.untraced_s_per_frame = statistics.median(plain)
    metrics = {}
    for m in spec["per_layer"]:
        v = harness.load_reader(root, m["name"])(w)
        if v is not None:
            metrics[m["name"]] = v
    for name in READERS:
        read = harness.load_reader(root, name)
        values = []
        for p in passes:
            w.spans = p
            values.append(read(w))
        if None not in values:
            metrics[name] = statistics.median(values)
            metrics[name + ".all"] = values
    idle = sum(s for _, s in w.gaps)
    outside = sum(s for n, s in w.gaps if n == "host outside the spans")
    last = passes[-1]
    tracing = {
        "untraced_ms_per_frame": statistics.median(plain) * 1e3,
        "spans_ms_per_frame": statistics.median(with_spans) * 1e3,
        "traced_ms_per_frame": w.window_s / w.frames * 1e3,
        "spans_over_untraced": statistics.median(
            s / u for s, u in zip(with_spans, plain)),
        "pairs_ms": [[u * 1e3, s * 1e3] for u, s in zip(plain, with_spans)],
        "calls_recorded_over_plain": statistics.median(by_call),
        "calls_ratio_quartiles": statistics.quantiles(by_call, n=4),
        "spans_coverage": statistics.median(p.coverage() for p in passes),
        "spans_a_frame": len(last.spans) / last.frames,
        "host_and_self_ms_per_frame": last.by_name(),
        "counters_per_frame": {k: v / last.frames
                               for k, v in sorted(last.counters.items())},
        "counters_in_passes": {k: sum(p.counters.get(k, 0) for p in passes)
                               for k in ("bank_builds", "chain_plans")},
        "host_outside_share_of_idle": outside / idle if idle else None,
    }
    dev = {"kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "busy_s": w.busy_s, "window_s": w.window_s}
    if on_card:
        dev.update(harness._nvidia_smi())
    return {"workload": workload, "seed": seed, "metrics": metrics,
            "tracing": tracing, "breakdown": tr.breakdown(w, top=16),
            "device": dev}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--side-seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    result = measure(args.workload, args.seed, args.pairs,
                     args.side_seconds, args.device)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
