"""One run of one cell: set-up, the measured or traced window, and the
comparison with the reference that decides ``correct``.

A cell of ``BENCHMARK.json`` names a configuration (its file, under
``portbench/configs/``) and a traffic mix (``portbench/traffic/<name>.json``);
its per-layer metrics are readers ``portbench/metrics/<metric>.py``. All
of them are found by name under the checkout's root, so a cell, a mix or
a metric is added by files alone.

Set-up loads the port's compiled libraries (building them in a checkout
that lacks them), trains the configuration's bank on the device through
the port's public API (``Detector.add_template`` on the shape image,
then ``add_templates_rotate`` for every further angle, as upstream's
angle_test does), makes the pool of frames on the host, and warms up by
one pass over the pool, so every shape the window meets (the overflow
re-runs' caps included) has run once. The window is a closed loop with
one client: each call hands the API host numpy frames and gets the match
lists back on the host, and the next call starts when it returns.

After the window, the program's state is dropped and the reference
(``portbench/reference/``) trains its own bank from the same image and
matches the sampled pool frames; every answer the window gave for those
frames is compared with it.
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import time
import traceback
from collections import defaultdict

import numpy as np

from . import frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "shape_based_matching_tpu")
CLASS_ID = "bench"
# seconds of whole untraced passes before a traced one (--trace 1)
UNTRACED_S = 2.0


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules, compared whole, that a run of the
    port must never load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The cell `workload` of ``<root>/BENCHMARK.json`` with its
    configuration, traffic mix and metric entries. KeyError when there is
    no such cell."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": _load_json(os.path.join(root, entry["file"])),
        "traffic": _load_json(os.path.join(root, "portbench", "traffic",
                                           cell["traffic"] + ".json")),
        "end_to_end": _for_cell(bench["end_to_end"], workload),
        "per_layer": _for_cell(bench["per_layer"], workload),
    }


def load_reader(root: str, name: str):
    """The ``read`` function of ``<root>/portbench/metrics/<name>.py``."""
    import importlib.util

    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Client:
    """The station's driver: call i hands the API the pool frames
    ``frames_of(i)`` and returns (their pool indices, one match list
    each)."""

    def __init__(self, det, traffic: dict, pool: np.ndarray,
                 threshold: float):
        self.det, self.pool, self.threshold = det, pool, threshold
        self.api = traffic["api"]
        self.batch = int(traffic.get("batch", 1))
        if self.api not in ("match", "match_batch"):
            raise ValueError(f"unknown api {self.api!r}")
        if self.api == "match" and self.batch != 1:
            raise ValueError("api 'match' takes one frame a call")
        self.calls_per_pass = len(pool) // self.batch

    def frames_of(self, i: int) -> range:
        b0 = (i % self.calls_per_pass) * self.batch
        return range(b0, b0 + self.batch)

    def __call__(self, i: int):
        idx = self.frames_of(i)
        if self.api == "match":
            return idx, [self.det.match(self.pool[idx.start],
                                        self.threshold)]
        return idx, self.det.match_batch(self.pool[idx.start:idx.stop],
                                         self.threshold)

    def api_span(self) -> tuple:
        """(owner, attribute, span name) of the API entry, for tracing."""
        return (type(self.det), self.api, "detector." + self.api)


class WindowLog:
    """A window's calls, and its answers for the frames to check."""

    def __init__(self, sample):
        self.sample = set(sample)
        self.kept = defaultdict(list)   # pool index -> answers
        self.due = defaultdict(int)     # pool index -> calls that ran it
        self.calls = []                 # (latency, frames) a call
        self.frames = 0
        self.failed = 0

    def run(self, client: Client, n_calls=None, seconds=None) -> float:
        """`n_calls` calls, or calls until `seconds` have passed (the call
        under way finishes); returns the elapsed seconds."""
        i = 0
        t0 = t1 = time.perf_counter()
        deadline = t0 + (seconds if seconds is not None else math.inf)
        while i < n_calls if n_calls is not None else t1 < deadline:
            a = time.perf_counter()
            try:
                idx, answers = client(i)
            except Exception:  # a failed call is counted, not fatal
                if not self.failed:
                    traceback.print_exc()
                idx, answers = client.frames_of(i), None
            t1 = time.perf_counter()
            self.calls.append((t1 - a, len(idx)))
            self.frames += len(idx)
            for j, pos in enumerate(idx):
                if pos in self.sample:
                    self.due[pos] += 1
                    if answers is not None:
                        self.kept[pos].append(answer_rows(answers[j]))
            if answers is None:
                self.failed += len(idx)
            i += 1
        return t1 - t0

    def latencies(self) -> list:
        """Every frame's latency: its call's."""
        return [lat for lat, n in self.calls for _ in range(n)]

    def profile(self) -> str:
        """Frames a second in each second of the window, and the median
        latency: how steady the window was."""
        per_s, t, n = [], 0.0, 0
        for lat, frames_ in self.calls:
            t += lat
            n += frames_
            if t >= 1.0:
                per_s.append(round(n / t, 1))
                t, n = 0.0, 0
        lat = sorted(self.latencies())
        return (f"frames/s by second {per_s}; median "
                f"{lat[len(lat) // 2] * 1e3:.3f} ms")


def p95(values: list) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def port_fingerprint(det) -> list:
    """The trained bank as ``reference.training.fingerprint`` gives it."""
    return [tuple((t.width, t.height, t.tl_x, t.tl_y,
                   tuple((f.x, f.y, f.label) for f in t.features))
                  for t in tp) for tp in det.class_templates[CLASS_ID]]


def answer_rows(matches) -> np.ndarray:
    """A match list as int64 rows (template_id, x, y, float32 score
    bits): a kept answer holds no Python objects, so keeping answers
    adds nothing to the window's garbage collections."""
    sims = np.array([m.similarity for m in matches], np.float32)
    return np.stack([np.array([m.template_id for m in matches], np.int64),
                     np.array([m.x for m in matches], np.int64),
                     np.array([m.y for m in matches], np.int64),
                     sims.view(np.int32).astype(np.int64)], axis=1)


def answer_set(rows: np.ndarray) -> tuple:
    """Kept rows as a set of tuples, and how many rows repeat one
    already in it."""
    s = set(map(tuple, rows.tolist()))
    return s, len(rows) - len(s)


def compare(kept: dict, due: dict, reference: dict) -> dict:
    """The numbers compared, from the answers kept per pool frame and the
    reference's set per pool frame."""
    mismatch = checked = missing = 0
    for pos, want in reference.items():
        missing += due.get(pos, 0) - len(kept.get(pos, []))
        for answer in kept.get(pos, []):
            got, repeats = (answer if isinstance(answer, tuple)
                            else answer_set(answer))
            mismatch += len(got ^ want) + repeats
            checked += 1
    return {"list_mismatch": mismatch, "lists_checked": checked,
            "lists_missing": missing}


def reference_bank(config: dict, shape: np.ndarray, device,
                   **control) -> tuple:
    """The reference's bank trained from `shape`: its fingerprint and
    its levels packed on `device` (`control`: ``training.train_bank``'s
    lower-precision setting, for the control)."""
    from .reference import line2d, training

    T = config["T"]
    bank = training.train_bank(
        shape, frames.template_angles(config), int(config["num_features"]),
        len(T), float(config["weak_threshold"]),
        float(config["strong_threshold"]), **control)
    return training.fingerprint(bank), [
        line2d.pack_bank(training.level_views(bank, l), device)
        for l in range(len(T))]


def bank_difference(got: list, want: list) -> int:
    """Templates whose pyramid differs, and templates on one side only."""
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def reference_sets(config: dict, banks: list, pool: np.ndarray, positions,
                   device, score_dtype=None) -> dict:
    """The reference's match set for each pool frame in `positions`."""
    import torch

    from .reference import line2d

    sets = {}
    for pos in positions:
        f = torch.from_numpy(np.ascontiguousarray(pool[pos])).to(device)
        sets[pos] = line2d.match_frame(
            f, banks, tuple(int(t) for t in config["T"]),
            float(config["weak_threshold"]),
            float(config["match_threshold"]), score_dtype or torch.float32)
    return sets


def load_libraries(on_card: bool) -> bool:
    """Load the port's compiled libraries (the host helpers, and the CUDA
    kernels on a card), building those that the checkout lacks. True
    where this process built one: its set-up then holds the compilers'
    time, which the ``kernels`` phase of the set-up line shows."""
    from shape_based_matching_tpu_torch.models import native

    libs = [native]
    if on_card:
        from shape_based_matching_tpu_torch.ops.cuda import build

        libs.append(build)
    built = not all(os.path.isfile(lib.library_path()) for lib in libs)
    for lib in libs:
        lib.library()
    return built


def _nvidia_smi() -> dict:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, limit = (v.strip() for v in out[0].split(",", 1))
    return {"smi_name": name, "power_limit": limit}


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", root: str = ROOT) -> dict:
    """One run of cell `workload`. Returns the result line's fields, with
    "checks" (each number compared and its limit) last."""
    import torch

    from shape_based_matching_tpu_torch import Detector

    spec = load_cell(workload, root)
    config, traffic = spec["config"], spec["traffic"]
    on_card = torch.device(device).type == "cuda"

    # --- set-up: kernels, bank, frames, warm-up ------------------------
    phases = [("imports", time.perf_counter())]
    built = load_libraries(on_card)
    phases.append(("kernels", time.perf_counter()))
    shape = frames.shape_image(config, seed)
    angles = frames.template_angles(config)
    T = tuple(int(t) for t in config["T"])
    det = Detector(num_features=int(config["num_features"]), T=T,
                   weak_threshold=float(config["weak_threshold"]),
                   strong_threshold=float(config["strong_threshold"]),
                   device=device)
    tid = det.add_template(shape, CLASS_ID, np.full_like(shape, 255))
    if tid != 0:
        raise RuntimeError("training the configuration's shape failed")
    det.add_templates_rotate(CLASS_ID, tid, angles[1:],
                             (shape.shape[1] / 2.0, shape.shape[0] / 2.0))
    phases.append(("bank", time.perf_counter()))
    pool = frames.frame_pool(config, traffic, shape, seed)
    phases.append(("frames", time.perf_counter()))
    counts = frames.instance_counts(traffic, seed)
    sample = frames.check_sample(traffic, seed, counts)
    client = Client(det, traffic, pool, float(config["match_threshold"]))
    for i in range(client.calls_per_pass):
        client(i)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    phases.append(("warm-up", t_start + setup_s))
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a)
        in zip(phases, [("start", t_start)] + phases[:-1])),
        file=sys.stderr)

    # --- the window ----------------------------------------------------
    win = WindowLog(sample)
    metrics, extra = {}, {}
    if not trace:
        elapsed = win.run(client, seconds=seconds)
        print("window: " + win.profile(), file=sys.stderr)
        values = {"frames_per_s": (win.frames / elapsed, "frames/s"),
                  "frame_ms_p95": (p95(win.latencies()) * 1e3, "ms"),
                  "setup_s": (setup_s, "s")}
        for m in spec["end_to_end"]:
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    else:
        from . import trace as tr

        # whole passes untraced first, on the host clock, for the window's
        # own seconds a frame: the profiler slows the host's dispatch
        f0, t0 = win.frames, time.perf_counter()
        while time.perf_counter() - t0 < UNTRACED_S:
            win.run(client, n_calls=client.calls_per_pass)
        untraced = (time.perf_counter() - t0) / (win.frames - f0)

        def one_pass():
            f1 = win.frames
            win.run(client, n_calls=client.calls_per_pass)
            return win.frames - f1

        records = defaultdict(list)
        w = tr.traced_window(one_pass, records, client.api_span())
        w.untraced_s_per_frame = untraced
        tracing = {"untraced_ms_per_frame": untraced * 1e3,
                   "traced_ms_per_frame": w.window_s / w.frames * 1e3}
        print("tracing: {untraced_ms_per_frame:.4f} ms a frame untraced, "
              "{traced_ms_per_frame:.4f} traced".format(**tracing),
              file=sys.stderr)
        for m in spec["per_layer"]:
            v = load_reader(root, m["name"])(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": w.busy_s if w.busy_s is not None else 0.0,
                 "window_s": w.window_s}
        breakdown = tr.breakdown(w)
        del w, records
    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count())) if on_card else 0)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), **extra}
    if on_card:
        dev.update(_nvidia_smi())

    # --- correctness -----------------------------------------------------
    got_bank = port_fingerprint(det)
    del client, det
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want_bank, banks = reference_bank(config, shape, device)
    sets = reference_sets(config, banks, pool, sorted(win.due), device)
    bank_mismatch = bank_difference(got_bank, want_bank)
    cmp = compare(win.kept, win.due, sets)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s for the bank and "
          f"{len(sets)} frames", file=sys.stderr)
    checks = {
        "bank_mismatch": {"value": bank_mismatch, "limit": 0},
        "list_mismatch": {"value": cmp["list_mismatch"], "limit": 0},
        "lists_missing": {"value": cmp["lists_missing"], "limit": 0},
        "failed_frames": {"value": win.failed, "limit": 0},
        "lists_checked": {"value": cmp["lists_checked"], "at_least": 1},
    }
    correct = (all(c["value"] <= c["limit"] for c in checks.values()
                   if "limit" in c)
               and cmp["lists_checked"] >= 1)
    out = {"correct": correct, "attempted": win.frames, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = breakdown
        out["tracing"] = tracing
    out["setup"] = {"built": built, "setup_s": setup_s,
                    "build_s": phases[1][1] - phases[0][1]}
    out["checks"] = checks
    return out
