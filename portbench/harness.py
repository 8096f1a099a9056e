"""One run of one cell: set-up, the measured or traced window, and the
comparison with the reference that decides ``correct``.

A cell of ``BENCHMARK.json`` names a configuration (its file, under
``portbench/configs/``) and a traffic mix (``portbench/traffic/<name>.json``);
its per-layer metrics are readers ``portbench/metrics/<metric>.py``. All
of them are found by name under the checkout's root, so a cell, a mix or
a metric is added by files alone. A configuration that names a
deployment module (``"module": "<name>"``, the file
``portbench/deployments/<name>.py``, found by name under the root in the
same way) takes its training, its frames, its call and its reference
from that module; everything else of a run stays here (see
``portbench/deployments/__init__.py``).

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
frames is compared with it. A ``match_icp`` mix's answers are the
refined candidates: their keys are compared as a match list's are, and
their poses with ``reference/icp.py``'s, field by field within
``POSE_TOL``.
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
APIS = ("match", "match_batch", "match_icp")
# what a match_icp mix passes to the call besides the frame and threshold
ICP_ARGS = ("top_c", "iters", "radius", "cand_cap")
POSE_FIELDS = ("dtheta_deg", "dscale", "tx", "ty")
# A refined candidate's pose matches the reference's where each of
# |d dtheta_deg|, |d dscale|, |d tx| and |d ty| is under its tolerance
# and the valid flags are equal: the repository's tolerances for float32
# results that differ only in the order of their sums (its tests of the
# port against the JAX package, tests/test_torch_icp.py). The inlier
# counts are compared exactly besides.
POSE_TOL = {"dtheta_deg": 1e-3, "dscale": 1e-4, "tx": 1e-2, "ty": 1e-2}
# the widest gap of each field over the candidates compared, reported
# beside the counts (a NaN on one side reads NO_NUMBER)
POSE_GAPS = ("pose_gap_deg", "pose_gap_scale", "pose_gap_px")
# a gap that is no number (a NaN on one side)
NO_NUMBER = 1e30


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


def load_deployment(config: dict, root: str = ROOT):
    """The deployment module that `config` names under ``"module"``,
    ``<root>/portbench/deployments/<name>.py``, or None where it names
    none. KeyError when there is no such file."""
    name = config.get("module")
    if name is None:
        return None
    import importlib.util

    path = os.path.join(root, "portbench", "deployments", name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no deployment module {name!r} "
                       f"(portbench/deployments/{name}.py)")
    spec = importlib.util.spec_from_file_location(
        "portbench_deployment_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    ``frames_of(i)`` and returns (their pool indices, one answer each: a
    match list, or ``match_icp``'s refined candidates)."""

    def __init__(self, det, traffic: dict, pool: np.ndarray,
                 threshold: float):
        self.det, self.pool, self.threshold = det, pool, threshold
        self.api = traffic["api"]
        self.batch = int(traffic.get("batch", 1))
        if self.api not in APIS:
            raise ValueError(f"unknown api {self.api!r}")
        if self.api != "match_batch" and self.batch != 1:
            raise ValueError(f"api {self.api!r} takes one frame a call")
        self.icp = ({a: int(traffic[a]) for a in ICP_ARGS}
                    if self.api == "match_icp" else None)
        self.calls_per_pass = len(pool) // self.batch

    def frames_of(self, i: int) -> range:
        b0 = (i % self.calls_per_pass) * self.batch
        return range(b0, b0 + self.batch)

    def __call__(self, i: int):
        idx = self.frames_of(i)
        if self.api == "match":
            return idx, [self.det.match(self.pool[idx.start],
                                        self.threshold)]
        if self.api == "match_icp":
            return idx, [self.det.match_icp(self.pool[idx.start],
                                            self.threshold, **self.icp)]
        return idx, self.det.match_batch(self.pool[idx.start:idx.stop],
                                         self.threshold)

    def rows(self, answer) -> np.ndarray:
        """One answer as the int64 rows the window keeps."""
        return icp_rows(answer) if self.icp else answer_rows(answer)

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
                        self.kept[pos].append(client.rows(answers[j]))
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


def icp_rows(results) -> np.ndarray:
    """``match_icp``'s refined candidates as int64 rows: their matches'
    ``answer_rows``, then the float32 bits of dtheta_deg, dscale, tx and
    ty, then inliers and valid."""
    ids = answer_rows([r["match"] for r in results])
    pose = np.array([[r[f] for f in POSE_FIELDS] for r in results],
                    np.float32).reshape(-1, len(POSE_FIELDS))
    rest = np.array([[r["inliers"], r["valid"]] for r in results],
                    np.int64).reshape(-1, 2)
    return np.concatenate([ids, pose.view(np.int32).astype(np.int64), rest],
                          axis=1)


def pose_rows(poses: dict) -> np.ndarray:
    """``reference/icp.match_icp_frame``'s {key: pose} as ``icp_rows``."""
    rows = [list(k) + [int(np.float32(v).view(np.int32)) for v in p[:4]]
            + [int(p[4]), int(p[5])] for k, p in poses.items()]
    return np.array(rows, np.int64).reshape(-1, 10)


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


def _gap(a: float, b: float) -> float:
    if a == b:
        return 0.0
    d = abs(a - b)
    return d if math.isfinite(d) else NO_NUMBER


def compare_poses(kept: dict, reference: dict) -> dict:
    """From the ``icp_rows`` kept per pool frame and the reference's {key:
    pose} per pool frame, over every kept candidate whose key the
    reference has (a key on one side only is ``compare``'s): the
    candidates (a pool frame's key counted once) whose pose is past
    ``POSE_TOL`` or whose valid flag differs (``pose_mismatch``), those
    whose inlier count differs (``inliers_mismatch``), the candidates
    compared (``poses_checked``), and the widest gaps (``POSE_GAPS``)."""
    out = dict.fromkeys(("pose_mismatch", "inliers_mismatch",
                         "poses_checked") + POSE_GAPS, 0)
    tol = [POSE_TOL[f] for f in POSE_FIELDS]
    bad_pose, bad_inliers = set(), set()
    for pos, want in reference.items():
        for rows in kept.get(pos, []):
            pose = rows[:, 4:8].astype(np.int32).view(np.float32)
            for key, p, n, v in zip(map(tuple, rows[:, :4].tolist()),
                                    pose.astype(np.float64).tolist(),
                                    rows[:, 8].tolist(), rows[:, 9].tolist()):
                w = want.get(key)
                if w is None:
                    continue
                out["poses_checked"] += 1
                gaps = [_gap(a, b) for a, b in zip(p, w[:4])]
                out["pose_gap_deg"] = max(out["pose_gap_deg"], gaps[0])
                out["pose_gap_scale"] = max(out["pose_gap_scale"], gaps[1])
                out["pose_gap_px"] = max(out["pose_gap_px"], *gaps[2:])
                if (any(g >= t for g, t in zip(gaps, tol))
                        or bool(v) != w[5]):
                    bad_pose.add((pos, key))
                if n != w[4]:
                    bad_inliers.add((pos, key))
    out["pose_mismatch"] = len(bad_pose)
    out["inliers_mismatch"] = len(bad_inliers)
    return out


def verdict(cmp: dict, failed: int, bank_mismatch: int) -> tuple:
    """(checks, correct) of a run or of the control: each number compared
    with its limit, from ``compare`` or ``compare_icp``'s readings, the
    failed frames and the bank's mismatch; ``correct`` where every number
    keeps its limit."""
    checks = {
        "bank_mismatch": {"value": bank_mismatch, "limit": 0},
        "list_mismatch": {"value": cmp["list_mismatch"], "limit": 0},
        "lists_missing": {"value": cmp["lists_missing"], "limit": 0},
        "failed_frames": {"value": failed, "limit": 0},
    }
    if "pose_mismatch" in cmp:
        for name in ("pose_mismatch", "inliers_mismatch"):
            checks[name] = {"value": cmp[name], "limit": 0}
        checks["poses_checked"] = {"value": cmp["poses_checked"],
                                   "at_least": 1}
    checks["lists_checked"] = {"value": cmp["lists_checked"], "at_least": 1}
    correct = all(c["value"] <= c["limit"] if "limit" in c
                  else c["value"] >= c["at_least"] for c in checks.values())
    return checks, correct


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


def reference_poses(config: dict, traffic: dict, banks: list,
                    pool: np.ndarray, positions, device, score_dtype=None,
                    pose_dtype=None) -> dict:
    """The reference's ``match_icp`` answer, {key: pose}, for each pool
    frame in `positions`."""
    import torch

    from .reference import icp

    out = {}
    for pos in positions:
        f = torch.from_numpy(np.ascontiguousarray(pool[pos])).to(device)
        out[pos] = icp.match_icp_frame(
            f, banks, tuple(int(t) for t in config["T"]),
            float(config["weak_threshold"]),
            float(config["match_threshold"]),
            *(int(traffic[a]) for a in ICP_ARGS),
            score_dtype=score_dtype or torch.float32,
            pose_dtype=pose_dtype or torch.float32)
    return out


def compare_icp(kept: dict, due: dict, reference: dict) -> dict:
    """``compare`` of the answers' keys and ``compare_poses`` of their
    poses, against the reference's {key: pose} per pool frame."""
    out = compare({pos: [rows[:, :4] for rows in answers]
                   for pos, answers in kept.items()}, due,
                  {pos: set(p) for pos, p in reference.items()})
    out.update(compare_poses(kept, reference))
    return out


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
    deployment = load_deployment(config, root)

    # --- set-up: kernels, bank, frames, warm-up ------------------------
    phases = [("imports", time.perf_counter())]
    built = load_libraries(on_card)
    phases.append(("kernels", time.perf_counter()))
    if deployment is None:
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
    else:
        det = deployment.train(config, seed, device)
        phases.append(("bank", time.perf_counter()))
        pool, counts = deployment.frame_pool(config, traffic, seed)
        phases.append(("frames", time.perf_counter()))
        if not len(pool) == len(counts) == int(traffic["pool"]):
            raise RuntimeError("the deployment's pool is not the mix's")
        sample = frames.check_sample(traffic, seed, counts)
        client = deployment.client(det, traffic, pool,
                                   float(config["match_threshold"]))
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
    if deployment is None:
        got_bank = port_fingerprint(det)
        icp = client.icp is not None
    else:
        got_bank, icp = deployment.fingerprint(det), False
    del client, det
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if deployment is None:
        want_bank, banks = reference_bank(config, shape, device)
        if icp:
            want = reference_poses(config, traffic, banks, pool,
                                   sorted(win.due), device)
            cmp = compare_icp(win.kept, win.due, want)
        else:
            want = reference_sets(config, banks, pool, sorted(win.due), device)
            cmp = compare(win.kept, win.due, want)
    else:
        want_bank, want = deployment.reference(
            config, traffic, seed, pool, sorted(win.due), device)
        if set(want) != set(win.due):
            raise RuntimeError("the deployment's reference left out frames "
                               "to compare")
        cmp = compare(win.kept, win.due, want)
    bank_mismatch = bank_difference(got_bank, want_bank)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s for the bank and "
          f"{len(want)} frames", file=sys.stderr)
    checks, correct = verdict(cmp, win.failed, bank_mismatch)
    if icp:
        print("pose gaps (widest; tolerances " + ", ".join(
            f"{f} {t:g}" for f, t in POSE_TOL.items()) + "): " + ", ".join(
            f"{n} {cmp[n]!r}" for n in POSE_GAPS), file=sys.stderr)
    out = {"correct": correct, "attempted": win.frames, "failed": win.failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = breakdown
        out["tracing"] = tracing
    out["setup"] = {"built": built, "setup_s": setup_s,
                    "build_s": phases[1][1] - phases[0][1]}
    if icp:
        out["pose_gaps"] = {n: cmp[n] for n in POSE_GAPS}
    out["checks"] = checks
    return out
