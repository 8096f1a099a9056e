"""Detector: LINE-2D training and matching (line2Dup.h:257-333) in PyTorch.

**Training.** ``add_templates`` trains one template pyramid per frame of
a chunk of same-shaped uint8 frames (gray ``[B, H, W]`` or BGR ``[B, H,
W, 3]``, optionally masked): per pyramid level the device runs the
gradients, the quantization, the 5x5 local max and the eroded-mask
eligibility for the whole chunk (``_train_level``) and hands the host,
in one download, the eligible pixels in row-major order and the
magnitude, label and angle at the strong ones; the host replays the
greedy passes (``models/training.py``). ``add_template`` is the same
sweep at B=1; ``add_template(s)_rotate`` derive rotated templates without
re-extracting features. Every add drops the class's cached banks and
chain plans, every merged bank that holds the class, and what the
sharded paths placed on their devices (``_shard_cached``).

**Matching.** Frames are gray ``[H, W]`` or BGR ``[H, W, 3]`` uint8,
optionally with a uint8 mask each, matched with 8 orientations or the
16-orientation experiment's (``num_orientations=16``), against banks of
any feature count. A frame's match runs as one device step per bank
group for B frames at once: ``_batch_pyramid`` (pyrDown of the frame
and, iteratively, the mask's nearest resize; the fused frontend kernel;
linear memories per level), then ``_match_batch_class`` (coarse scoring
with counted candidate extraction at the top level -- the delta-chain
kernel when the bank has a chain plan at this frame size, the plain
coarse kernel otherwise -- then a refine step at every finer level),
then one device-to-host transfer, the ``Match`` list and
``_sort_dedup``. A bank group is one class, or, when ``match_batch``
lists more than one class, all of them in one merged bank whose
templates map back through ``(class_of_k, tid_of_k)`` (the JAX
package's ``_get_merged_banks``). The candidate cap is static; a frame
whose exact candidate count ``n_above`` exceeds it re-runs the same step
alone at the cap ``candidate_cap`` picks, the smallest ``_CAND_BUCKETS``
cap that holds all of them (or ``n_above`` past the last bucket), so the
match list is always complete. ``match(max_candidates=)`` runs the same
step, download and re-run, at caps bounded by its limit.

Every refine step, the first step's and a re-run's, takes the window
kernel (``refine_candidates``). The JAX package's re-run takes its map
route from a cap of 1024 on (``_refine_level`` there), a threshold set by
the TPU's costs; on the H100 the window was the faster at every re-run
cap, and both give the same bits. The map route itself,
``ops/similarity.refine_by_maps``, stays as the port of its two kernels.

**Spans and counters.** ``match`` and ``match_batch`` each open one root
span (``sbm.match`` / ``sbm.match_batch``) over ``sbm.prepare`` (checks,
the host copy, ``sbm.upload``), ``sbm.pyramid`` (per level
``sbm.pyramid.down``, ``.frontend``, ``.lm``; ``.down`` and ``.lm``
carry ``route``), ``sbm.step`` (``sbm.coarse``, a ``sbm.refine`` a
level), ``sbm.download``, a ``sbm.rerun`` a re-run frame, ``sbm.list``
and ``sbm.sort_dedup`` (``utils/profiling.span``: no-ops unless a
recording or torch.profiler runs). ``Detector.counters`` counts on the
host, always: frames, steps, re-runs, candidates (each listed frame's
``n_above``, already on the host), matches returned, and the bank and
chain-plan cache misses.

Trained templates and match results are bit-identical to the JAX
package's ``Detector`` (template id, position and float32 similarity of
every match). Subpixel pose refinement of the matches (``match_icp``,
``match_icp_async``) lives in ``models/icp.py``; the fiducial inspection
(``inspect``, ``inspect_batch``: match, NMS and the CCORR gate against
the fiducials of ``set_fiducial``) in ``models/inspect.py``.

**Persistence.** Settings and classes are written and read as the
reference's OpenCV YAML (``write_settings`` ... ``read_classes``,
line2Dup.cpp:1489-1599, through ``utils/yaml_io.py``), in the same files
and text as the JAX package's; ``get_instance`` bootstraps a process-wide
detector from a settings file that lists its classes.
"""

from __future__ import annotations

import os
import warnings
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.chain_plan import ChainPlan, plan_chain
from ..ops.cuda.chain import plan_to_device
from ..ops.cuda.frontend import quant_spread
from ..ops.cuda.pyramid import linear_memories, pyr_down
from ..ops.filters import erode3_u8, resize_nearest
from ..ops.gradients import (quantized_orientations,
                             quantized_orientations_color,
                             quantized_orientations_gray)
from ..ops.response import to_i32
# refine_by_maps runs nowhere here: portbench/trace.py wraps it by this name
from ..ops.similarity import (LevelBank, coarse_extract, coarse_route,
                              refine_by_maps, refine_candidates)
from ..utils.convert import pyramids_to_banks
from ..utils.profiling import span
from ..utils.yaml_io import (class_file_path, dump_opencv_yaml,
                             load_opencv_yaml)
from . import training
from .template import Template, TemplatePyramid, crop_templates


@dataclass
class Match:
    """A detection (line2Dup.h:222-250). (x, y) is the match origin at full
    resolution; similarity in [0, 100]."""

    x: int
    y: int
    similarity: float
    class_id: str
    template_id: int

    def sort_key(self):
        return (-self.similarity, self.template_id)

    def __eq__(self, rhs) -> bool:  # operator== (line2Dup.h:240-243)
        return (self.x == rhs.x and self.y == rhs.y
                and self.similarity == rhs.similarity
                and self.class_id == rhs.class_id)


# Candidate-capacity buckets (candidate_cap)
_CAND_BUCKETS = (256, 1024, 4096, 16384, 65536)
# The most candidates a merged multi-class step shares (merged_cap)
_MERGED_MAX_CAP = 4096
# Merged banks kept at once (device memory); the oldest goes first.
_MERGED_CACHE = 8


def candidate_cap(n_above: int, cells: int | None = None,
                  limit: int | None = None) -> int:
    """The candidate cap at which a step holds `n_above` candidates: the
    smallest of ``_CAND_BUCKETS`` that holds them all, else n_above
    itself. ``match(max_candidates=)`` passes a class's `cells` (K*M at
    the top level) and its `limit`: the buckets then stop at cells (a
    class of fewer cells has the one cap cells), each is clipped to
    limit, and past the last the last one holds, so that the step keeps
    its first candidates (the JAX package's ``_match_escalating``)."""
    if cells is None:
        return next((c for c in _CAND_BUCKETS if c >= n_above), n_above)
    caps = [c for c in _CAND_BUCKETS if c <= cells] or [cells]
    cap = next((c for c in caps if c >= n_above), caps[-1])
    return cap if limit is None else min(cap, limit)


def merged_cap(cand_cap: int, n_classes: int) -> int:
    """The candidate cap that one step over the merged bank of `n_classes`
    classes shares: cand_cap a class, up to ``_MERGED_MAX_CAP`` (the JAX
    package's clamp, detector.py:924 there)."""
    return min(int(cand_cap) * n_classes, _MERGED_MAX_CAP)


def _sort_dedup(matches: list) -> list:
    """sort + dedup (line2Dup.cpp:1143-1145). Deliberate divergence from
    the reference: its operator== ignores template_id, so std::unique
    after an UNSTABLE sort removes a nondeterministic subset of
    same-position detections from *different* templates (verified on
    case2: the reference drops tid 89 but keeps 90/94 at one position,
    purely by libstdc++ partition order). Different templates are
    different angle/scale hypotheses — we keep them all and collapse
    only true duplicates (same template converging from several coarse
    candidates). Result: a deterministic superset of the reference's
    match list; downstream NMS resolves same-position hypotheses."""
    with span("sbm.sort_dedup") as sp:
        matches.sort(key=lambda m: (-m.similarity, m.template_id, m.x, m.y,
                                    m.class_id))
        out = []
        seen = set()
        for m in matches:
            key = (m.x, m.y, m.similarity, m.class_id, m.template_id)
            if key in seen:
                continue
            seen.add(key)
            out.append(m)
        sp.note(matches=len(out))
    return out


def _batch_pyramid(sources: torch.Tensor, T: tuple, levels: int,
                   weak_threshold: float, n_ori: int = 8,
                   masks: torch.Tensor | None = None,
                   patch_2843: bool = False) -> tuple:
    """uint8 frames, gray [B, H, W] or planar color [B, 3, H, W], and
    optional [B, H, W] uint8 masks -> one flat linear-memory buffer per
    level, [B, n_ori*T*T*M + M] uint8: the [n_ori, T*T, M] linear memories
    of each frame followed by an M-byte zero tail that dead and off-image
    features read (match() preamble, line2Dup.cpp:1084-1120). Each level's
    mask is the nearest resize of the level before's (line2Dup.cpp:439).
    On the card a level is at most three launches (pyrDown,
    ``csrc/pyramid.cu``; the frontend; the linear memories with their
    tail, ``csrc/pyramid.cu``); on the CPU it runs their plain twins. The
    spans' ``route`` says which ("kernel" / "plain").
    `patch_2843`: weak pixels cast no orientation votes (the frontend's
    opencv_contrib #2843 mode)."""
    flats = []
    src, msk = sources, masks
    route = "kernel" if sources.device.type == "cuda" else "plain"
    with span("sbm.pyramid", levels=levels):
        for l in range(levels):
            if l > 0:
                with span("sbm.pyramid.down", level=l, route=route):
                    src = pyr_down(src)
                    if msk is not None:
                        msk = resize_nearest(msk, src.shape[-2:])
            with span("sbm.pyramid.frontend", level=l):
                spread = quant_spread(src, weak_threshold, T[l], n_ori, msk,
                                      patch_2843=patch_2843)
            with span("sbm.pyramid.lm", level=l, route=route):
                flats.append(linear_memories(spread, T[l], n_ori))
    return tuple(flats)


def _match_batch_class(lmflats: tuple, banks: list, threshold: torch.Tensor,
                       T: tuple, levels: int, sizes: tuple, cand_cap: int,
                       chain: ChainPlan | None = None, n_ori: int = 8):
    """matchClass for B frames (line2Dup.cpp:1160-1297): coarse scoring and
    candidate extraction at the top level (through `chain`, the coarse
    bank's plan, when given), then refinement through the window down to
    level 0. Returns (k, x, y, score, valid) each [B, cand_cap] and
    n_above [B]."""
    with span("sbm.coarse", route="chain" if chain is not None else "plain"):
        k, x, y, sc, valid, n_above = coarse_extract(
            lmflats[-1], banks[-1], T[-1], sizes[-1], threshold, cand_cap,
            chain, n_ori)
    for l in range(levels - 2, -1, -1):
        with span("sbm.refine", level=l):
            k, x, y, sc, valid = refine_candidates(
                lmflats[l], banks[l], T[l], sizes[l], k, x, y, valid,
                threshold, n_ori)
    return k, x, y, sc, valid, n_above


def _to_host(result) -> np.ndarray:
    """One device-to-host transfer of a class step's results: [B, 5*C + 1]
    int32 rows (k, x, y, score bits, valid; then n_above). Its span
    holds the wait for the device."""
    with span("sbm.download"):
        k, x, y, sc, valid, n_above = result
        B = k.shape[0]
        rows = torch.stack([k, x, y, sc.view(torch.int32),
                            valid.to(torch.int32)], dim=1).reshape(B, -1)
        return torch.cat([rows, n_above[:, None]], dim=1).cpu().numpy()


def _as_tensor(a) -> torch.Tensor:
    """A tensor as it is; anything else copied into a new CPU tensor."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))


def _one(a):
    """A batch of one: a view of the tensor or array `a` with a leading
    axis of 1 (``_as_tensor`` makes the copy)."""
    return (a if isinstance(a, torch.Tensor) else np.asarray(a))[None]


def _planar(frames, device) -> torch.Tensor:
    """uint8 frames, gray [B, H, W] or BGR [B, H, W, 3] (numpy or a
    tensor), on `device` as the frontend and the gradients read them:
    [B, H, W], or planar [B, 3, H, W]; contiguous."""
    frames = _as_tensor(frames)
    with span("sbm.upload", bytes=frames.nbytes):
        frames = frames.to(device)
        if frames.dim() == 4:
            frames = frames.permute(0, 3, 1, 2)
        return frames.contiguous()


def _strong_lower_bound(strong_threshold: float) -> float:
    """A float32 two ulps under strong_threshold^2: the device pre-filter
    keeps every borderline pixel, and the host applies the exact float64
    ``score > threshold^2`` (line2Dup.cpp:518) -- filtering at the
    float32 value itself would lose pixels just above the float64 one."""
    lo = np.float32(float(strong_threshold) ** 2)
    for _ in range(2):
        lo = np.nextafter(lo, np.float32(0))
    return float(lo)


def _train_level(src: torch.Tensor, msk: torch.Tensor | None,
                 weak_threshold: float, strong_lo: float, n_ori: int,
                 patch_2843: bool = False):
    """The device half of a training sweep at one pyramid level for a
    chunk of frames, gray [B, H, W] or planar color [B, 3, H, W] uint8
    (masks [B, H, W] or None): gradients and quantization, the
    ties-allowed 5x5 local max, the eroded-mask eligibility, the strong
    pre-filter (magnitude above `strong_lo` and a nonzero label). One
    download hands the host an int32 [n_e + 2 n_s, 3] array: the n_e
    eligible pixels (frame, y, x) in row-major order per frame
    (``torch.nonzero`` order), the n_s strong ones likewise, then their
    (magnitude bits, label, angle bits). Returns (array, n_e, n_s).
    `patch_2843` as in ``_batch_pyramid``."""
    quant = (quantized_orientations_color if src.dim() == 4
             else quantized_orientations_gray)(src, weak_threshold, n_ori,
                                               patch_2843)
    elig = training.local_max_map(quant.magnitude)
    if msk is not None:
        elig &= erode3_u8(msk) > 0
    label = to_i32(quant.angle)
    lo = torch.tensor(strong_lo, dtype=torch.float32, device=src.device)
    strong = elig & (quant.magnitude > lo) & (label > 0)
    e = torch.nonzero(elig).to(torch.int32)
    st = torch.nonzero(strong)
    b, y, x = st.unbind(1)
    vals = torch.stack([quant.magnitude[b, y, x].view(torch.int32),
                        label[b, y, x],
                        quant.angle_ori[b, y, x].view(torch.int32)], dim=1)
    host = torch.cat([e, st.to(torch.int32), vals]).cpu().numpy()
    return host, e.shape[0], st.shape[0]


def _sweep_inputs(sources, object_masks) -> tuple:
    """A training sweep's frames and masks as numpy arrays, checked: uint8
    [B, H, W] or [B, H, W, 3] frames, None or uint8 [B, H, W] masks."""
    sources = np.asarray(sources)
    if sources.dtype != np.uint8 or not (
            sources.ndim == 3 or (sources.ndim == 4
                                  and sources.shape[-1] == 3)):
        raise ValueError("add_templates expects uint8 [B, H, W] or "
                         "[B, H, W, 3] frames")
    masks = None if object_masks is None else np.asarray(object_masks)
    if masks is not None and (masks.dtype != np.uint8
                              or masks.shape != sources.shape[:3]):
        raise ValueError("masks must be uint8 [B, H, W] like the frames")
    return sources, masks


def _train_levels(src: torch.Tensor, msk: torch.Tensor | None, levels: int,
                  weak_threshold: float, strong_lo: float, n_ori: int,
                  patch_2843: bool = False) -> list:
    """The device half of a training chunk at every pyramid level (frames
    and masks as ``_train_level`` takes them, on the device; the masks'
    nearest resize down the pyramid): per level ``((array, n_e, n_s),
    (h, w))``, the level's ``_train_level`` download and size."""
    out = []
    for l in range(levels):
        if l > 0:
            src = pyr_down(src)
            if msk is not None:
                msk = resize_nearest(msk, src.shape[-2:])
        out.append((_train_level(src, msk, weak_threshold, strong_lo, n_ori,
                                 patch_2843), tuple(src.shape[-2:])))
    return out


_instance: "Detector | None" = None


def get_instance(path: str | None = None, *, device="cuda") -> "Detector":
    """Singleton bootstrap from a settings YAML (line2Dup.cpp:1355-1393).

    Loads `detector_linemod.yaml` (default: ./model_images/) onto
    `device` plus every class listed under its `classes` key from
    `templates_dir`. Later calls return the same detector until
    ``reset_instance``."""
    global _instance
    if _instance is None:
        if path is None:
            path = os.path.join(os.getcwd(), "model_images",
                                "detector_linemod.yaml")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"LINEMOD configuration file ({path}) not found!")
        doc = load_opencv_yaml(path)
        det = Detector(device=device)
        det.read_settings(doc)
        class_ids = doc.get("classes") or []
        templates_dir = doc.get("templates_dir", "")
        if class_ids:
            det.read_classes(class_ids,
                             os.path.join(templates_dir, "%s.yaml.gz"))
        _instance = det
    return _instance


def reset_instance() -> None:
    global _instance
    _instance = None


class Detector:
    """LINE-2D detector: training and matching. Args mirror
    Detector(num_features, T, weak_thresh, strong_thresh)
    (line2Dup.h:266); ``T`` is the per-pyramid-level spread factor, finest
    level first; ``num_orientations`` is 8, or 16 for the 16-orientation
    experiment. ``patch_2843`` takes the opencv_contrib #2843 variant
    (compiled out of the reference, line2Dup.cpp:9): weak pixels cast no
    orientation votes, in training and matching. ``device`` is where
    frames, banks and all device work live: the card unless the caller
    asks for "cpu" (where every kernel runs its plain twin); "cuda"
    without a card raises."""

    def __init__(self, num_features: int = 63, T=(4, 8),
                 weak_threshold: float = 30.0,
                 strong_threshold: float = 60.0,
                 num_orientations: int = 8, patch_2843: bool = False, *,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector(device='cuda') but CUDA is not "
                               "available")
        if num_orientations not in (8, 16):
            raise ValueError(f"num_orientations={num_orientations}: 8 or 16")
        self.num_features = int(num_features)
        self.T_at_level = tuple(int(t) for t in T)
        self.pyramid_levels = len(self.T_at_level)
        self.weak_threshold = float(weak_threshold)
        self.strong_threshold = float(strong_threshold)
        self.num_orientations = int(num_orientations)
        self.patch_2843 = bool(patch_2843)
        self.class_templates: dict[str, list[TemplatePyramid]] = {}
        # per bank group -- a class id, or the sorted tuple of the classes
        # of a merged bank: its banks, and its chain plans keyed (group,
        # size)
        self._banks: dict[object, list] = {}
        self._chain_plans: dict[tuple, ChainPlan | None] = {}
        # merged group -> (class_of_k, tid_of_k), at most _MERGED_CACHE
        self._merged: dict[tuple, tuple] = {}
        # (group, ...) -> a group's banks, bank slices or chain plans placed
        # on a shard's device (parallel/; _shard_cached)
        self._sharded: dict[tuple, object] = {}
        # what the match path did, always on (host counts, no device
        # read): "frames", "steps" (class steps, re-runs included),
        # "reruns", "candidates" (the sum of each listed frame's
        # n_above), "matches" (in the lists returned), and the cache
        # misses "bank_builds" and "chain_plans"
        self.counters: Counter = Counter()
        # (class_id, template_id) -> level-0 feature (x, y), [n, 2] float32
        # (models/icp.py)
        self._icp_pts: dict[tuple, np.ndarray] = {}
        # the inspection's gate (models/inspect.py): class_id ->
        # {template_id, or None for the class's other templates: the
        # fiducial image}; the device bank of every registered template's
        # normalized reference crop
        self._fiducials: dict[str, dict] = {}
        self._gate_bank = None
        # the inspection's page-locked upload buffer and the event after
        # the card's last read of it (models/inspect._upload)
        self._upload_stage = None

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def add_template(self, source, class_id: str, object_mask=None,
                     sscale: float = -1.0, orientation: float = -1.0,
                     tag_field_id: int = 0, fiducial_src: str = "none",
                     num_features: int = 0) -> int:
        """Train a template pyramid from one uint8 frame, gray [H, W] or
        BGR [H, W, 3], with an optional uint8 mask (line2Dup.cpp:
        1299-1353): ``add_templates`` at B=1. Returns the new template
        id, or -1 when extraction fails."""
        mask = None if object_mask is None else np.asarray(object_mask)[None]
        return self.add_templates(
            np.asarray(source)[None], class_id, mask,
            num_features=num_features, sscales=[sscale],
            orientations=[orientation], tag_field_ids=[tag_field_id],
            fiducial_src=fiducial_src)[0]

    def add_templates(self, sources, class_id: str, object_masks=None,
                      num_features: int = 0, cand_cap: int = 4096,
                      chunk: int = 64, sscales=None, orientations=None,
                      tag_field_ids=None, fiducial_src: str = "none"
                      ) -> list[int]:
        """Train one template pyramid from each of B same-shaped uint8
        frames, gray [B, H, W] or BGR [B, H, W, 3], with optional uint8
        [B, H, W] masks; equal to B ``add_template`` calls. Per chunk of
        `chunk` frames and pyramid level, one device pass
        (``_train_level``) and one download; the host then runs the
        greedy passes frame by frame. Returns one template id per frame
        (-1 where extraction failed). `sscales` / `orientations` /
        `tag_field_ids` (per-frame sequences) and `fiducial_src` carry the
        fork's metadata as add_template's arguments would.

        `cand_cap` is accepted so that the JAX package's callers run
        unchanged, and changes nothing: the JAX package compacts the
        strong pixels into `cand_cap` slots and re-runs a frame that has
        more, while here the device hands over exactly as many as there
        are."""
        del cand_cap
        sources, masks = _sweep_inputs(sources, object_masks)
        nfeat = int(num_features) if num_features > 0 else self.num_features
        strong_lo = _strong_lower_bound(self.strong_threshold)
        pyramids = self.class_templates.setdefault(class_id, [])
        meta = (sscales, orientations, tag_field_ids, fiducial_src)
        ids = []
        for b0 in range(0, sources.shape[0], chunk):
            src = _planar(sources[b0:b0 + chunk], self.device)
            msk = (None if masks is None else
                   _planar(masks[b0:b0 + chunk], self.device))
            levels = _train_levels(src, msk, self.pyramid_levels,
                                   self.weak_threshold, strong_lo,
                                   self.num_orientations, self.patch_2843)
            self._consume_chunk(b0, src.shape[0], levels, nfeat, pyramids,
                                ids, meta)
        self._invalidate(class_id)
        return ids

    def _consume_chunk(self, b0: int, n: int, levels: list, nfeat: int,
                       pyramids: list, ids: list, meta: tuple) -> None:
        """The host half of a chunk of frames b0 .. b0 + n - 1 of a sweep,
        in frame order, from its device half (``_train_levels``'s list):
        each frame's pyramid (``_train_frame``) with the sweep's metadata
        (sscales, orientations, tag_field_ids, fiducial_src), cropped and
        appended to `pyramids`; its id, or -1, appended to `ids`. Shared
        by ``add_templates`` and the mesh-sharded sweep
        (``parallel/mesh.add_templates_sharded``)."""
        sscales, orientations, tag_field_ids, fiducial_src = meta
        for bi in range(n):
            b = b0 + bi
            tp = self._train_frame(bi, levels, nfeat)
            if tp is None:
                ids.append(-1)
                continue
            for t in tp:
                t.sscale = -1.0 if sscales is None else float(sscales[b])
                t.orientation = (-1.0 if orientations is None
                                 else float(orientations[b]))
                t.tag_field_id = (0 if tag_field_ids is None
                                  else int(tag_field_ids[b]))
                t.fiducial_src = fiducial_src
            crop_templates(tp)
            pyramids.append(tp)
            ids.append(len(pyramids) - 1)

    def _train_frame(self, bi: int, levels: list, nfeat: int):
        """The host half for frame `bi` of a chunk: per level, greedy
        acceptance over its eligible pixels, then the strong candidates
        among the accepted ones (``training.template_from_strong``).
        Returns the uncropped pyramid, or None when a level fails."""
        tp = []
        for l, ((host, n_e, n_s), (h, w)) in enumerate(levels):
            e, st = host[:n_e], host[n_e:n_e + n_s]
            vals = host[n_e + n_s:]
            e = e[np.searchsorted(e[:, 0], bi):np.searchsorted(
                e[:, 0], bi, side="right")]
            lo, hi = (np.searchsorted(st[:, 0], bi),
                      np.searchsorted(st[:, 0], bi, side="right"))
            st, vals = st[lo:hi], vals[lo:hi]
            flags = training.greedy_accept(h, w, e[:, 1], e[:, 2])
            acc = np.zeros((h, w), bool)
            acc[e[flags, 1], e[flags, 2]] = True
            keep = acc[st[:, 1], st[:, 2]]
            templ = training.template_from_strong(
                st[keep, 2], st[keep, 1],
                vals[keep, 0].view(np.float32), vals[keep, 1],
                vals[keep, 2].view(np.float32), nfeat >> l,
                self.strong_threshold, l)
            if templ is None:
                return None
            tp.append(templ)
        return tp

    def add_template_rotate(self, class_id: str, zero_id: int, theta: float,
                            center) -> int:
        """Derive a rotated template from template `zero_id` without
        re-extracting features (line2Dup.cpp:1409-1451)."""
        pyramids = self.class_templates[class_id]
        tp = training.rotate_template_features(
            pyramids[zero_id], float(theta), center, self.pyramid_levels,
            self.num_orientations)
        crop_templates(tp)
        pyramids.append(tp)
        self._invalidate(class_id)
        return len(pyramids) - 1

    def add_templates_rotate(self, class_id: str, zero_id: int, thetas,
                             center) -> list[int]:
        """``add_template_rotate`` for every angle of a sweep in one
        vectorised pass, with the same templates. Returns the new template
        ids in order."""
        pyramids = self.class_templates[class_id]
        tps = training.rotate_templates_batch(
            pyramids[zero_id], [float(t) for t in thetas], center,
            self.pyramid_levels, self.num_orientations)
        first = len(pyramids)
        pyramids.extend(tps)
        self._invalidate(class_id)
        return list(range(first, len(pyramids)))

    def get_templates(self, class_id: str,
                      template_id: int) -> TemplatePyramid:
        return self.class_templates[class_id][template_id]

    def num_templates(self, class_id: str | None = None) -> int:
        if class_id is None:
            return sum(len(v) for v in self.class_templates.values())
        return len(self.class_templates.get(class_id, []))

    def num_classes(self) -> int:
        return len(self.class_templates)

    def class_ids(self) -> list[str]:
        return list(self.class_templates.keys())

    def get_t(self, pyramid_level: int) -> int:
        return self.T_at_level[pyramid_level]

    # ------------------------------------------------------------------
    # Bank groups and their caches
    # ------------------------------------------------------------------

    def _invalidate(self, class_id: str) -> None:
        """Drop every cache that holds the class: its banks and chain
        plans, every merged bank it is part of, its ICP points and the
        gate's bank."""
        for group in [g for g in self._banks
                      if g == class_id or (isinstance(g, tuple)
                                           and class_id in g)]:
            self._drop_group(group)
        for key in [k for k in self._icp_pts if k[0] == class_id]:
            del self._icp_pts[key]
        self._gate_bank = None

    def _drop_group(self, group) -> None:
        self._banks.pop(group, None)
        self._merged.pop(group, None)
        for cache in (self._chain_plans, self._sharded):
            for key in [k for k in cache if k[0] == group]:
                del cache[key]

    def _get_banks(self, group) -> list:
        """The LevelBanks of a bank group: a class id, or a sorted tuple
        of class ids (``_get_merged``)."""
        banks = self._banks.get(group)
        if banks is None:
            if isinstance(group, tuple):
                return self._get_merged(group)[0]
            pyramids = self.class_templates[group]
            self.counters["bank_builds"] += 1
            banks = pyramids_to_banks(pyramids, self.pyramid_levels,
                                      self.device, self.num_orientations)
            self._banks[group] = banks
        return banks

    def _get_merged(self, order: tuple) -> tuple:
        """One bank spanning the classes of `order` (sorted): matchClass is
        independent per class (line2Dup.cpp:1129-1141), so scoring the
        concatenated bank in one step is exact. Each level's slots are
        padded dead to the widest class's N, as ``pack_level_bank`` pads
        a short template. Returns (banks, class_of_k, tid_of_k): template
        k of the merged bank is template tid_of_k[k] of class
        order[class_of_k[k]]. At most ``_MERGED_CACHE`` merged banks are
        kept; the oldest goes first."""
        if order in self._merged:
            return (self._banks[order],) + self._merged[order]
        per_class = [self._get_banks(c) for c in order]
        self.counters["bank_builds"] += 1
        banks = []
        for l in range(self.pyramid_levels):
            parts = [pc[l] for pc in per_class]
            N = max(p.fx.shape[1] for p in parts)
            fields = []
            for name in LevelBank._fields:
                f = [getattr(p, name) for p in parts]
                if f[0].dim() == 2:  # [K, n] slots: zeros, valid False
                    f = [F.pad(a, (0, N - a.shape[1])) for a in f]
                fields.append(torch.cat(f))
            banks.append(LevelBank(*fields))
        ks = [pc[0].fx.shape[0] for pc in per_class]
        maps = (np.repeat(np.arange(len(order)), ks),
                np.concatenate([np.arange(k) for k in ks]))
        while len(self._merged) >= _MERGED_CACHE:
            self._drop_group(next(iter(self._merged)))
        self._banks[order] = banks
        self._merged[order] = maps
        return (banks,) + maps

    def _get_chain(self, group, size_wh) -> ChainPlan | None:
        """The coarse bank's delta-chain plan at this frame size, planned on
        the host once per (bank group, size) and uploaded once; None when
        the planner declines (a sparse bank keeps the plain coarse
        kernel). A merged bank gets the planner's own decision."""
        key = (group, tuple(size_wh))
        if key not in self._chain_plans:
            self.counters["chain_plans"] += 1
            bank = self._get_banks(group)[-1]
            plan = plan_chain(LevelBank(*(f.cpu().numpy() for f in bank)),
                              self.T_at_level[-1], size_wh,
                              self.num_orientations)
            self._chain_plans[key] = (None if plan is None
                                      else plan_to_device(plan, self.device))
        return self._chain_plans[key]

    def coarse_route(self, class_id: str, size_hw) -> str:
        """Which coarse kernel route a match of `class_id` at this frame
        size engages -- 'chain' | 'packed4' | 'wide'
        (``ops/similarity.coarse_route``). A host-side probe: it builds
        the class's banks and chain plan as a match would, and caches
        them."""
        sizes = self._level_sizes(size_hw)
        chain = self._get_chain(class_id, sizes[-1])
        return coarse_route(self._get_banks(class_id)[-1],
                            self.T_at_level[-1], sizes[-1],
                            self.num_orientations, chain is not None)

    def _shard_cached(self, group, key: tuple, make):
        """What a sharded path keeps of a bank group for one shard (its
        banks, a bank slice or a chain plan, on the shard's device):
        ``make()`` once per (group, key), dropped with the group's other
        caches."""
        full = (group,) + key
        if full not in self._sharded:
            self._sharded[full] = make()
        return self._sharded[full]

    def _quantized(self, src: np.ndarray):
        """Quantized orientations of one gray [H, W] or BGR [H, W, 3]
        uint8 frame on the device (the CLI's --debug dumps)."""
        return quantized_orientations(
            torch.from_numpy(np.ascontiguousarray(src)).to(self.device),
            self.weak_threshold, self.num_orientations, self.patch_2843)

    def _level_sizes(self, hw) -> list[tuple]:
        h, w = int(hw[0]), int(hw[1])
        sizes = []
        for _ in range(self.pyramid_levels):
            sizes.append((w, h))  # (width, height) like cv::Size
            h //= 2
            w //= 2
        return sizes

    def _validate_size(self, hw) -> None:
        h, w = int(hw[0]), int(hw[1])
        for l, t in enumerate(self.T_at_level):
            if h % t or w % t or (h * w) % 16:
                stride = self.T_at_level[-1] * (2 ** (self.pyramid_levels - 1))
                raise ValueError(
                    f"image {w}x{h} not tileable at level {l} (T={t}); "
                    f"crop/pad dims to multiples of {stride} "
                    f"(reference asserts the same: line2Dup.cpp:639,751)")
            h //= 2
            w //= 2

    # ------------------------------------------------------------------
    # Matching
    # ------------------------------------------------------------------

    def match(self, source, threshold: float, class_ids=None, mask=None,
              max_candidates: int | None = None) -> list[Match]:
        """Detect all trained templates in one uint8 frame, gray [H, W] or
        BGR [H, W, 3], with an optional uint8 [H, W] mask
        (line2Dup.cpp:1078-1150): match_batch at B=1.

        With `max_candidates`, the classes run one by one (never merged)
        at the candidate caps of ``_CAND_BUCKETS`` up to the class's K*M
        cells, each clipped to `max_candidates`: the first cap that holds
        every candidate, else the last, keeping the first candidates in
        extraction order and warning (``candidate_cap``; the JAX
        package's ``_match_escalating``)."""
        with span("sbm.match", B=1,
                  classes=len(class_ids or self.class_templates)):
            frames = _one(source)
            masks = None if mask is None else _one(mask)
            if max_candidates is None:
                return self._match_batch(frames, threshold, class_ids,
                                         masks)[0]
            lms, sizes, thr, class_ids = self._prepare(frames, masks,
                                                       threshold, class_ids)
            self.counters["frames"] += 1
            return self._match_groups(lms, sizes, thr, class_ids, None,
                                      int(max_candidates))[0]

    def _prepare(self, sources, masks, threshold: float, class_ids):
        """Checks and uploads the frames and masks, builds their
        linear-memory pyramid; returns (lms, sizes, threshold as a 0-d
        float32 device tensor, the trained classes among `class_ids`,
        all of them when it is empty)."""
        with span("sbm.prepare"):
            frames = _as_tensor(sources)
            color = frames.dim() == 4 and frames.shape[-1] == 3
            if frames.dtype != torch.uint8 or not (frames.dim() == 3
                                                   or color):
                raise ValueError("match_batch expects uint8 [B, H, W] or "
                                 "[B, H, W, 3] frames")
            self._validate_size(frames.shape[1:3])
            frames = _planar(frames, self.device)
            if masks is not None:
                masks = _as_tensor(masks)
                if masks.dtype != torch.uint8 or masks.shape != (
                        frames.shape[0], *frames.shape[-2:]):
                    raise ValueError("masks must be uint8 [B, H, W] like "
                                     "the frames")
                masks = masks.to(self.device).contiguous()
            sizes = tuple(self._level_sizes(frames.shape[-2:]))
            # a fill on the device: torch.tensor(..., device=) would copy
            # from the host and wait for the card
            thr = torch.full((), threshold, dtype=torch.float32,
                             device=self.device)
            class_ids = [c for c in (class_ids or self.class_templates)
                         if c in self.class_templates]
        lms = _batch_pyramid(frames, self.T_at_level, self.pyramid_levels,
                             self.weak_threshold, self.num_orientations,
                             masks, self.patch_2843)
        return lms, sizes, thr, class_ids

    def match_batch(self, sources, threshold: float, class_ids=None,
                    masks=None, cand_cap: int = 256, distinct_cap: int = 64,
                    as_matches: bool = True):
        """Match B same-shaped uint8 frames, gray [B, H, W] or BGR
        [B, H, W, 3] (numpy or a tensor), with optional uint8 [B, H, W]
        masks; returns one match list per frame, identical to
        [match(f, mask=m) for f, m in zip(...)].

        One class runs as one device step and one download. More than one
        class runs as ONE step over their merged bank at a shared cap of
        min(cand_cap * n_classes, 4096) (``merged_cap``); matches map back
        to their class and template. A frame that overflows the cap
        re-runs its step at the smallest ``_CAND_BUCKETS`` cap that holds
        every candidate (``candidate_cap``).

        ``as_matches=False`` returns {class_id: (k, x, y, score, valid,
        overflow)} per class instead: device tensors [B, cand_cap]
        (int32, int32, int32, float32, bool) and overflow [B] bool
        (n_above > cand_cap), with no download and no re-run; the caller
        re-runs an overflowing frame. `distinct_cap` is accepted so that
        the JAX package's callers run unchanged, and changes no list here
        or there: JAX re-runs a frame whose distinct refine templates
        overflow it on its map route, past cand_cap 4096, and the port
        refines every step through the window, which has no distinct cap.
        So the port's overflow flag never counts distinct templates."""
        del distinct_cap
        with span("sbm.match_batch", B=len(sources),
                  classes=len(class_ids or self.class_templates)):
            return self._match_batch(sources, threshold, class_ids, masks,
                                     cand_cap, as_matches)

    def _match_batch(self, sources, threshold: float, class_ids, masks,
                     cand_cap: int = 256, as_matches: bool = True):
        """``match_batch``, inside its caller's root span."""
        lms, sizes, thr, class_ids = self._prepare(sources, masks,
                                                   threshold, class_ids)
        B = lms[0].shape[0]
        self.counters["frames"] += B
        if not as_matches:
            out = {}
            for class_id in class_ids:
                k, x, y, sc, valid, n_above = self._step(
                    lms, class_id, thr, sizes, cand_cap)
                out[class_id] = (k, x, y, sc, valid, n_above > cand_cap)
            return out
        if len(class_ids) > 1:
            return self._match_groups(lms, sizes, thr,
                                      [tuple(sorted(class_ids))],
                                      merged_cap(cand_cap, len(class_ids)))
        return self._match_groups(lms, sizes, thr, class_ids, int(cand_cap))

    def _match_groups(self, lms: tuple, sizes: tuple, thr: torch.Tensor,
                      groups: list, cap: int | None,
                      limit: int | None = None) -> list[list[Match]]:
        """The sorted, deduplicated Match list of each of the B frames of
        `lms`: per bank group, one step at candidate cap `cap` and one
        download; a frame whose n_above overflows the cap re-runs alone
        (``sbm.rerun``) at ``candidate_cap``; then its valid candidates
        become Matches. With `limit` (``match(max_candidates=)``; `cap`
        None) each group's caps stop at its top level's K*M cells and at
        `limit`, its first step runs at the smallest of them, and a frame
        that overflows the last keeps its first candidates and warns."""
        B = lms[0].shape[0]
        out: list[list[Match]] = [[] for _ in range(B)]
        cells = None
        for group in groups:
            if limit is not None:
                K = self._get_banks(group)[-1].fx.shape[0]
                (w, h), T = sizes[-1], self.T_at_level[-1]
                cells = K * (w // T) * (h // T)
                cap = candidate_cap(0, cells, limit)
            host = self._class_step(lms, group, thr, sizes, cap)
            for b in range(B):
                row = host[b]
                n_above = int(row[-1])
                self.counters["candidates"] += n_above
                if n_above > cap:
                    re_cap = candidate_cap(n_above, cells, limit)
                    if n_above > re_cap:
                        warnings.warn(
                            f"candidate overflow: {n_above} above threshold,"
                            f" cap {re_cap}; raise max_candidates for full "
                            f"parity")
                    if re_cap > cap:
                        with span("sbm.rerun", frame=b, n_above=n_above,
                                  cap=re_cap):
                            self.counters["reruns"] += 1
                            row = self._class_step(
                                tuple(f[b:b + 1] for f in lms), group, thr,
                                sizes, re_cap, rerun=True)[0]
                out[b].extend(self._matches(row, group))
        lists = [_sort_dedup(m) for m in out]
        self.counters["matches"] += sum(map(len, lists))
        return lists

    def _step(self, lms: tuple, group, thr: torch.Tensor, sizes: tuple,
              cap: int, rerun: bool = False):
        """One device step of a bank group at candidate cap `cap`: (k, x,
        y, score, valid) [B, cap] and n_above [B] on the device. `rerun`
        marks an overflow re-run in its span."""
        with span("sbm.step", cap=cap, rerun=rerun):
            self.counters["steps"] += 1
            return _match_batch_class(
                lms, self._get_banks(group), thr, self.T_at_level,
                self.pyramid_levels, sizes, cap,
                self._get_chain(group, sizes[-1]), self.num_orientations)

    def _class_step(self, lms: tuple, group, thr: torch.Tensor,
                    sizes: tuple, cap: int, rerun: bool = False):
        """``_step`` and its one download (see _to_host)."""
        return _to_host(self._step(lms, group, thr, sizes, cap, rerun))

    def _matches(self, row: np.ndarray, group) -> list[Match]:
        """The valid candidates of a downloaded row as Matches; a merged
        group's templates map back to their class and template id."""
        with span("sbm.list") as sp:
            k, x, y, sc_bits, valid = row[:-1].reshape(5, -1)
            sc = sc_bits.view(np.float32)
            idx = np.nonzero(valid)[0]
            sp.note(matches=len(idx))
            if isinstance(group, tuple):
                class_of_k, tid_of_k = self._merged[group]
                return [Match(int(x[i]), int(y[i]), float(sc[i]),
                              group[class_of_k[k[i]]], int(tid_of_k[k[i]]))
                        for i in idx]
            return [Match(int(x[i]), int(y[i]), float(sc[i]), group,
                          int(k[i])) for i in idx]

    # ------------------------------------------------------------------
    # Pose refinement
    # ------------------------------------------------------------------

    def match_icp(self, source, threshold: float, class_ids=None,
                  top_c: int = 32, iters: int = 12, radius: int = 8,
                  cand_cap: int = 256) -> list[dict]:
        """Match a gray frame and sim2-refine each class's top_c best
        candidates with one download (``models/icp.match_icp``)."""
        from .icp import match_icp

        return match_icp(self, source, threshold, class_ids, top_c=top_c,
                         iters=iters, radius=radius, cand_cap=cand_cap)

    def match_icp_async(self, source, threshold: float, class_ids=None,
                        top_c: int = 32, iters: int = 12, radius: int = 8,
                        cand_cap: int = 256):
        """``match_icp`` without waiting: a ``MatchIcpHandle`` whose
        ``result()`` makes the download (``models/icp.match_icp_async``)."""
        from .icp import match_icp_async

        return match_icp_async(self, source, threshold, class_ids,
                               top_c=top_c, iters=iters, radius=radius,
                               cand_cap=cand_cap)

    # ------------------------------------------------------------------
    # Inspection (models/inspect.py)
    # ------------------------------------------------------------------

    def set_fiducial(self, class_id: str, image, template_ids=None) -> None:
        """Register the fiducial source image (uint8 gray [h, w] or BGR
        [h, w, 3]) that the inspection's gate compares the matches of
        `class_id` with: for the templates in `template_ids`, or in
        place of every one registered for the class."""
        image = np.ascontiguousarray(image)
        fids = self._fiducials.setdefault(class_id, {})
        if template_ids is None:
            fids.clear()
            fids[None] = image
        else:
            for tid in template_ids:
                fids[int(tid)] = image
        self._gate_bank = None

    def inspect_batch(self, sources, threshold: float, class_ids=None,
                      nms: float = 0.5, ccorr: float = 0.8) -> list:
        """The fiducial inspection of B same-shaped uint8 frames, gray
        [B, H, W] or BGR [B, H, W, 3]: ``match_batch``, greedy NMS at IoU
        `nms` per frame, and the CCORR gate at `ccorr` (none at 0) of the
        kept matches whose templates have a fiducial
        (``set_fiducial``). Per frame every NMS-kept match as an
        ``Inspected`` (match, ccorr, passed) (``models/inspect.py``)."""
        from .inspect import inspect_batch

        return inspect_batch(self, sources, threshold, class_ids, nms, ccorr)

    def inspect(self, source, threshold: float, class_ids=None,
                nms: float = 0.5, ccorr: float = 0.8) -> list:
        """``inspect_batch`` of one frame, gray [H, W] or BGR [H, W, 3]."""
        return self.inspect_batch(_one(source), threshold, class_ids, nms,
                                  ccorr)[0]

    # ------------------------------------------------------------------
    # Persistence (line2Dup.cpp:1489-1599)
    # ------------------------------------------------------------------

    def write_settings(self) -> dict:
        doc = {
            "pyramid_levels": self.pyramid_levels,
            "T": list(self.T_at_level),
            "type": "ColorGradient",
            "weak_threshold": float(self.weak_threshold),
            "num_features": int(self.num_features),
            "strong_threshold": float(self.strong_threshold),
        }
        if self.num_orientations != 8:
            doc["num_orientations"] = self.num_orientations
        return doc

    def read_settings(self, doc: dict) -> None:
        """Take the settings of `doc`; drops every class, cache and
        fiducial."""
        self.pyramid_levels = int(doc["pyramid_levels"])
        self.T_at_level = tuple(int(t) for t in doc["T"])
        self.weak_threshold = float(doc.get("weak_threshold", 30.0))
        self.num_features = int(doc.get("num_features", 63))
        self.strong_threshold = float(doc.get("strong_threshold", 60.0))
        self.num_orientations = int(doc.get("num_orientations", 8))
        if self.num_orientations not in (8, 16):
            raise ValueError(f"num_orientations={self.num_orientations}: "
                             f"8 or 16")
        for class_id in list(self.class_templates):
            self._invalidate(class_id)
        self.class_templates.clear()
        self._fiducials.clear()

    def save_settings(self, path: str, templates_dir: str | None = None,
                      classes=None) -> None:
        """Write detector settings; with `templates_dir`/`classes` the file
        matches the jabil driver's full schema (test_jabil.cpp:113-117) and
        bootstraps get_instance()."""
        doc = self.write_settings()
        if templates_dir is not None:
            doc["templates_dir"] = templates_dir
        if classes is not None:
            doc["classes"] = list(classes)
        elif templates_dir is not None:
            doc["classes"] = self.class_ids()
        dump_opencv_yaml(doc, path)

    @classmethod
    def load_settings(cls, path: str, *, device="cuda") -> "Detector":
        det = cls(device=device)
        det.read_settings(load_opencv_yaml(path))
        return det

    def write_class(self, class_id: str) -> dict:
        pyramids = self.class_templates[class_id]
        return {
            "class_id": class_id,
            "pyramid_levels": self.pyramid_levels,
            "template_pyramids": [
                {
                    "template_id": i,
                    "templates": [t.to_yaml() for t in tp],
                }
                for i, tp in enumerate(pyramids)
            ],
        }

    def read_class(self, doc: dict, class_id_override: str = "") -> str:
        """Take the class of `doc` (replacing one of the same id) and drop
        every cache that held it."""
        class_id = class_id_override or doc["class_id"]
        pyramids = []
        for tp_node in doc.get("template_pyramids", []):
            tp = [Template.from_yaml(t) for t in tp_node.get("templates", [])]
            pyramids.append(tp)
        self.class_templates[class_id] = pyramids
        self._invalidate(class_id)
        return class_id

    def write_classes(self, fmt: str = "templates_%s.yml.gz") -> None:
        for class_id in self.class_templates:
            path = class_file_path(fmt, class_id)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            dump_opencv_yaml(self.write_class(class_id), path)

    def read_classes(self, class_ids, fmt: str = "templates_%s.yml.gz"
                     ) -> None:
        for class_id in class_ids:
            self.read_class(load_opencv_yaml(class_file_path(fmt, class_id)))
