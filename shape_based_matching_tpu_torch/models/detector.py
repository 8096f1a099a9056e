"""Detector: the LINE-2D match path (line2Dup.h:257-333) in PyTorch.

Frames are gray ``[H, W]`` or BGR ``[H, W, 3]`` uint8, optionally with a
uint8 mask each, matched with 8 orientations or the 16-orientation
experiment's (``num_orientations=16``), against banks of any feature
count. A frame's match runs as one device step per class for B frames at
once: ``_batch_pyramid`` (pyrDown of the frame and, iteratively, the
mask's nearest resize; the fused frontend kernel; linear memories per
level), then ``_match_batch_class`` (coarse scoring with counted
candidate extraction at the top level -- the delta-chain kernel when the
bank has a chain plan at this frame size, the plain coarse kernel
otherwise -- then a refine step at every finer level), then one
device-to-host transfer, the ``Match`` list and ``_sort_dedup``. The
candidate cap is static; a frame whose exact candidate count ``n_above``
exceeds it re-runs the same step at the smallest ``_CAND_BUCKETS`` cap
that holds all of them (or at ``n_above`` past the last bucket), so the
match list is always complete.

Refine routes follow the JAX package's ``_refine_mode`` / ``_refine_level``
(``detector.py:1034-1051``, ``:1244-1296`` there): the first step takes the
window kernel; the re-run, at a cap of 1024 or more on a bank that is not
pathological, takes the map route (level maps of the distinct candidate
templates, then the map-window kernel), and the window otherwise.

Results are bit-identical to the JAX package's ``Detector`` (template id,
position and float32 similarity of every match).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.chain_plan import ChainPlan, plan_chain
from ..ops.cuda.chain import plan_to_device
from ..ops.cuda.frontend import quant_spread
from ..ops.filters import pyr_down_u8, resize_nearest
from ..ops.response import build_lm_from_spread
from ..ops.similarity import (LevelBank, coarse_extract, refine_by_maps,
                              refine_candidates)
from ..utils.convert import level_max_dims, pyramids_to_banks
from .template import TemplatePyramid


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


# Candidate-capacity buckets: a frame that overflows the static cap re-runs
# at the smallest bucket >= its true above-threshold count.
_CAND_BUCKETS = (256, 1024, 4096, 16384, 65536)
# The re-run takes the map route from this cap on: the JAX package's
# ``_refine_level`` rule, kept so that both packages take the same routes.
# It is not tuned to the GPU; chip_smoke.py times both routes at caps
# 1024, 4096 and 16384.
_MAP_MIN_CAP = 1024


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
    return out


def _batch_pyramid(sources: torch.Tensor, T: tuple, levels: int,
                   weak_threshold: float, n_ori: int = 8,
                   masks: torch.Tensor | None = None) -> tuple:
    """uint8 frames, gray [B, H, W] or planar color [B, 3, H, W], and
    optional [B, H, W] uint8 masks -> one flat linear-memory buffer per
    level, [B, n_ori*T*T*M + M] uint8: the [n_ori, T*T, M] linear memories
    of each frame followed by an M-byte zero tail that dead and off-image
    features read (match() preamble, line2Dup.cpp:1084-1120). Each level's
    mask is the nearest resize of the level before's (line2Dup.cpp:439)."""
    flats = []
    src, msk = sources, masks
    for l in range(levels):
        if l > 0:
            src = pyr_down_u8(src)
            if msk is not None:
                msk = resize_nearest(msk, src.shape[-2:])
        lm = build_lm_from_spread(
            quant_spread(src, weak_threshold, T[l], n_ori, msk), T[l], n_ori)
        B, M = lm.shape[0], lm.shape[-1]
        flats.append(torch.cat([lm.reshape(B, -1), lm.new_zeros((B, M))],
                               dim=1))
    return tuple(flats)


def _match_batch_class(lmflats: tuple, banks: list, threshold: torch.Tensor,
                       T: tuple, levels: int, sizes: tuple, cand_cap: int,
                       chain: ChainPlan | None = None,
                       map_levels: tuple = (), n_ori: int = 8):
    """matchClass for B frames (line2Dup.cpp:1160-1297): coarse scoring and
    candidate extraction at the top level (through `chain`, the coarse
    bank's plan, when given), then refinement down to level 0, by the map
    route at the levels in `map_levels` and by the window elsewhere.
    Returns (k, x, y, score, valid) each [B, cand_cap] and n_above [B]."""
    k, x, y, sc, valid, n_above = coarse_extract(
        lmflats[-1], banks[-1], T[-1], sizes[-1], threshold, cand_cap, chain,
        n_ori)
    for l in range(levels - 2, -1, -1):
        refine = refine_by_maps if l in map_levels else refine_candidates
        k, x, y, sc, valid = refine(lmflats[l], banks[l], T[l], sizes[l], k,
                                    x, y, valid, threshold, n_ori)
    return k, x, y, sc, valid, n_above


def _to_host(result) -> np.ndarray:
    """One device-to-host transfer of a class step's results: [B, 5*C + 1]
    int32 rows (k, x, y, score bits, valid; then n_above)."""
    k, x, y, sc, valid, n_above = result
    B = k.shape[0]
    rows = torch.stack([k, x, y, sc.view(torch.int32),
                        valid.to(torch.int32)], dim=1).reshape(B, -1)
    return torch.cat([rows, n_above[:, None]], dim=1).cpu().numpy()


def _as_tensor(a) -> torch.Tensor:
    """A tensor as it is; anything else copied into a new CPU tensor."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))


class Detector:
    """LINE-2D detector, match path. Args mirror Detector(num_features, T,
    weak_thresh, strong_thresh) (line2Dup.h:266); ``T`` is the
    per-pyramid-level spread factor, finest level first;
    ``num_orientations`` is 8, or 16 for the 16-orientation experiment.
    ``strong_threshold`` is kept for training, which the port does not
    have yet. ``device`` is where frames, banks and all device work live:
    the card unless the caller asks for "cpu" (where every kernel runs its
    plain twin); "cuda" without a card raises."""

    def __init__(self, num_features: int = 63, T=(4, 8),
                 weak_threshold: float = 30.0,
                 strong_threshold: float = 60.0,
                 num_orientations: int = 8, *, device="cuda"):
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
        self.class_templates: dict[str, list[TemplatePyramid]] = {}
        self._banks: dict[str, list] = {}
        self._max_dims: dict[str, list] = {}
        self._chain_plans: dict[tuple, ChainPlan | None] = {}
        # refine levels run per route ("window", "maps"), for tests and
        # profiles to see which route a match took
        self.refine_routes: Counter = Counter()

    def _get_banks(self, class_id: str) -> list:
        banks = self._banks.get(class_id)
        if banks is None:
            pyramids = self.class_templates[class_id]
            banks = pyramids_to_banks(pyramids, self.pyramid_levels,
                                      self.device, self.num_orientations)
            self._banks[class_id] = banks
            self._max_dims[class_id] = level_max_dims(pyramids,
                                                      self.pyramid_levels)
        return banks

    def _get_chain(self, class_id: str, size_wh) -> ChainPlan | None:
        """The coarse bank's delta-chain plan at this frame size, planned on
        the host once per (class, size) and uploaded once; None when the
        planner declines (a sparse bank keeps the plain coarse kernel)."""
        key = (class_id, tuple(size_wh))
        if key not in self._chain_plans:
            bank = self._get_banks(class_id)[-1]
            plan = plan_chain(LevelBank(*(f.cpu().numpy() for f in bank)),
                              self.T_at_level[-1], size_wh,
                              self.num_orientations)
            self._chain_plans[key] = (None if plan is None
                                      else plan_to_device(plan, self.device))
        return self._chain_plans[key]

    def _is_pathological(self, class_id: str, level: int, size_wh) -> bool:
        """Whether a template of the class is wider or taller than the
        level's image - 16T, where the border clamp inverts and features
        fall off the image, so level maps no longer hold the windows."""
        wmax, hmax = self._max_dims[class_id][level]
        border = 16 * self.T_at_level[level]
        return size_wh[0] - wmax < border or size_wh[1] - hmax < border

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

    def match(self, source, threshold: float, class_ids=None,
              mask=None) -> list[Match]:
        """Detect all trained templates in one uint8 frame, gray [H, W] or
        BGR [H, W, 3], with an optional uint8 [H, W] mask
        (line2Dup.cpp:1078-1150): match_batch at B=1."""
        return self.match_batch(
            _as_tensor(source)[None], threshold, class_ids,
            None if mask is None else _as_tensor(mask)[None])[0]

    def match_batch(self, sources, threshold: float, class_ids=None,
                    masks=None, cand_cap: int = 256) -> list[list[Match]]:
        """Match B same-shaped uint8 frames, gray [B, H, W] or BGR
        [B, H, W, 3] (numpy or a tensor), with optional uint8 [B, H, W]
        masks, in one device step per class; returns one match list per
        frame, identical to [match(f, mask=m) for f, m in zip(...)]."""
        frames = _as_tensor(sources)
        color = frames.dim() == 4 and frames.shape[-1] == 3
        if frames.dtype != torch.uint8 or not (frames.dim() == 3 or color):
            raise ValueError("match_batch expects uint8 [B, H, W] or "
                             "[B, H, W, 3] frames")
        self._validate_size(frames.shape[1:3])
        frames = frames.to(self.device)
        if color:  # planar channels, as the frontend reads them
            frames = frames.permute(0, 3, 1, 2)
        frames = frames.contiguous()
        if masks is not None:
            masks = _as_tensor(masks)
            if masks.dtype != torch.uint8 or masks.shape != (
                    frames.shape[0], *frames.shape[-2:]):
                raise ValueError("masks must be uint8 [B, H, W] like the "
                                 "frames")
            masks = masks.to(self.device).contiguous()
        B = frames.shape[0]
        sizes = tuple(self._level_sizes(frames.shape[-2:]))
        lms = _batch_pyramid(frames, self.T_at_level, self.pyramid_levels,
                             self.weak_threshold, self.num_orientations,
                             masks)
        thr = torch.tensor(threshold, dtype=torch.float32,
                           device=self.device)
        if not class_ids:
            class_ids = list(self.class_templates.keys())
        out: list[list[Match]] = [[] for _ in range(B)]
        for class_id in class_ids:
            if class_id not in self.class_templates:
                continue
            host = self._class_step(lms, class_id, thr, sizes, cand_cap)
            for b in range(B):
                row = host[b]
                n_above = int(row[-1])
                if n_above > cand_cap:
                    cap = next((c for c in _CAND_BUCKETS if c >= n_above),
                               n_above)
                    row = self._class_step(tuple(f[b:b + 1] for f in lms),
                                           class_id, thr, sizes, cap,
                                           rerun=True)[0]
                out[b].extend(self._matches(row, class_id))
        return [_sort_dedup(m) for m in out]

    def _class_step(self, lms: tuple, class_id: str, thr: torch.Tensor,
                    sizes: tuple, cap: int, rerun: bool = False):
        """One device step of a class at candidate cap `cap` and its one
        download (see _to_host). The first step refines through the
        window; an overflow re-run at a cap of _MAP_MIN_CAP or more takes
        the map route at every level whose bank is not pathological."""
        levels = self.pyramid_levels - 1
        maps = tuple(l for l in range(levels)
                     if rerun and cap >= _MAP_MIN_CAP
                     and not self._is_pathological(class_id, l, sizes[l]))
        self.refine_routes["maps"] += len(maps)
        self.refine_routes["window"] += levels - len(maps)
        return _to_host(_match_batch_class(
            lms, self._get_banks(class_id), thr, self.T_at_level,
            self.pyramid_levels, sizes, cap,
            self._get_chain(class_id, sizes[-1]), maps,
            self.num_orientations))

    @staticmethod
    def _matches(row: np.ndarray, class_id: str) -> list[Match]:
        k, x, y, sc_bits, valid = row[:-1].reshape(5, -1)
        sc = sc_bits.view(np.float32)
        return [Match(int(x[i]), int(y[i]), float(sc[i]), class_id,
                      int(k[i])) for i in np.nonzero(valid)[0]]
