"""Detector: the LINE-2D match path (line2Dup.h:257-333) in PyTorch.

A frame's match runs as one device step per class for B frames at once:
``_batch_pyramid`` (pyrDown, the fused frontend kernel, linear memories
per level), then ``_match_batch_class`` (coarse scoring kernel with
counted candidate extraction at the top level, then the window refine
kernel at every finer level), then one device-to-host transfer, the
``Match`` list and ``_sort_dedup``. The candidate cap is static; a frame
whose exact candidate count ``n_above`` exceeds it re-runs the same step
at the smallest ``_CAND_BUCKETS`` cap that holds all of them (or at
``n_above`` past the last bucket), so the match list is always complete.

Results are bit-identical to the JAX package's ``Detector`` (template id,
position and float32 similarity of every match).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.cuda.frontend import quant_spread
from ..ops.filters import pyr_down_u8
from ..ops.response import build_lm_from_spread
from ..ops.similarity import coarse_extract, refine_candidates
from ..utils.convert import pyramids_to_banks
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
                   weak_threshold: float) -> tuple:
    """[B, H, W] uint8 frames -> one flat linear-memory buffer per level,
    [B, 8*T*T*M + M] uint8: the [8, T*T, M] linear memories of each frame
    followed by an M-byte zero tail that dead and off-image features read
    (match() preamble, line2Dup.cpp:1084-1120)."""
    flats = []
    src = sources
    for l in range(levels):
        if l > 0:
            src = pyr_down_u8(src)
        lm = build_lm_from_spread(quant_spread(src, weak_threshold, T[l]),
                                  T[l])
        B, M = lm.shape[0], lm.shape[-1]
        flats.append(torch.cat([lm.reshape(B, -1), lm.new_zeros((B, M))],
                               dim=1))
    return tuple(flats)


def _match_batch_class(lmflats: tuple, banks: list, threshold: torch.Tensor,
                       T: tuple, levels: int, sizes: tuple, cand_cap: int):
    """matchClass for B frames (line2Dup.cpp:1160-1297): coarse scoring and
    candidate extraction at the top level, then window refinement down to
    level 0. Returns (k, x, y, score, valid) each [B, cand_cap] and
    n_above [B]."""
    k, x, y, sc, valid, n_above = coarse_extract(
        lmflats[-1], banks[-1], T[-1], sizes[-1], threshold, cand_cap)
    for l in range(levels - 2, -1, -1):
        k, x, y, sc, valid = refine_candidates(
            lmflats[l], banks[l], T[l], sizes[l], k, x, y, valid, threshold)
    return k, x, y, sc, valid, n_above


def _to_host(result) -> np.ndarray:
    """One device-to-host transfer of a class step's results: [B, 5*C + 1]
    int32 rows (k, x, y, score bits, valid; then n_above)."""
    k, x, y, sc, valid, n_above = result
    B = k.shape[0]
    rows = torch.stack([k, x, y, sc.view(torch.int32),
                        valid.to(torch.int32)], dim=1).reshape(B, -1)
    return torch.cat([rows, n_above[:, None]], dim=1).cpu().numpy()


class Detector:
    """LINE-2D detector, match path. Args mirror Detector(num_features, T,
    weak_thresh) (line2Dup.h:266); ``T`` is the per-pyramid-level spread
    factor, finest level first. ``device`` is where frames, banks and all
    device work live; asking for "cuda" without a card raises."""

    def __init__(self, num_features: int = 63, T=(4, 8),
                 weak_threshold: float = 30.0, *, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector(device='cuda') but CUDA is not "
                               "available")
        self.num_features = int(num_features)
        self.T_at_level = tuple(int(t) for t in T)
        self.pyramid_levels = len(self.T_at_level)
        self.weak_threshold = float(weak_threshold)
        self.class_templates: dict[str, list[TemplatePyramid]] = {}
        self._banks: dict[str, list] = {}

    def _get_banks(self, class_id: str) -> list:
        banks = self._banks.get(class_id)
        if banks is None:
            banks = pyramids_to_banks(self.class_templates[class_id],
                                      self.pyramid_levels, self.device)
            self._banks[class_id] = banks
        return banks

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

    def match(self, source, threshold: float, class_ids=None) -> list[Match]:
        """Detect all trained templates in one uint8 [H, W] gray frame
        (line2Dup.cpp:1078-1150): match_batch at B=1."""
        return self.match_batch(source[None], threshold, class_ids)[0]

    def match_batch(self, sources, threshold: float, class_ids=None,
                    cand_cap: int = 256) -> list[list[Match]]:
        """Match B same-shaped uint8 [B, H, W] frames (numpy or a tensor)
        in one device step per class; returns one match list per frame,
        identical to [match(f) for f in sources]."""
        frames = torch.as_tensor(np.asarray(sources)) \
            if not isinstance(sources, torch.Tensor) else sources
        if frames.dim() != 3 or frames.dtype != torch.uint8:
            raise ValueError("match_batch expects uint8 [B, H, W] frames")
        frames = frames.to(self.device).contiguous()
        self._validate_size(frames.shape[1:3])
        B = frames.shape[0]
        sizes = tuple(self._level_sizes(frames.shape[1:3]))
        lms = _batch_pyramid(frames, self.T_at_level, self.pyramid_levels,
                             self.weak_threshold)
        thr = torch.tensor(threshold, dtype=torch.float32,
                           device=self.device)
        if not class_ids:
            class_ids = list(self.class_templates.keys())
        out: list[list[Match]] = [[] for _ in range(B)]
        for class_id in class_ids:
            if class_id not in self.class_templates:
                continue
            banks = self._get_banks(class_id)
            step = (banks, thr, self.T_at_level, self.pyramid_levels, sizes)
            host = _to_host(_match_batch_class(lms, *step, cand_cap))
            for b in range(B):
                row = host[b]
                n_above = int(row[-1])
                if n_above > cand_cap:
                    cap = next((c for c in _CAND_BUCKETS if c >= n_above),
                               n_above)
                    lms_b = tuple(f[b:b + 1] for f in lms)
                    row = _to_host(_match_batch_class(lms_b, *step, cap))[0]
                out[b].extend(self._matches(row, class_id))
        return [_sort_dedup(m) for m in out]

    @staticmethod
    def _matches(row: np.ndarray, class_id: str) -> list[Match]:
        k, x, y, sc_bits, valid = row[:-1].reshape(5, -1)
        sc = sc_bits.view(np.float32)
        return [Match(int(x[i]), int(y[i]), float(sc[i]), class_id,
                      int(k[i])) for i in np.nonzero(valid)[0]]
