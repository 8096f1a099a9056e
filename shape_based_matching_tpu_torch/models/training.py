"""Template training: feature extraction, and the rotation sweep.

The dense work of extraction (gradients, quantization, the 5x5 local-max
map, the mask erosion) runs as torch ops on the frames' device
(``models/detector._train_level``); the order-dependent greedy passes -- the
NMS acceptance scan and the scattered feature selection
(line2Dup.cpp:452-539, :163-212) -- run on the host over the short pixel
lists the device hands over, in the compiled helpers of ``csrc/host.cpp``
(``models/native.py``). Their Python loops stay here as the plain
versions (``greedy_accept_plain``, ``select_scattered_plain``).

The reference's greedy magnitude NMS (line2Dup.cpp:466-511) scans row-major
with a `magnitude_valid` bitmap. Its exact semantics reduce to:

  * a pixel is an *accepted max* iff it is mask-eligible, a ties-allowed 5x5
    local max of magnitude, and no previously accepted max lies within
    Chebyshev distance 2 (suppression only ever comes from accepted maxes);
  * candidates are accepted maxes with magnitude > strong^2 and a nonzero
    quantized orientation.

Everything here follows the JAX package's ``models/training.py`` in the
same IEEE operation order, so both packages train the same templates.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import native
from .template import Feature, Template


def local_max_map(magnitude: torch.Tensor) -> torch.Tensor:
    """Ties-allowed 5x5 local-max map of [..., H, W] float32 magnitudes,
    interior only (k=2 border margin): a pixel is a max iff it is >= its
    24 neighbours, i.e. equal to the 5x5 max-pool with -inf padding."""
    h, w = magnitude.shape[-2:]
    pooled = F.max_pool2d(magnitude.reshape(-1, 1, h, w), 5, stride=1,
                          padding=2).reshape(magnitude.shape)
    rows = torch.arange(h, device=magnitude.device)[:, None]
    cols = torch.arange(w, device=magnitude.device)[None, :]
    interior = (rows >= 2) & (rows < h - 2) & (cols >= 2) & (cols < w - 2)
    return (magnitude == pooled) & interior


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def greedy_accept(h: int, w: int, ys, xs) -> np.ndarray:
    """Row-major greedy acceptance flags (bool [n]) over the ROW-MAJOR
    eligible pixel list (line2Dup.cpp:466-511): a pixel is accepted iff no
    previously accepted pixel lies within Chebyshev distance 2. The
    compiled helper; ``greedy_accept_plain`` is its Python loop."""
    ys32 = np.ascontiguousarray(ys, np.int32)
    xs32 = np.ascontiguousarray(xs, np.int32)
    n = len(ys32)
    if n == 0:
        return np.zeros(0, bool)
    if len(xs32) != n or ys32.min() < 0 or ys32.max() >= h \
            or xs32.min() < 0 or xs32.max() >= w:
        raise ValueError(f"greedy_accept: points outside the {h} x {w} "
                         f"plane, or ys and xs of different lengths")
    flags = np.zeros(n, np.uint8)
    native.library().sbm_greedy_accept(
        h, w, n, _i32p(ys32), _i32p(xs32),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return flags.astype(bool)


def greedy_accept_plain(h: int, w: int, ys, xs) -> np.ndarray:
    """The plain version of ``greedy_accept``."""
    accepted = np.zeros((h, w), dtype=bool)
    flags = np.zeros(len(ys), bool)
    for i, (r, c) in enumerate(zip(np.asarray(ys).tolist(),
                                   np.asarray(xs).tolist())):
        r0, r1 = max(0, r - 2), min(h, r + 3)
        c0, c1 = max(0, c - 2), min(w, c + 3)
        if accepted[r0:r1, c0:c1].any():
            continue
        accepted[r, c] = True
        flags[i] = True
    return flags


class Candidate:
    __slots__ = ("x", "y", "label", "score", "theta")

    def __init__(self, x, y, label, score, theta):
        self.x, self.y, self.label = x, y, label
        self.score, self.theta = score, theta


def template_from_strong(xs, ys, mag_v, quant_v, theta_v,
                         num_features: int, strong_threshold: float,
                         pyramid_level: int) -> Template | None:
    """Tail of extractTemplate given the ACCEPTED pixels in row-major
    order: exact float strong-threshold filter, stable score sort,
    scattered selection (line2Dup.cpp:513-539). None when too few
    candidates (<= 4): the reference aborts and addTemplate returns -1
    (line2Dup.cpp:513-517, 1342)."""
    threshold_sq = float(strong_threshold) ** 2
    candidates = []  # row-major acceptance order (pre-sort tie order)
    for x, y, s, q, t in zip(np.asarray(xs).tolist(),
                             np.asarray(ys).tolist(),
                             np.asarray(mag_v).tolist(),
                             np.asarray(quant_v).tolist(),
                             np.asarray(theta_v).tolist()):
        q = int(q)
        if s > threshold_sq and q > 0:
            candidates.append(
                Candidate(x=int(x), y=int(y), label=q.bit_length() - 1,
                          score=float(s), theta=float(t)))

    if len(candidates) < num_features and len(candidates) <= 4:
        return None

    candidates.sort(key=lambda cd: -cd.score)  # stable (line2Dup.cpp:522)
    distance = float(len(candidates) // num_features + 1)
    feats = select_scattered_features(candidates, num_features, distance)

    templ = Template(width=-1, height=-1, pyramid_level=pyramid_level)
    templ.features = [Feature(c.x, c.y, c.label, c.theta) for c in feats]
    return templ


def select_scattered_features(candidates, num_features: int,
                              distance: float):
    """Greedy spatially-scattered subset of the score-sorted candidates
    (line2Dup.cpp:163-212): the compiled helper;
    ``select_scattered_plain`` is its Python loop."""
    if not candidates:
        return []
    xs = np.ascontiguousarray([c.x for c in candidates], np.int32)
    ys = np.ascontiguousarray([c.y for c in candidates], np.int32)
    out = np.zeros(len(candidates), np.int32)
    cnt = native.library().sbm_select_scattered(
        len(candidates), _i32p(xs), _i32p(ys), int(num_features),
        ctypes.c_float(distance), _i32p(out))
    return [candidates[i] for i in out[:cnt]]


def select_scattered_plain(candidates, num_features: int, distance: float):
    """The plain version of ``select_scattered_features``."""
    features = []
    distance_sq = distance * distance
    i = 0
    first_select = True
    while True:
        c = candidates[i]
        keep = True
        for f in features:
            dx = c.x - f.x
            dy = c.y - f.y
            if dx * dx + dy * dy < distance_sq:
                keep = False
                break
        if keep:
            features.append(c)
        i += 1
        if i == len(candidates):
            num_ok = len(features) >= num_features
            if first_select:
                if num_ok:
                    features = []
                    i = 0
                    distance += 1.0
                    distance_sq = distance * distance
                    continue
                first_select = False
            i = 0
            distance -= 1.0
            distance_sq = distance * distance
            if num_ok or distance < 3:
                break
    return features


def _rotate_level(src: Template, cx: float, cy: float, cos_a, sin_a,
                  theta_f32, n_ori: int):
    """Rotated positions, labels and angles of one level's features for
    A angles at once ([A] float64 cos and sin, [A] float32 angles): the
    IEEE op sequence of addTemplate_rotate (line2Dup.cpp:1409-1451):
    float32 adds and subs, the rotation in double narrowed to float32,
    truncation toward zero. Returns four [A, n] arrays."""
    f32 = np.float32
    A = len(theta_f32)
    if not src.features:
        z = np.zeros((A, 0), np.int64)
        return z, z, z, np.zeros((A, 0), f32)
    px = (np.array([f.x for f in src.features], np.int64)
          + src.tl_x).astype(f32)
    py = (np.array([f.y for f in src.features], np.int64)
          + src.tl_y).astype(f32)
    dx = (px - f32(cx)).astype(np.float64)
    dy = (py - f32(cy)).astype(np.float64)
    rx = (cos_a[:, None] * dx[None, :]
          - sin_a[:, None] * dy[None, :]).astype(f32)
    ry = (sin_a[:, None] * dx[None, :]
          + cos_a[:, None] * dy[None, :]).astype(f32)
    fxs = np.trunc((rx + f32(cx)) + f32(0.5)).astype(np.int64)
    fys = np.trunc((ry + f32(cy)) + f32(0.5)).astype(np.int64)
    th0 = np.array([f.theta for f in src.features], np.float64).astype(f32)
    th = (th0[None, :] - theta_f32[:, None]).astype(f32)
    while np.any(th > 360):
        th = np.where(th > 360, th - f32(360), th).astype(f32)
    while np.any(th < 0):
        th = np.where(th < 0, th + f32(360), th).astype(f32)
    labels = (np.trunc(th * f32(2 * n_ori) / f32(360) + f32(0.5))
              .astype(np.int64)) & (n_ori - 1)
    return fxs, fys, labels, th


def _trig(thetas) -> tuple:
    """float64 cos and sin of -theta in radians, per angle with math.cos
    and math.sin (numpy may route float64 trig through a SIMD libm that
    differs in the last ulp), and the angles as float32."""
    t64 = np.asarray(thetas, np.float64).reshape(-1)
    cos_a = np.array([math.cos(-t / 180.0 * math.pi) for t in t64.tolist()],
                     np.float64)
    sin_a = np.array([math.sin(-t / 180.0 * math.pi) for t in t64.tolist()],
                     np.float64)
    return cos_a, sin_a, t64.astype(np.float32)


def _half(v: float) -> float:
    """center /= 2 at each level, in float32 (line2Dup.cpp:1422)."""
    return np.float32(np.float32(v) / np.float32(2)).item()


def rotate_template_features(tp, theta: float, center_xy,
                             pyramid_levels: int, n_ori: int = 8):
    """addTemplate_rotate's feature math for one angle (line2Dup.cpp:
    1395-1451): a new pyramid of uncropped templates."""
    cos_a, sin_a, th = _trig([float(theta)])
    cx, cy = float(center_xy[0]), float(center_xy[1])
    out = []
    for l in range(pyramid_levels):
        if l > 0:
            cx, cy = _half(cx), _half(cy)
        fxs, fys, labels, ths = _rotate_level(tp[l], cx, cy, cos_a, sin_a,
                                              th, n_ori)
        t_new = Template(pyramid_level=l)
        t_new.features = [Feature(int(x), int(y), int(lb), float(t))
                          for x, y, lb, t in zip(fxs[0], fys[0], labels[0],
                                                 ths[0])]
        out.append(t_new)
    return out


def rotate_templates_batch(tp, thetas, center_xy, pyramid_levels: int,
                           n_ori: int = 8):
    """Every angle of a rotation sweep of one base template at once, crop
    included: equal to ``crop_templates(rotate_template_features(tp,
    theta, ...))`` per angle, from [A, n] numpy arrays and a vectorised
    crop (the joint bounding box over levels at level-0 scale, the
    C-remainder even-origin rule, the per-level rebase). Returns CROPPED
    template pyramids in angle order."""
    cos_a, sin_a, th_f32 = _trig(thetas)
    A = len(th_f32)
    cx, cy = float(center_xy[0]), float(center_xy[1])
    per_level = []
    for l in range(pyramid_levels):
        if l > 0:
            cx, cy = _half(cx), _half(cy)
        per_level.append(_rotate_level(tp[l], cx, cy, cos_a, sin_a, th_f32,
                                       n_ori))

    big = np.int64(1) << 30
    min_x = np.full(A, big, np.int64)
    min_y = np.full(A, big, np.int64)
    max_x = np.full(A, -big, np.int64)
    max_y = np.full(A, -big, np.int64)
    for l, (fxs, fys, _, _) in enumerate(per_level):
        if fxs.shape[1]:
            min_x = np.minimum(min_x, (fxs << l).min(axis=1))
            min_y = np.minimum(min_y, (fys << l).min(axis=1))
            max_x = np.maximum(max_x, (fxs << l).max(axis=1))
            max_y = np.maximum(max_y, (fys << l).max(axis=1))
    min_x = np.where((min_x >= 0) & (min_x % 2 == 1), min_x - 1, min_x)
    min_y = np.where((min_y >= 0) & (min_y % 2 == 1), min_y - 1, min_y)

    lvl = []
    for l, (fxs, fys, labels, th) in enumerate(per_level):
        tlx = min_x >> l
        tly = min_y >> l
        lvl.append((
            (fxs - tlx[:, None]).tolist(), (fys - tly[:, None]).tolist(),
            labels.tolist(), th.astype(np.float64).tolist(),
            ((max_x - min_x) >> l).tolist(), ((max_y - min_y) >> l).tolist(),
            tlx.tolist(), tly.tolist()))
    out = []
    for a in range(A):
        tp_new = []
        for l in range(pyramid_levels):
            xs, ys, lbs, ths, ws, hs, tlxs, tlys = lvl[l]
            t = Template(pyramid_level=l, width=ws[a], height=hs[a],
                         tl_x=tlxs[a], tl_y=tlys[a])
            t.features = [Feature(x_, y_, l_, t_) for x_, y_, l_, t_
                          in zip(xs[a], ys[a], lbs[a], ths[a])]
            tp_new.append(t)
        out.append(tp_new)
    return out
