"""Scalar NumPy oracle of the LINE-2D pipeline, frozen inside the benchmark.

A copy of the port's ``oracle/reference.py`` (itself the JAX package's
scalar oracle, which follows the C++ control flow of line2Dup.cpp as
directly as possible), kept here so that the yardstick does not move when
the program changes. It imports NumPy only.

The benchmark's reference uses it as it stands for training (feature
extraction, scattered selection, the crop) and as the ground truth that
``portbench/tests`` hold the vectorised torch reference (``line2d.py``)
to at small sizes.
"""

from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# Filters (bit-exact OpenCV arithmetic, see ops/filters.py for derivations)
# ---------------------------------------------------------------------------

_GAUSS7_Q8 = np.array([8, 28, 56, 72, 56, 28, 8], dtype=np.int64)
_PYR5 = np.array([1, 4, 6, 4, 1], dtype=np.int64)


def gaussian_blur7_u8(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.int64)
    pad = ((3, 3), (3, 3)) + (((0, 0),) if x.ndim == 3 else ())
    p = np.pad(x, pad, mode="edge")
    h, w = img.shape[:2]
    hs = sum(_GAUSS7_Q8[i] * p[:, i : i + w] for i in range(7))
    vs = sum(_GAUSS7_Q8[i] * hs[i : i + h] for i in range(7))
    return ((vs + (1 << 15)) >> 16).astype(np.uint8)


def sobel3(img_u8: np.ndarray, dx: bool) -> np.ndarray:
    x = img_u8.astype(np.int64)
    pad = ((1, 1), (1, 1)) + (((0, 0),) if x.ndim == 3 else ())
    p = np.pad(x, pad, mode="edge")
    h, w = img_u8.shape[:2]
    if dx:
        v = p[0:h, :] + 2 * p[1 : h + 1, :] + p[2 : h + 2, :]  # vertical smooth
        return (v[:, 2 : w + 2] - v[:, 0:w]).astype(np.int64)
    hz = p[:, 0:w] + 2 * p[:, 1 : w + 1] + p[:, 2 : w + 2]  # horizontal smooth
    return (hz[2 : h + 2, :] - hz[0:h, :]).astype(np.int64)


def pyr_down_u8(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.int64)
    pad = ((2, 2), (2, 2)) + (((0, 0),) if x.ndim == 3 else ())
    p = np.pad(x, pad, mode="reflect")
    h, w = img.shape[:2]
    hs = sum(_PYR5[i] * p[:, i : i + w] for i in range(5))
    vs = sum(_PYR5[i] * hs[i : i + h] for i in range(5))
    full = (vs + 128) >> 8
    return full[: 2 * (h // 2) : 2, : 2 * (w // 2) : 2].astype(np.uint8)


def resize_nearest(img: np.ndarray, out_hw) -> np.ndarray:
    oh, ow = out_hw
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(oh) * (h / oh)).astype(int), h - 1)
    xs = np.minimum(np.floor(np.arange(ow) * (w / ow)).astype(int), w - 1)
    return img[np.ix_(ys, xs)]


def erode3_u8(img: np.ndarray) -> np.ndarray:
    p = np.pad(img, 1, mode="edge")
    h, w = img.shape
    return np.minimum.reduce(
        [p[i : i + h, j : j + w] for i in range(3) for j in range(3)]
    )


def fast_atan2_deg(dy: np.ndarray, dx: np.ndarray) -> np.ndarray:
    """cv::fastAtan2 replica, float32 (see ops/fastmath.py)."""
    P1 = np.float32(0.9997878412794807 * (180.0 / math.pi))
    P3 = np.float32(-0.3258083974640975 * (180.0 / math.pi))
    P5 = np.float32(0.1555786518463281 * (180.0 / math.pi))
    P7 = np.float32(-0.04432655554792128 * (180.0 / math.pi))
    EPS = np.float32(2.220446049250313e-16)
    x = dx.astype(np.float32)
    y = dy.astype(np.float32)
    ax, ay = np.abs(x), np.abs(y)
    c = np.where(ax >= ay, ay / (ax + EPS), ax / (ay + EPS)).astype(np.float32)
    c2 = (c * c).astype(np.float32)
    a = ((((P7 * c2 + P5) * c2 + P3) * c2 + P1) * c).astype(np.float32)
    a = np.where(ax < ay, np.float32(90.0) - a, a)
    a = np.where(x < 0, np.float32(180.0) - a, a)
    a = np.where(y < 0, np.float32(360.0) - a, a)
    return a.astype(np.float32)


# ---------------------------------------------------------------------------
# Quantization (line2Dup.cpp:218-404)
# ---------------------------------------------------------------------------

def hysteresis_quantize(magnitude: np.ndarray, angle_deg: np.ndarray,
                        threshold_sq: float, n_ori: int = 8) -> np.ndarray:
    """Majority-vote quantization. The 3x3 vote is order-independent, so the
    loop is vectorized; np.argmax keeps the C++ first-max-wins tie rule.
    n_ori=16 mirrors the ori_16bit_experiment (CV_16U output)."""
    h, w = angle_deg.shape
    # convertTo(CV_8U/CV_16U, 2*n_ori/360): cvRound = round-half-to-even.
    q16 = np.rint(angle_deg.astype(np.float64)
                  * (2.0 * n_ori / 360.0)).astype(np.int32)
    q16[0, :] = 0
    q16[-1, :] = 0
    q16[:, 0] = 0
    q16[:, -1] = 0
    q8 = (q16 & (n_ori - 1)).astype(np.int32)

    onehot = np.zeros((h, w, n_ori), np.int32)
    np.put_along_axis(onehot, q8[..., None], 1, axis=2)
    p = np.pad(onehot, ((1, 1), (1, 1), (0, 0)))
    votes = sum(p[i : i + h, j : j + w] for i in range(3) for j in range(3))
    max_votes = votes.max(axis=2)
    best = votes.argmax(axis=2)

    interior = np.zeros((h, w), bool)
    interior[1:-1, 1:-1] = True
    ok = interior & (magnitude > threshold_sq) & (max_votes >= 5)
    dtype = np.uint8 if n_ori <= 8 else np.uint16
    return np.where(ok, (1 << best).astype(dtype), dtype(0))


def quantized_orientations(src: np.ndarray, weak_threshold: float,
                           n_ori: int = 8):
    """Returns (magnitude_sq f32, quantized u8/u16, angle_deg f32)."""
    smoothed = gaussian_blur7_u8(src)
    if src.ndim == 2:
        dx = sobel3(smoothed, dx=True).astype(np.float32)
        dy = sobel3(smoothed, dx=False).astype(np.float32)
        magnitude = dx * dx + dy * dy
    else:
        dx3 = sobel3(smoothed, dx=True)
        dy3 = sobel3(smoothed, dx=False)
        mag3 = dx3 * dx3 + dy3 * dy3
        m0, m1, m2 = mag3[..., 0], mag3[..., 1], mag3[..., 2]
        pick0 = (m0 >= m1) & (m0 >= m2)
        pick1 = (~pick0) & (m1 >= m0) & (m1 >= m2)
        sel = np.where(pick0, 0, np.where(pick1, 1, 2))
        ii, jj = np.meshgrid(np.arange(src.shape[0]), np.arange(src.shape[1]),
                             indexing="ij")
        dx = dx3[ii, jj, sel].astype(np.float32)
        dy = dy3[ii, jj, sel].astype(np.float32)
        magnitude = mag3[ii, jj, sel].astype(np.float32)
    ang = fast_atan2_deg(dy, dx)
    quant = hysteresis_quantize(magnitude, ang, float(weak_threshold) ** 2,
                                n_ori=n_ori)
    return magnitude, quant, ang


# ---------------------------------------------------------------------------
# Response maps (line2Dup.cpp:583-777)
# ---------------------------------------------------------------------------

def spread(src: np.ndarray, T: int) -> np.ndarray:
    h, w = src.shape
    dst = np.zeros_like(src)
    for r in range(T):
        for c in range(T):
            dst[: h - r, : w - c] |= src[r:, c:]
    return dst


def response_maps(spread_img: np.ndarray, n_ori: int = 8) -> np.ndarray:
    s = spread_img.astype(np.int32)
    out = np.zeros((n_ori,) + spread_img.shape, dtype=np.uint8)
    if n_ori == 8:
        for ori in range(8):
            exact = (s >> ori) & 1
            adj = ((s >> ((ori + 1) & 7)) & 1) | ((s >> ((ori - 1) & 7)) & 1)
            out[ori] = np.where(exact == 1, 4, np.where(adj == 1, 3, 0))
        return out
    # the vendored SIMILARITY_LUT (line2Dup_16bit_ori.cpp:575-608):
    # circular distance d -> 4 (d <= 2), 1 (d in {3,4}), 0 (d >= 5).
    # (LUT_gen.cpp's graded 8..0 table / LUT16.txt is NOT what the
    # experiment compiles — the compiled table is the parity target.)
    # Bits 12..15 never contribute: the reference's nibble split extracts
    # the top segment with (src & (15 << 16)) >> 16 — always zero for a
    # ushort (line2Dup_16bit_ori.cpp:639).
    live = 0xFFF
    for ori in range(n_ori):
        near = mid = 0
        for d in (-2, -1, 0, 1, 2):
            near |= 1 << ((ori + d) % n_ori)
        for d in (-4, -3, 3, 4):
            mid |= 1 << ((ori + d) % n_ori)
        out[ori] = np.where((s & near & live) > 0, 4,
                            np.where((s & mid & live) > 0, 1, 0))
    return out


def linearize(resp: np.ndarray, T: int) -> np.ndarray:
    """[n_ori, H, W] -> [n_ori, T*T, M] exactly like line2Dup.cpp:749-777."""
    n_ori, h, w = resp.shape
    assert h % T == 0 and w % T == 0
    hd, wd = h // T, w // T
    out = np.zeros((n_ori, T * T, hd * wd), dtype=np.uint8)
    for ori in range(n_ori):
        idx = 0
        for r0 in range(T):
            for c0 in range(T):
                out[ori, idx] = resp[ori, r0::T, c0::T].ravel()
                idx += 1
    return out


# ---------------------------------------------------------------------------
# Similarity (line2Dup.cpp:807-1048) — flat-offset semantics incl. wrap
# ---------------------------------------------------------------------------

def similarity(lm: np.ndarray, features, templ_wh, size_wh, T: int) -> np.ndarray:
    """Whole-image similarity, u16 result [H/T, W/T].

    lm: [8, T*T, M] linear memories. features: list of (x, y, label).
    templ_wh: (width, height) of the cropped template. size_wh: image (w, h).
    """
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    tw, th = templ_wh
    wf = (tw - 1) // T + 1
    hf = (th - 1) // T + 1
    span_x = W - wf
    span_y = H - hf
    positions = span_y * W + span_x + 1

    dst = np.zeros(M, dtype=np.int64)
    for (x, y, label) in features:
        if x < 0 or x >= w_img or y < 0 or y >= h_img:
            continue
        grid = (y % T) * T + (x % T)
        off = (y // T) * W + (x // T)
        # C++ (line2Dup.cpp:843-856) reads lm_ptr[j] for all j < positions
        # with NO clamp at the plane end: when off + positions > M (a
        # feature at fx == width with T | width) the read continues into
        # the NEXT grid row of the same orientation's contiguous [T*T, M]
        # Mat. Flatten the orientation to reproduce those bytes exactly
        # (similarity_local below does the same).
        plane = lm[label].reshape(-1)
        start = grid * M + off
        n = min(positions, plane.shape[0] - start)
        dst[:n] += plane[start : start + n]
    return dst.reshape(H, W).astype(np.uint16)


def similarity_local(lm: np.ndarray, features, size_wh, T: int,
                     center_xy) -> np.ndarray:
    """16x16 local similarity around `center` (line2Dup.cpp:860-922).

    Reproduces the flat row reads: lm_ptr advances by W per patch row and may
    wrap across plane rows exactly like the C++ pointer arithmetic.
    """
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    cx, cy = center_xy
    off_x = (cx // T - 8) * T
    off_y = (cy // T - 8) * T
    dst = np.zeros((16, 16), dtype=np.int64)
    for (x, y, label) in features:
        fx = x + off_x
        fy = y + off_y
        if fx < 0 or fy < 0 or fx >= w_img or fy >= h_img:
            continue
        grid = (fy % T) * T + (fx % T)
        base = (fy // T) * W + (fx // T)
        # C++ reads lm_ptr + rr*W + cc as raw pointer arithmetic inside the
        # [T*T, M] plane Mat; reads may cross grid rows — flatten the plane.
        plane = lm[label].reshape(-1)
        for rr in range(16):
            start = grid * M + base + rr * W
            n = max(0, min(16, plane.shape[0] - start))
            dst[rr, :n] += plane[start : start + n]
    return dst.astype(np.uint16)


# ---------------------------------------------------------------------------
# Template extraction (line2Dup.cpp:452-539 + 163-212)
# ---------------------------------------------------------------------------

def extract_template(magnitude: np.ndarray, quantized: np.ndarray,
                     angle_ori: np.ndarray, mask: np.ndarray | None,
                     num_features: int, strong_threshold: float):
    """Returns list of Candidate dicts already greedily NMS'd + sorted, then
    scatter-selected features; or None on abort (<=4 candidates)."""
    h, w = magnitude.shape
    local_mask = erode3_u8(mask) if mask is not None else None
    threshold_sq = float(strong_threshold) ** 2
    k = 5 // 2

    magnitude_valid = np.ones((h, w), dtype=np.uint8)
    candidates = []  # (score, y, x, label, theta) in scan order
    for r in range(k, h - k):
        for c in range(k, w - k):
            if local_mask is not None and not local_mask[r, c]:
                continue
            score = 0.0
            if magnitude_valid[r, c] > 0:
                score = magnitude[r, c]
                is_max = True
                for ro in range(-k, k + 1):
                    for co in range(-k, k + 1):
                        if ro == 0 and co == 0:
                            continue
                        if score < magnitude[r + ro, c + co]:
                            score = 0.0
                            is_max = False
                            break
                    if not is_max:
                        break
                if is_max:
                    for ro in range(-k, k + 1):
                        for co in range(-k, k + 1):
                            if ro == 0 and co == 0:
                                continue
                            magnitude_valid[r + ro, c + co] = 0
            if score > threshold_sq and quantized[r, c] > 0:
                label = int(quantized[r, c]).bit_length() - 1
                candidates.append(
                    dict(x=c, y=r, label=label, score=float(score),
                         theta=float(angle_ori[r, c]))
                )

    if len(candidates) < num_features:
        if len(candidates) <= 4:
            return None
    # stable sort by score desc
    candidates.sort(key=lambda d: -d["score"])
    distance = float(len(candidates) // num_features + 1)
    return select_scattered_features(candidates, num_features, distance)


def select_scattered_features(candidates, num_features: int, distance: float):
    """Greedy distance-based subset (line2Dup.cpp:163-212)."""
    features = []
    distance_sq = distance * distance
    i = 0
    first_select = True
    while True:
        c = candidates[i]
        keep = True
        for f in features:
            dx = c["x"] - f["x"]
            dy = c["y"] - f["y"]
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


def crop_templates(templates):
    """line2Dup.cpp:115-161. templates: list of dicts with 'features'
    (list of feature dicts) and 'pyramid_level'. Mutates in place."""
    min_x = min_y = 1 << 30
    max_x = max_y = -(1 << 30)
    for t in templates:
        for f in t["features"]:
            x = f["x"] << t["pyramid_level"]
            y = f["y"] << t["pyramid_level"]
            min_x = min(min_x, x)
            min_y = min(min_y, y)
            max_x = max(max_x, x)
            max_y = max(max_y, y)
    # C-style remainder: negative odd min_x stays odd (C's -3 % 2 == -1).
    if min_x >= 0 and min_x % 2 == 1:
        min_x -= 1
    if min_y >= 0 and min_y % 2 == 1:
        min_y -= 1
    for t in templates:
        l = t["pyramid_level"]
        t["width"] = (max_x - min_x) >> l
        t["height"] = (max_y - min_y) >> l
        t["tl_x"] = min_x >> l
        t["tl_y"] = min_y >> l
        for f in t["features"]:
            f["x"] -= t["tl_x"]
            f["y"] -= t["tl_y"]
    return templates


# ---------------------------------------------------------------------------
# Full match orchestration (line2Dup.cpp:1078-1297)
# ---------------------------------------------------------------------------

def build_lm_pyramid(src: np.ndarray, weak_threshold: float,
                     T_at_level, n_ori: int = 8, mask: np.ndarray = None):
    """match() preamble (line2Dup.cpp:1095-1120): per level
    quantize (masked copy, :446-450) -> spread -> response LUT ->
    linearize. Mask pyrDown is INTER_NEAREST (:433). Returns
    (lm_pyramid, sizes) with lm [n_ori, T*T, M] per level."""
    lms, sizes = [], []
    img = src
    msk = mask
    for l, T in enumerate(T_at_level):
        if l > 0:
            img = pyr_down_u8(img)
            if msk is not None:
                msk = resize_nearest(msk, img.shape[:2])
        _, quant, _ = quantized_orientations(img, weak_threshold, n_ori)
        if msk is not None:
            quant = np.where(msk > 0, quant, 0).astype(quant.dtype)
        lms.append(linearize(response_maps(spread(quant, T), n_ori), T))
        sizes.append((img.shape[1], img.shape[0]))
    return lms, sizes


def match_class(lm_pyramid, sizes, T_at_level, template_pyramids,
                threshold: float, class_id: str = ""):
    """matchClass (line2Dup.cpp:1160-1297): coarse full-image scan at the
    lowest level, then per-candidate 16x16 local refinement up the
    pyramid with the C++'s border clamps, strict-> argmax (first max in
    row-major order) and re-thresholding.

    template_pyramids: list of per-template lists of dicts
    {'features': [(x, y, label)], 'width', 'height'} indexed by level.
    Returns list of dicts {'x', 'y', 'similarity', 'class_id',
    'template_id'}.
    """
    levels = len(T_at_level)
    matches = []
    for template_id, tp in enumerate(template_pyramids):
        lowest_T = T_at_level[-1]
        templ = tp[levels - 1]
        nfeat = len(templ["features"])
        S = similarity(lm_pyramid[-1], templ["features"],
                       (templ["width"], templ["height"]), sizes[-1],
                       lowest_T)
        offset = lowest_T // 2 + (lowest_T % 2 - 1)
        candidates = []
        f32 = np.float32
        for r in range(S.shape[0]):
            for c in range(S.shape[1]):
                # float32 arithmetic as in the C++ (raw*100.f)/(4*nfeat)
                score = f32(f32(int(S[r, c]) * f32(100.0)) /
                            f32(4 * nfeat))
                if score > threshold:
                    candidates.append({
                        "x": c * lowest_T + offset,
                        "y": r * lowest_T + offset,
                        "similarity": np.float32(score),
                        "class_id": class_id,
                        "template_id": template_id,
                    })

        for l in range(levels - 2, -1, -1):
            T = T_at_level[l]
            w_img, h_img = sizes[l]
            border = 8 * T
            offset = T // 2 + (T % 2 - 1)
            templ = tp[l]
            nfeat = len(templ["features"])
            max_x = w_img - templ["width"] - border
            max_y = h_img - templ["height"] - border
            for m in candidates:
                # C++ clamp order: max(border) THEN min(max_x)
                x = min(max(m["x"] * 2 + 1, border), max_x)
                y = min(max(m["y"] * 2 + 1, border), max_y)
                S2 = similarity_local(lm_pyramid[l], templ["features"],
                                      sizes[l], T, (x, y))
                best_score = np.float32(0.0)
                best_r = best_c = -1
                for r in range(16):
                    for c in range(16):
                        score = f32(f32(int(S2[r, c]) * f32(100.0)) /
                                    f32(4 * nfeat))
                        if score > best_score:
                            best_score, best_r, best_c = score, r, c
                m["similarity"] = np.float32(best_score)
                m["x"] = (x // T - 8 + best_c) * T + offset
                m["y"] = (y // T - 8 + best_r) * T + offset
            candidates = [m for m in candidates
                          if m["similarity"] >= threshold]
        matches.extend(candidates)
    return matches
