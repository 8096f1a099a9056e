"""The plain reference of ddcr's fiducial inspection (test_jabil.cpp:46-312):
the scale-swept bank, a BGR frame's match, greedy NMS and the stored-
fiducial CCORR gate, in NumPy and plain PyTorch.

Written from the C++ and OpenCV, independent of the program under test:

* **Creation** (test_jabil.cpp:79-104, line2Dup.h:379-449): the sweep's
  angles and scales accumulate in float32 (``for (float v = lo; v <= hi
  + eps; v += step)``), scale-major; each render is cv::rotate by an
  exact multiple of 90 degrees, then cv::resize INTER_LINEAR at the
  float32 scale (``resize_linear``: OpenCV's 11-bit fixed-point
  coefficients, horizontal ones clamped at the edges, vertical source
  rows clipped); its mask is the full mask rendered alike, every nonzero
  pixel 255. Feature extraction is the frozen scalar oracle's
  (``oracle_np.py``) on the colour render: per pixel the channel of
  largest squared gradient (line2Dup.cpp:218-404), the greedy magnitude
  scan, the scattered selection, the crop.
* **Match** (line2Dup.cpp:1078-1297): the colour frontend written here
  over the frame's three channels (7x7 blur, Sobel, the first channel of
  largest squared magnitude, fastAtan2, the 3x3 vote), pyrDown of every
  channel, and ``line2d.py``'s spread, response maps, linear memories,
  coarse scan and window refine: exact integers, the float32 score.
* **NMS** (nms.hpp:21-96): score-descending order, stable over the list
  sorted by (-score, template, x, y), at most one of each (template, x,
  y, score); a box is kept unless its IoU with a kept one, computed in
  float32, passes the threshold.
* **Gate** (test_jabil.cpp:185-211): the frame in gray (cv::cvtColor
  BGR2GRAY, 15-bit fixed point), the gray fiducial resized INTER_LINEAR
  by the template's scale (when it is not 1 within FLT_EPSILON) then
  rotated by its angle (rotateScaleImage, utils.cpp:157-187), the
  template rect cut from it, the matched rect cut from the frame, both
  min-max normalized to u8 (cv::normalize NORM_MINMAX: float64, rounded
  half to even), and TM_CCORR_NORMED: exact integer sums, the quotient
  in float64 rounded to float32. A rect that leaves the frame or the
  fiducial gives (False, 0.0).

Departures from test_jabil.cpp, each where the port departs too:

* the match list keeps every (template, x, y, score) once, where the
  C++'s std::unique after an unstable sort drops a varying subset of
  same-position matches of different templates;
* the fiducial is given as a BGR image and converted with BGR2GRAY,
  where the C++ reads the stored file with IMREAD_GRAYSCALE (the same
  values for the benchmark's fiducial, whose three channels are equal);
* cv::resize's 2x2 INTER_AREA shortcut (a scale of exactly 0.5) is not
  written: ``resize_linear`` raises there;
* the frames are uint8 arrays, never cropped: their sides are
  multiples of 16 (the C++ crops to 16n x 16m, test_jabil.cpp:349-354).

``lower=True`` (the control) computes the match scores in bfloat16 and
the CCORR in float32. It sets ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` to False, though no product here
runs through them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import line2d, training
from . import oracle_np as oracle

FLT_EPSILON = float(np.finfo(np.float32).eps)
COEF_BITS = 11                     # INTER_RESIZE_COEF_BITS
# cv::cvtColor BGR2GRAY: R2Y and G2Y rounded from 0.299 and 0.587 at 15
# bits, B2Y the rest of 2^15
R2Y = 9798
G2Y = 19235
B2Y = (1 << 15) - R2Y - G2Y


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Image transforms (cv::rotate, cv::resize INTER_LINEAR, cvtColor)
# ---------------------------------------------------------------------------

def rotate90(img: np.ndarray, quarters: int) -> np.ndarray:
    """cv::rotate by `quarters` quarter turns clockwise (0 to 3)."""
    # np.rot90 turns counter-clockwise in (row, column) order
    return np.ascontiguousarray(np.rot90(img, k=-quarters, axes=(0, 1)))


def _taps(n_dst: int, n_src: int, inv_scale: float, clamp: bool):
    """Per destination index: the two source indices and their 11-bit
    weights. `clamp` (the horizontal pass) zeroes the fraction where the
    left tap falls off either edge; otherwise (the vertical pass) the
    fraction stays and the source indices are clipped."""
    f32 = np.float32
    pos = ((np.arange(n_dst) + 0.5) * inv_scale - 0.5).astype(f32)
    s = np.floor(pos).astype(np.int64)
    frac = (pos - s.astype(f32)).astype(f32)
    if clamp:
        frac = np.where((s < 0) | (s >= n_src - 1), f32(0), frac)
        s = np.clip(s, 0, n_src - 1)
    one = f32(1 << COEF_BITS)
    w0 = np.rint(((f32(1) - frac) * one).astype(f32)).astype(np.int64)
    w1 = np.rint((frac * one).astype(f32)).astype(np.int64)
    return (np.clip(s, 0, n_src - 1), np.clip(s + 1, 0, n_src - 1), w0, w1)


def resize_linear(img: np.ndarray, scale: float) -> np.ndarray:
    """cv::resize(img, dst, Size(), scale, scale, INTER_LINEAR) of uint8
    [h, w] or [h, w, c]: the size rounded half to even, source positions
    at 1 / scale, an integer horizontal pass, then the vertical pass
    ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2 >> 2."""
    h, w = img.shape[:2]
    dh, dw = int(np.rint(h * scale)), int(np.rint(w * scale))
    if (dh, dw) == (h, w):
        return img.copy()
    if abs(1.0 / scale - 2.0) < np.finfo(np.float64).eps:
        raise ValueError("the 2x2 INTER_AREA shortcut is not written here")
    x0, x1, a0, a1 = _taps(dw, w, 1.0 / scale, clamp=True)
    y0, y1, b0, b1 = _taps(dh, h, 1.0 / scale, clamp=False)
    src = img.astype(np.int64)
    a0, a1 = (a.reshape((-1,) + (1,) * (img.ndim - 2)) for a in (a0, a1))
    b0, b1 = (b.reshape((-1,) + (1,) * (img.ndim - 1)) for b in (b0, b1))
    rows = src[:, x0] * a0 + src[:, x1] * a1
    out = (((b0 * (rows[y0] >> 4)) >> 16)
           + ((b1 * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def render(src: np.ndarray, angle: float, scale: float) -> np.ndarray:
    """shapeInfo_producer::transform (line2Dup.h:379-405): a turn where
    the angle is 90, 180 or 270 within FLT_EPSILON, then the resize at
    the float32 scale."""
    quarters = next((q for q in (1, 2, 3)
                     if abs(angle - 90.0 * q) < FLT_EPSILON), 0)
    return resize_linear(rotate90(src, quarters), float(np.float32(scale)))


def rotate_scale(img: np.ndarray, scale: float, angle: float) -> np.ndarray:
    """rotateScaleImage (utils.cpp:157-187): the resize where the scale is
    not 1 within FLT_EPSILON, then the turn that int(angle) names (90 or
    -270, 180 or -180, 270 or -90)."""
    if abs(scale - 1.0) > FLT_EPSILON:
        img = resize_linear(img, scale)
    quarters = {90: 1, -270: 1, 180: 2, -180: 2, 270: 3, -90: 3}
    return rotate90(img, quarters.get(int(angle), 0))


def bgr2gray(img: np.ndarray) -> np.ndarray:
    """cv::cvtColor BGR2GRAY of uint8 [..., 3]."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((b * B2Y + g * G2Y + r * R2Y + (1 << 14)) >> 15).astype(np.uint8)


# ---------------------------------------------------------------------------
# Creation (test_jabil.cpp:79-104)
# ---------------------------------------------------------------------------

def sweep(lo: float, hi: float, step: float, eps: float = 1e-5) -> list:
    """``for (float v = lo; v <= hi + eps; v += step)`` in float32."""
    f32 = np.float32
    out, v = [], f32(lo)
    while v <= f32(hi) + f32(eps):
        out.append(float(v))
        v = f32(v + f32(step))
    return out


def poses(config: dict) -> list:
    """The bank's (angle, scale) in template order, scale-major, from the
    configuration's ranges and steps (line2Dup.h:407-449)."""
    return [(angle, scale)
            for scale in sweep(*config["scale_range"], config["scale_step"])
            for angle in sweep(*config["angle_range"], config["angle_step"])]


def _template(img: np.ndarray, mask: np.ndarray, num_features: int,
              levels: int, weak: float, strong: float) -> list:
    """addTemplate of one colour render under its mask: the cropped
    pyramid as ``training.py``'s per-level dicts."""
    tp = []
    src, msk = img, mask
    for l in range(levels):
        if l > 0:
            src = oracle.pyr_down_u8(src)
            msk = oracle.resize_nearest(msk, src.shape[:2])
        mag, quant, ang = oracle.quantized_orientations(src, weak)
        feats = oracle.extract_template(mag, quant, ang, msk,
                                        num_features >> l, strong)
        if feats is None:
            raise RuntimeError(f"reference training failed at level {l}")
        tp.append({"pyramid_level": l,
                   "features": [dict(x=f["x"], y=f["y"], label=f["label"],
                                     theta=f["theta"]) for f in feats]})
    return oracle.crop_templates(tp)


def train_bank(fiducial: np.ndarray, config: dict) -> list:
    """The sweep's bank: one template pyramid a pose, in ``poses``'
    order."""
    full = np.full(fiducial.shape[:2], 255, np.uint8)
    bank = []
    for angle, scale in poses(config):
        mask = np.where(render(full, angle, scale) > 0, 255, 0).astype(
            np.uint8)
        bank.append(_template(
            render(fiducial, angle, scale), mask,
            int(config["num_features"]), len(config["T"]),
            float(config["weak_threshold"]),
            float(config["strong_threshold"])))
    return bank


# ---------------------------------------------------------------------------
# Match of a BGR frame (line2Dup.cpp:218-404, 1078-1297)
# ---------------------------------------------------------------------------

def quantize_color(img: torch.Tensor, weak_threshold: float) -> torch.Tensor:
    """uint8 [h, w, 3] -> the 8-orientation quantized image, one bit a
    pixel (int64 [h, w]): per channel the blur and Sobel, per pixel the
    first channel of largest dx^2 + dy^2, its fastAtan2, the 3x3 vote."""
    dxs, dys = zip(*(line2d.sobel3(line2d.gaussian_blur7_u8(img[..., c]))
                     for c in range(3)))
    dx, dy = torch.stack(dxs), torch.stack(dys)       # [3, h, w] int64
    mag = dx * dx + dy * dy
    best = mag.argmax(dim=0, keepdim=True)            # the first maximum
    dx = dx.gather(0, best)[0]
    dy = dy.gather(0, best)[0]
    magnitude = mag.gather(0, best)[0].to(torch.float32)
    ang = line2d.fast_atan2_deg(dy, dx)
    h, w = magnitude.shape
    q = torch.round(ang.to(torch.float64) * (16.0 / 360.0)).to(torch.int64)
    q[0, :] = 0
    q[-1, :] = 0
    q[:, 0] = 0
    q[:, -1] = 0
    votes = torch.nn.functional.pad(torch.nn.functional.one_hot(q & 7, 8),
                                    (0, 0, 1, 1, 1, 1))
    votes = sum(votes[i:i + h, j:j + w] for i in range(3) for j in range(3))
    top = votes.argmax(dim=2)                         # the first maximum
    interior = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    interior[1:-1, 1:-1] = True
    ok = (interior & (magnitude > float(weak_threshold) ** 2)
          & (votes.amax(dim=2) >= 5))
    return torch.where(ok, torch.ones_like(top) << top,
                       torch.zeros_like(top))


def lm_pyramid_color(frame: torch.Tensor, T_at_level, weak_threshold: float):
    """match()'s preamble for one BGR frame: per level the linear memories
    [8, T*T, M] and the (width, height)."""
    lms, sizes = [], []
    img = frame
    for l, T in enumerate(T_at_level):
        if l > 0:
            img = torch.stack([line2d.pyr_down_u8(img[..., c])
                               for c in range(3)], dim=-1)
        q = quantize_color(img, weak_threshold)
        lms.append(line2d.linearize(line2d.response_maps(
            line2d.spread(q, T)), T))
        sizes.append((img.shape[1], img.shape[0]))
    return lms, sizes


def match_list(frame: torch.Tensor, banks: list, T_at_level,
               weak_threshold: float, threshold: float,
               score_dtype=torch.float32) -> list:
    """One BGR frame's matches as (template, x, y, float32 score), each
    once, sorted by (-score, template, x, y)."""
    lms, sizes = lm_pyramid_color(frame, T_at_level, weak_threshold)
    k, x, y = line2d.coarse_candidates(lms[-1], sizes[-1], T_at_level[-1],
                                       banks[-1], threshold, score_dtype)
    for l in range(len(T_at_level) - 2, -1, -1):
        k, x, y, sc = line2d.refine_level(lms[l], sizes[l], T_at_level[l],
                                          banks[l], k, x, y, threshold,
                                          score_dtype)
    sc = sc.to(torch.float32).cpu().numpy()
    rows = set(zip(k.cpu().tolist(), x.cpu().tolist(), y.cpu().tolist(),
                   sc.tolist()))
    return sorted(rows, key=lambda r: (-r[3], r[0], r[1], r[2]))


# ---------------------------------------------------------------------------
# NMS (nms.hpp:21-96) and the gate (test_jabil.cpp:185-211)
# ---------------------------------------------------------------------------

def nms(boxes: list, scores: list, threshold: float) -> list:
    """Greedy NMS: the kept indices, best score first (ties in list
    order); IoU in float32 as the C++'s float rects."""
    f32 = np.float32
    order = sorted(range(len(scores)), key=lambda i: -scores[i])
    keep = []
    for i in order:
        ax, ay, aw, ah = (f32(v) for v in boxes[i])
        ok = True
        for j in keep:
            bx, by, bw, bh = (f32(v) for v in boxes[j])
            area_a, area_b = aw * ah, bw * bh
            if area_a + area_b <= f32(FLT_EPSILON):
                iou = f32(1)
            else:
                iw = max(f32(0), min(ax + aw, bx + bw) - max(ax, bx))
                ih = max(f32(0), min(ay + ah, by + bh) - max(ay, by))
                inter = iw * ih
                iou = inter / (area_a + area_b - inter)
            if iou > f32(threshold):
                ok = False
                break
        if ok:
            keep.append(i)
    return keep


def normalize_minmax(a: np.ndarray) -> np.ndarray:
    """cv::normalize(a, dst, 0, 255, NORM_MINMAX, CV_8U)."""
    a = a.astype(np.float64)
    lo, hi = a.min(), a.max()
    if hi <= lo:
        return np.zeros(a.shape, np.int64)
    return np.clip(np.rint((a - lo) * (255.0 / (hi - lo))), 0,
                   255).astype(np.int64)


def ccorr_normed(a: np.ndarray, b: np.ndarray, lower: bool = False) -> float:
    """TM_CCORR_NORMED of two equal-sized integer images at their one
    position: exact integer sums, the quotient in float64 rounded to
    float32 (in float32 throughout with `lower`)."""
    num, e1, e2 = int((a * b).sum()), int((a * a).sum()), int((b * b).sum())
    if lower:
        f = np.float32
        den = max(np.sqrt(f(e1) * f(e2)), f(1e-12))
        return float(f(f(num) / den))
    den = max(np.sqrt(float(e1) * float(e2)), 1e-12)
    return float(np.float32(num / den))


def gate(gray_frame: np.ndarray, x: int, y: int, templ: dict,
         fid_gray: np.ndarray, angle: float, scale: float, threshold: float,
         lower: bool = False) -> tuple:
    """(passed, float32 CCORR) of the match of level-0 template `templ`
    (its rect: tl_x, tl_y, width, height) at (x, y)."""
    ref = rotate_scale(fid_gray, scale, angle)
    tx, ty, w, h = templ["tl_x"], templ["tl_y"], templ["width"], \
        templ["height"]
    if tx < 0 or ty < 0 or tx + w > ref.shape[1] or ty + h > ref.shape[0]:
        return False, 0.0
    H, W = gray_frame.shape
    if x < 0 or y < 0 or x + w > W or y + h > H:
        return False, 0.0
    score = ccorr_normed(normalize_minmax(gray_frame[y:y + h, x:x + w]),
                         normalize_minmax(ref[ty:ty + h, tx:tx + w]), lower)
    return score >= threshold, score


# ---------------------------------------------------------------------------
# The inspection of a frame
# ---------------------------------------------------------------------------

def _bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


def inspect_frame(frame: np.ndarray, banks: list, bank: list,
                  fid_gray: np.ndarray, config: dict, device,
                  lower: bool = False) -> set:
    """Every NMS-kept match of one BGR frame as (template, x, y, score
    bits, CCORR bits, passed)."""
    T = tuple(int(t) for t in config["T"])
    found = match_list(
        torch.from_numpy(np.ascontiguousarray(frame)).to(device), banks, T,
        float(config["weak_threshold"]), float(config["match_threshold"]),
        torch.bfloat16 if lower else torch.float32)
    boxes = [(x, y, bank[k][0]["width"], bank[k][0]["height"])
             for k, x, y, _ in found]
    gray = bgr2gray(frame)
    pose = poses(config)
    out = set()
    for i in nms(boxes, [s for *_, s in found], float(config["nms"])):
        k, x, y, s = found[i]
        ok, cc = gate(gray, x, y, bank[k][0], fid_gray, *pose[k],
                      float(config["ccorr"]), lower)
        out.add((k, x, y, _bits(s), _bits(cc), int(ok)))
    return out


def reference(fiducial: np.ndarray, config: dict, frames: dict, device,
              lower: bool = False) -> tuple:
    """(the bank's fingerprint, {key: NMS-kept rows}) of the BGR frames
    `frames` ({key: uint8 [H, W, 3]})."""
    _no_tf32()
    bank = train_bank(fiducial, config)
    banks = [line2d.pack_bank(training.level_views(bank, l), device)
             for l in range(len(config["T"]))]
    fid_gray = bgr2gray(fiducial)
    return training.fingerprint(bank), {
        key: inspect_frame(f, banks, bank, fid_gray, config, device, lower)
        for key, f in frames.items()}
