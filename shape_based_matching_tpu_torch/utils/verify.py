"""Match verification: normalized cross-correlation gate + SSIM.

Mirrors the reference's false-positive filter (test_jabil.cpp:187-211:
cv::matchTemplate TM_CCORR_NORMED >= 0.8 on the matched crop vs the stored
fiducial) and evalSSIM (utils.cpp:455-523: 11x11 sigma=1.5 Gaussian SSIM map,
edge strip cropped like skimage). These are quality gates, not score-parity
surfaces: ``ssim``, ``match_template_ccorr_normed`` and ``_blur_sep`` are
torch ops on their inputs' device (numpy inputs go to a tensor input's
device, or to `device` when both are numpy), and
their floats differ from the JAX package's XLA float32 and from OpenCV in
the last bits, so a gate decision can differ only that close to its
threshold. The rest is numpy, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_SSIM_C1 = 6.5025
_SSIM_C2 = 58.5225


def _tensor(a, device) -> torch.Tensor:
    """A tensor as it is; a numpy array (or anything else) on `device`."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur_sep(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable blur with BORDER_REFLECT_101 on float32 [H, W] (or
    [H, W, C]), the taps summed left to right as the JAX package does."""
    pad = len(k) // 2
    for axis in (0, 1):
        n = x.shape[axis]
        lo = x.narrow(axis, 1, pad).flip(axis)
        hi = x.narrow(axis, n - pad - 1, pad).flip(axis)
        a = torch.cat([lo, x, hi], dim=axis)
        acc = None
        for i, t in enumerate(k):
            term = a.narrow(axis, i, n) * float(t)
            acc = term if acc is None else acc + term
        x = acc
    return x


def ssim(img1, img2, device="cuda"):
    """(mean SSIM, ssim map cropped by the 5px edge strip) -- evalSSIM;
    float32 tensors on the inputs' device."""
    k = _gaussian_kernel(11, 1.5)
    if isinstance(img2, torch.Tensor):
        device = img2.device
    x = _tensor(img1, device).to(torch.float32)
    y = _tensor(img2, x.device).to(x.device, torch.float32)
    mu1 = _blur_sep(x, k)
    mu2 = _blur_sep(y, k)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur_sep(x * x, k) - mu1_sq
    sigma2_sq = _blur_sep(y * y, k) - mu2_sq
    sigma12 = _blur_sep(x * y, k) - mu1_mu2
    t3 = (2 * mu1_mu2 + _SSIM_C1) * (2 * sigma12 + _SSIM_C2)
    t1 = (mu1_sq + mu2_sq + _SSIM_C1) * (sigma1_sq + sigma2_sq + _SSIM_C2)
    ssim_map = t3 / t1
    cropped = ssim_map[5:, 5:]
    return cropped.mean(), cropped


def match_template_ccorr_normed(image, templ, device="cuda") -> torch.Tensor:
    """cv::matchTemplate(image, templ, TM_CCORR_NORMED) for single-channel
    uint8/float inputs: float32 [H-th+1, W-tw+1] on the inputs' device.

    The correlations run in float64 (exact for 8-bit inputs up to 2^53 /
    255^2 pixels, and free of the card's TF32 convolutions) and the
    result is rounded to float32."""
    if isinstance(templ, torch.Tensor):
        device = templ.device
    img = _tensor(image, device).to(torch.float64)
    t = _tensor(templ, img.device).to(img.device, torch.float64)
    num = F.conv2d(img[None, None], t[None, None])[0, 0]
    sq = F.conv2d((img * img)[None, None],
                  torch.ones_like(t)[None, None])[0, 0]
    denom = torch.sqrt(sq * (t * t).sum())
    return (num / denom.clamp_min(1e-12)).to(torch.float32)


def verify_match_ccorr(scene: np.ndarray, match_xy, templ_img: np.ndarray,
                       threshold: float = 0.8,
                       device="cuda") -> tuple[bool, float]:
    """The jabil false-positive gate: crop the matched region and require
    TM_CCORR_NORMED >= threshold against the stored template image."""
    x, y = match_xy
    th, tw = templ_img.shape[:2]
    h, w = scene.shape[:2]
    if x < 0 or y < 0 or x + tw > w or y + th > h:
        return False, 0.0
    crop = scene[y : y + th, x : x + tw]
    if crop.ndim == 3:
        crop = crop.mean(axis=2)
    t = templ_img
    if t.ndim == 3:
        t = t.mean(axis=2)
    score = float(match_template_ccorr_normed(crop, t, device)[0, 0])
    return score >= threshold, score


def normalize_minmax_u8(img: np.ndarray) -> np.ndarray:
    """cv::normalize(img, dst, 0, 255, NORM_MINMAX, CV_8U)."""
    a = np.asarray(img, np.float64)
    mn = a.min()
    mx = a.max()
    if mx <= mn:
        return np.zeros(a.shape, np.uint8)
    scale = 255.0 / (mx - mn)
    return np.clip(np.rint((a - mn) * scale), 0, 255).astype(np.uint8)


def fiducial_reference(templ, fid_img: np.ndarray) -> np.ndarray | None:
    """The gate's reference crop of one template (test_jabil.cpp:185-199):
    the stored fiducial source (gray; a BGR one is converted, as the
    reference loads it IMREAD_GRAYSCALE) rotated and scaled by the
    template's metadata, cropped to the template rect (tl_x, tl_y, width,
    height) and min-max normalized to u8; None where the rect leaves the
    transformed fiducial."""
    ref = np.asarray(fid_img)
    if ref.ndim == 3:
        ref = bgr2gray_u8(ref)
    sscale = getattr(templ, "sscale", 1.0) or 1.0
    orientation = getattr(templ, "orientation", 0.0)
    if sscale > 0 or orientation >= 0:
        ref = rotate_scale_image(ref, sscale if sscale > 0 else 1.0,
                                 orientation if orientation >= 0 else 0.0)
    rh, rw = ref.shape[:2]
    if (templ.tl_x < 0 or templ.tl_y < 0
            or templ.tl_x + templ.width > rw
            or templ.tl_y + templ.height > rh):
        return None
    return normalize_minmax_u8(ref[templ.tl_y:templ.tl_y + templ.height,
                                   templ.tl_x:templ.tl_x + templ.width])


def verify_match_fiducial(scene_gray: np.ndarray, match_xy, templ,
                          fid_img: np.ndarray, threshold: float = 0.8,
                          device="cuda") -> tuple[bool, float]:
    """The reference's fiducial verification gate (test_jabil.cpp:185-211):
    the template's reference crop (``fiducial_reference``) against the
    matched scene crop, min-max normalized to u8, and require
    TM_CCORR_NORMED >= threshold. The plain twin of the batched gate of
    ``models/inspect.py``."""
    im2 = fiducial_reference(templ, fid_img)
    if im2 is None:
        return False, 0.0
    x, y = match_xy
    h, w = scene_gray.shape[:2]
    if x < 0 or y < 0 or x + templ.width > w or y + templ.height > h:
        return False, 0.0
    crop = np.asarray(scene_gray)[y:y + templ.height, x:x + templ.width]
    if crop.ndim == 3:
        crop = bgr2gray_u8(crop)

    im1 = normalize_minmax_u8(crop)
    score = float(match_template_ccorr_normed(im1, im2, device)[0, 0])
    return score >= threshold, score


def bgr2gray_u8(img):
    """cv::cvtColor BGR2GRAY on uint8 ``[..., 3]`` (a tensor, on its own
    device, or a numpy array), bit-exact to OpenCV: (B*3735 + G*19235 +
    R*9798 + 16384) >> 15. The sum stays below 2^23, so int32 holds it."""
    if isinstance(img, torch.Tensor):
        x = img.to(torch.int32)
        b, g, r = x[..., 0], x[..., 1], x[..., 2]
        return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).to(
            torch.uint8)
    x = np.asarray(img).astype(np.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(
        np.uint8)


def calc_histogram(img: np.ndarray, hist_size: int = 256) -> np.ndarray:
    """Normalized gray-level histogram (utils.cpp:403-421)."""
    h = np.bincount(np.asarray(img, np.uint8).ravel(), minlength=hist_size)
    return h.astype(np.float64) / img.size


def comp_histogram(h1, h2) -> float:
    """Pearson correlation of two histograms (utils.cpp:423-452)."""
    a = np.asarray(h1, np.float64)
    b = np.asarray(h2, np.float64)
    a = a - a.mean()
    b = b - b.mean()
    denom = math.sqrt(float((a * a).sum() * (b * b).sum()))
    return float((a * b).sum() / denom) if denom else 0.0


def rotate_scale_image(img: np.ndarray, scale: float,
                       angle: float) -> np.ndarray:
    """utils.cpp:157-187: optional INTER_LINEAR resize then exact-90 rotate."""
    from .cv_resize import resize_linear_u8

    out = img
    if abs(scale - 1.0) > np.finfo(np.float32).eps:
        out = resize_linear_u8(out, float(scale), float(scale))
    rot = int(angle)
    if rot in (90, -270):
        out = np.ascontiguousarray(np.flip(np.swapaxes(out, 0, 1), axis=1))
    elif rot in (270, -90):
        out = np.ascontiguousarray(np.flip(np.swapaxes(out, 0, 1), axis=0))
    elif rot in (180, -180):
        out = np.ascontiguousarray(np.flip(np.flip(out, 0), 1))
    return out


def rotate_scale_rect(rect, scale: float, angle: float, img_size_wh):
    """utils.cpp:189-235: transform a rect under rotate+scale about the image
    center; returns (x, y, w, h)."""
    x, y, w, h = rect
    iw, ih = img_size_wh
    a = math.radians(angle)
    cos_a = math.cos(a) * scale
    sin_a = math.sin(a) * scale
    cx, cy = iw / 2.0, ih / 2.0

    def rot(px, py):
        # cv::getRotationMatrix2D(0, -angle, s) = [[s·cosA, -s·sinA],
        # [s·sinA, s·cosA]] (OpenCV angle is CCW-positive in image coords)
        return (cos_a * px - sin_a * py, sin_a * px + cos_a * py)

    tlx, tly = rot(x - cx, y - cy)
    brx, bry = rot(x + w - cx, y + h - cy)

    r1 = math.fmod(angle, 360.0)
    if (abs(r1 - 90.0) <= np.finfo(np.float32).eps
            or abs(r1 - 270.0) <= np.finfo(np.float32).eps):
        sx, sy = ih / 2.0 * scale, iw / 2.0 * scale
    else:
        sx, sy = cx * scale, cy * scale
    # cv::Rect(Point2f, Point2f) converts each corner through
    # saturate_cast/cvRound (round-half-to-even) BEFORE normalizing order.
    nx0 = int(np.rint(tlx + sx))
    ny0 = int(np.rint(tly + sy))
    nx1 = int(np.rint(brx + sx))
    ny1 = int(np.rint(bry + sy))
    x0, x1 = sorted((nx0, nx1))
    y0, y1 = sorted((ny0, ny1))
    return (x0, y0, x1 - x0, y1 - y0)


def extract_fiducial_img(matched_fiducials: dict, templ) -> np.ndarray:
    """utils.cpp:236+: re-apply a template's stored orientation/scale to its
    source fiducial image."""
    src = np.asarray(matched_fiducials[templ.fiducial_src])
    return rotate_scale_image(src, getattr(templ, "sscale", 1.0) or 1.0,
                              templ.orientation)
