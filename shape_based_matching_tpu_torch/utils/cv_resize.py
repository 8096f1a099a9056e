"""cv::resize(INTER_LINEAR) on uint8, bit-exact NumPy replica of OpenCV 4.x.

OpenCV's 8-bit bilinear resize is fixed-point: coefficients are
round(c * 2048) shorts, the horizontal pass accumulates int32 rows, and the
specialized 8u vertical pass computes

    dst = uchar(( ((b0*(h0>>4))>>16) + ((b1*(h1>>4))>>16) + 2 ) >> 2 )

Subtleties verified against the OpenCV 4.6 C++ library:
* when fx/fy are given (dsize empty), source coordinates use scale = 1/fx
  exactly — OpenCV does NOT recompute the scale from the rounded dsize;
* when the true scales are exactly (2, 2), INTER_LINEAR silently switches to
  the INTER_AREA 2×2 fast path: dst = (s00+s01+s10+s11+2)>>2, with
  round-half-even means on clipped boundary blocks;
* border handling is per-axis: horizontal coefficients are clamped to
  (2048, 0) at the image edges, vertical coefficients keep their fraction
  and only the source row indices are clipped (see _lin_coeffs);
* exactness: bit-identical to libopencv 4.6 for down- AND upscales —
  verified on 563 randomized cases (sizes 1..256 px, scales 0.05..8,
  gray+color, fx/fy and explicit-dsize paths;
  tools/golden_gen/probe_build.cpp, probe_resize2.cpp).

The producer's scale sweep (ShapeInfoProducer.transform) feeds template
training, so this must match the C++ exactly for training parity on the
bundled cases.
"""

from __future__ import annotations

import numpy as np

_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE (bits = 11)


def _round_half_even(x: np.ndarray) -> np.ndarray:
    return np.rint(x).astype(np.int64)


def _lin_coeffs(dlen: int, slen: int, scale: float, horizontal: bool = True):
    """Per-output-pixel (s0, s1, a0, a1) with OpenCV border handling.

    OpenCV narrows the FULL source coordinate to float32 BEFORE the
    floor/frac split (`float fxx = (float)((dx+0.5)*scale_x - 0.5)`); the
    narrowing can push frac*2048 onto an exact .5 where cvRound's
    half-to-even produces coefficient pairs like (1316, 732) — observed on
    the bundled circle image at scale 0.7.

    Border semantics differ per axis (verified against libopencv 4.6 on a
    randomized battery, tools/golden_gen/probe_build.cpp):
    * horizontal: the table-building loop in cv::resize() zeroes the
      fraction at both borders (`fxx = 0, sx = 0` when sx < 0; `fxx = 0,
      sx = width-1` past the right edge) — coefficient clamping;
    * vertical: the beta loop applies NO clamping — the fractional
      coefficient is kept (e.g. (93, 1955) for the first output row at
      scale 1.1) and resizeGeneric_ clips the source ROW INDICES instead.
    """
    fx = ((np.arange(dlen, dtype=np.float64) + 0.5) * scale
          - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    if horizontal:
        fx = np.where(sx < 0, np.float32(0), fx)
        sx = np.maximum(sx, 0)
        hit_edge = sx >= slen - 1
        fx = np.where(hit_edge, np.float32(0), fx)
        sx = np.where(hit_edge, slen - 1, sx)
        s0 = sx
        s1 = np.minimum(sx + 1, slen - 1)
    else:
        s0 = np.clip(sx, 0, slen - 1)
        s1 = np.clip(sx + 1, 0, slen - 1)
    # OpenCV: saturate_cast<short>(cbuf[k] * INTER_RESIZE_COEF_SCALE) — the
    # product is evaluated in float32, then cvRound (half-to-even).
    a1 = _round_half_even(
        (fx * np.float32(_COEF_SCALE)).astype(np.float32))
    a0 = _round_half_even(
        ((np.float32(1.0) - fx) * np.float32(_COEF_SCALE)).astype(np.float32))
    return s0, s1, a0, a1


def _area_fast_2x2(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """INTER_AREA 2×2 fast path: interior (sum+2)>>2; boundary cells whose
    block is clipped by the image use round_half_even(mean of available)
    (verified against OpenCV 4.6)."""
    sh, sw = src.shape[:2]
    s = src.astype(np.int64)
    fh = min(dh, sh // 2)  # rows with a full 2-row block
    fw = min(dw, sw // 2)
    out = np.zeros((dh, dw) + src.shape[2:], np.uint8)
    s00 = s[0 : 2 * fh : 2, 0 : 2 * fw : 2]
    s01 = s[0 : 2 * fh : 2, 1 : 2 * fw : 2]
    s10 = s[1 : 2 * fh : 2, 0 : 2 * fw : 2]
    s11 = s[1 : 2 * fh : 2, 1 : 2 * fw : 2]
    out[:fh, :fw] = ((s00 + s01 + s10 + s11 + 2) >> 2).astype(np.uint8)
    for dy in range(dh):
        for dx in range(dw):
            if dy < fh and dx < fw:
                continue
            block = s[2 * dy : min(2 * dy + 2, sh),
                      2 * dx : min(2 * dx + 2, sw)]
            if block.size == 0:
                continue
            out[dy, dx] = np.rint(
                block.reshape(-1, *block.shape[2:]).mean(axis=0)
            ).astype(np.uint8)
    return out


def resize_linear_u8(src: np.ndarray, fx: float = 0.0, fy: float = 0.0,
                     dsize=None) -> np.ndarray:
    """cv::resize(src, dst, dsize or Size(), fx, fy, INTER_LINEAR) on uint8."""
    sh, sw = src.shape[:2]
    if dsize is None:
        dw = int(np.rint(sw * fx))
        dh = int(np.rint(sh * fy))
        scale_x = 1.0 / fx
        scale_y = 1.0 / fy
    else:
        dw, dh = dsize
        scale_x = sw / dw
        scale_y = sh / dh
    if dw == sw and dh == sh:
        return src.copy()

    # INTER_LINEAR -> INTER_AREA fast-path switch for exact 2x2 decimation.
    if (abs(scale_x - round(scale_x)) < np.finfo(np.float64).eps
            and abs(scale_y - round(scale_y)) < np.finfo(np.float64).eps
            and round(scale_x) == 2 and round(scale_y) == 2):
        return _area_fast_2x2(src, dh, dw)

    x0, x1, ax0, ax1 = _lin_coeffs(dw, sw, scale_x, horizontal=True)
    y0, y1, ay0, ay1 = _lin_coeffs(dh, sh, scale_y, horizontal=False)

    s = src.astype(np.int64)
    if s.ndim == 3:
        h = s[:, x0] * ax0[None, :, None] + s[:, x1] * ax1[None, :, None]
        r0 = h[y0] >> 4
        r1 = h[y1] >> 4
        out = (((ay0[:, None, None] * r0) >> 16)
               + ((ay1[:, None, None] * r1) >> 16) + 2) >> 2
    else:
        h = s[:, x0] * ax0[None, :] + s[:, x1] * ax1[None, :]
        r0 = h[y0] >> 4
        r1 = h[y1] >> 4
        out = (((ay0[:, None] * r0) >> 16)
               + ((ay1[:, None] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
