"""Contrast-enhancement preprocessing: equalizeHist / CLAHE replicas.

The reference's preprocessing experiment (test_old.cpp:277-334) runs
cv::equalizeHist or cv::createCLAHE(40, 8x8)->apply on the gray test
image before inspection. These are bit-exact NumPy replicas of the
OpenCV 4.6 algorithms (verified against the compiled library on a
randomized battery, tools/golden_gen/probe_hist.cpp):

* equalizeHist (histogram.cpp): lut[i] = round_half_even(cumsum * 255 /
  (total - hist[first_nonzero])), lut[first_nonzero] = 0;
* CLAHE (clahe.cpp): per-tile clipped histograms (integer clip limit
  max(1, clip*tileArea/256), batch + stride residual redistribution),
  per-tile LUTs, and float bilinear interpolation between the four
  surrounding tile LUTs with border-replicated tile indices. Images not
  divisible by the tile grid are padded right/bottom with BORDER_REFLECT_101
  for LUT building only.

Host-side utilities (like cv_resize): they feed template training /
verification, not the device hot path.
"""

from __future__ import annotations

import numpy as np


def _round_half_even_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def equalize_hist(src: np.ndarray) -> np.ndarray:
    """cv::equalizeHist on a uint8 gray image (histogram.cpp:669-720)."""
    src = np.asarray(src)
    assert src.dtype == np.uint8 and src.ndim == 2
    if src.size == 0:
        return src.copy()
    hist = np.bincount(src.reshape(-1), minlength=256)
    i0 = int(np.nonzero(hist)[0][0])
    total = src.size
    if hist[i0] == total:
        return np.full_like(src, i0)
    scale = np.float32(255.0) / np.float32(total - hist[i0])
    cum = np.cumsum(hist)
    # lut[i] = saturate_cast<uchar>((cum[i]-cum[i0]) * scale); cvRound is
    # half-to-even. OpenCV accumulates from i0+1, so subtract cum[i0].
    lut = _round_half_even_u8(
        ((cum - cum[i0]).astype(np.float32) * scale).astype(np.float32))
    lut[i0] = 0
    lut[:i0] = 0  # unused bins (no pixels below i0)
    return lut[src]


def _clahe_tile_luts(padded: np.ndarray, tiles_xy, tile_wh,
                     clip_limit: float) -> np.ndarray:
    tiles_x, tiles_y = tiles_xy
    tw, th = tile_wh
    tile_area = tw * th
    lut_scale = np.float32(255.0) / np.float32(tile_area)

    if clip_limit > 0.0:
        clip = max(int(clip_limit * tile_area / 256), 1)
    else:
        clip = 0

    luts = np.empty((tiles_y, tiles_x, 256), np.uint8)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            tile = padded[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
            hist = np.bincount(tile.reshape(-1), minlength=256)
            if clip > 0:
                over = hist > clip
                clipped = int((hist[over] - clip).sum())
                hist = np.minimum(hist, clip)
                hist += clipped // 256
                residual = clipped - (clipped // 256) * 256
                if residual:
                    step = max(256 // residual, 1)
                    idx = np.arange(0, 256, step)[:residual]
                    hist[idx] += 1
            cum = np.cumsum(hist).astype(np.float32)
            luts[ty, tx] = _round_half_even_u8(
                (cum * lut_scale).astype(np.float32))
    return luts


def clahe(src: np.ndarray, clip_limit: float = 40.0,
          tile_grid=(8, 8)) -> np.ndarray:
    """cv::CLAHE::apply on a uint8 gray image (clahe.cpp).

    `tile_grid` is (tilesX, tilesY) like cv::createCLAHE's Size.
    """
    src = np.asarray(src)
    assert src.dtype == np.uint8 and src.ndim == 2
    h, w = src.shape
    tiles_x, tiles_y = int(tile_grid[0]), int(tile_grid[1])

    if w % tiles_x == 0 and h % tiles_y == 0:
        padded = src
        tw, th = w // tiles_x, h // tiles_y
    else:
        # clahe.cpp pads with `tilesX - (cols % tilesX)` — when only ONE
        # dimension is non-divisible, the other gets a FULL extra tile of
        # padding (quirk preserved for bit-exactness).
        pw = tiles_x - (w % tiles_x)
        ph = tiles_y - (h % tiles_y)
        # BORDER_REFLECT_101 on right/bottom (clahe.cpp copyMakeBorder)
        cols = np.concatenate(
            [np.arange(w), w - 2 - np.arange(pw)]) if pw else np.arange(w)
        rows = np.concatenate(
            [np.arange(h), h - 2 - np.arange(ph)]) if ph else np.arange(h)
        padded = src[np.ix_(rows, cols)]
        tw, th = (w + pw) // tiles_x, (h + ph) // tiles_y

    luts = _clahe_tile_luts(padded, (tiles_x, tiles_y), (tw, th),
                            float(clip_limit))

    # bilinear interpolation between the 4 surrounding tile LUTs, on the
    # ORIGINAL (uncropped) pixel grid
    xf = np.arange(w, dtype=np.float32) * np.float32(1.0 / tw) \
        - np.float32(0.5)
    tx1 = np.floor(xf).astype(np.int64)
    px = (xf - tx1).astype(np.float32)
    tx2 = np.minimum(tx1 + 1, tiles_x - 1)
    tx1 = np.maximum(tx1, 0)

    yf = np.arange(h, dtype=np.float32) * np.float32(1.0 / th) \
        - np.float32(0.5)
    ty1 = np.floor(yf).astype(np.int64)
    py = (yf - ty1).astype(np.float32)
    ty2 = np.minimum(ty1 + 1, tiles_y - 1)
    ty1 = np.maximum(ty1, 0)

    v = src
    lut_y1x1 = luts[ty1[:, None], tx1[None, :], v]
    lut_y1x2 = luts[ty1[:, None], tx2[None, :], v]
    lut_y2x1 = luts[ty2[:, None], tx1[None, :], v]
    lut_y2x2 = luts[ty2[:, None], tx2[None, :], v]

    pxr = px[None, :]
    pyr = py[:, None]
    res = ((lut_y1x1 * (1 - pxr) + lut_y1x2 * pxr) * (1 - pyr)
           + (lut_y2x1 * (1 - pxr) + lut_y2x2 * pxr) * pyr)
    return _round_half_even_u8(res)
