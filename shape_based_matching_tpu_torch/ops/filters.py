"""Bit-exact separable uint8 image filters in PyTorch (int32 math).

The same fixed-point arithmetic OpenCV uses on uint8 images, so the
orientation quantization downstream matches the C++ reference
(line2Dup.cpp:313-404) and the JAX package's ``ops/filters.py``:

* ``gaussian_blur7_u8``: cv::GaussianBlur(ksize=7, sigma=0,
  BORDER_REPLICATE) in Q8, taps [8,28,56,72,56,28,8], one final rounding
  ``(acc + 2^15) >> 16``.
* ``sobel3_i32``: cv::Sobel(ksize=3, BORDER_REPLICATE), smooth [1,2,1]
  times diff [-1,0,1], exact in int32.
* ``pyr_down_u8_plain``: cv::pyrDown, 5-tap [1,4,6,4,1] separable kernel,
  BORDER_REFLECT_101, ``(acc + 128) >> 8``, even pixels kept (the plain
  twin of ``ops/cuda/pyramid.pyr_down``, which the pyramid calls).
* ``resize_nearest``: cv::resize(INTER_NEAREST) of masks down the pyramid.
* ``erode3_u8``: cv::erode with the default 3x3 kernel, BORDER_REPLICATE
  (training's mask erosion).

Every function works on the last two axes of a ``[..., H, W]`` tensor, so
a batch of frames, or the channels of planar color frames ``[B, 3, H,
W]``, filter in one call. Borders are index gathers, which work for every
dtype on every device.
"""

from __future__ import annotations

import numpy as np
import torch

GAUSS7_Q8 = (8, 28, 56, 72, 56, 28, 8)
PYR5 = (1, 4, 6, 4, 1)


def _replicate_index(n: int, r: int, device) -> torch.Tensor:
    return torch.arange(-r, n + r, device=device).clamp_(0, n - 1)


def _sep(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Correlate `x`, already padded by len(taps)//2 along `dim`."""
    size = x.shape[dim] - (len(taps) - 1)
    acc = None
    for i, t in enumerate(taps):
        if t == 0:
            continue
        sl = x.narrow(dim, i, size)
        term = sl if t == 1 else sl * t
        acc = term if acc is None else acc + term
    return acc


def _pad_replicate(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    return x.index_select(dim, _replicate_index(x.shape[dim], r, x.device))


def gaussian_blur7_u8(img: torch.Tensor) -> torch.Tensor:
    """cv::GaussianBlur(img, 7x7, sigma=0, BORDER_REPLICATE) on uint8
    (line2Dup.cpp:320)."""
    x = img.to(torch.int32)
    x = _sep(_pad_replicate(x, 3, -1), GAUSS7_Q8, -1)
    x = _sep(_pad_replicate(x, 3, -2), GAUSS7_Q8, -2)
    return ((x + (1 << 15)) >> 16).to(torch.uint8)


def sobel3_i32(img_u8: torch.Tensor, dx: bool) -> torch.Tensor:
    """cv::Sobel(img, 1/0, 0/1, ksize=3, BORDER_REPLICATE) as int32
    (line2Dup.cpp:324-325)."""
    x = img_u8.to(torch.int32)
    smooth = (1, 2, 1)
    diff = (-1, 0, 1)
    if dx:
        x = _sep(_pad_replicate(x, 1, -2), smooth, -2)
        return _sep(_pad_replicate(x, 1, -1), diff, -1)
    x = _sep(_pad_replicate(x, 1, -1), smooth, -1)
    return _sep(_pad_replicate(x, 1, -2), diff, -2)


def _pyr_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """out[j] = sum_k PYR5[k] * x[reflect101(2j + k - 2)] along `dim`."""
    n = x.shape[dim]
    n2 = n // 2
    acc = None
    for k, t in enumerate(PYR5):
        i = torch.arange(n2, device=x.device) * 2 + (k - 2)
        i = torch.where(i < 0, -i, i)
        i = torch.where(i >= n, 2 * n - 2 - i, i)
        term = x.index_select(dim, i) * t
        acc = term if acc is None else acc + term
    return acc


def pyr_down_u8_plain(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown(img, size/2) on uint8, bit-exact (line2Dup.cpp:433).

    Output is (H//2, W//2) on the last two axes, as the reference passes
    Size(cols/2, rows/2) explicitly."""
    x = _pyr_rows(img.to(torch.int32), -1)
    x = _pyr_rows(x, -2)
    return ((x + 128) >> 8).to(torch.uint8)


def resize_nearest(img: torch.Tensor, out_hw) -> torch.Tensor:
    """cv::resize(..., INTER_NEAREST) on the last two axes (mask
    downsampling in the pyramid, line2Dup.cpp:439): source index
    min(floor(dst * (src_len / dst_len)), src_len - 1), the product taken
    in float32 as the JAX package's ``resize_nearest`` takes it (an int32
    iota times a weakly typed Python float)."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    h, w = img.shape[-2:]

    def index(n_out: int, n_in: int) -> torch.Tensor:
        scale = torch.tensor(np.float32(n_in / n_out), device=img.device)
        i = torch.arange(n_out, dtype=torch.float32, device=img.device)
        return torch.floor(i * scale).to(torch.int64).clamp_(max=n_in - 1)

    return img.index_select(-2, index(oh, h)).index_select(-1, index(ow, w))


def erode3_u8(img: torch.Tensor) -> torch.Tensor:
    """cv::erode(img, Mat(), 1, BORDER_REPLICATE): 3x3 min filter on the
    last two axes (template mask erosion, line2Dup.cpp:458)."""
    x = _pad_replicate(img, 1, -2)
    x = torch.minimum(torch.minimum(x[..., :-2, :], x[..., 1:-1, :]),
                      x[..., 2:, :])
    x = _pad_replicate(x, 1, -1)
    return torch.minimum(torch.minimum(x[..., :-2], x[..., 1:-1]),
                         x[..., 2:])
