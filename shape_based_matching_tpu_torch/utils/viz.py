"""Visualization helpers (mirror of utils.cpp:113-401 display functions).

Pure NumPy drawing (no GUI): colorize quantized orientation maps, draw match
boxes and feature points, save as PNG through ``utils/imageio.py`` (no
image library needed). Replaces the reference's imshow galleries with
file/array outputs usable headless. ``Annotator`` (circles, lines and
text for the ``demo`` command) draws with Pillow and needs it installed.
"""

from __future__ import annotations

import numpy as np

# displayQuantized color table (utils.cpp/test.cpp displayQuantized)
_QUANT_COLORS = {
    0: (0, 0, 0),
    1: (55, 55, 55),
    2: (80, 80, 80),
    4: (105, 105, 105),
    8: (130, 130, 130),
    16: (155, 155, 155),
    32: (180, 180, 180),
    64: (205, 205, 205),
    128: (230, 230, 230),
    255: (0, 0, 255),
}
_QUANT_DEFAULT = (0, 255, 0)


def display_quantized(quantized: np.ndarray) -> np.ndarray:
    """Colorize a quantized orientation bitmask image -> BGR uint8."""
    q = np.asarray(quantized, np.uint8)
    out = np.empty(q.shape + (3,), np.uint8)
    out[:] = _QUANT_DEFAULT
    for val, bgr in _QUANT_COLORS.items():
        out[q == val] = bgr
    return out


def _clip_int(v, lo, hi):
    return int(max(lo, min(hi, v)))


def draw_rect(img: np.ndarray, rect, color=(0, 255, 0), thickness=2):
    """In-place rectangle on [H, W, 3] uint8; rect = (x, y, w, h)."""
    x, y, w, h = (int(v) for v in rect)
    hh, ww = img.shape[:2]
    for t in range(thickness):
        x0, y0 = _clip_int(x + t, 0, ww - 1), _clip_int(y + t, 0, hh - 1)
        x1, y1 = _clip_int(x + w - t, 0, ww - 1), _clip_int(y + h - t, 0, hh - 1)
        img[y0, x0 : x1 + 1] = color
        img[y1, x0 : x1 + 1] = color
        img[y0 : y1 + 1, x0] = color
        img[y0 : y1 + 1, x1] = color
    return img


def draw_dot(img: np.ndarray, xy, color=(0, 0, 255), radius=2):
    x, y = int(xy[0]), int(xy[1])
    hh, ww = img.shape[:2]
    y0, y1 = _clip_int(y - radius, 0, hh - 1), _clip_int(y + radius, 0, hh - 1)
    x0, x1 = _clip_int(x - radius, 0, ww - 1), _clip_int(x + radius, 0, ww - 1)
    img[y0 : y1 + 1, x0 : x1 + 1] = color
    return img


def draw_matches(image: np.ndarray, matches, detector,
                 max_matches: int = 50) -> np.ndarray:
    """showAllMatchings equivalent: boxes + feature dots per match."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img.copy()
    rng = np.random.RandomState(7)
    for m in matches[:max_matches]:
        t0 = detector.get_templates(m.class_id, m.template_id)[0]
        color = tuple(int(c) for c in rng.randint(100, 255, 3))
        draw_rect(img, (m.x, m.y, t0.width, t0.height), color)
        for f in t0.features:
            draw_dot(img, (m.x + f.x, m.y + f.y), color)
    return img


def save_image(img: np.ndarray, path: str) -> None:
    """Write a gray [H, W] or BGR [H, W, 3] uint8 image (``imageio``)."""
    from .imageio import save_image as _save

    _save(img, path)


class Annotator:
    """PIL-backed drawing surface over a BGR uint8 image.

    Covers the primitives the reference demo drivers use on their result
    images (test.cpp:246-556: cv::circle, cv::line, cv::rectangle,
    cv::putText) for headless file output. Colors are BGR tuples like the
    reference's cv::Scalar."""

    def __init__(self, img_bgr: np.ndarray):
        try:
            from PIL import Image, ImageDraw
        except ImportError:
            raise ImportError("viz.Annotator (the demo command's drawing) "
                              "needs Pillow (PIL), which is not "
                              "installed") from None

        arr = np.asarray(img_bgr, np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        self._im = Image.fromarray(arr[:, :, ::-1].copy())  # BGR -> RGB
        self._draw = ImageDraw.Draw(self._im)

    @staticmethod
    def _rgb(color):
        b, g, r = (int(c) for c in color)
        return (r, g, b)

    def circle(self, center, radius, color, thickness=2, fill=False):
        x, y = float(center[0]), float(center[1])
        r = float(radius)
        box = (x - r, y - r, x + r, y + r)
        if fill:
            self._draw.ellipse(box, fill=self._rgb(color))
        else:
            self._draw.ellipse(box, outline=self._rgb(color),
                               width=int(thickness))
        return self

    def line(self, p0, p1, color, thickness=2):
        self._draw.line([tuple(map(float, p0)), tuple(map(float, p1))],
                        fill=self._rgb(color), width=int(thickness))
        return self

    def rect(self, xywh, color, thickness=2):
        x, y, w, h = (float(v) for v in xywh)
        self._draw.rectangle((x, y, x + w, y + h),
                             outline=self._rgb(color), width=int(thickness))
        return self

    def text(self, xy, s, color):
        self._draw.text((float(xy[0]), float(xy[1]) - 10), str(s),
                        fill=self._rgb(color))
        return self

    def array(self) -> np.ndarray:
        """Rendered image back as a BGR uint8 array."""
        return np.asarray(self._im)[:, :, ::-1].copy()

    def save(self, path: str) -> None:
        self._im.save(path)
