"""The plain reference of the bank: upstream's addTemplate, then
addTemplate_rotate for every further angle (line2Dup.cpp:1299-1451).

Feature extraction is the frozen scalar oracle's (``oracle_np.py``: the
quantized gradients, the greedy magnitude NMS scan, the scattered
selection, the crop). The rotation is written here from the C++: each
feature of template 0, shifted back by the template's corner, is rotated
about the centre (halved at each level, in float32) by -theta with the
rotation computed in double and stored as float32 (``rotate2d``), rounded
by ``int(p + 0.5f)``; its gradient angle becomes ``theta_f - theta``
wrapped into [0, 360], its label ``int(angle * 16 / 360 + 0.5f) & 7``;
then the pyramid is cropped. One loop over the angles, each level's
features at once in NumPy, one IEEE operation at a time.
"""

from __future__ import annotations

import math

import numpy as np

from . import oracle_np as oracle


def _extract(img: np.ndarray, mask: np.ndarray, num_features: int,
             weak_threshold: float, strong_threshold: float):
    magnitude, quant, angle = oracle.quantized_orientations(img,
                                                            weak_threshold)
    return oracle.extract_template(magnitude, quant, angle, mask,
                                   num_features, strong_threshold)


def train_base(img: np.ndarray, num_features: int, levels: int,
               weak_threshold: float, strong_threshold: float) -> list:
    """addTemplate of one gray image under a full mask: the cropped
    pyramid as per-level dicts {'features': [dict(x, y, label, theta)],
    'width', 'height', 'tl_x', 'tl_y', 'pyramid_level'}."""
    mask = np.full(img.shape, 255, np.uint8)
    tp = []
    src, msk = img, mask
    for l in range(levels):
        if l > 0:
            src = oracle.pyr_down_u8(src)
            msk = oracle.resize_nearest(msk, src.shape[:2])
        feats = _extract(src, msk, num_features >> l, weak_threshold,
                         strong_threshold)
        if feats is None:
            raise RuntimeError(f"reference training failed at level {l}")
        tp.append({"pyramid_level": l,
                   "features": [dict(x=f["x"], y=f["y"], label=f["label"],
                                     theta=f["theta"]) for f in feats]})
    return oracle.crop_templates(tp)


def _same(a):
    return a


def rotate(tp: list, theta: float, center, narrow=_same) -> list:
    """addTemplate_rotate of the cropped pyramid `tp` by `theta` degrees
    about `center` (x, y at level 0): the new cropped pyramid. `narrow`
    maps each rotated float32 coordinate to what a lower precision would
    store (the control of the bank's comparison); by default it keeps
    float32, as the C++'s Point2f does."""
    f32 = np.float32
    ang = -float(theta) / 180.0 * math.pi
    cos_a, sin_a = math.cos(ang), math.sin(ang)
    th = f32(theta)
    cx, cy = f32(center[0]), f32(center[1])
    out = []
    for l, src in enumerate(tp):
        if l > 0:
            cx, cy = f32(cx / f32(2)), f32(cy / f32(2))
        fs = src["features"]
        px = np.array([f["x"] + src["tl_x"] for f in fs], np.int64).astype(f32)
        py = np.array([f["y"] + src["tl_y"] for f in fs], np.int64).astype(f32)
        dx = (px - cx).astype(np.float64)
        dy = (py - cy).astype(np.float64)
        rx = narrow((cos_a * dx - sin_a * dy).astype(f32))
        ry = narrow((sin_a * dx + cos_a * dy).astype(f32))
        xs = np.trunc((rx + cx) + f32(0.5)).astype(np.int64)
        ys = np.trunc((ry + cy) + f32(0.5)).astype(np.int64)
        t = np.array([f["theta"] for f in fs], np.float32) - th
        while np.any(t > 360):
            t = np.where(t > 360, t - f32(360), t)
        while np.any(t < 0):
            t = np.where(t < 0, t + f32(360), t)
        labels = np.trunc(t * f32(16) / f32(360) + f32(0.5)).astype(
            np.int64) & 7
        feats = [dict(x=a, y=b, label=c, theta=d) for a, b, c, d in zip(
            xs.tolist(), ys.tolist(), labels.tolist(), t.tolist())]
        out.append({"pyramid_level": l, "features": feats})
    return oracle.crop_templates(out)


def train_bank(img: np.ndarray, angles, num_features: int, levels: int,
               weak_threshold: float, strong_threshold: float,
               narrow=_same) -> list:
    """The bank: template 0 from `img`, then template 0 rotated by each
    further angle about the image centre. A list of pyramids."""
    base = train_base(img, num_features, levels, weak_threshold,
                      strong_threshold)
    center = (img.shape[1] / 2.0, img.shape[0] / 2.0)
    return [base] + [rotate(base, a, center, narrow)
                     for a in list(angles)[1:]]


def level_views(bank: list, level: int) -> list:
    """One level of every pyramid as {'features': [(x, y, label)],
    'width', 'height'}, the form ``line2d.pack_bank`` takes."""
    return [{"features": [(f["x"], f["y"], f["label"])
                          for f in tp[level]["features"]],
             "width": tp[level]["width"], "height": tp[level]["height"]}
            for tp in bank]


def fingerprint(bank: list) -> list:
    """Per template, per level: (width, height, tl_x, tl_y, features as
    (x, y, label)) -- what a trained bank is compared on."""
    return [tuple((t["width"], t["height"], t["tl_x"], t["tl_y"],
                   tuple((f["x"], f["y"], f["label"]) for f in t["features"]))
                  for t in tp) for tp in bank]
