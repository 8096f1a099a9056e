"""The benchmark's one traffic generator: the training shape and the frames.

Everything a run feeds the program comes from here, made from ``--seed``
with NumPy alone, so the same seed gives the same inputs and the program
receives only the generated arrays. A configuration
(``portbench/configs/<name>.json``) names the training shape and the frame
size; a traffic mix (``portbench/traffic/<name>.json``) names the pool of
frames, the instances pasted into each and the noise. This module is the
benchmark's own copy of the shapes the port's ``utils/synthetic.py`` draws
and of upstream's ``shapeInfo_producer::transform`` (a rotation about the
image centre with bilinear interpolation, as ``cv::warpAffine`` with
``INTER_LINEAR`` and a zero border does), so that later changes to the
program cannot move the yardstick.
"""

from __future__ import annotations

import math

import numpy as np

# independent random streams of one seed
STREAM_SHAPE, STREAM_POOL, STREAM_COUNTS, STREAM_SAMPLE = 0, 1, 2, 3


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of `seed` (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def star_image(size: int, rng: np.random.Generator) -> np.ndarray:
    """A spiky star polygon with a hole, on dark noise: strong edges all
    round (the shape of the port's ``synthetic_shape_image``)."""
    img = (rng.random((size, size)) * 20).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    c = size / 2.0
    ang = np.arctan2(yy - c, xx - c)
    rad = np.hypot(yy - c, xx - c)
    rmax = size * (0.28 + 0.10 * np.cos(3 * ang) + 0.06 * np.sin(7 * ang))
    img[rad < rmax] = 200
    img[rad < size * (0.08 + 0.03 * np.sin(5 * ang))] = 40
    return img


SHAPES = {"star": star_image}


def shape_image(config: dict, seed: int) -> np.ndarray:
    """The configuration's training image, which is also the shape that
    the frames show."""
    return SHAPES[config["train_image"]](int(config["train_size"]),
                                         rng_for(seed, STREAM_SHAPE))


def rotate_linear(src: np.ndarray, angle_deg: float) -> np.ndarray:
    """`src` (uint8 [h, w]) rotated by `angle_deg` counter-clockwise about
    (w/2, h/2) at scale 1: ``cv::getRotationMatrix2D`` then
    ``cv::warpAffine`` with bilinear interpolation and a zero border, in
    float32 and rounded to the nearest integer."""
    h, w = src.shape
    f32 = np.float32
    cx, cy = f32(w / 2.0), f32(h / 2.0)
    a = math.radians(angle_deg)
    al, be = f32(math.cos(a)), f32(math.sin(a))
    dx = np.arange(w, dtype=f32)[None, :] - cx
    dy = np.arange(h, dtype=f32)[:, None] - cy
    # the inverse of dst = R (src - c) + c with R = [[al, be], [-be, al]]
    sx = al * dx - be * dy + cx
    sy = be * dx + al * dy + cy
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx, fy = sx - x0, sy - y0
    inside = (x0 >= -1) & (x0 < w) & (y0 >= -1) & (y0 < h)
    pad = np.zeros((h + 3, w + 2), f32)  # a zero ring, one row to spare
    pad[1:h + 1, 1:w + 1] = src
    flat = pad.reshape(-1)
    idx = ((np.clip(y0, -1, h - 1).astype(np.int64) + 1) * (w + 2)
           + np.clip(x0, -1, w - 1).astype(np.int64) + 1)
    top = flat[idx] + fx * (flat[idx + 1] - flat[idx])
    bot = flat[idx + w + 2] + fx * (flat[idx + w + 3] - flat[idx + w + 2])
    v = top + fy * (bot - top)
    return np.where(inside, np.rint(v), 0).astype(np.uint8)


def instance_counts(traffic: dict, seed: int) -> np.ndarray:
    """Instances per pool frame: the mix's counts repeated over the pool,
    the same multiset for every seed, in an order drawn from the seed."""
    counts = np.resize(np.asarray(traffic["instances"], np.int64),
                       int(traffic["pool"]))
    return rng_for(seed, STREAM_COUNTS).permutation(counts)


def frame_pool(config: dict, traffic: dict, shape: np.ndarray,
               seed: int) -> np.ndarray:
    """The pool of frames, uint8 [pool, H, W]: noise of the mix's
    amplitude, with the shape pasted (brighter pixel wins) at uniform
    positions, each instance rotated by a uniform angle in [0, 360)."""
    n = int(traffic["pool"])
    H, W = int(config["frame_height"]), int(config["frame_width"])
    rng = rng_for(seed, STREAM_POOL)
    counts = instance_counts(traffic, seed)
    pool = rng.integers(0, int(traffic["noise_amplitude"]), size=(n, H, W),
                        dtype=np.uint8)
    th, tw = shape.shape
    for i in range(n):
        for _ in range(int(counts[i])):
            rot = rotate_linear(shape, float(rng.uniform(0.0, 360.0)))
            y = int(rng.integers(0, H - th))
            x = int(rng.integers(0, W - tw))
            np.maximum(pool[i, y:y + th, x:x + tw], rot,
                       out=pool[i, y:y + th, x:x + tw])
    return pool


def template_angles(config: dict) -> list[float]:
    """The bank's angles in degrees: template 0 is trained at 0, template
    i is template 0 rotated by i * angle_step."""
    step = float(config["angle_step"])
    return [i * step for i in range(int(config["num_templates"]))]


def check_sample(traffic: dict, seed: int, counts: np.ndarray) -> list[int]:
    """The pool frames whose every answer in the window is compared with
    the reference: `check_frames` of them drawn from the seed, the frame
    with the most instances (the longest list) always among them."""
    n = int(traffic["pool"])
    k = min(int(traffic["check_frames"]), n)
    pick = rng_for(seed, STREAM_SAMPLE).permutation(n)[:k].tolist()
    longest = int(np.argmax(counts))
    if longest not in pick:
        pick[-1] = longest
    return sorted(pick)
