"""ddcr's fiducial inspection (test_jabil.cpp:46-312) as a deployment
module: one fiducial class trained over the configuration's angle and
scale sweep through ``ShapeInfoProducer`` and ``add_template``, its
fiducial registered with ``set_fiducial``; BGR camera frames of a
PCB-like background holding fiducials at the trained poses and
contrast-inverted copies that the gate must reject; the call
``Detector.inspect`` (match, NMS, the CCORR gate) at B=1; the reference
``reference/jabil.py``.

A call's rows are every NMS-kept match: (template, x, y, float32 score
bits, float32 CCORR bits, passed).
"""

import gzip
import json
import os

import numpy as np

from portbench import frames

CLASS_ID = "fiducial"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# a slot of the frame's grid holds at most one fiducial, inside a margin
# that keeps every match clear of the refine's border clamp
SLOT = 272
MARGIN = 40
BOARD = (40, 100, 30)       # B, G, R of the solder mask
COPPER = (60, 140, 170)
PAD = (175, 180, 185)


def _config() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "jabil_fiducials.json")) as f:
        return json.load(f)


def fiducial(config: dict) -> np.ndarray:
    """The fiducial crop, uint8 [h, w, 3] BGR (a dumped cv::Mat: int32
    rows, cols, channels, then the bytes)."""
    with gzip.open(os.path.join(ROOT, config["fiducial"]), "rb") as f:
        rows, cols, ch = np.frombuffer(f.read(12), np.int32)
        return np.frombuffer(f.read(), np.uint8).reshape(rows, cols, ch)


def train(config, seed, device):
    from shape_based_matching_tpu_torch import Detector, ShapeInfoProducer

    fid = fiducial(config)
    det = Detector(num_features=int(config["num_features"]),
                   T=tuple(int(t) for t in config["T"]),
                   weak_threshold=float(config["weak_threshold"]),
                   strong_threshold=float(config["strong_threshold"]),
                   device=device)
    det.set_fiducial(CLASS_ID, fid)
    shapes = ShapeInfoProducer(
        fid, angle_range=list(config["angle_range"]),
        angle_step=float(config["angle_step"]),
        scale_range=list(config["scale_range"]),
        scale_step=float(config["scale_step"]))
    for info in shapes.produce_infos():
        if det.add_template(shapes.src_of(info), CLASS_ID,
                            shapes.mask_of(info), info.scale,
                            info.angle) < 0:
            raise RuntimeError("training a pose of the fiducial failed")
    return det


def fingerprint(det):
    return [tuple((t.width, t.height, t.tl_x, t.tl_y,
                   tuple((f.x, f.y, f.label) for f in t.features))
                  for t in tp) for tp in det.class_templates[CLASS_ID]]


def _board(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """A solder-mask board with a seeded texture, copper traces and pads."""
    img = np.empty((H, W, 3), np.uint8)
    img[...] = BOARD
    img += rng.integers(0, 16, size=(H, W, 1), dtype=np.uint8)
    for _ in range(int(rng.integers(30, 60))):
        length, width = int(rng.integers(60, 900)), int(rng.integers(4, 16))
        h, w = (width, length) if rng.random() < 0.5 else (length, width)
        h, w = min(h, H - 1), min(w, W - 1)
        y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
        img[y:y + h, x:x + w] = COPPER
    for _ in range(int(rng.integers(40, 80))):
        h, w = int(rng.integers(10, 30)), int(rng.integers(10, 30))
        y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
        img[y:y + h, x:x + w] = PAD
    return img


def frame_pool(config, traffic, seed):
    from portbench.reference import jabil

    fid = fiducial(config)
    renders = [jabil.render(fid, a, s) for a, s in jabil.poses(config)]
    H, W = int(config["frame_height"]), int(config["frame_width"])
    rows, cols = (H - 2 * MARGIN) // SLOT, (W - 2 * MARGIN) // SLOT
    counts = frames.instance_counts(traffic, seed)
    rng = frames.rng_for(seed, frames.STREAM_POOL)
    pool = np.empty((int(traffic["pool"]), H, W, 3), np.uint8)
    for i, n in enumerate(counts):
        pool[i] = _board(rng, H, W)
        n_fake = int(rng.choice(traffic["distractors"]))
        slots = rng.choice(rows * cols, size=int(n) + n_fake, replace=False)
        for j, slot in enumerate(slots.tolist()):
            patch = renders[int(rng.integers(len(renders)))]
            if j >= n:
                patch = 255 - patch
            h, w = patch.shape[:2]
            y = MARGIN + (slot // cols) * SLOT + int(rng.integers(0, SLOT - h))
            x = MARGIN + (slot % cols) * SLOT + int(rng.integers(0, SLOT - w))
            pool[i, y:y + h, x:x + w] = patch
    return pool, counts


class Client:
    """One AOI camera: call i inspects pool frame i mod pool."""

    def __init__(self, det, traffic, pool, threshold):
        if traffic["api"] != "inspect" or int(traffic.get("batch", 1)) != 1:
            raise ValueError("this deployment's mix calls inspect at B=1")
        config = _config()
        self.det, self.pool, self.threshold = det, pool, threshold
        self.nms, self.ccorr = float(config["nms"]), float(config["ccorr"])
        self.calls_per_pass = len(pool)

    def frames_of(self, i):
        i %= self.calls_per_pass
        return range(i, i + 1)

    def __call__(self, i):
        idx = self.frames_of(i)
        return idx, [self.det.inspect(self.pool[idx.start], self.threshold,
                                      nms=self.nms, ccorr=self.ccorr)]

    def rows(self, answer):
        out = np.zeros((len(answer), 6), np.int64)
        for j, r in enumerate(answer):
            m = r.match
            out[j] = (m.template_id, m.x, m.y,
                      np.float32(m.similarity).view(np.int32),
                      np.float32(r.ccorr).view(np.int32), int(r.passed))
        return out

    def api_span(self):
        return (type(self.det), "inspect", "detector.inspect")


def client(det, traffic, pool, threshold):
    return Client(det, traffic, pool, threshold)


def reference(config, traffic, seed, pool, positions, device, lower=False):
    from portbench.reference import jabil

    return jabil.reference(fiducial(config), config,
                           {pos: pool[pos] for pos in positions}, device,
                           lower)
