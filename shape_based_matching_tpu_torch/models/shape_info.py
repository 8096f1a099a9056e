"""Training-variant producer (mirror of shape_based_matching::shapeInfo_producer,
line2Dup.h:344-460).

Enumerates an (angle, scale) grid and materializes transformed image/mask
pairs. This fork's transform() rotates only by exact 90/180/270 via cv::rotate
(arbitrary-angle warpAffine is commented out upstream, line2Dup.h:398-402) and
resizes with INTER_LINEAR. We reproduce cv::rotate with transpose/flip and
cv::resize(INTER_LINEAR) with the exact 8-bit fixed-point arithmetic
(see utils/cv_resize.py).

A copy of the JAX package's ``models/shape_info.py``, so the port never
imports that package; the same sweep gives the same frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..utils.cv_resize import resize_linear_u8

ANGLE_TOLERANCE = np.finfo(np.float32).eps  # line2Dup.h:8


@dataclass
class ShapeInfo:
    angle: float
    scale: float


@dataclass
class ShapeInfoProducer:
    src: np.ndarray
    mask: np.ndarray | None = None
    angle_range: List[float] = field(default_factory=list)
    scale_range: List[float] = field(default_factory=list)
    angle_step: float = 15.0
    scale_step: float = 0.5
    eps: float = 0.00001

    infos: List[ShapeInfo] = field(default_factory=list)

    def __post_init__(self):
        self.src = np.asarray(self.src)
        if self.mask is None or np.asarray(self.mask).size == 0:
            self.mask = np.full(self.src.shape[:2], 255, np.uint8)
        else:
            self.mask = np.asarray(self.mask)

    @staticmethod
    def transform(src: np.ndarray, angle: float, scale: float) -> np.ndarray:
        """Exact-90° rotations + INTER_LINEAR scaling (line2Dup.h:379-405).

        The C++ signature takes `float` — narrow to float32 so e.g. 0.7
        resizes with the same 0.69999998... the reference uses."""
        scale = float(np.float32(scale))
        if abs(angle - 90.0) < ANGLE_TOLERANCE:
            dst = np.flip(np.swapaxes(src, 0, 1), axis=1)  # ROTATE_90_CW
            return resize_linear_u8(np.ascontiguousarray(dst), scale, scale)
        if abs(angle - 180.0) < ANGLE_TOLERANCE:
            dst = np.flip(np.flip(src, axis=0), axis=1)  # ROTATE_180
            return resize_linear_u8(np.ascontiguousarray(dst), scale, scale)
        if abs(angle - 270.0) < ANGLE_TOLERANCE:
            dst = np.flip(np.swapaxes(src, 0, 1), axis=0)  # ROTATE_90_CCW
            return resize_linear_u8(np.ascontiguousarray(dst), scale, scale)
        return resize_linear_u8(src, scale, scale)

    def produce_infos(self) -> List[ShapeInfo]:
        """Enumerate the (angle, scale) grid with the reference's inclusive
        float loops (line2Dup.h:407-449)."""
        self.infos = []
        assert len(self.angle_range) <= 2
        assert len(self.scale_range) <= 2
        assert self.angle_step > self.eps * 10
        assert self.scale_step > self.eps * 10
        angle_range = list(self.angle_range) or [0.0]
        scale_range = list(self.scale_range) or [1.0]

        def frange(lo, hi, step):
            # float32 accumulation like the C++ `for(float v=lo; v<=hi+eps;
            # v+=step)`
            vals = []
            v = np.float32(lo)
            while v <= np.float32(hi) + np.float32(self.eps):
                vals.append(float(v))
                v = np.float32(v + np.float32(step))
            return vals

        if len(angle_range) == 1 and len(scale_range) == 1:
            self.infos.append(ShapeInfo(angle_range[0], scale_range[0]))
        elif len(angle_range) == 1:
            assert scale_range[1] > scale_range[0]
            for s in frange(scale_range[0], scale_range[1], self.scale_step):
                self.infos.append(ShapeInfo(angle_range[0], s))
        elif len(scale_range) == 1:
            assert angle_range[1] > angle_range[0]
            for a in frange(angle_range[0], angle_range[1], self.angle_step):
                self.infos.append(ShapeInfo(a, scale_range[0]))
        else:
            assert scale_range[1] > scale_range[0]
            assert angle_range[1] > angle_range[0]
            for s in frange(scale_range[0], scale_range[1], self.scale_step):
                for a in frange(angle_range[0], angle_range[1],
                                self.angle_step):
                    self.infos.append(ShapeInfo(a, s))
        return self.infos

    def src_of(self, info: ShapeInfo) -> np.ndarray:
        return self.transform(self.src, info.angle, info.scale)

    def mask_of(self, info: ShapeInfo) -> np.ndarray:
        t = self.transform(self.mask, info.angle, info.scale)
        return ((t > 0) * np.uint8(255)).astype(np.uint8)

    @staticmethod
    def save_infos(infos, path: str) -> None:
        """Persist (angle, scale) per template id — upstream save_infos
        schema (test.cpp:200; the bundled case *_info.yaml files)."""
        from ..utils.yaml_io import dump_opencv_yaml

        dump_opencv_yaml(
            {"infos": [{"angle": float(i.angle), "scale": float(i.scale)}
                       for i in infos]},
            path,
        )

    @staticmethod
    def load_infos(path: str):
        from ..utils.yaml_io import load_opencv_yaml

        doc = load_opencv_yaml(path)
        return [ShapeInfo(float(n["angle"]), float(n["scale"]))
                for n in doc.get("infos", [])]
