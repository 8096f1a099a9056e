"""Replica of OpenCV's fastAtan2 so orientation bins match the reference.

cv::phase(dx, dy, degrees=true) (line2Dup.cpp:327,398) computes angles with
cv::fastAtan2, a degree-7 polynomial approximation. Quantization into 16
buckets happens downstream via round(angle * 16/360), so the polynomial is
reproduced in float32 with the same operation order as the JAX package's
``ops/fastmath.py``: every multiply, add and divide is its own float32
rounding, which the CUDA frontend matches by compiling without FMA
contraction (``--fmad=false``) and with IEEE division.
"""

from __future__ import annotations

import math

import numpy as np
import torch

P1 = float(np.float32(0.9997878412794807 * (180.0 / math.pi)))
P3 = float(np.float32(-0.3258083974640975 * (180.0 / math.pi)))
P5 = float(np.float32(0.1555786518463281 * (180.0 / math.pi)))
P7 = float(np.float32(-0.04432655554792128 * (180.0 / math.pi)))
DBL_EPS_F32 = float(np.float32(2.220446049250313e-16))


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def phase_deg(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Angle in degrees in [0, 360), cv::fastAtan2 semantics, float32."""
    x = dx.to(torch.float32)
    y = dy.to(torch.float32)
    ax = x.abs()
    ay = y.abs()
    eps = _f32(DBL_EPS_F32, x)
    c = torch.where(ax >= ay, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    a = (((_f32(P7, x) * c2 + _f32(P5, x)) * c2
          + _f32(P3, x)) * c2 + _f32(P1, x)) * c
    a = torch.where(ax < ay, _f32(90.0, x) - a, a)
    a = torch.where(x < 0, _f32(180.0, x) - a, a)
    a = torch.where(y < 0, _f32(360.0, x) - a, a)
    return a
