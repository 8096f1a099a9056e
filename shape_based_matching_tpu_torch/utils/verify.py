"""Verification helpers (the JAX package's ``utils/verify.py``).

Only the BGR-to-gray conversion lives here so far; ICP refinement needs it
for BGR frames (``models/icp.refine_matches_icp``).
"""

from __future__ import annotations

import torch


def bgr2gray_u8(img: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor BGR2GRAY on a uint8 ``[..., 3]`` tensor, on its own
    device, bit-exact to OpenCV: (B*3735 + G*19235 + R*9798 + 16384) >>
    15. The sum stays below 2^23, so int32 holds it."""
    x = img.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).to(
        torch.uint8)
