"""The ICP layer's edge field, ``csrc/icp_field.cu``.

``edge_field(src, weak_threshold, radius)`` maps a uint8 ``[H, W]`` frame
to ``models/icp.py::edge_nearest_field``'s five outputs: off ``[H, W, 2]``
int32, normal ``[H, W, 2]`` float32, edge ``[H, W]`` bool, has ``[H, W]``
bool, subpix ``[H, W, 2]`` float32.

Port-only kernels: the JAX package computes the field in XLA, with no
Pallas kernel. On a CPU tensor the wrapper runs the plain twin
(``models/icp.py::edge_nearest_field_plain``); on a CUDA tensor it makes
one launch of the edge frontend, one a flood stride up to the kernel's
``HALO_STRIDE_MAX`` and eight a stride above it (the library reports how
many), and no torch op but the allocation of its outputs and of the
flood's two seed buffers, or raises. Every output equals the twin's on
the card bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..gradients import weak_threshold_sq
from . import build


def edge_field(src: torch.Tensor, weak_threshold: float,
               radius: int) -> tuple:
    """uint8 [H, W] frame, as ``edge_nearest_field`` checks it -> (off,
    normal, edge, has, subpix)."""
    if src.device.type != "cuda":
        from ...models.icp import edge_nearest_field_plain
        return edge_nearest_field_plain(src, weak_threshold, radius)
    src = src.contiguous()
    H, W = src.shape
    dev = src.device
    off = torch.empty((H, W, 2), dtype=torch.int32, device=dev)
    normal = torch.empty((H, W, 2), dtype=torch.float32, device=dev)
    edge = torch.empty((H, W), dtype=torch.bool, device=dev)
    has = torch.empty((H, W), dtype=torch.bool, device=dev)
    subpix = torch.empty((H, W, 2), dtype=torch.float32, device=dev)
    seeds = torch.empty((2, H, W, 2), dtype=torch.int32, device=dev)
    n = ctypes.c_int(0)
    build.check(build.library().sbm_icp_field(
        src.data_ptr(), edge.data_ptr(), normal.data_ptr(),
        subpix.data_ptr(), off.data_ptr(), has.data_ptr(),
        seeds[0].data_ptr(), seeds[1].data_ptr(), H, W,
        weak_threshold_sq(weak_threshold), radius, build.stream_ptr(dev),
        ctypes.byref(n)), "sbm_icp_field")
    edge_field.launches += n.value
    return off, normal, edge, has, subpix


edge_field.launches = 0
