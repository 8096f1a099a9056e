"""The ICP layer's kernel, ``csrc/icp.cu``.

``icp_steps(off, normal, has, subpix, pts, origins, pt_valid, iters,
radius, min_inliers)`` runs all `iters` sim2 point-to-plane steps of
``models/icp.py::icp_refine_points`` for every candidate and returns its
seven fields (dtheta_deg, dscale, tx, ty, rmse, inliers, valid) as a
tuple: float32 ``[C]`` each, inliers int32, valid bool.

Port-only kernel: the JAX package computes the steps in XLA, with no
Pallas kernel. On a CPU tensor the wrapper runs the plain twin
(``models/icp.py::icp_refine_points_plain``); on a CUDA tensor it makes
one launch -- a block a candidate, every step inside it -- and no torch
op but the allocation of its outputs, or raises. The correspondences of
an equal state are the twin's bit for bit; the sums and the 4x4 solve
are float32 in the kernel's own order, so poses differ from the twin's
by float32 rounding alone.
"""

from __future__ import annotations

import torch

from . import build

_INT32_MAX = 2**31 - 1


def _expect(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    if (t.dtype != dtype or t.dim() != len(shape)
            or any(s is not None and d != s for d, s in zip(t.shape, shape))):
        want = "x".join("?" if s is None else str(s) for s in shape)
        raise ValueError(f"{name}: expected {dtype} [{want}], got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, pts on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(off, normal, has, subpix, pts, origins, pt_valid, iters: int,
           radius: int) -> None:
    dev = pts.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _expect("pts", pts, torch.float32, (None, None, 2), dev)
    C, N = pts.shape[:2]
    _expect("has", has, torch.bool, (None, None), dev)
    H, W = has.shape
    _expect("off", off, torch.int32, (H, W, 2), dev)
    _expect("normal", normal, torch.float32, (H, W, 2), dev)
    _expect("subpix", subpix, torch.float32, (H, W, 2), dev)
    _expect("origins", origins, torch.float32, (C, 2), dev)
    _expect("pt_valid", pt_valid, torch.bool, (C, N), dev)
    if H < 1 or W < 1 or H * W > _INT32_MAX or C > _INT32_MAX:
        raise ValueError(f"a {W}x{H} field of {C} candidates is outside "
                         f"the kernel's int32 indices")
    if iters < 0 or radius < 0:
        raise ValueError(f"iters={iters} and radius={radius} must be >= 0")


def icp_steps(off, normal, has, subpix, pts: torch.Tensor,
              origins: torch.Tensor, pt_valid: torch.Tensor, iters: int,
              radius: int, min_inliers: int) -> tuple:
    """off [H, W, 2] int32, normal and subpix [H, W, 2] float32, has [H, W]
    bool (``edge_nearest_field``); pts [C, N, 2] float32, origins [C, 2]
    float32, pt_valid [C, N] bool -> (dtheta_deg, dscale, tx, ty, rmse,
    inliers, valid), each [C]."""
    _check(off, normal, has, subpix, pts, origins, pt_valid, iters, radius)
    if pts.device.type == "cpu":
        from ...models.icp import icp_refine_points_plain

        return tuple(icp_refine_points_plain(
            off, normal, has, subpix, pts, origins, pt_valid, iters=iters,
            radius=radius, min_inliers=min_inliers))
    for name, t in (("off", off), ("normal", normal), ("subpix", subpix),
                    ("pts", pts), ("origins", origins)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must start on 8 bytes (pairs load "
                             f"as one word)")
    C, N = pts.shape[:2]
    H, W = has.shape
    out = torch.empty((5, C), dtype=torch.float32, device=pts.device)
    inliers = torch.empty(C, dtype=torch.int32, device=pts.device)
    valid = torch.empty(C, dtype=torch.bool, device=pts.device)
    if C:
        build.check(build.library().sbm_icp_steps(
            off.data_ptr(), normal.data_ptr(), has.data_ptr(),
            subpix.data_ptr(), pts.data_ptr(), origins.data_ptr(),
            pt_valid.data_ptr(), out.data_ptr(), inliers.data_ptr(),
            valid.data_ptr(), C, N, H, W, iters, float(radius * radius),
            min_inliers, build.stream_ptr(pts.device)), "sbm_icp_steps")
        icp_steps.launches += 1
    return (*out.unbind(0), inliers, valid)


icp_steps.launches = 0
