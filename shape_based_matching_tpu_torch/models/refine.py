"""Point-to-plane pose refinement of LINE-2D matches over a window search
of the gradient maps (similarity and affine models), in PyTorch.

The JAX package's ``models/refine.py``, op for op:

* model="sim2": scale, rotation and translation (4 DOF);
* model="affine": the full 2D affine map (6 DOF), for shear and aspect.

Each iteration places the template's features at the current pose,
searches each feature's own normal ray (radius 3) for the magnitude
crest of an edge whose signed gradient direction agrees within 45
degrees, localizes it by a parabola, and solves the weighted normal
equations (4x4 or 6x6, anchored by +1e-3 I). ``refine_detections``
refines a ``Detector.match`` list and reads the poses back in one
download. For the tighter subpixel tier see ``models/icp.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.gradients import quantized_orientations, weak_threshold_sq
from .detector import _as_tensor
from .icp import solve_batched

LAMBDA = 1e-3  # anchor of the normal equations


class RefinedPose(NamedTuple):
    x: torch.Tensor            # [C] float32 refined match origin
    y: torch.Tensor            # [C]
    angle_delta: torch.Tensor  # [C] degrees (residual rotation)
    scale: torch.Tensor        # [C] residual scale factor
    residual: torch.Tensor     # [C] mean feature-to-edge distance (px)
    valid: torch.Tensor        # [C] bool
    affine: torch.Tensor       # [C, 2, 2] linear part


def _normal_equations(J: torch.Tensor, wgt: torch.Tensor, r: torch.Tensor):
    """(J^T W J + 1e-3 I, -J^T W r) of [C, N, P] rows."""
    Wj = J * wgt[..., None]
    eye = torch.eye(J.shape[-1], dtype=torch.float32, device=J.device)
    A = torch.einsum("cni,cnj->cij", Wj, J) + eye * LAMBDA
    return A, -torch.einsum("cni,cn->ci", Wj, r)


def refine_matches(magnitude: torch.Tensor, angle_deg: torch.Tensor,
                   fx: torch.Tensor, fy: torch.Tensor, ftheta: torch.Tensor,
                   fvalid: torch.Tensor, mx: torch.Tensor, my: torch.Tensor,
                   mvalid: torch.Tensor, mag_threshold: float,
                   radius: int = 3, iterations: int = 5,
                   model: str = "sim2") -> RefinedPose:
    """Batched point-to-plane refinement (JAX's ``refine_matches``).

    magnitude / angle_deg: [H, W] squared gradient magnitude and raw
    fastAtan2 angle (``quantized_orientations``). fx / fy / ftheta /
    fvalid: [C, N] template features (template frame); mx / my: [C]
    integer match origins; mvalid: [C]."""
    if model not in ("sim2", "affine"):
        raise ValueError(f"unknown refine model: {model!r}")
    h, w = magnitude.shape
    C = fx.shape[0]
    dev = magnitude.device
    n_taps = 2 * radius + 1
    ts = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)

    def signed_diff_deg(a, b):
        d = torch.remainder(a - b, 360.0).abs()
        return torch.minimum(d, 360.0 - d)

    def correspondences(px, py, theta_cur):
        """The magnitude crest along each feature's normal ray, where the
        signed gradient direction agrees (360-degree space, so the far
        flank of a thin structure does not count): (signed distance t
        along the normal, nx, ny, found)."""
        ang_f = ftheta + torch.rad2deg(theta_cur)[:, None]
        rad = torch.deg2rad(ang_f)
        nx = torch.cos(rad)
        ny = torch.sin(rad)
        sx = torch.round(px[..., None] + ts * nx[..., None]).to(
            torch.int64).clamp(0, w - 1)
        sy = torch.round(py[..., None] + ts * ny[..., None]).to(
            torch.int64).clamp(0, h - 1)
        mag = magnitude[sy, sx]
        ang = angle_deg[sy, sx]
        good = (mag > mag_threshold) & (
            signed_diff_deg(ang, ang_f[..., None]) < 45.0)
        score = torch.where(good, torch.sqrt(mag) - 5.0 * ts.abs(),
                            -torch.inf)
        best = score.argmax(dim=-1)  # the first max
        found = torch.isfinite(score.gather(-1, best[..., None])[..., 0])

        def tap(idx):
            idx = idx.clamp(0, n_taps - 1)
            return torch.sqrt(mag.gather(-1, idx[..., None])[..., 0])

        m0, mp, mm = tap(best), tap(best + 1), tap(best - 1)
        d2 = mm - 2 * m0 + mp  # concave (< 0) at a crest
        safe = torch.where(d2.abs() > 1e-6, d2, -1e-6)
        delta = (0.5 * (mm - mp) / safe).clamp(-0.5, 0.5)
        delta = torch.where(m0 >= torch.maximum(mm, mp), delta, 0.0)
        return ts[best] + delta, nx, ny, found

    fxf = fx.to(torch.float32)
    fyf = fy.to(torch.float32)
    tx = mx.to(torch.float32)
    ty = my.to(torch.float32)
    resid = torch.zeros(C, device=dev)
    nfound = torch.zeros(C, device=dev)

    if model == "sim2":
        theta = torch.zeros(C, device=dev)
        scale = torch.ones(C, device=dev)
        for _ in range(iterations):
            ar = scale * torch.cos(theta)
            ai = scale * torch.sin(theta)
            vx = ar[:, None] * fxf - ai[:, None] * fyf
            vy = ai[:, None] * fxf + ar[:, None] * fyf
            t_found, nx, ny, found = correspondences(
                vx + tx[:, None], vy + ty[:, None], theta)
            wgt = (found & fvalid).to(torch.float32)
            nfound = wgt.sum(dim=1)
            # point-to-plane residual r = -t; rows d/d[tx, ty, theta, s]
            r = -t_found
            j_t = (-vy) * nx + vx * ny
            j_s = (vx * nx + vy * ny) / scale[:, None]
            A, b = _normal_equations(torch.stack([nx, ny, j_t, j_s], -1),
                                     wgt, r)
            delta = solve_batched(A, b)
            tx = tx + delta[:, 0]
            ty = ty + delta[:, 1]
            theta = theta + delta[:, 2]
            scale = (scale + delta[:, 3]).clamp(0.5, 2.0)
            resid = (wgt * r.abs()).sum(dim=1) / nfound.clamp(min=1.0)
        ar = scale * torch.cos(theta)
        ai = scale * torch.sin(theta)
        lin = torch.stack([torch.stack([ar, -ai], -1),
                           torch.stack([ai, ar], -1)], -2)
        angle_out = torch.rad2deg(theta)
        scale_out = scale
    else:
        # p = (a fx + b fy + tx, c fx + d fy + ty)
        a = torch.ones(C, device=dev)
        bb = torch.zeros(C, device=dev)
        c = torch.zeros(C, device=dev)
        d = torch.ones(C, device=dev)
        for _ in range(iterations):
            vx = a[:, None] * fxf + bb[:, None] * fyf
            vy = c[:, None] * fxf + d[:, None] * fyf
            t_found, nx, ny, found = correspondences(
                vx + tx[:, None], vy + ty[:, None], torch.atan2(c, a))
            wgt = (found & fvalid).to(torch.float32)
            nfound = wgt.sum(dim=1)
            r = -t_found
            A, bvec = _normal_equations(
                torch.stack([nx, ny, fxf * nx, fyf * nx, fxf * ny,
                             fyf * ny], -1), wgt, r)
            delta = solve_batched(A, bvec)
            tx = tx + delta[:, 0]
            ty = ty + delta[:, 1]
            a = a + delta[:, 2]
            bb = bb + delta[:, 3]
            c = c + delta[:, 4]
            d = d + delta[:, 5]
            resid = (wgt * r.abs()).sum(dim=1) / nfound.clamp(min=1.0)
        lin = torch.stack([torch.stack([a, bb], -1),
                           torch.stack([c, d], -1)], -2)
        angle_out = torch.rad2deg(torch.atan2(c, a))
        scale_out = torch.sqrt((a * d - bb * c).abs())

    need = torch.clamp(0.3 * fvalid.to(torch.float32).sum(dim=1), min=3.0)
    ok = mvalid & (nfound >= need)
    return RefinedPose(tx, ty, angle_out, scale_out, resid, ok, lin)


def refine_detections(detector, image, matches, radius: int = 3,
                      iterations: int = 3, model: str = "sim2") -> list:
    """Refine a ``Detector.match`` list against `image` (gray [H, W] or BGR
    [H, W, 3] uint8, numpy or a tensor) on the detector's device; the
    poses come back in one download. Returns one dict ({match, x, y,
    angle_delta, scale, residual, affine}) for each match that refined
    successfully, in the order of `matches`."""
    if not matches:
        return []
    dev = detector.device
    grads = quantized_orientations(_as_tensor(image).to(dev),
                                   detector.weak_threshold,
                                   detector.num_orientations)
    feats = [detector.get_templates(m.class_id, m.template_id)[0].features
             for m in matches]
    C, N = len(matches), max(len(f) for f in feats)
    fx = np.zeros((C, N), np.int32)
    fy = np.zeros((C, N), np.int32)
    th = np.zeros((C, N), np.float32)
    fv = np.zeros((C, N), bool)
    for i, fs in enumerate(feats):
        for n, f in enumerate(fs):
            fx[i, n], fy[i, n], th[i, n] = f.x, f.y, f.theta
        fv[i, :len(fs)] = True
    mxy = np.array([(m.x, m.y) for m in matches], np.int32)

    def up(a):
        return torch.from_numpy(a).to(dev)

    pose = refine_matches(
        grads.magnitude, grads.angle_ori, up(fx), up(fy), up(th), up(fv),
        up(mxy[:, 0]), up(mxy[:, 1]),
        torch.ones(C, dtype=torch.bool, device=dev),
        weak_threshold_sq(detector.weak_threshold), radius=radius,
        iterations=iterations, model=model)
    host = torch.cat([torch.stack([pose.x, pose.y, pose.angle_delta,
                                   pose.scale, pose.residual,
                                   pose.valid.to(torch.float32)], 1),
                      pose.affine.reshape(C, 4)], 1).cpu().numpy()
    return [{"match": m, "x": float(row[0]), "y": float(row[1]),
             "angle_delta": float(row[2]), "scale": float(row[3]),
             "residual": float(row[4]), "affine": row[6:].reshape(2, 2).copy()}
            for m, row in zip(matches, host) if row[5] >= 0.5]
