"""The plain reference of ``Detector.match_icp``: a frame's LINE-2D
candidates and the sim2 point-to-plane ICP of its `top_c` best, in plain
PyTorch.

Written from the documented semantics of the port's ``models/icp.py``
(its module docstring, ``_edge_frontend``, ``edge_nearest_field``,
``icp_refine_points``, ``refine_packed_candidates`` and
``_match_icp_collect``). It imports torch and the reference's own
``line2d`` only: nothing of the program under test, and it takes nothing
the program made; the bank it refines with is the reference's own
(``training.py``), and its candidates are ``line2d``'s.

* **Edge field** (``edge_field``): ``line2d``'s blur and Sobel, |g|^2,
  the octant ``round(atan2(dy, dx) / f32(pi/4)) mod 4``, edges where |g|^2
  passes the weak threshold and is no less than both neighbours along
  the octant (outside the frame a neighbour reads -1), unit normals
  g / sqrt(max(|g|^2, 1e-12)), and the parabola's subpixel shift through
  |g| at the two neighbours, clamped to half a pixel, along the octant's
  unit step (1, 0), (1, 1), (0, 1), (-1, 1).
* **Nearest edge** (``jump_flood``): the system's documented jump flood
  (the JAX package's ``_jump_flood_impl``, as its docstrings and the
  port's ``_jump_flood`` state it), written here from that statement:
  strides from the power of two at or above `radius` halved down to 1;
  per stride each pixel's current distance once, then its 8 neighbours
  at (dr, dc) in {-s, 0, s}^2, dr outer, dc inner, each read from the
  seeds as the neighbours before it left them (a Gauss-Seidel sweep), a
  neighbour's seed taken where its squared distance is strictly less.
  Distances are exact integers here (int64). ``has``: the seed lies
  within the square (|dx|, |dy| <= r). The flood is not the exact
  nearest edge: at a few pixels a frame it stops at a farther edge, and
  it breaks ties of equal distance by its order. ``nearest_edge_scan``
  is the exact nearest edge by a brute-force scan; the tests report
  where the flood is farther, and nothing the benchmark judges uses it.
* **ICP** (``icp``): `iters` steps per candidate from (a, b, tx, ty) =
  (1, 0, origin). A step moves each template point p to q = (a px - b py
  + tx, b px + a py + ty), rounds q to its pixel (half to even), follows
  the field to the nearest edge e (pixel plus subpixel shift; lookups
  clip to the frame), keeps the point where ``has`` holds at its pixel
  and |q - e| <= r, and solves the normal equations of the residual
  n . (M s - e) with the Tikhonov anchor: (A + 1e-3 I) s = v + 1e-3 s_prev,
  in float32 by ``torch.linalg.solve`` with TF32 off. A candidate with
  fewer than 8 inliers keeps its state; inliers are the last step's;
  valid is inliers >= 8 (the port's rmse is not compared, nor computed
  here).
* **Candidates** (``match_icp_frame``): ``line2d``'s coarse candidates in
  (template, cell row-major) order, refined down the pyramid, the
  survivors kept in that order; a stable sort by score, descending,
  and the first `top_c`. A frame whose coarse candidates pass
  `cand_cap` takes the port's documented overflow path instead: the
  sorted, de-duplicated match list and its first `top_c`. Results are
  keyed by (template id, x, y, float32 score bits); a key refined twice
  (one template converging from two coarse candidates) has the same pose
  both times and is kept once.

Departures from ``models/icp.py``, each deliberate: the normal
equations' sums are matrix products of the same shapes, so their
contraction order is torch's, as in the port; the seeds' distances are
int64 where the port's are float32 (both exact). ``pose_dtype=
torch.bfloat16`` is the control: the transform, the plane rows, the
normal equations and the state in bfloat16 (the solve in float32 of
bfloat16 operands, its result rounded to bfloat16).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import line2d

LAMBDA = 1e-3         # the Tikhonov anchor of the normal equations
MIN_INLIERS = 8
NO_SEED = 1 << 40     # the flood's seed coordinate where there is none
NO_DIST = 1 << 62     # its squared distance
# the octant's neighbours (row, column) along octant 0..3, forward
_FWD = ((0, 1), (1, 1), (1, 0), (1, -1))


class Field(NamedTuple):
    """A frame's edge field; every plane [H, W]."""

    edge: torch.Tensor     # bool
    nx: torch.Tensor       # float32 unit gradient
    ny: torch.Tensor
    sx: torch.Tensor       # float32 subpixel shift of an edge pixel
    sy: torch.Tensor
    off_x: torch.Tensor    # int64 offset to the nearest edge pixel
    off_y: torch.Tensor
    has: torch.Tensor      # bool: that edge lies within the square


class Pose(NamedTuple):
    """Per candidate [C]: scene = R(dtheta) * dscale * template + (tx,
    ty)."""

    dtheta_deg: torch.Tensor
    dscale: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    inliers: torch.Tensor
    valid: torch.Tensor


def octant(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """round(atan2(dy, dx) / f32(pi/4)) mod 4, int64; the divisor a
    float32 tensor (a CUDA division by a Python scalar multiplies by its
    reciprocal)."""
    q = torch.tensor(math.pi / 4, dtype=torch.float32, device=dx.device)
    return torch.remainder(torch.round(torch.atan2(dy, dx) / q).to(
        torch.int64), 4)


def _edges(frame: torch.Tensor, weak_threshold: float):
    """(edge, normal x, normal y, subpixel x, subpixel y) of a gray uint8
    [H, W] frame."""
    dx_i, dy_i = line2d.sobel3(line2d.gaussian_blur7_u8(frame))
    dx, dy = dx_i.to(torch.float32), dy_i.to(torch.float32)
    mag = dx * dx + dy * dy
    h, w = mag.shape
    o = octant(dx, dy)
    pad = torch.nn.functional.pad(mag, (1, 1, 1, 1), value=-1.0)

    def along(sign):
        planes = [pad[1 + sign * r:1 + sign * r + h,
                      1 + sign * c:1 + sign * c + w] for r, c in _FWD]
        return torch.stack(planes).gather(0, o[None])[0]

    fwd, bwd = along(1), along(-1)
    weak = torch.tensor(weak_threshold, dtype=torch.float32)
    edge = (mag > float(weak * weak)) & (mag >= fwd) & (mag >= bwd)
    norm = torch.sqrt(mag.clamp(min=1e-12))
    g0 = torch.sqrt(mag.clamp(min=0.0))
    gf = torch.sqrt(fwd.clamp(min=0.0))
    gb = torch.sqrt(bwd.clamp(min=0.0))
    denom = gb - 2.0 * g0 + gf
    delta = torch.where(denom.abs() > 1e-6, 0.5 * (gb - gf) / denom, 0.0)
    delta = delta.clamp(-0.5, 0.5)
    step_x = torch.where(o == 2, 0.0, torch.where(o == 3, -1.0, 1.0))
    step_y = torch.where(o == 0, 0.0, 1.0)
    return edge, dx / norm, dy / norm, delta * step_x, delta * step_y


def strides(radius: int) -> list:
    """The flood's strides: the power of two at or above `radius`, halved
    down to 1 (8, 4, 2, 1 at radius 8)."""
    s = 1
    while s < radius:
        s *= 2
    out = []
    while s >= 1:
        out.append(s)
        s //= 2
    return out


def _offsets(sy, sx, radius: int) -> tuple:
    """Seed planes -> (off_x, off_y, has)."""
    h, w = sy.shape
    none = sy == NO_SEED
    rows = torch.arange(h, device=sy.device)[:, None]
    cols = torch.arange(w, device=sy.device)[None, :]
    off_x = torch.where(none, 0, sx - cols)
    off_y = torch.where(none, 0, sy - rows)
    has = ~none & (off_x.abs() <= radius) & (off_y.abs() <= radius)
    return off_x, off_y, has


def jump_flood(edge: torch.Tensor, radius: int) -> tuple:
    """(off_x, off_y, has) by the jump flood of the module's docstring.
    The seeds (row, column; ``NO_SEED`` where none) live in planes padded
    by the largest stride, so a neighbour is a view of them."""
    h, w = edge.shape
    dev = edge.device
    P = strides(radius)[0]
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    sy = torch.full((h + 2 * P, w + 2 * P), NO_SEED, dtype=torch.int64,
                    device=dev)
    sx = sy.clone()
    here_y, here_x = sy[P:P + h, P:P + w], sx[P:P + h, P:P + w]
    here_y.copy_(torch.where(edge, rows, NO_SEED))
    here_x.copy_(torch.where(edge, cols, NO_SEED))

    def dist2(y, x):
        none = y == NO_SEED
        dy = torch.where(none, 0, y - rows)
        dx = torch.where(none, 0, x - cols)
        return torch.where(none, NO_DIST, dy * dy + dx * dx)

    for s in strides(radius):
        best = dist2(here_y, here_x)
        for dr in (-s, 0, s):
            for dc in (-s, 0, s):
                if dr == 0 and dc == 0:
                    continue
                cy = sy[P + dr:P + dr + h, P + dc:P + dc + w]
                cx = sx[P + dr:P + dr + h, P + dc:P + dc + w]
                d = dist2(cy, cx)
                take = d < best
                best = torch.where(take, d, best)
                new_y = torch.where(take, cy, here_y)
                new_x = torch.where(take, cx, here_x)
                here_y.copy_(new_y)
                here_x.copy_(new_x)
    return _offsets(here_y, here_x, radius)


def nearest_edge_scan(edge: torch.Tensor, radius: int) -> tuple:
    """(off_x, off_y, has) of the exact nearest edge pixel, by a
    brute-force scan of the offsets in the disc dx^2 + dy^2 <= 2 radius^2
    (which holds the whole square of `radius`) in order of distance, then
    dy, then dx: a pixel takes the first that lands on an edge. An edge
    outside the disc is farther than any edge inside the square, so where
    ``has`` holds this is the nearest edge of the frame."""
    h, w = edge.shape
    R = math.isqrt(2 * radius * radius)
    order = sorted(((dy * dy + dx * dx, dy, dx)
                    for dy in range(-R, R + 1) for dx in range(-R, R + 1)
                    if dy * dy + dx * dx <= 2 * radius * radius))
    pad = torch.nn.functional.pad(edge, (R, R, R, R))
    found = torch.zeros_like(edge)
    off_x = torch.zeros((h, w), dtype=torch.int64, device=edge.device)
    off_y = torch.zeros_like(off_x)
    for _, dy, dx in order:
        hit = pad[R + dy:R + dy + h, R + dx:R + dx + w] & ~found
        off_x = torch.where(hit, dx, off_x)
        off_y = torch.where(hit, dy, off_y)
        found |= hit
    has = found & (off_x.abs() <= radius) & (off_y.abs() <= radius)
    return off_x, off_y, has


def edge_field(frame: torch.Tensor, weak_threshold: float,
               radius: int) -> Field:
    edge, nx, ny, sx, sy = _edges(frame, weak_threshold)
    return Field(edge, nx, ny, sx, sy, *jump_flood(edge, radius))


def icp(field: Field, pts: torch.Tensor, origins: torch.Tensor,
        pt_valid: torch.Tensor, iters: int, radius: int,
        pose_dtype=torch.float32) -> Pose:
    """The point-to-plane ICP of the module's docstring. pts [C, N, 2]
    float32 template points, origins [C, 2] float32, pt_valid [C, N]. The
    matrix products run in float32, TF32 off."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _icp(field, pts, origins, pt_valid, iters, radius,
                    pose_dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _icp(field, pts, origins, pt_valid, iters, radius, dt):
    h, w = field.has.shape
    C = pts.shape[0]
    dev = pts.device
    f32 = torch.float32

    def low(t):  # the working precision: float32, or the control's
        return t.to(dt).to(f32)

    px, py = pts[..., 0], pts[..., 1]

    def at(plane, yy, xx):
        return plane.reshape(-1)[yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]

    state = low(torch.stack([torch.ones(C, device=dev),
                             torch.zeros(C, device=dev),
                             origins[:, 0], origins[:, 1]], dim=1))
    eye = torch.eye(4, dtype=f32, device=dev) * LAMBDA
    n_in = torch.zeros(C, dtype=torch.int64, device=dev)
    for _ in range(iters):
        a, b, tx, ty = (t[:, None] for t in state.unbind(1))
        qx = low(low(low(a * px) - low(b * py)) + tx)
        qy = low(low(low(b * px) + low(a * py)) + ty)
        ix = torch.round(qx).to(torch.int64)
        iy = torch.round(qy).to(torch.int64)
        ok = at(field.has, iy, ix) & pt_valid
        ei = ix + at(field.off_x, iy, ix)
        ej = iy + at(field.off_y, iy, ix)
        nx, ny = at(field.nx, ej, ei), at(field.ny, ej, ei)
        ex = ei.to(f32) + at(field.sx, ej, ei)
        ey = ej.to(f32) + at(field.sy, ej, ei)
        ddx, ddy = qx - ex, qy - ey
        ok = ok & (ddx * ddx + ddy * ddy <= float(radius * radius))
        wgt = ok.to(f32)
        M = low(torch.stack([nx * px + ny * py, -nx * py + ny * px, nx, ny],
                            dim=-1))                     # [C, N, 4]
        rhs = low(nx * ex + ny * ey)                     # [C, N]
        Mw = (M * wgt[..., None]).transpose(1, 2)        # [C, 4, N]
        A = low(Mw @ M) + eye
        v = low((Mw @ rhs[..., None])[..., 0]) + LAMBDA * state
        n_in = ok.sum(dim=1)
        solved = low(torch.linalg.solve(A, v))
        state = torch.where((n_in >= MIN_INLIERS)[:, None], solved, state)
    a, b, tx, ty = state.unbind(1)
    return Pose(low(torch.rad2deg(torch.atan2(b, a))), low(torch.hypot(a, b)),
                tx, ty, n_in, n_in >= MIN_INLIERS)


def select(k, x, y, sc, n_coarse: int, top_c: int, cand_cap: int) -> tuple:
    """The candidates refined: the first `top_c` by a stable sort on the
    score, descending; past `cand_cap` coarse candidates, the first
    `top_c` of the sorted, de-duplicated match list (score descending,
    then template, x, y)."""
    if n_coarse <= cand_cap:
        order = torch.sort(sc, descending=True, stable=True).indices[:top_c]
        return k[order], x[order], y[order], sc[order]
    rows = sorted({(-s, int(kk), int(xx), int(yy)) for kk, xx, yy, s in zip(
        k.tolist(), x.tolist(), y.tolist(), sc.tolist())})[:top_c]
    d = k.device
    return (torch.tensor([r[1] for r in rows], dtype=torch.int64, device=d),
            torch.tensor([r[2] for r in rows], dtype=torch.int64, device=d),
            torch.tensor([r[3] for r in rows], dtype=torch.int64, device=d),
            torch.tensor([-r[0] for r in rows], dtype=torch.float32,
                         device=d))


def match_icp_frame(frame: torch.Tensor, banks: list, T_at_level,
                    weak_threshold: float, threshold: float, top_c: int,
                    iters: int, radius: int, cand_cap: int,
                    score_dtype=torch.float32,
                    pose_dtype=torch.float32) -> dict:
    """{(template_id, x, y, float32 score bits): (dtheta_deg, dscale, tx,
    ty, inliers, valid)} of one gray uint8 [H, W] frame."""
    k, x, y, sc, n_coarse = line2d.candidate_row(frame, banks, T_at_level,
                                                 weak_threshold, threshold,
                                                 score_dtype)
    k, x, y, sc = select(k, x, y, sc, n_coarse, top_c, cand_cap)
    if not k.numel():
        return {}
    bank0 = banks[0]
    pts = torch.stack([bank0.fx[k], bank0.fy[k]], dim=-1).to(torch.float32)
    origins = torch.stack([x, y], dim=-1).to(torch.float32)
    pose = icp(edge_field(frame, weak_threshold, radius), pts, origins,
               bank0.valid[k], iters, radius, pose_dtype)
    bits = sc.contiguous().view(torch.int32)
    keys = torch.stack([k, x, y, bits.to(torch.int64)], 1).tolist()
    fields = torch.stack([pose.dtheta_deg, pose.dscale, pose.tx, pose.ty,
                          pose.inliers.to(torch.float32),
                          pose.valid.to(torch.float32)], 1).tolist()
    out = {}
    for key, (dth, ds, tx, ty, n, v) in zip(keys, fields):
        out.setdefault(tuple(key), (dth, ds, tx, ty, int(n), bool(v)))
    return out
