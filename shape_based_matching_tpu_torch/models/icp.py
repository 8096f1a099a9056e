"""Subpixel sim2 pose refinement of LINE-2D matches: the edge field, the
jump flood and the batched point-to-plane ICP, in PyTorch.

The JAX package's ``models/icp.py``, op for op:

* **Edge field** (``edge_nearest_field``): the frontend's blur and Sobel,
  |grad|^2, a gradient-direction non-max suppression over the 8-way
  quantized direction (edges: local maxima along it, above the weak
  threshold), unit normals, and a parabola subpixel offset along that
  direction. A jump flood then gives every pixel the offset to its
  nearest edge pixel within `radius`. On the card the frontend is one
  launch and the flood one launch a stride (``ops/cuda/icp_field``,
  ``csrc/icp_field.cu``), bit for bit the plain twin
  ``edge_nearest_field_plain``, which the CPU runs.
* **ICP** (``icp_refine_points``): per candidate, 12 steps of a
  point-to-plane least squares that is linear in the sim2 parameters
  (a, b, tx, ty) = (s cos, s sin, t): one 4x4 solve per candidate and
  step. On the card all steps of all candidates are one launch of
  ``csrc/icp.cu``; on the CPU the plain twin batches them over the
  candidates.
* **Entry points**: ``refine_matches_icp`` (a list of ``Match`` es),
  ``match_icp`` (match and refine with one download), ``match_icp_async``
  (the same, returning before any device work finishes) and
  ``match_refine_batch`` (everything stays on the device).

The edge mask, the offsets and the within-radius mask are bit-exact to
JAX: the octant depends only on the integer (dx, dy) pair (no pair lies
within an ulp of a boundary; ``tests/test_torch_icp.py`` checks all of
them), and the flood's distances are exact integers in float32. Normals,
subpixel offsets and poses follow JAX to float32 rounding: XLA contracts
multiply-adds and sums in its own order.

Every function works on the device of its tensors, the detector's for
the entry points; nothing moves to the CPU but the results the host
reads, one download a call. A device-resident gray frame dispatches
``match_icp_async`` without waiting for the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.icp import icp_steps
from ..ops.cuda.icp_field import edge_field
from ..ops.filters import gaussian_blur7_u8, sobel3_i32
from ..ops.gradients import weak_threshold_sq
from ..utils.profiling import span
from ..utils.verify import bgr2gray_u8
from .detector import Match, _as_tensor

BIG = 1 << 20          # "no seed" coordinate of the jump flood
FAR = 1e18             # float32 distance of a pixel without a seed
QUARTER_PI = float(np.float32(math.pi / 4))
LAMBDA = 1e-3          # Tikhonov anchor of the ICP normal equations


class IcpResult(NamedTuple):
    """Refined pose per match: scene_pt = R(dtheta) * dscale * templ_pt +
    (tx, ty), templ_pt in the matched template's frame."""

    dtheta_deg: torch.Tensor  # [C] residual rotation (degrees, CCW)
    dscale: torch.Tensor      # [C] residual scale
    tx: torch.Tensor          # [C] refined template-origin x (subpixel)
    ty: torch.Tensor          # [C]
    rmse: torch.Tensor        # [C] point-to-plane RMS residual (px)
    inliers: torch.Tensor     # [C] int32 correspondences in the last step
    valid: torch.Tensor       # [C] bool: enough inliers to trust


def _strides(radius: int) -> list[int]:
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


def octant(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """round(atan2(dy, dx) / f32(pi/4)) mod 4 as int32 (floor modulo: an
    octant of -1 is 3): the 8-way gradient direction, folded to 4. The
    divisor is a device tensor (a CUDA division by a Python scalar
    multiplies by its reciprocal)."""
    q = torch.full((), QUARTER_PI, dtype=torch.float32, device=dx.device)
    return torch.remainder(torch.round(torch.atan2(dy, dx) / q).to(
        torch.int32), 4)


def _edge_frontend(src: torch.Tensor, weak_threshold: float):
    """uint8 [H, W] -> (edge [H, W] bool, normal [H, W, 2], subpix
    [H, W, 2] float32): JAX's ``_edge_frontend_impl``. The CPU route and
    the reference of ``csrc/icp_field.cu``'s frontend, which keeps this
    order of operations and these float32 constants."""
    smoothed = gaussian_blur7_u8(src)
    dx = sobel3_i32(smoothed, dx=True).to(torch.float32)
    dy = sobel3_i32(smoothed, dx=False).to(torch.float32)
    mag = dx * dx + dy * dy
    h, w = mag.shape
    o = octant(dx, dy).to(torch.int64)
    padm = F.pad(mag, (1, 1, 1, 1), value=-1.0)

    def shift(dr, dc):
        return padm[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    # the two neighbours along octant 0..3: (0, +-1), (+-1, +-1),
    # (+-1, 0), (+-1, -+1) as (row, column)
    fwd = torch.stack([shift(0, 1), shift(1, 1), shift(1, 0),
                       shift(1, -1)]).gather(0, o[None])[0]
    bwd = torch.stack([shift(0, -1), shift(-1, -1), shift(-1, 0),
                       shift(-1, 1)]).gather(0, o[None])[0]
    edge = (mag > weak_threshold_sq(weak_threshold)) & (mag >= fwd) & (
        mag >= bwd)

    inv = torch.sqrt(mag.clamp(min=1e-12))
    normal = torch.stack([dx / inv, dy / inv], dim=-1)

    # parabola through |g| along the quantized direction
    g0 = torch.sqrt(mag.clamp(min=0.0))
    gf = torch.sqrt(fwd.clamp(min=0.0))
    gb = torch.sqrt(bwd.clamp(min=0.0))
    denom = gb - 2.0 * g0 + gf
    delta = torch.where(denom.abs() > 1e-6, 0.5 * (gb - gf) / denom, 0.0)
    delta = delta.clamp(-0.5, 0.5)
    # unit step along octant 0..3: (1, 0) (1, 1) (0, 1) (-1, 1)
    step_x = torch.where(o == 2, 0.0, torch.where(o == 3, -1.0, 1.0))
    step_y = torch.where(o == 0, 0.0, 1.0)
    subpix = torch.stack([delta * step_x, delta * step_y], dim=-1)
    return edge, normal, subpix


def _jump_flood(edge: torch.Tensor, radius: int) -> torch.Tensor:
    """Nearest-seed field [2, H, W] int32 (seed row, seed column; BIG
    where none) by JAX's jump flood (``_jump_flood_impl``), in its order:
    per stride the current distances once, then the 8 neighbours at
    (dr, dc) in {-s, 0, s}^2, dr outer, each read from the seeds as the
    neighbours before it left them (Gauss-Seidel across neighbours,
    Jacobi within one), taken where strictly nearer (float32 distances).
    The seeds live inside one buffer padded with BIG by the largest
    stride, so a neighbour is a view of it.

    The CPU route and the reference of ``csrc/icp_field.cu``'s flood. The
    neighbours' row offsets are three -s, two 0 and three +s, and likewise
    the columns', so a pixel's seed after a stride depends only on the
    stride's input within +-3s on each axis: the kernel runs a stride as
    tiles that each stage a 3s halo (BIG outside the frame) and write to
    another buffer, which gives these seeds bit for bit."""
    h, w = edge.shape
    dev = edge.device
    strides = _strides(radius)
    P = strides[0]
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    buf = torch.full((2, h + 2 * P, w + 2 * P), BIG, dtype=torch.int32,
                     device=dev)
    seed = buf[:, P:P + h, P:P + w]
    seed[0] = torch.where(edge, rows, BIG)
    seed[1] = torch.where(edge, cols, BIG)

    def dist2(s):
        dr = (s[0] - rows).to(torch.float32)
        dc = (s[1] - cols).to(torch.float32)
        return torch.where(s[0] >= BIG, FAR, dr * dr + dc * dc)

    for s in strides:
        best = dist2(seed)
        for dr in (-s, 0, s):
            for dc in (-s, 0, s):
                if dr == 0 and dc == 0:
                    continue
                cand = buf[:, P + dr:P + dr + h, P + dc:P + dc + w]
                d = dist2(cand)
                take = d < best
                best = torch.where(take, d, best)
                seed.copy_(torch.where(take, cand, seed))
    return seed


def _flood_epilogue(seed: torch.Tensor, radius: int):
    """Seed planes -> (offset to the nearest seed [H, W, 2] int32 as (dx,
    dy), within-radius mask [H, W])."""
    _, h, w = seed.shape
    dev = seed.device
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    sr, sc = seed[0], seed[1]
    off = torch.stack([torch.where(sc >= BIG, 0, sc - cols),
                       torch.where(sr >= BIG, 0, sr - rows)],
                      dim=-1).to(torch.int32)
    has = (sr < BIG) & (off[..., 0].abs() <= radius) & (
        off[..., 1].abs() <= radius)
    return off, has


def edge_nearest_field(src: torch.Tensor, weak_threshold: float,
                       radius: int = 8):
    """Scene edge field of a uint8 [H, W] frame for ICP: (off [H, W, 2]
    int32 offset (dx, dy) to the nearest edge pixel, normal [H, W, 2]
    float32 unit gradient, edge [H, W] bool, has [H, W] bool (an edge
    within `radius` on both axes), subpix [H, W, 2] float32 subpixel
    shift of each edge pixel along its quantized direction).

    On the card ``csrc/icp_field.cu`` (``ops/cuda/icp_field.edge_field``:
    1 + len(strides) launches up to radius 8); on the CPU the plain twin
    ``edge_nearest_field_plain``. The span's ``route`` says which
    ("kernel" / "plain"). Raises ValueError, on either route, for a frame
    that is not uint8 [H, W] or whose seed coordinates or radius reach
    BIG."""
    if src.dtype != torch.uint8 or src.dim() != 2:
        raise ValueError(f"expected a uint8 [H, W] frame, got {src.dtype} "
                         f"{tuple(src.shape)}")
    H, W = src.shape
    if not (0 < H < BIG and 0 < W < BIG) or radius > BIG:
        raise ValueError(f"a {W}x{H} frame at radius {radius} is outside "
                         f"the field's seed coordinates (below {BIG})")
    route = "kernel" if src.device.type == "cuda" else "plain"
    # strides: len(_strides(radius)), without building the list
    with span("sbm.icp.field", route=route, H=H, W=W,
              strides=max(radius - 1, 0).bit_length() + 1):
        return edge_field(src, weak_threshold, radius)


def edge_nearest_field_plain(src: torch.Tensor, weak_threshold: float,
                             radius: int = 8):
    """Plain twin of ``edge_nearest_field`` in torch ops: ``_edge_frontend``,
    ``_jump_flood``, ``_flood_epilogue``."""
    edge, normal, subpix = _edge_frontend(src, weak_threshold)
    off, has = _flood_epilogue(_jump_flood(edge, radius), radius)
    return off, normal, edge, has, subpix


def solve_batched(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched A x = v ([C, n, n], [C, n]) without a host read of the
    factorization's info (``torch.linalg.solve`` checks it, a sync)."""
    return torch.linalg.solve_ex(A, v[..., None],
                                 check_errors=False).result[..., 0]


def icp_refine_points(off, normal, has, subpix, pts: torch.Tensor,
                      origins: torch.Tensor, pt_valid: torch.Tensor,
                      iters: int = 12, radius: int = 8,
                      min_inliers: int = 8) -> IcpResult:
    """Batched sim2 point-to-plane ICP (JAX's ``_icp_refine_points_impl``).

    off/normal/has/subpix: the ``edge_nearest_field`` outputs. pts [C, N,
    2] float32 template points (template frame); origins [C, 2] float32
    initial origins in the scene (the LINE-2D match); pt_valid [C, N]
    bool. Each step moves a point to its rounded scene pixel, follows the
    field to the nearest edge (lookups clip to the frame), drops
    correspondences farther than `radius`, and solves the normal
    equations with the anchor A + 1e-3 I, v + 1e-3 state; a candidate
    with fewer than `min_inliers` keeps its state. rmse and inliers are
    the last step's, after that choice.

    On the card every step of every candidate is one launch
    (``ops/cuda/icp.icp_steps``, ``csrc/icp.cu``); on the CPU it runs the
    plain twin ``icp_refine_points_plain``. The span's ``route`` says
    which ("kernel" / "plain")."""
    route = "kernel" if pts.device.type == "cuda" else "plain"
    with span("sbm.icp.steps", route=route, C=pts.shape[0], N=pts.shape[1],
              iters=iters):
        return IcpResult(*icp_steps(off, normal, has, subpix, pts, origins,
                                    pt_valid, iters, radius, min_inliers))


def icp_refine_points_plain(off, normal, has, subpix, pts: torch.Tensor,
                            origins: torch.Tensor, pt_valid: torch.Tensor,
                            iters: int = 12, radius: int = 8,
                            min_inliers: int = 8) -> IcpResult:
    """Plain twin of ``icp_refine_points`` in torch ops: a Python loop over
    the steps, each a batch of elementwise ops, gathers, three bmm and a
    batched ``solve_batched`` over the candidates."""
    h, w = has.shape
    C = pts.shape[0]
    dev = pts.device
    px, py = pts[..., 0], pts[..., 1]
    off_f = off.reshape(-1, 2)
    has_f = has.reshape(-1)
    normal_f = normal.reshape(-1, 2)
    sub_f = subpix.reshape(-1, 2)
    eye = torch.eye(4, dtype=torch.float32, device=dev) * LAMBDA

    def flat(yy, xx):
        return yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)

    state = torch.stack([torch.ones(C, device=dev),
                         torch.zeros(C, device=dev),
                         origins[:, 0], origins[:, 1]], dim=1)
    rmse = torch.zeros(C, device=dev)
    n_in = torch.zeros(C, dtype=torch.int64, device=dev)
    for _ in range(iters):
        a, b, tx, ty = (t[:, None] for t in state.unbind(1))
        qx = a * px - b * py + tx
        qy = b * px + a * py + ty
        ix = torch.round(qx).to(torch.int32)
        iy = torch.round(qy).to(torch.int32)
        i = flat(iy, ix)
        o = off_f[i]
        ok = has_f[i] & pt_valid
        ei = ix + o[..., 0]
        ej = iy + o[..., 1]
        j = flat(ej, ei)
        n = normal_f[j]
        sp = sub_f[j]
        ex = ei.to(torch.float32) + sp[..., 0]
        ey = ej.to(torch.float32) + sp[..., 1]
        ddx, ddy = qx - ex, qy - ey
        ok = ok & (ddx * ddx + ddy * ddy <= float(radius * radius))
        wgt = ok.to(torch.float32)
        nx, ny = n[..., 0], n[..., 1]
        M = torch.stack([nx * px + ny * py, -nx * py + ny * px, nx, ny],
                        dim=-1)                       # [C, N, 4]
        rhs = nx * ex + ny * ey                       # [C, N]
        Mw = (M * wgt[..., None]).transpose(1, 2)     # [C, 4, N]
        A = Mw @ M + eye
        v = (Mw @ rhs[..., None])[..., 0] + LAMBDA * state
        n_in = ok.sum(dim=1)
        new = torch.where((n_in >= min_inliers)[:, None],
                          solve_batched(A, v), state)
        r = ((M @ new[..., None])[..., 0] - rhs) * wgt
        rmse = torch.sqrt((r * r).sum(dim=1)
                          / n_in.clamp(min=1).to(torch.float32))
        state = new
    a, b, tx, ty = state.unbind(1)
    return IcpResult(torch.rad2deg(torch.atan2(b, a)), torch.hypot(a, b),
                     tx, ty, rmse, n_in.to(torch.int32),
                     n_in >= min_inliers)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """The one device-to-host transfer of a refine call."""
    return t.cpu().numpy()


def _pack_icp_result(res: IcpResult) -> torch.Tensor:
    """The 7 per-match fields as one [7, C] float32 tensor (inliers, an
    int32 count <= 8191, is exact in float32)."""
    return torch.stack([res.dtheta_deg, res.dscale, res.tx, res.ty,
                        res.rmse, res.inliers.to(torch.float32),
                        res.valid.to(torch.float32)])


def _template_icp_points(detector, class_id: str,
                         template_id: int) -> np.ndarray:
    """Level-0 feature (x, y) of one template as a [n, 2] float32 array,
    cached on the detector under (class_id, template_id); retraining the
    class drops its entries (``Detector._invalidate``)."""
    key = (class_id, template_id)
    pts = detector._icp_pts.get(key)
    if pts is None:
        feats = detector.get_templates(class_id, template_id)[0].features
        pts = np.array([(f.x, f.y) for f in feats],
                       np.float32).reshape(-1, 2)
        detector._icp_pts[key] = pts
    return pts


def _gray_source(detector, source) -> torch.Tensor:
    """A gray [H, W] or BGR [H, W, 3] uint8 frame (numpy or a tensor) as a
    gray [H, W] tensor on the detector's device."""
    src = _as_tensor(source).to(detector.device)
    if src.dim() == 3:
        src = bgr2gray_u8(src)
    return src.contiguous()


def refine_matches_icp(detector, source, matches, iters: int = 12,
                       radius: int = 8) -> list[dict]:
    """sim2-refine a list of LINE-2D Matches against `source` (gray [H, W]
    or BGR [H, W, 3] uint8, numpy or a tensor). Returns one dict a match
    ({match, dtheta_deg, dscale, tx, ty, rmse, inliers, valid}); the
    refined subpixel template origin is (tx, ty), and the total pose
    composes the template's trained angle and scale with (dtheta, dscale).
    One download."""
    if not matches:
        return []
    src = _gray_source(detector, source)
    off, normal, _edge, has, subpix = edge_nearest_field(
        src, detector.weak_threshold, radius)
    plist = [_template_icp_points(detector, m.class_id, m.template_id)
             for m in matches]
    N = max(p.shape[0] for p in plist)
    C = len(matches)
    pts = np.zeros((C, N, 2), np.float32)
    pv = np.zeros((C, N), bool)
    for i, p in enumerate(plist):
        pts[i, :p.shape[0]] = p
        pv[i, :p.shape[0]] = True
    origins = np.array([(m.x, m.y) for m in matches], np.float32)
    dev = detector.device
    res = icp_refine_points(off, normal, has, subpix,
                            torch.from_numpy(pts).to(dev),
                            torch.from_numpy(origins).to(dev),
                            torch.from_numpy(pv).to(dev), iters=iters,
                            radius=radius)
    host = _to_host(_pack_icp_result(res))
    return [{"match": m, "dtheta_deg": float(host[0, i]),
             "dscale": float(host[1, i]), "tx": float(host[2, i]),
             "ty": float(host[3, i]), "rmse": float(host[4, i]),
             "inliers": int(host[5, i]), "valid": bool(host[6, i])}
            for i, m in enumerate(matches)]


def refine_packed_candidates(off, normal, has, subpix, bank_fx, bank_fy,
                             bank_valid, k, x, y, sc, valid,
                             top_c: int = 32, iters: int = 12,
                             radius: int = 8, min_inliers: int = 8):
    """Candidate selection and ICP for ONE frame's ``match_batch(...,
    as_matches=False)`` row (k, x, y, sc, valid each [C]), on the device.

    The top_c best valid candidates in ``lax.top_k``'s order (score
    descending, the lower index first among equal scores: a stable sort),
    their level-0 points gathered from the bank ([K, N] fx, fy, valid),
    refined. Returns (IcpResult [top_c], kk template ids, ox, oy integer
    origins, top_sc scores); rows past the valid candidates have
    valid=False and score -inf."""
    score = torch.where(valid, sc, -math.inf)
    top_sc, idx = torch.sort(score, descending=True, stable=True)
    top_sc, idx = top_sc[:top_c], idx[:top_c]
    live = torch.isfinite(top_sc)
    kk = k[idx]
    pts = torch.stack([bank_fx[kk], bank_fy[kk]], dim=-1).to(torch.float32)
    pv = bank_valid[kk] & live[:, None]
    ox, oy = x[idx], y[idx]
    origins = torch.stack([ox, oy], dim=-1).to(torch.float32)
    res = icp_refine_points(off, normal, has, subpix, pts, origins, pv,
                            iters=iters, radius=radius,
                            min_inliers=min_inliers)
    return res._replace(valid=res.valid & live), kk, ox, oy, top_sc


def _pack_refined(res: IcpResult, kk, ox, oy, sc, overflow) -> torch.Tensor:
    """One class's refined candidates as [13, top_c] float32 rows: the 7
    IcpResult fields, template id, origin x, origin y, the LINE-2D score
    (-1 where dead), a live flag and the class's overflow flag (ids and
    pixel origins are exact in float32)."""
    live = torch.isfinite(sc)
    return torch.cat([
        _pack_icp_result(res),
        torch.stack([kk.to(torch.float32), ox.to(torch.float32),
                     oy.to(torch.float32), torch.where(live, sc, -1.0),
                     live.to(torch.float32),
                     overflow.to(torch.float32).expand(kk.shape)])])


def _match_icp_dispatch(detector, source, threshold: float, class_ids,
                        top_c: int, iters: int, radius: int, cand_cap: int):
    """Enqueue a frame's match, edge field, per-class refines and packing.
    Returns (source on the device, class ids, the [n_cls, 13, top_c]
    device tensor or None when no class is trained)."""
    src = _as_tensor(source)
    if src.dim() != 2:
        raise ValueError("match_icp expects a gray [H, W] frame")
    src = src.to(detector.device)
    packed = detector.match_batch(src[None], threshold, class_ids,
                                  cand_cap=cand_cap, as_matches=False)
    if not packed:
        return src, [], None
    off, normal, _edge, has, subpix = edge_nearest_field(
        src, detector.weak_threshold, radius)
    rows = []
    for cid, (k, x, y, sc, valid, overflow) in packed.items():
        bank0 = detector._get_banks(cid)[0]
        res, kk, ox, oy, top_sc = refine_packed_candidates(
            off, normal, has, subpix, bank0.fx, bank0.fy, bank0.valid,
            k[0], x[0], y[0], sc[0], valid[0], top_c=top_c, iters=iters,
            radius=radius)
        rows.append(_pack_refined(res, kk, ox, oy, top_sc, overflow[0]))
    return src, list(packed), torch.stack(rows)


def _match_icp_collect(detector, source, cids, dev, threshold: float,
                       top_c: int, iters: int, radius: int) -> list[dict]:
    """The one download and the host decode: Matches, the overflow
    fallback (``match`` then ``refine_matches_icp`` of its first top_c)
    for a class past the cap, duplicates dropped, sorted by
    ``Match.sort_key``."""
    if not cids:
        return []
    host = _to_host(dev)
    out = []
    for ci, cid in enumerate(cids):
        if host[ci, 12, 0] >= 0.5:
            matches = detector.match(source, threshold, [cid])
            out.extend(refine_matches_icp(detector, source, matches[:top_c],
                                          iters=iters, radius=radius))
            continue
        seen = set()
        for j in range(host.shape[2]):
            if host[ci, 11, j] < 0.5:
                continue  # dead slot: fewer than top_c candidates
            m = Match(int(host[ci, 8, j]), int(host[ci, 9, j]),
                      float(host[ci, 10, j]), cid, int(host[ci, 7, j]))
            key = (m.x, m.y, m.similarity, m.class_id, m.template_id)
            if key in seen:
                continue
            seen.add(key)
            out.append({"match": m, "dtheta_deg": float(host[ci, 0, j]),
                        "dscale": float(host[ci, 1, j]),
                        "tx": float(host[ci, 2, j]),
                        "ty": float(host[ci, 3, j]),
                        "rmse": float(host[ci, 4, j]),
                        "inliers": int(host[ci, 5, j]),
                        "valid": bool(host[ci, 6, j] >= 0.5)})
    out.sort(key=lambda d: d["match"].sort_key())
    return out


def match_icp(detector, source, threshold: float, class_ids=None,
              top_c: int = 32, iters: int = 12, radius: int = 8,
              cand_cap: int = 256) -> list[dict]:
    """Match a gray [H, W] frame and sim2-refine, per class, its top_c
    best candidates, with ONE download: the ``refine_matches_icp``
    schema, sorted by (similarity descending, template id). A class whose
    candidates overflow `cand_cap` takes the two-download path
    (``match``, then ``refine_matches_icp`` of its first top_c)."""
    src, cids, dev = _match_icp_dispatch(detector, source, threshold,
                                         class_ids, top_c, iters, radius,
                                         cand_cap)
    return _match_icp_collect(detector, src, cids, dev, threshold, top_c,
                              iters, radius)


class MatchIcpHandle:
    """A ``match_icp`` in flight: its device work is queued; ``result()``
    makes the one download and the host decode (memoized)."""

    __slots__ = ("_detector", "_source", "_cids", "_dev", "_args",
                 "_result")

    def __init__(self, detector, source, cids, dev, args):
        self._detector = detector
        self._source = source
        self._cids = cids
        self._dev = dev
        self._args = args
        self._result = None

    def result(self) -> list[dict]:
        """The ``match_icp`` list (memoized; frees the handle's tensors)."""
        if self._result is None:
            threshold, top_c, iters, radius = self._args
            self._result = _match_icp_collect(
                self._detector, self._source, self._cids, self._dev,
                threshold, top_c, iters, radius)
            self._detector = self._source = self._dev = None
        return self._result


def match_icp_async(detector, source, threshold: float, class_ids=None,
                    top_c: int = 32, iters: int = 12, radius: int = 8,
                    cand_cap: int = 256) -> MatchIcpHandle:
    """``match_icp`` without waiting: queue the frame's device work and
    return a ``MatchIcpHandle``. A streaming loop dispatches frame N+1
    before it reads frame N's ``result()``, so the card computes while
    the host decodes. With a device-resident frame the dispatch reads
    nothing back from the card."""
    src, cids, dev = _match_icp_dispatch(detector, source, threshold,
                                         class_ids, top_c, iters, radius,
                                         cand_cap)
    return MatchIcpHandle(detector, src, cids, dev,
                          (threshold, top_c, iters, radius))


def match_refine_batch(detector, frames, threshold: float, class_ids=None,
                       top_c: int = 32, iters: int = 12, radius: int = 8,
                       cand_cap: int = 256) -> dict:
    """Match and refine B gray frames ([B, H, W] uint8) on the device, with
    no download: {class_id: [{icp: IcpResult, k, x, y, score, overflow}
    per frame]} of device tensors (``refine_packed_candidates``'s
    outputs). Frames are the outer loop, so one edge field is live at a
    time; a frame that overflows `cand_cap` is flagged, not re-run."""
    frames = _as_tensor(frames)
    if frames.dim() != 3:
        raise ValueError("match_refine_batch expects gray [B, H, W] frames")
    frames = frames.to(detector.device)
    packed = detector.match_batch(frames, threshold, class_ids,
                                  cand_cap=cand_cap, as_matches=False)
    banks0 = {cid: detector._get_banks(cid)[0] for cid in packed}
    return refine_frames(frames, detector.weak_threshold, packed, banks0,
                         top_c, iters, radius)


def refine_frames(frames: torch.Tensor, weak_threshold: float, packed: dict,
                  banks0: dict, top_c: int, iters: int, radius: int) -> dict:
    """The refine half of ``match_refine_batch``: B gray frames [B, H, W]
    on the device, each class's packed candidates ``packed[cid] = (k, x,
    y, score, valid, overflow)`` ([B, C] tensors, overflow [B]) and its
    level-0 bank ``banks0[cid]`` -> {class_id: [{icp, k, x, y, score,
    overflow} per frame]}. Frames are the outer loop, so one edge field is
    live at a time. The mesh's production tier
    (``parallel/mesh._local_refine``) runs it on each shard's frames."""
    out = {cid: [] for cid in packed}
    for b in range(frames.shape[0]):
        off, normal, _edge, has, subpix = edge_nearest_field(
            frames[b].contiguous(), weak_threshold, radius)
        for cid, (k, x, y, sc, valid, overflow) in packed.items():
            bank0 = banks0[cid]
            res, kk, ox, oy, top_sc = refine_packed_candidates(
                off, normal, has, subpix, bank0.fx, bank0.fy, bank0.valid,
                k[b], x[b], y[b], sc[b], valid[b], top_c=top_c, iters=iters,
                radius=radius)
            out[cid].append({"icp": res, "k": kk, "x": ox, "y": oy,
                             "score": top_sc, "overflow": overflow[b]})
    return out
