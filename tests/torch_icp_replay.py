"""``csrc/icp.cu`` replayed in NumPy, and the scenes its tests refine.

``replay`` follows the kernel's arithmetic from its source's constants:
the per-point values in the plain path's order, A's running fused
multiply-adds in point order, v's lanes of runs and their shfl_down fold,
the solve as cuBLAS's getrf and getrs, rmse's per-thread sums and folds,
one IEEE float32 rounding per operation throughout. It imports neither
JAX nor the JAX package, so the card tests compare the kernel with it bit
for bit.
"""

import os
import re

import numpy as np
import torch

from shape_based_matching_tpu_torch.models import icp
from shape_based_matching_tpu_torch.utils import synthetic

from .torch_csrc import CSRC, constants

F32 = np.float32
K = constants("icp.cu")


def _float_constant(name: str) -> np.float32:
    with open(os.path.join(CSRC, "icp.cu")) as f:
        m = re.search(rf"^constexpr float {name} = ([^;]+?)f;", f.read(),
                      re.M)
    return F32(float(m.group(1)))


LAMBDA = _float_constant("LAMBDA")
RAD2DEG = _float_constant("RAD2DEG")
# A's distinct entries in the kernel's order of sums, then v's
SUM_ENTRIES = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3),
               (2, 2), (2, 3), (3, 3)]


def _correspond(field, s, px, py, pv, r2):
    """The kernel's ``correspond`` for every point: (M [4, C, N], rhs, ok)."""
    off, normal, has, subpix = field
    H, W = has.shape
    a, b, tx, ty = (s[:, k:k + 1] for k in range(4))
    qx = (a * px - b * py) + tx
    qy = (b * px + a * py) + ty
    ix = np.rint(qx).astype(np.int32)
    iy = np.rint(qy).astype(np.int32)

    def flat(y, x):
        return np.clip(y, 0, H - 1).astype(np.int64) * W + np.clip(x, 0, W - 1)

    i = flat(iy, ix)
    o = off.reshape(-1, 2)[i]
    ei, ej = ix + o[..., 0], iy + o[..., 1]
    j = flat(ej, ei)
    n = normal.reshape(-1, 2)[j]
    sp = subpix.reshape(-1, 2)[j]
    ex = ei.astype(F32) + sp[..., 0]
    ey = ej.astype(F32) + sp[..., 1]
    ddx, ddy = qx - ex, qy - ey
    ok = pv & has.reshape(-1)[i] & (ddx * ddx + ddy * ddy <= r2)
    nx, ny = n[..., 0], n[..., 1]
    M = np.stack([nx * px + ny * py, (-nx) * py + ny * px, nx, ny])
    return M, nx * ex + ny * ey, ok


def fma(a, b, c):
    """float32 a * b + c rounded once: the product is exact in the 64-bit
    significand of np.longdouble, and so is the sum wherever the two
    differ in exponent by under 40 (every sum here)."""
    ld = np.longdouble
    return (np.asarray(a, ld) * np.asarray(b, ld) + np.asarray(c, ld)).astype(
        F32)


def _count_sums(Mw, M, rhs):
    """A's 10 distinct entries [10, C], one running fused multiply-add a
    point in point order, and v [4, C], GEMV_LANES lanes of runs of
    GEMV_RUN points, folded by shfl_down."""
    _, C, N = M.shape
    rows = Mw[[r for r, _ in SUM_ENTRIES]].astype(np.longdouble)
    cols = M[[c for _, c in SUM_ENTRIES]].astype(np.longdouble)
    a = np.zeros((10, C), F32)
    for k in range(N):
        a = fma(rows[..., k], cols[..., k], a)
    lanes, run = K["GEMV_LANES"], K["GEMV_RUN"]
    part = np.zeros((4, C, lanes), F32)
    for k in range(N):
        lane = (k // run) % lanes
        part[..., lane] = fma(Mw[:, :, k], rhs[:, k], part[..., lane])
    d = lanes // 2
    while d >= 1:
        part[..., :d] = part[..., :d] + part[..., d:2 * d]
        d //= 2
    return a, part[..., 0]


def _warp_tree_sum(x):
    """[C, N] float32 terms -> [C]: per-thread running sums over the
    points a thread strides to, warp folds, warps in order (rmse)."""
    C, N = x.shape
    T, WARP = K["ICP_THREADS"], K["ICP_WARP"]
    rows = -(-N // T)
    pad = np.zeros((C, rows * T), F32)  # +0 terms leave a sum as it is
    pad[:, :N] = x
    part = np.zeros((C, T), F32)
    for r in range(rows):
        part = part + pad[:, r * T:(r + 1) * T]
    v = part.reshape(C, K["ICP_WARPS"], WARP)
    d = WARP // 2
    while d >= 1:
        v[..., :d] = v[..., :d] + v[..., d:2 * d]
        d //= 2
    tot = v[:, 0, 0].copy()
    for w in range(1, K["ICP_WARPS"]):
        tot = tot + v[:, w, 0]
    return tot


def _solve4(m, b):
    """The kernel's ``solve4`` (cuBLAS's getrf and getrs) on [C, 4, 4]
    systems and [C, 4] right-hand sides."""
    m, b = m.copy(), b.copy()
    rows = np.arange(m.shape[0])
    piv = []
    for j in range(4):
        p = j + np.argmax(np.abs(m[:, j:, j]), axis=1)  # first largest
        piv.append(p)
        top, low = m[rows, j].copy(), m[rows, p].copy()
        m[rows, j], m[rows, p] = low, top
        rc = F32(1) / m[:, j, j]
        m[:, j + 1:, j] = m[:, j + 1:, j] * rc[:, None]
        for i in range(j + 1, 4):
            m[:, i, j + 1:] = fma(-m[:, i, j:j + 1], m[:, j, j + 1:],
                                  m[:, i, j + 1:])
    for j, p in enumerate(piv):
        top, low = b[rows, j].copy(), b[rows, p].copy()
        b[rows, j], b[rows, p] = low, top
    for j in range(4):
        for i in range(j + 1, 4):
            b[:, i] = fma(-m[:, i, j], b[:, j], b[:, i])
    for j in range(3, -1, -1):
        b[:, j] = b[:, j] / m[:, j, j]
        for i in range(j):
            b[:, i] = fma(-m[:, i, j], b[:, j], b[:, i])
    return b


def replay(off, normal, has, subpix, pts, origins, pt_valid, iters: int = 12,
           radius: int = 8, min_inliers: int = 8) -> tuple:
    """NumPy arrays (``icp_steps``'s inputs) -> its outputs (dtheta_deg,
    dscale, tx, ty, rmse, inliers, valid) as the kernel computes them."""
    field = (off, normal, has, subpix)
    px, py = pts[..., 0], pts[..., 1]
    C = pts.shape[0]
    r2 = F32(radius * radius)
    s = np.stack([np.ones(C, F32), np.zeros(C, F32), origins[:, 0],
                  origins[:, 1]], axis=1).astype(F32)
    prev, n_in = s, np.zeros(C, np.int64)
    for _ in range(iters):
        M, rhs, ok = _correspond(field, s, px, py, pt_valid, r2)
        a, v = _count_sums(M * ok.astype(F32), M, rhs)
        m = np.zeros((C, 4, 4), F32)
        for e, (r, c) in enumerate(SUM_ENTRIES):
            m[:, r, c] = m[:, c, r] = a[e] + (LAMBDA if r == c else F32(0))
        b = (v + LAMBDA * s.T).T
        n_in = ok.sum(axis=1)
        prev, s = s, np.where((n_in >= min_inliers)[:, None], _solve4(m, b),
                              s)
    sq = np.zeros(C, F32)
    if iters:
        M, rhs, ok = _correspond(field, prev, px, py, pt_valid, r2)
        dot = M[0] * s[:, :1]
        for k in range(1, 4):
            dot = dot + M[k] * s[:, k:k + 1]
        r = (dot - rhs) * ok.astype(F32)
        sq = _warp_tree_sum(r * r)
    rmse = np.sqrt(sq / np.maximum(n_in, 1).astype(F32))
    return (np.arctan2(s[:, 1], s[:, 0]) * RAD2DEG, np.hypot(s[:, 0], s[:, 1]),
            s[:, 2], s[:, 3], rmse, n_in.astype(np.int32),
            n_in >= min_inliers)


def replay_torch(off, normal, has, subpix, pts, origins, pt_valid,
                 **kw) -> tuple:
    """``replay`` of torch tensors (on any device)."""
    return replay(*(t.cpu().numpy() for t in (off, normal, has, subpix, pts,
                                              origins, pt_valid)), **kw)


def scene_case(C: int, N: int, seed: int, device="cpu"):
    """Instances of the synthetic shape pasted into a 192 x 256 frame, and
    C candidates of N of its edge pixels each at an instance's corner
    moved by up to 3 px, a tenth of the points dead: (field of
    ``edge_nearest_field``, pts, origins, pt_valid) on `device`."""
    rng = np.random.RandomState(seed)
    templ = synthetic.synthetic_shape_image(96, seed % 4)
    frame = np.full((192, 256), 10, np.uint8)
    tops = [(8, 12), (140, 20), (70, 90)]
    for x, y in tops:
        frame[y:y + 96, x:x + 96] = np.maximum(frame[y:y + 96, x:x + 96],
                                               templ)
    edge = icp.edge_nearest_field(torch.from_numpy(templ), 30.0, 8)[2]
    ys, xs = np.nonzero(edge.numpy())
    pick = np.stack([rng.choice(len(xs), N, replace=len(xs) < N)
                     for _ in range(C)])
    pts = np.stack([xs[pick], ys[pick]], axis=-1).astype(np.float32)
    corner = np.array(tops, np.float32)[np.arange(C) % len(tops)]
    origins = (corner + rng.randint(-3, 4, (C, 2))).astype(np.float32)
    pv = rng.rand(C, N) < 0.9
    field = icp.edge_nearest_field(torch.from_numpy(frame).to(device), 30.0,
                                   8)
    return ((field[0], field[1], field[3], field[4]),
            *(torch.from_numpy(a).to(device) for a in (pts, origins, pv)))
