"""The plain reference of a frame's match, vectorised in plain PyTorch.

The same arithmetic as the frozen scalar oracle (``oracle_np.py``:
``build_lm_pyramid`` and ``match_class``, which follow line2Dup.cpp), with
the loops over pixels, templates and candidates turned into tensor
operations so that it runs over a 10,000-template bank in well under a
second a frame on the card, in blocks of templates and of candidates.
Gray frames, 8 orientations. It imports torch only: nothing of the program
under test, and it takes nothing the program made; the bank it matches is
the reference's own (``training.py``).

Every step is exact integer arithmetic except the score, which is the
C++'s float32 ``(raw * 100.f) / (4 * nfeat)``: a product by a scalar and
an IEEE division by a tensor (a division by a Python scalar would
multiply by its reciprocal on the card). ``score_dtype=torch.bfloat16``
computes the score in bfloat16 instead: the control that a comparison
with this reference must fail.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_GAUSS7_Q8 = (8, 28, 56, 72, 56, 28, 8)
_PYR5 = (1, 4, 6, 4, 1)
CAND_BLOCK = 512      # candidates refined at once
TEMPLATE_BLOCK = 1024  # templates scored at once


class Bank(NamedTuple):
    """One pyramid level of a bank, padded to N feature slots."""

    fx: torch.Tensor      # [K, N] int64
    fy: torch.Tensor      # [K, N] int64
    label: torch.Tensor   # [K, N] int64
    valid: torch.Tensor   # [K, N] bool
    nfeat: torch.Tensor   # [K] int64
    width: torch.Tensor   # [K] int64
    height: torch.Tensor  # [K] int64


def pack_bank(level_templates: list, device) -> Bank:
    """Per-template dicts {'features': [(x, y, label)], 'width',
    'height'} of one level as a padded Bank on `device`."""
    K = len(level_templates)
    N = max(1, max(len(t["features"]) for t in level_templates))
    fx = torch.zeros((K, N), dtype=torch.int64)
    fy = torch.zeros((K, N), dtype=torch.int64)
    lb = torch.zeros((K, N), dtype=torch.int64)
    va = torch.zeros((K, N), dtype=torch.bool)
    for k, t in enumerate(level_templates):
        f = torch.tensor([tuple(v)[:3] for v in t["features"]],
                         dtype=torch.int64).reshape(-1, 3)
        n = f.shape[0]
        fx[k, :n], fy[k, :n], lb[k, :n] = f[:, 0], f[:, 1], f[:, 2]
        va[k, :n] = True
    nf = va.sum(1)
    wh = torch.tensor([(t["width"], t["height"]) for t in level_templates],
                      dtype=torch.int64).reshape(-1, 2)
    return Bank(*(a.to(device) for a in (fx, fy, lb, va, nf, wh[:, 0],
                                         wh[:, 1])))


# ---------------------------------------------------------------------------
# Frontend (oracle_np: gaussian_blur7_u8 ... linearize)
# ---------------------------------------------------------------------------

def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of a row of n padded by lo and hi with its edge values."""
    return torch.arange(-lo, n + hi, device=device).clamp(0, n - 1)


def _reflect_index(n: int, p: int, device) -> torch.Tensor:
    """Indices of a row of n padded by p on each side, reflected about the
    edge pixels (numpy's 'reflect', OpenCV's BORDER_REFLECT_101)."""
    i = torch.arange(-p, n + p, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _separable(x: torch.Tensor, taps, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """The separable filter of integer `taps` over int64 [h, w] `x`,
    padded through the index rows `rows` and `cols` (horizontal pass,
    then vertical)."""
    h, w = x.shape
    p = x[rows][:, cols]
    hs = sum(t * p[:, i:i + w] for i, t in enumerate(taps))
    return sum(t * hs[i:i + h] for i, t in enumerate(taps))


def gaussian_blur7_u8(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    d = img.device
    vs = _separable(img.to(torch.int64), _GAUSS7_Q8, _edge_index(h, 3, 3, d),
                    _edge_index(w, 3, 3, d))
    return ((vs + (1 << 15)) >> 16).to(torch.uint8)


def pyr_down_u8(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    d = img.device
    vs = _separable(img.to(torch.int64), _PYR5, _reflect_index(h, 2, d),
                    _reflect_index(w, 2, d))
    full = (vs + 128) >> 8
    return full[:2 * (h // 2):2, :2 * (w // 2):2].to(torch.uint8)


def sobel3(img: torch.Tensor) -> tuple:
    """(dx, dy) int64 of the 3x3 Sobel with replicated edges."""
    h, w = img.shape
    d = img.device
    p = img.to(torch.int64)[_edge_index(h, 1, 1, d)][:, _edge_index(w, 1, 1,
                                                                     d)]
    v = p[0:h] + 2 * p[1:h + 1] + p[2:h + 2]
    dx = v[:, 2:w + 2] - v[:, 0:w]
    hz = p[:, 0:w] + 2 * p[:, 1:w + 1] + p[:, 2:w + 2]
    dy = hz[2:h + 2] - hz[0:h]
    return dx, dy


def fast_atan2_deg(dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2 in float32, one IEEE operation at a time."""
    f = torch.float32
    d = dx.device

    def c_(v):
        return torch.tensor(v, dtype=f, device=d)

    P1 = c_(0.9997878412794807 * (180.0 / math.pi))
    P3 = c_(-0.3258083974640975 * (180.0 / math.pi))
    P5 = c_(0.1555786518463281 * (180.0 / math.pi))
    P7 = c_(-0.04432655554792128 * (180.0 / math.pi))
    EPS = c_(2.220446049250313e-16)
    x, y = dx.to(f), dy.to(f)
    ax, ay = x.abs(), y.abs()
    c = torch.where(ax >= ay, ay / (ax + EPS), ax / (ay + EPS))
    c2 = c * c
    a = (((P7 * c2 + P5) * c2 + P3) * c2 + P1) * c
    a = torch.where(ax < ay, c_(90.0) - a, a)
    a = torch.where(x < 0, c_(180.0) - a, a)
    return torch.where(y < 0, c_(360.0) - a, a)


def quantize(img: torch.Tensor, weak_threshold: float) -> torch.Tensor:
    """uint8 [h, w] -> the 8-orientation quantized image, one bit a pixel
    (int64 [h, w]): blur, Sobel, fastAtan2, the 3x3 majority vote."""
    dx, dy = sobel3(gaussian_blur7_u8(img))
    fx, fy = dx.to(torch.float32), dy.to(torch.float32)
    mag = fx * fx + fy * fy
    ang = fast_atan2_deg(dy, dx)
    h, w = img.shape
    q16 = torch.round(ang.to(torch.float64) * (16.0 / 360.0)).to(torch.int64)
    q16[0, :] = 0
    q16[-1, :] = 0
    q16[:, 0] = 0
    q16[:, -1] = 0
    onehot = torch.nn.functional.one_hot(q16 & 7, 8)  # [h, w, 8]
    p = torch.nn.functional.pad(onehot, (0, 0, 1, 1, 1, 1))
    votes = sum(p[i:i + h, j:j + w] for i in range(3) for j in range(3))
    max_votes = votes.amax(dim=2)
    best = votes.argmax(dim=2)  # the first maximum, as the C++ loop keeps
    interior = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    interior[1:-1, 1:-1] = True
    ok = interior & (mag > float(weak_threshold) ** 2) & (max_votes >= 5)
    return torch.where(ok, torch.ones_like(best) << best,
                       torch.zeros_like(best))


def spread(q: torch.Tensor, T: int) -> torch.Tensor:
    h, w = q.shape
    out = torch.zeros_like(q)
    for r in range(T):
        for c in range(T):
            out[:h - r, :w - c] |= q[r:, c:]
    return out


def response_maps(s: torch.Tensor) -> torch.Tensor:
    """[8, h, w] uint8: 4 where the orientation is present, 3 where a
    neighbouring one is, 0 otherwise."""
    out = []
    for ori in range(8):
        exact = (s >> ori) & 1
        adj = ((s >> ((ori + 1) & 7)) & 1) | ((s >> ((ori - 1) & 7)) & 1)
        out.append(torch.where(exact == 1, 4, torch.where(adj == 1, 3, 0)))
    return torch.stack(out).to(torch.uint8)


def linearize(resp: torch.Tensor, T: int) -> torch.Tensor:
    """[8, H, W] -> [8, T*T, M] (line2Dup.cpp:749-777)."""
    n, h, w = resp.shape
    return torch.stack([resp[:, r0::T, c0::T].reshape(n, -1)
                        for r0 in range(T) for c0 in range(T)], dim=1)


def lm_pyramid(frame: torch.Tensor, T_at_level, weak_threshold: float):
    """match()'s preamble for one gray frame: per level the linear
    memories [8, T*T, M] and the (width, height)."""
    lms, sizes = [], []
    img = frame
    for l, T in enumerate(T_at_level):
        if l > 0:
            img = pyr_down_u8(img)
        q = quantize(img, weak_threshold)
        lms.append(linearize(response_maps(spread(q, T)), T))
        sizes.append((img.shape[1], img.shape[0]))
    return lms, sizes


# ---------------------------------------------------------------------------
# Match (oracle_np.similarity, similarity_local, match_class)
# ---------------------------------------------------------------------------

def _padded_planes(lm: torch.Tensor, tail: int) -> tuple:
    """Each orientation's [T*T*M] plane followed by `tail` zeros, flat
    int32, and the padded plane's length: reads past a plane's end read
    zero, as the oracle's truncated reads add nothing."""
    n = lm.shape[0]
    flat = lm.reshape(n, -1).to(torch.int32)
    plen = flat.shape[1]
    out = torch.cat([flat, flat.new_zeros((n, tail))], dim=1)
    return out.reshape(-1), plen + tail, plen


def _score(raw: torch.Tensor, nfeat: torch.Tensor, dtype) -> torch.Tensor:
    """(raw * 100) / (4 * nfeat) in `dtype`, the division by a tensor."""
    return (raw.to(dtype) * 100) / (4 * nfeat).to(dtype)


def coarse_candidates(lm: torch.Tensor, size_wh, T: int, bank: Bank,
                      threshold: float, score_dtype=torch.float32) -> tuple:
    """Every (k, x, y) of the top level whose score passes `threshold`
    (``match_class``'s full scan), as int64 tensors."""
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    flat, stride, _ = _padded_planes(lm, M)
    offset = T // 2 + (T % 2 - 1)
    d = lm.device
    m = torch.arange(M, device=d)
    wf = (bank.width - 1) // T + 1
    hf = (bank.height - 1) // T + 1
    positions = (H - hf) * W + (W - wf) + 1
    ks, xs, ys = [], [], []
    for k0 in range(0, bank.fx.shape[0], TEMPLATE_BLOCK):
        sl = slice(k0, k0 + TEMPLATE_BLOCK)
        fx, fy, lb, va = bank.fx[sl], bank.fy[sl], bank.label[sl], \
            bank.valid[sl]
        live = va & (fx >= 0) & (fx < w_img) & (fy >= 0) & (fy < h_img)
        start = (lb * stride + ((fy % T) * T + fx % T) * M
                 + (fy // T) * W + fx // T)
        S = torch.zeros((fx.shape[0], M), dtype=torch.int32, device=d)
        for n in range(fx.shape[1]):
            vals = flat[(start[:, n, None] + m[None, :]).clamp(
                0, flat.numel() - 1)]
            S += torch.where(live[:, n, None], vals, 0)
        S = torch.where(m[None, :] < positions[sl, None], S, 0)
        sc = _score(S, bank.nfeat[sl, None], score_dtype)
        kk, mm = torch.nonzero(sc > threshold, as_tuple=True)
        ks.append(kk + k0)
        xs.append((mm % W) * T + offset)
        ys.append((mm // W) * T + offset)
    return torch.cat(ks), torch.cat(xs), torch.cat(ys)


def refine_level(lm: torch.Tensor, size_wh, T: int, bank: Bank,
                 k: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 threshold: float, score_dtype=torch.float32) -> tuple:
    """One finer level of ``match_class``: each candidate's 16x16 local
    similarity around its doubled position under the border clamp, the
    first maximum in row-major order, the re-threshold. Returns the
    surviving (k, x, y, score)."""
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    flat, stride, _ = _padded_planes(lm, 16 * W + M + 16)
    border = 8 * T
    offset = T // 2 + (T % 2 - 1)
    d = lm.device
    rr = torch.arange(16, device=d)
    win = (rr[:, None] * W + rr[None, :]).reshape(1, 1, 256)
    out = [], [], [], []
    for c0 in range(0, k.shape[0], CAND_BLOCK):
        kc = k[c0:c0 + CAND_BLOCK]
        max_x = w_img - bank.width[kc] - border
        max_y = h_img - bank.height[kc] - border
        cx = torch.minimum((x[c0:c0 + CAND_BLOCK] * 2 + 1).clamp(min=border),
                           max_x)
        cy = torch.minimum((y[c0:c0 + CAND_BLOCK] * 2 + 1).clamp(min=border),
                           max_y)
        off_x = (torch.div(cx, T, rounding_mode="floor") - 8) * T
        off_y = (torch.div(cy, T, rounding_mode="floor") - 8) * T
        fx = bank.fx[kc] + off_x[:, None]
        fy = bank.fy[kc] + off_y[:, None]
        live = (bank.valid[kc] & (fx >= 0) & (fy >= 0) & (fx < w_img)
                & (fy < h_img))
        fxc, fyc = fx.clamp(min=0), fy.clamp(min=0)
        start = (bank.label[kc] * stride + ((fyc % T) * T + fxc % T) * M
                 + (fyc // T) * W + fxc // T)
        vals = flat[(start[:, :, None] + win).clamp(0, flat.numel() - 1)]
        S2 = torch.where(live[:, :, None], vals, 0).sum(1)  # [C, 256]
        sc = _score(S2, bank.nfeat[kc, None], score_dtype)
        best = sc.amax(dim=1)
        arg = sc.argmax(dim=1)  # the first maximum in row-major order
        pos = best > 0
        br = torch.where(pos, arg // 16, -1)
        bc = torch.where(pos, arg % 16, -1)
        best = torch.where(pos, best, torch.zeros_like(best))
        nx = (torch.div(cx, T, rounding_mode="floor") - 8 + bc) * T + offset
        ny = (torch.div(cy, T, rounding_mode="floor") - 8 + br) * T + offset
        keep = best >= threshold
        for lst, v in zip(out, (kc, nx, ny, best)):
            lst.append(v[keep])
    return tuple(torch.cat(v) if v else torch.zeros(0, dtype=torch.int64,
                                                    device=d)
                 for v in out)


def candidate_row(frame: torch.Tensor, banks: list, T_at_level,
                  weak_threshold: float, threshold: float,
                  score_dtype=torch.float32) -> tuple:
    """The survivors of one gray uint8 [H, W] frame against the banks (one
    Bank a level, finest first): (k, x, y, float32 score) in coarse
    (template, cell row-major) order, refined down the pyramid, and the
    number of coarse candidates."""
    lms, sizes = lm_pyramid(frame, T_at_level, weak_threshold)
    k, x, y = coarse_candidates(lms[-1], sizes[-1], T_at_level[-1],
                                banks[-1], threshold, score_dtype)
    n_coarse = int(k.numel())
    sc = None
    for l in range(len(T_at_level) - 2, -1, -1):
        k, x, y, sc = refine_level(lms[l], sizes[l], T_at_level[l], banks[l],
                                   k, x, y, threshold, score_dtype)
    return k, x, y, sc.to(torch.float32), n_coarse


def match_frame(frame: torch.Tensor, banks: list, T_at_level,
                weak_threshold: float, threshold: float,
                score_dtype=torch.float32) -> set:
    """The match list of one gray uint8 [H, W] frame against the banks
    (one Bank a level, finest first) as a set of (template_id, x, y,
    float32 score bits); duplicates (one template refined to one place
    from two coarse candidates) collapse, as the port's list does."""
    k, x, y, sc, _ = candidate_row(frame, banks, T_at_level, weak_threshold,
                                   threshold, score_dtype)
    bits = sc.contiguous().view(torch.int32)
    rows = torch.stack([k, x, y, bits.to(torch.int64)], 1).cpu().tolist()
    return {tuple(r) for r in rows}
