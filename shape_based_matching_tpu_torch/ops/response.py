"""Orientation spreading, cosine-response maps and the linear layout
(line2Dup.cpp:583-777), on ``[..., H, W]`` tensors.

* ``spread``: dst[r, c] = OR_{0<=dr,dc<T} src[r+dr, c+dc], zeros beyond
  the image.
* ``response_maps``: response[ori] = 4 if bit ori is set, else 3 if an
  adjacent bit (ori +- 1 mod 8) is set, else 0 (the SIMILARITY_LUT).
* ``linearize``: row (ty*T + tx) of plane ori holds resp[ori, ty::T,
  tx::T] row-major, so a template shift is a contiguous read of the flat
  buffer; a reshape and a permute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shift_or(x: torch.Tensor, T: int, dim: int) -> torch.Tensor:
    """acc[i] = OR_{0<=d<T} x[i+d] along `dim`, zeros beyond."""
    n = x.shape[dim]
    acc = x
    for d in range(1, T):
        if d >= n:
            break
        pad = [0, 0, 0, 0]
        pad[1 if dim == -1 else 3] = d
        acc = acc | F.pad(x.narrow(dim, d, n - d), pad)
    return acc


def spread(quantized: torch.Tensor, T: int) -> torch.Tensor:
    """OR orientations over the T x T window (line2Dup.cpp:616-630)."""
    return _shift_or(_shift_or(quantized, T, -2), T, -1)


def response_maps(spread_img: torch.Tensor) -> torch.Tensor:
    """[..., A, B] spread bytes -> [..., 8, A, B] uint8 responses in
    {0, 3, 4}."""
    s = spread_img.to(torch.int32).unsqueeze(-3)
    oris = torch.arange(8, dtype=torch.int32,
                        device=s.device).view(8, 1, 1)
    exact = (s >> oris) & 1
    adj = ((s >> ((oris + 1) & 7)) | (s >> ((oris - 1) & 7))) & 1
    resp = torch.where(exact == 1, 4, torch.where(adj == 1, 3, 0))
    return resp.to(torch.uint8)


def linearize(resp: torch.Tensor, T: int) -> torch.Tensor:
    """[..., n, H, W] -> [..., n, T*T, M] linear memories, M = H/T * W/T."""
    *lead, n, h, w = resp.shape
    if h % T or w % T:
        raise ValueError(f"{w}x{h} is not a multiple of T={T}")
    hd, wd = h // T, w // T
    x = resp.reshape(*lead, n, hd, T, wd, T)  # (.., yd, ty, xd, tx)
    a = len(lead) + 1
    x = x.permute(*range(a), a + 1, a + 3, a, a + 2)  # (.., ty, tx, yd, xd)
    return x.reshape(*lead, n, T * T, hd * wd)


def build_lm_from_spread(sp: torch.Tensor, T: int) -> torch.Tensor:
    """[..., H, W] spread plane -> [..., 8, T*T, M] linear memories.

    The response LUT is pointwise and linearize a permutation, so the one
    spread plane is linearized first and the responses are taken on its
    [T*T, M] rows: the same bytes as linearize(response_maps(sp), T)."""
    lin = linearize(sp.unsqueeze(-3), T).squeeze(-3)
    return response_maps(lin)
