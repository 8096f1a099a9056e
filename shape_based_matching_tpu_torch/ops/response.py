"""Orientation spreading, cosine-response maps and the linear layout
(line2Dup.cpp:583-777), on ``[..., H, W]`` tensors.

* ``spread``: dst[r, c] = OR_{0<=dr,dc<T} src[r+dr, c+dc], zeros beyond
  the image.
* ``response_maps``: for 8 orientations, response[ori] = 4 if bit ori is
  set, else 3 if an adjacent bit (ori +- 1 mod 8) is set, else 0 (the
  SIMILARITY_LUT); for 16, the LUT the 16-orientation experiment compiles
  (line2Dup_16bit_ori.cpp:575-639): 4 for a set bit within circular
  distance 2, else 1 within distance 3-4, else 0, with spread bits 12..15
  dead (its top nibble is read as ``(s & (15 << 16)) >> 16``, always 0
  for a ushort).
* ``linearize``: row (ty*T + tx) of plane ori holds resp[ori, ty::T,
  tx::T] row-major, so a template shift is a contiguous read of the flat
  buffer; a reshape and a permute.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_i32(plane: torch.Tensor) -> torch.Tensor:
    """A uint8 or uint16 orientation plane as int32. uint16 is read through
    an int16 view: PyTorch implements few operators for uint16, on the
    card least of all, and a view and an int16 cast work everywhere."""
    if plane.dtype == torch.uint16:
        return plane.view(torch.int16).to(torch.int32) & 0xFFFF
    return plane.to(torch.int32)


def from_i32(plane: torch.Tensor, dtype) -> torch.Tensor:
    """The inverse of ``to_i32`` for values that fit `dtype`."""
    if dtype == torch.uint16:
        return plane.to(torch.int16).view(torch.uint16)
    return plane.to(dtype)


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


def response_maps(spread_img: torch.Tensor, n_ori: int = 8) -> torch.Tensor:
    """[..., A, B] spread bytes (uint8, or uint16 for 16 orientations) ->
    [..., n_ori, A, B] uint8 responses, in {0, 3, 4} for 8 orientations
    and {0, 1, 4} for 16."""
    s = to_i32(spread_img).unsqueeze(-3)
    dev = s.device
    if n_ori == 8:
        oris = torch.arange(8, dtype=torch.int32, device=dev).view(8, 1, 1)
        exact = (s >> oris) & 1
        adj = ((s >> ((oris + 1) & 7)) | (s >> ((oris - 1) & 7))) & 1
        resp = torch.where(exact == 1, 4, torch.where(adj == 1, 3, 0))
        return resp.to(torch.uint8)
    if n_ori != 16:
        raise ValueError(f"n_ori={n_ori}: 8 or 16 orientations")
    live = 0xFFF  # bits 12..15 are dead (the reference's 15 << 16 bug)
    near, mid = [], []
    for ori in range(16):
        near.append(sum(1 << ((ori + d) % 16) for d in (-2, -1, 0, 1, 2))
                    & live)
        mid.append(sum(1 << ((ori + d) % 16) for d in (-4, -3, 3, 4))
                   & live)
    near_t = torch.tensor(near, dtype=torch.int32, device=dev).view(16, 1, 1)
    mid_t = torch.tensor(mid, dtype=torch.int32, device=dev).view(16, 1, 1)
    resp = torch.where((s & near_t) > 0, 4,
                       torch.where((s & mid_t) > 0, 1, 0))
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


def build_lm_from_spread(sp: torch.Tensor, T: int,
                         n_ori: int = 8) -> torch.Tensor:
    """[..., H, W] spread plane (uint8, or uint16 for 16 orientations) ->
    [..., n_ori, T*T, M] uint8 linear memories.

    The response LUT is pointwise and linearize a permutation, so the one
    spread plane is linearized first and the responses are taken on its
    [T*T, M] rows: the same bytes as linearize(response_maps(sp), T)."""
    if sp.dtype == torch.uint16:
        sp = to_i32(sp)
    lin = linearize(sp.unsqueeze(-3), T).squeeze(-3)
    return response_maps(lin, n_ori)
