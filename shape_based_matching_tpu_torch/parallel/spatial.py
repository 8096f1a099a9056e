"""Spatial scale-out: one huge frame matched as row tiles with a halo.

For frames too large for one device's memory or latency budget
(large-format panels, line-scan strips), the frame is cut into n bands of
Hs = H/n rows. Shard i receives an overlapping tile of Hs + 2*halo rows,
clipped to the image (the first and last tiles start and end at the
image's borders, so the frontend's border semantics land on the true
edges), runs the whole match on it -- pyramid, coarse scores through the
chain plan made for the tile's coarse size where the planner engages,
candidate extraction, window refinement at every level -- and keeps the
candidates whose coarse origin lies in its own band (a halo candidate is
a neighbour's). Their y moves to frame coordinates; the tiles' lists are
concatenated on the mesh's first device.

The halo covers, at every level, the template height, the refinement
window's reach and the frontend's support (``required_halo``), so every
band candidate sees the same linear memories and windows as on the whole
frame: the list equals ``Detector.match`` of the frame, bit for bit. The
JAX package's ``parallel/spatial.py`` is the reference; its checks and
errors are kept. The tiles of a mesh whose shards share a card run one
after another, which still bounds the working set: the coarse scores and
the candidate gathers are a tile's, not the frame's.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..models.detector import (_batch_pyramid, _planar, _sort_dedup,
                               _to_host, candidate_cap)
from ..ops.similarity import LevelBank, coarse_extract, refine_candidates
from .mesh import (Mesh, _group, _grid, _on, _threshold, _warn_overflow,
                   mesh_devices, shard_banks, shard_chains)


def make_spatial_mesh(n_shards: int | None = None, devices=None) -> Mesh:
    """A one-axis ("spatial") mesh of `n_shards` tiles
    (``mesh.mesh_devices``: every visible card unless `devices` is
    given, round-robin past them). JAX's takes the first n devices, so
    there more shards than devices run fewer tiles; the list is the same
    either way."""
    devs = mesh_devices(n_shards, devices)
    return Mesh(_grid(devs, (len(devs),)), ("spatial",))


def required_halo(banks, T_levels: tuple) -> int:
    """The least halo (frame rows) for exact band-edge semantics: for
    every pyramid level l (a level-l row spans 2^l frame rows) the
    template height, plus the 16x16 refinement window's reach (8 * T_0
    frame rows around the doubled origin) and the frontend's support
    (blur, Sobel, vote, spread and the pyrDown chain: at most 128 frame
    rows). `banks` is the finest level's LevelBank or the list of them."""
    if isinstance(banks, LevelBank):
        banks = [banks]
    th_max = max(int(b.height.max()) * (2 ** l) for l, b in enumerate(banks))
    return th_max + 8 * T_levels[0] + 128


def default_halo(banks, T_levels: tuple) -> int:
    """``required_halo`` rounded up to the pyramid stride (every tile keeps
    each level's tiling)."""
    stride = T_levels[-1] * (2 ** (len(T_levels) - 1))
    return -(-required_halo(banks, T_levels) // stride) * stride


def _tile_start(i: int, h: int, hs: int, tile_h: int, halo: int) -> int:
    return min(max(i * hs - halo, 0), h - tile_h)


def slice_tiles(image: np.ndarray, n_shards: int, halo: int) -> np.ndarray:
    """The overlapping in-image row tiles [n, Hs + 2*halo, W(, 3)] of
    ``spatial_match_step``."""
    h = image.shape[0]
    hs = h // n_shards
    tile_h = hs + 2 * halo
    return np.stack([image[s:s + tile_h] for s in
                     (_tile_start(i, h, hs, tile_h, halo)
                      for i in range(n_shards))])


def spatial_match_step(mesh: Mesh, T_levels: tuple, size_hw: tuple,
                       n_shards: int, halo: int, cand_cap: int = 256,
                       distinct_cap: int = 64, gray: bool = True,
                       n_ori: int = 8, patch_2843: bool = False):
    """The row-sharded match of one frame, as one callable:

        step(tiles, weak_threshold, threshold, banks, chains=None) ->
            (k, x, y, score, valid) each [n_shards * cand_cap] in frame
            coordinates, n_above [n_shards]

    `tiles` from ``slice_tiles`` (uint8, gray or BGR); `banks` and
    `chains` the replicated bank and the chain plans at the TILE's coarse
    size (``shard_banks`` / ``shard_chains`` with ``split=False``; None:
    plain coarse scoring). Dead slots are zero. `distinct_cap` is taken
    and unused, as in ``Detector.match_batch``."""
    del distinct_cap
    if mesh.devices.shape != (n_shards,):
        raise ValueError(f"a spatial mesh of {n_shards} shards, got "
                         f"{mesh.shape}")
    h, w = size_hw
    hs = h // n_shards
    tile_h = hs + 2 * halo
    if h < tile_h:
        raise ValueError(f"frame height {h} < tile {tile_h}; "
                         f"lower halo or shard count")
    levels = len(T_levels)
    stride = T_levels[-1] * (2 ** (levels - 1))
    if hs % stride or halo % stride:
        raise ValueError(f"band {hs} and halo {halo} must be multiples "
                         f"of the pyramid stride {stride}")
    sizes = tuple((w >> l, tile_h >> l) for l in range(levels))
    scale = 2 ** (levels - 1)
    out_dev = mesh.devices[0]

    def step(tiles, weak_threshold, threshold, banks, chains=None):
        tiles = torch.as_tensor(np.asarray(tiles))
        if tiles.dim() != (3 if gray else 4) or tuple(
                tiles.shape[:3]) != (n_shards, tile_h, w):
            raise ValueError(f"expected {n_shards} {'gray' if gray else 'BGR'}"
                             f" tiles of {tile_h}x{w}, got "
                             f"{tuple(tiles.shape)}")
        parts = []
        for i, dev in enumerate(mesh.devices):
            start = _tile_start(i, h, hs, tile_h, halo)
            bk = banks[i]
            with _on(dev):
                thr = _threshold(threshold, dev)
                lms = _batch_pyramid(_planar(tiles[i:i + 1], dev), T_levels,
                                     levels, float(weak_threshold), n_ori,
                                     None, patch_2843)
                k, x, y, sc, valid, n_above = coarse_extract(
                    lms[-1], bk[-1], T_levels[-1], sizes[-1], thr, cand_cap,
                    None if chains is None else chains[i], n_ori)
                # the band owns the candidates whose coarse origin is its
                y_frame = y * scale + start
                valid = valid & (y_frame >= i * hs) & (y_frame < (i + 1) * hs)
                for l in range(levels - 2, -1, -1):
                    k, x, y, sc, valid = refine_candidates(
                        lms[l], bk[l], T_levels[l], sizes[l], k, x, y, valid,
                        thr, n_ori)
                part = [torch.where(valid, a, torch.zeros_like(a))
                        for a in (k, x, y + start, sc)] + [valid, n_above]
            parts.append([a[0].to(out_dev) for a in part])
        return tuple(torch.cat([p[j].reshape(-1) for p in parts])
                     for j in range(6))

    return step


def match_huge_frame(detector, image, threshold: float,
                     mesh: Mesh | None = None, class_id=None,
                     halo: int | None = None, cand_cap: int | None = 256):
    """The row-sharded match of one frame, gray [H, W] or BGR [H, W, 3]
    uint8: the sorted, deduplicated Match list of ``Detector.match``.

    `class_id`: a class name, a list of names, or None for every trained
    class; more than one runs as one merged bank on every tile. An
    explicit `halo` below ``required_halo`` of the banks raises (near the
    band edges the scores would be inexact); None takes
    ``default_halo``. A tile whose candidates overflow `cand_cap` warns
    and is not re-run (the JAX package's contract). With `cand_cap`
    None (the CLI's ``--spatial-shards``) the tiles run at a cap of 256
    and, when one overflows it, again at the detector's
    ``candidate_cap`` for the most candidates a tile holds, as
    ``Detector.match`` re-runs a frame."""
    if mesh is None:
        mesh = make_spatial_mesh()
    n = mesh.devices.shape[0]
    image = np.asarray(image)
    h, w = image.shape[:2]
    detector._validate_size((h, w))
    if h % n:
        raise ValueError(f"frame height {h} not divisible by {n} shards")
    group, cap = _group(detector, class_id,
                        256 if cand_cap is None else cand_cap)
    banks = detector._get_banks(group)
    T_levels = detector.T_at_level
    need = required_halo(banks, T_levels)
    if halo is None:
        halo = default_halo(banks, T_levels)
    elif halo < need:
        raise ValueError(
            f"halo {halo} < required {need} (template height + 16x16 "
            f"refinement reach + frontend support); near-band-edge "
            f"matches would be inexact -- pass halo >= {need} or omit it")
    levels = detector.pyramid_levels
    tile_h = h // n + 2 * halo
    cache = partial(detector._shard_cached, group)
    placed = shard_banks(mesh, banks, False, cache)
    chains = shard_chains(mesh, banks[-1], T_levels[-1],
                          (w >> (levels - 1), tile_h >> (levels - 1)),
                          detector.num_orientations, False, cache)
    tiles = slice_tiles(image, n, halo)

    def run(cap: int) -> np.ndarray:
        step = spatial_match_step(mesh, T_levels, (h, w), n, halo, cap,
                                  gray=image.ndim == 2,
                                  n_ori=detector.num_orientations,
                                  patch_2843=detector.patch_2843)
        k, x, y, sc, valid, n_above = step(tiles, detector.weak_threshold,
                                           threshold, placed, chains)
        return _to_host((k[None], x[None], y[None], sc[None], valid[None],
                         n_above.max()[None]))[0]

    row = run(cap)
    if cand_cap is None and row[-1] > cap:
        cap = candidate_cap(int(row[-1]))
        row = run(cap)
    _warn_overflow(int(row[-1]), cap)
    return _sort_dedup(detector._matches(row, group))
