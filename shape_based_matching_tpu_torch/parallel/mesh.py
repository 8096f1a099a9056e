"""Multi-device scale-out: data-parallel frames x template-parallel bank.

The reference's only parallelism is an OpenMP loop over templates on one
CPU (line2Dup.cpp:1166-1169). The port spreads two axes over a ``Mesh``
of torch devices, as the JAX package's ``parallel/mesh.py`` does over a
``jax.sharding.Mesh``:

* ``data``: a batch of frames; each shard builds the pyramid of its own
  frames;
* ``templ``: the template bank, padded to a multiple of the axis
  (``shard_pad_bank``); each shard scores its slice against its frames,
  with the slice's own delta-chain plan where the planner engages
  (``ops/chain_plan.plan_chain_sharded``), and refines its own
  candidates through the window at every level.

One controller issues every shard's work on the shard's device. CUDA
launches return at once, so shards on different cards overlap; shards
that share a card run one after another on its stream. The JAX
package's collectives become tensor operations on the output device
(the mesh's first): ``all_gather`` is a copy there and a ``torch.cat``,
``psum`` a sum. There is no process group and no NCCL.

``make_mesh`` takes every visible CUDA card unless given ``devices``; when
more shards are asked for than there are devices, they go round-robin, so
one card runs any mesh shape. Without CUDA and without ``devices`` it
raises: there is no CPU fallback.

Every path's lists equal the single-device ``Detector``'s: the sharded
match is ``Detector.match`` frame by frame (template id, position and
float32 score), the sharded training sweep is ``add_templates`` field for
field, and the production tier is ``match_refine_batch`` bit for bit.
"""

from __future__ import annotations

import contextlib
import warnings
from functools import partial

import numpy as np
import torch

from ..models.detector import (_as_tensor, _batch_pyramid,
                               _match_batch_class, _planar, _sort_dedup,
                               _strong_lower_bound, _sweep_inputs, _to_host,
                               _train_levels, merged_cap)
from ..models.icp import refine_frames
from ..ops.chain_plan import plan_chain_sharded
from ..ops.cuda.chain import plan_to_device
from ..ops.similarity import LevelBank, coarse_similarity


class Mesh:
    """Torch devices laid out on named axes: ``devices`` is a numpy object
    array of ``torch.device`` with one dimension per name of
    ``axis_names``, read as the JAX package's ``Mesh``. A device may
    appear more than once (round-robin shards)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def mesh_devices(n: int | None, devices=None) -> list:
    """`n` devices for `n` shards (default: one a device): `devices`, or
    every visible CUDA card, round-robin when `n` exceeds them. Raises
    without CUDA unless `devices` is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh needs CUDA, or an explicit devices= "
                               "list (e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    n = int(n or len(devices))
    return [devices[i % len(devices)] for i in range(n)]


def _grid(devices: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr.reshape(shape)


def make_mesh(n_devices: int | None = None, data: int | None = None,
              devices=None) -> Mesh:
    """A (data, templ) mesh of `n_devices` shards (``mesh_devices``).

    Template parallelism is favoured (the bank is usually the big axis):
    ``data=2`` only when n is even and at least 4, so the shapes are
    (1, 2), (2, 2) and (2, 4)."""
    devs = mesh_devices(n_devices, devices)
    n = len(devs)
    if data is None:
        data = 2 if n % 2 == 0 and n >= 4 else 1
    if data < 1 or n % data:
        raise ValueError(f"{n} devices do not split into {data} data rows")
    return Mesh(_grid(devs, (data, n // data)), ("data", "templ"))


def shard_pad_bank(bank: LevelBank, n_shards: int) -> LevelBank:
    """Pad the template axis to a multiple of n_shards with dead rows
    (valid=False, nfeat=0: never above threshold; a 1x1 bbox)."""
    K = bank.fx.shape[0]
    pad = -K % n_shards
    if not pad:
        return bank

    def rows(a, fill=0):
        return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])

    return LevelBank(
        fx=rows(bank.fx), fy=rows(bank.fy), label=rows(bank.label),
        valid=rows(bank.valid, False), nfeat=rows(bank.nfeat),
        width=rows(bank.width, 1), height=rows(bank.height, 1))


def _make(key, make):
    return make()


def shard_banks(mesh: Mesh, banks: list, split: bool = True,
                cache=_make) -> np.ndarray:
    """The per-level banks each shard scores, as an object array of the
    mesh's shape: at position (..., t) the padded bank's slice t of the
    last axis (``split``), or the whole bank (replicated), on that
    position's device. ``cache(key, make)`` keeps what it makes
    (``Detector._shard_cached``), so a device holds each slice once."""
    n = mesh.devices.shape[-1] if split else 1
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx, dev in np.ndenumerate(mesh.devices):
        t = idx[-1] if split else 0

        def make(t=t, dev=dev):
            parts = []
            for b in banks:
                b = shard_pad_bank(b, n)
                k = b.fx.shape[0] // n
                parts.append(LevelBank(*(f[t * k:(t + 1) * k].to(dev)
                                         for f in b)))
            return parts

        out[idx] = cache(("banks", n, t, dev), make)
    return out


def shard_chains(mesh: Mesh, bank: LevelBank, T: int, size_wh, n_ori: int,
                 split: bool = True, cache=_make):
    """Each shard's delta-chain plan for its bank (``shard_banks``'
    slices of the coarse bank `bank`) at coarse frame size `size_wh`, as
    an object array of the mesh's shape, or None when the planner
    declines any slice (``plan_chain_sharded``)."""
    n = mesh.devices.shape[-1] if split else 1
    size = tuple(int(v) for v in size_wh)
    plans = cache(("plans", n, size), lambda: plan_chain_sharded(
        LevelBank(*(f.cpu().numpy() for f in shard_pad_bank(bank, n))), n,
        T, size, n_ori))
    if plans is None:
        return None
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx, dev in np.ndenumerate(mesh.devices):
        t = idx[-1] if split else 0
        out[idx] = cache(("chain", n, t, size, dev),
                         lambda t=t, dev=dev: plan_to_device(plans[t], dev))
    return out


def _on(device: torch.device):
    """Where a shard's work is issued: under its card (the kernels launch
    on the current device's stream), or as it is on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _threshold(value, device) -> torch.Tensor:
    # a fill on the device: no copy from the host, no wait for the card
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _shard_pyramids(mesh: Mesh, images: torch.Tensor, rows: int,
                    T_levels: tuple, weak_threshold: float, n_ori: int,
                    patch_2843: bool) -> dict:
    """Each shard's frames and their pyramid, keyed (row, device): the
    frames of row r of the batch's `rows` equal parts, on the device; a
    device that holds several shards of a row builds them once."""
    b_loc = images.shape[0] // rows
    out = {}
    for idx, dev in np.ndenumerate(mesh.devices):
        r = idx[0]
        if (r, dev) not in out:
            with _on(dev):
                frames = _planar(images[r * b_loc:(r + 1) * b_loc], dev)
                out[r, dev] = frames, _batch_pyramid(
                    frames, T_levels, len(T_levels), weak_threshold, n_ori,
                    None, patch_2843)
    return out


def multichip_match_step(mesh: Mesh, T_levels: tuple, size_hw: tuple,
                         cand_cap: int = 256, distinct_cap: int = 64,
                         gray: bool = True, n_ori: int = 8,
                         return_scores: bool = False,
                         patch_2843: bool = False):
    """The full match over the mesh, as one callable:

        step(images, weak_threshold, threshold, banks, chains=None) ->
            (k, x, y, score, valid) each [B, n_templ * cand_cap],
            n_above [B]

    `images` [B, H, W] (gray) or [B, H, W, 3] (BGR) uint8, numpy or a
    tensor, B a multiple of the data axis; `banks` and `chains` from
    ``shard_banks`` / ``shard_chains`` (None: plain coarse scoring).
    Frames split over ``data``, the bank over ``templ``; each shard
    matches its frames against its slice, its ids turned global
    (``k + t * K_loc``); the lists are concatenated over ``templ`` and
    the counts summed, on the mesh's first device. With
    ``return_scores`` the step also returns the coarse scores [B,
    K_total, M] (zeroed past each template's positions), concatenated
    over ``templ``. `distinct_cap` is taken and unused, as in
    ``Detector.match_batch``."""
    del distinct_cap
    h, w = size_hw
    levels = len(T_levels)
    sizes = tuple((w >> l, h >> l) for l in range(levels))
    n_data, n_templ = mesh.devices.shape
    out_dev = mesh.devices.flat[0]

    def step(images, weak_threshold, threshold, banks, chains=None):
        images = _as_tensor(images)
        if images.dim() != (3 if gray else 4) or tuple(
                images.shape[1:3]) != (h, w):
            raise ValueError(f"expected {'gray' if gray else 'BGR'} frames "
                             f"of {h}x{w}, got {tuple(images.shape)}")
        if images.shape[0] % n_data:
            raise ValueError(f"batch {images.shape[0]} not divisible by the "
                             f"mesh data axis ({n_data}); pad the batch")
        pyr = _shard_pyramids(mesh, images, n_data, T_levels,
                              float(weak_threshold), n_ori, patch_2843)
        rows = []
        for d in range(n_data):
            parts = []
            for t in range(n_templ):
                dev = mesh.devices[d, t]
                bk = banks[d, t]
                with _on(dev):
                    lms = pyr[d, dev][1]
                    k, x, y, sc, valid, n_above = _match_batch_class(
                        lms, bk, _threshold(threshold, dev), T_levels,
                        levels, sizes, cand_cap,
                        None if chains is None else chains[d, t], n_ori)
                    k = torch.where(valid, k + t * bk[-1].fx.shape[0], 0)
                    part = [k, x, y, sc, valid, n_above]
                    if return_scores:
                        part.append(torch.stack([coarse_similarity(
                            lm, bk[-1], T_levels[-1], sizes[-1], True,
                            n_ori)[0] for lm in lms[-1]]))
                parts.append([a.to(out_dev) for a in part])
            row = [torch.cat([p[i] for p in parts], dim=1)
                   for i in range(5)]
            row.append(sum(p[5] for p in parts))
            if return_scores:
                row.append(torch.cat([p[6] for p in parts], dim=1))
            rows.append(row)
        return tuple(torch.cat([r[i] for r in rows]) for i in
                     range(len(rows[0])))

    return step


def _group(detector, class_id, cand_cap: int) -> tuple:
    """(bank group, candidate cap) of a sharded call: one class as it is;
    several (None: every trained class) as one merged bank
    (``Detector._get_merged``) at the detector's ``merged_cap``, warning
    when its clamp bites."""
    if class_id is None:
        class_ids = detector.class_ids()
    elif isinstance(class_id, str):
        class_ids = [class_id]
    else:
        class_ids = list(class_id)
    if not class_ids:
        raise ValueError("the detector has no trained class")
    if len(class_ids) == 1:
        return class_ids[0], int(cand_cap)
    group = tuple(sorted(class_ids))
    detector._get_merged(group)
    cap = merged_cap(cand_cap, len(class_ids))
    if cap < int(cand_cap) * len(class_ids):
        warnings.warn(
            f"merged multi-class cap clamped to {cap} (< cand_cap*"
            f"{len(class_ids)} classes = {int(cand_cap) * len(class_ids)});"
            f" busy frames may overflow -- the n_above warning below "
            f"reports it")
    return group, cap


def _warn_overflow(n_above: int, cap: int) -> None:
    if n_above > cap:
        warnings.warn(f"candidate overflow: max {n_above} above threshold, "
                      f"cap {cap}; raise cand_cap for full parity")


def match_images_sharded(detector, images, threshold: float,
                         mesh: Mesh | None = None, class_id=None,
                         cand_cap: int = 256, distinct_cap: int = 64):
    """The sharded match of a batch of frames, one sorted, deduplicated
    Match list per frame, each equal to ``Detector.match`` of the frame.

    `class_id`: a class name, a list of names, or None for every trained
    class; more than one class runs as one merged bank
    (``Detector._get_merged``). A frame whose candidates overflow the cap
    warns and is not re-run (the JAX package's contract).
    `distinct_cap` is taken and unused, as in ``Detector.match_batch``."""
    del distinct_cap
    if mesh is None:
        mesh = make_mesh()
    group, cap = _group(detector, class_id, cand_cap)
    per = _match_images_sharded_banks(detector, images, threshold, mesh,
                                      group, cap)
    return [_sort_dedup(ms) for ms in per]


def _match_images_sharded_banks(detector, images, threshold: float,
                                mesh: Mesh, group, cand_cap: int) -> list:
    """One bank group's sharded match of a batch of frames: an unsorted
    Match list per frame."""
    images = _as_tensor(images)
    if images.dtype != torch.uint8 or not (
            images.dim() == 3 or (images.dim() == 4
                                  and images.shape[-1] == 3)):
        raise ValueError("expected uint8 [B, H, W] or [B, H, W, 3] frames")
    h, w = images.shape[1:3]
    detector._validate_size((h, w))
    banks = detector._get_banks(group)
    K = banks[-1].fx.shape[0]
    cache = partial(detector._shard_cached, group)
    sizes = detector._level_sizes((h, w))
    placed = shard_banks(mesh, banks, True, cache)
    chains = shard_chains(mesh, banks[-1], detector.T_at_level[-1],
                          sizes[-1], detector.num_orientations, True, cache)
    step = multichip_match_step(mesh, detector.T_at_level, (h, w), cand_cap,
                                gray=images.dim() == 3,
                                n_ori=detector.num_orientations,
                                patch_2843=detector.patch_2843)
    k, x, y, sc, valid, n_above = step(images, detector.weak_threshold,
                                       threshold, placed, chains)
    host = _to_host((k, x, y, sc, valid & (k < K), n_above))
    _warn_overflow(int(host[:, -1].max()), cand_cap)
    return [detector._matches(row, group) for row in host]


def _gather_levels(parts: list, b_loc: int) -> list:
    """The shards' ``_train_levels`` lists (shard i holding frames i *
    b_loc ...) as one list for the whole batch: at each level the eligible
    and strong pixels of every frame in frame order, then their values,
    as ``_train_level`` of the whole batch hands them over."""
    out = []
    for lvl in zip(*parts):
        es, sts, vals = [], [], []
        for i, ((host, n_e, n_s), _) in enumerate(lvl):
            shift = np.array([i * b_loc, 0, 0], np.int32)
            es.append(host[:n_e] + shift)
            sts.append(host[n_e:n_e + n_s] + shift)
            vals.append(host[n_e + n_s:])
        e, st = np.concatenate(es), np.concatenate(sts)
        out.append(((np.concatenate([e, st] + vals), len(e), len(st)),
                    lvl[0][1]))
    return out


def multichip_train_step(mesh: Mesh, size_hw: tuple,
                         pyramid_levels: int = 2,
                         weak_threshold: float = 30.0,
                         strong_lo: float | None = None,
                         gray: bool = True, has_mask: bool = False,
                         n_ori: int = 8, patch_2843: bool = False,
                         cand_cap: int = 4096):
    """The device half of a training sweep over every device of the mesh
    (data x templ flattened: training has no template axis), as one
    callable:

        step(images[, masks]) -> (levels, n_strong)

    `images` [B, H, W] or [B, H, W, 3] uint8, B a multiple of the mesh's
    size (callers pad); `masks` [B, H, W] uint8 when `has_mask`. Each
    shard runs ``_train_levels`` on its frames; `levels` is what
    ``_train_levels`` of the whole batch gives (per level the pixel lists
    and values, and the size), so ``Detector._consume_chunk`` reads it
    unchanged; `n_strong` counts the strong pixels of every frame and
    level. `strong_lo` defaults to the bound of a strong threshold of
    60; `cand_cap` is taken and unused, as in ``add_templates``."""
    del cand_cap
    if strong_lo is None:
        strong_lo = _strong_lower_bound(60.0)
    devices = list(mesh.devices.flat)
    h, w = size_hw

    def step(images, masks=None):
        images = _as_tensor(images)
        if images.dim() != (3 if gray else 4) or tuple(
                images.shape[1:3]) != (h, w):
            raise ValueError(f"expected {'gray' if gray else 'BGR'} frames "
                             f"of {h}x{w}, got {tuple(images.shape)}")
        if (masks is not None) != has_mask:
            raise ValueError(f"has_mask={has_mask} but masks "
                             f"{'missing' if masks is None else 'given'}")
        n = len(devices)
        if images.shape[0] % n:
            raise ValueError(f"batch {images.shape[0]} not divisible by the "
                             f"{n} mesh devices; pad the batch")
        b_loc = images.shape[0] // n
        parts = []
        for i, dev in enumerate(devices):
            sl = slice(i * b_loc, (i + 1) * b_loc)
            with _on(dev):
                parts.append(_train_levels(
                    _planar(images[sl], dev),
                    None if masks is None else _planar(masks[sl], dev),
                    pyramid_levels, weak_threshold, strong_lo, n_ori,
                    patch_2843))
        levels = _gather_levels(parts, b_loc)
        return levels, sum(n_s for (_, _, n_s), _ in levels)

    return step


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    """`arr` with its last frame repeated up to n frames."""
    if arr.shape[0] == n:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], n - arr.shape[0],
                                          axis=0)])


def add_templates_sharded(detector, sources, class_id: str,
                          object_masks=None, mesh: Mesh | None = None,
                          num_features: int = 0, cand_cap: int = 4096,
                          chunk_per_dev: int = 16, sscales=None,
                          orientations=None, tag_field_ids=None,
                          fiducial_src: str = "none") -> list[int]:
    """``Detector.add_templates`` with its device half spread over every
    device of the mesh (``multichip_train_step``): chunks of
    chunk_per_dev frames a device, the last chunk padded with its last
    frame. Every chunk is dispatched before the host's greedy passes
    (``Detector._consume_chunk``) run, in frame order. Equal to
    ``add_templates``, template for template and field for field.
    Returns one template id per frame (-1 where extraction failed)."""
    sources, masks = _sweep_inputs(sources, object_masks)
    nfeat = int(num_features) if num_features > 0 else detector.num_features
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    step = multichip_train_step(
        mesh, sources.shape[1:3], detector.pyramid_levels,
        detector.weak_threshold,
        _strong_lower_bound(detector.strong_threshold), sources.ndim == 3,
        masks is not None, detector.num_orientations, detector.patch_2843,
        cand_cap)
    chunk = max(n_dev, chunk_per_dev * n_dev)
    pending = []
    for b0 in range(0, sources.shape[0], chunk):
        b1 = min(b0 + chunk, sources.shape[0])
        bp = -(-(b1 - b0) // n_dev) * n_dev
        levels, _ = step(_pad_to(sources[b0:b1], bp),
                         None if masks is None else _pad_to(masks[b0:b1], bp))
        pending.append((b0, b1, levels))
    ids: list[int] = []
    pyramids = detector.class_templates.setdefault(class_id, [])
    meta = (sscales, orientations, tag_field_ids, fiducial_src)
    for b0, b1, levels in pending:
        detector._consume_chunk(b0, b1 - b0, levels, nfeat, pyramids, ids,
                                meta)
    detector._invalidate(class_id)
    return ids


def _local_refine(frames: torch.Tensor, lms: tuple, banks: list,
                  T_levels: tuple, sizes: tuple, weak_threshold: float,
                  threshold: torch.Tensor, cand_cap: int, n_ori: int,
                  top_c: int, iters: int, radius: int, chain=None) -> list:
    """The production tier on a shard's gray frames [B, H, W] and their
    pyramid: the first step of ``Detector.match_batch``
    (``_match_batch_class``, the window at every finer level), then
    ``match_refine_batch``'s refine half (``models/icp.refine_frames``).
    Eleven tensors [B, top_c]: the seven
    ``IcpResult`` fields (dtheta, dscale, tx, ty, rmse, inliers, valid),
    then template id, origin x, origin y and score of each refined
    candidate."""
    k, x, y, sc, valid, n_above = _match_batch_class(
        lms, banks, threshold, T_levels, len(T_levels), sizes, cand_cap,
        chain, n_ori)
    per = refine_frames(frames, weak_threshold,
                        {0: (k, x, y, sc, valid, n_above > cand_cap)},
                        {0: banks[0]}, top_c, iters, radius)[0]
    cols = [[*r["icp"], r["k"], r["x"], r["y"], r["score"]] for r in per]
    return [torch.stack(c) for c in zip(*cols)]


def multichip_refine_step(mesh: Mesh, T_levels: tuple, size_hw: tuple,
                          cand_cap: int = 256, distinct_cap: int = 64,
                          top_c: int = 8, iters: int = 10, radius: int = 8,
                          n_ori: int = 8):
    """The production tier (match, then the sim2 ICP of each frame's top_c
    candidates: ``match_refine_batch``'s flow) data-parallel over every
    device of the mesh, as one callable:

        step(images, weak_threshold, threshold, banks, chains=None) ->
            11 tensors [B, top_c] (``_local_refine``)

    `images` gray [B, H, W] uint8, B a multiple of the mesh's size; the
    bank replicated (``shard_banks(..., split=False)``, ``shard_chains``
    likewise). Each frame runs end to end on one shard, so every output
    equals per-frame ``match_refine_batch`` bit for bit (of a detector
    with the default vote: the JAX package's tier has no #2843 mode
    either). `distinct_cap` is taken and unused, as in
    ``Detector.match_batch``."""
    del distinct_cap
    h, w = size_hw
    sizes = tuple((w >> l, h >> l) for l in range(len(T_levels)))
    devices = list(mesh.devices.flat)
    flat = Mesh(_grid(devices, (len(devices),)), ("batch",))
    out_dev = devices[0]

    def step(images, weak_threshold, threshold, banks, chains=None):
        images = _as_tensor(images)
        if images.dim() != 3 or tuple(images.shape[1:]) != (h, w):
            raise ValueError(f"expected gray frames of {h}x{w}, got "
                             f"{tuple(images.shape)}")
        n = len(devices)
        if images.shape[0] % n:
            raise ValueError(f"batch {images.shape[0]} not divisible by the "
                             f"{n} mesh devices; pad the batch")
        pyr = _shard_pyramids(flat, images, n, T_levels,
                              float(weak_threshold), n_ori, False)
        parts = []
        for idx, dev in np.ndenumerate(mesh.devices):
            i = int(np.ravel_multi_index(idx, mesh.devices.shape))
            frames, lms = pyr[i, dev]
            with _on(dev):
                outs = _local_refine(
                    frames, lms, banks[idx], T_levels, sizes,
                    float(weak_threshold), _threshold(threshold, dev),
                    cand_cap, n_ori, top_c, iters, radius,
                    None if chains is None else chains[idx])
            parts.append([a.to(out_dev) for a in outs])
        return tuple(torch.cat(c) for c in zip(*parts))

    return step
