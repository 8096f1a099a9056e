"""Entry points: the flagship match step and the multi-device dry
run, the port's counterparts of the JAX package's ``__graft_entry__.py``.

* ``entry(num_templates)`` gives ``(match_step, example_args)``: one
  frame's match on the flagship configuration (a device-resident 1024^2
  gray frame, a rotation bank of `num_templates` x 63 features, T=(4, 8),
  threshold 85, candidate cap 256), with no overflow re-run and no
  ``Match`` list. ``bench.py`` times it.
* ``match_sets`` turns a step's outputs into per-frame sets of
  ``(template_id, x, y, float32 bits)`` for exact comparisons.
* ``dryrun_multichip(n_devices)`` runs the sharded paths of
  ``parallel/`` once on small shapes (the data x templ match, training,
  the production tier and the row-tiled huge frame) and holds each to
  the single-device path, bit for bit.

Both run on the card unless the caller passes CPU devices, where every
kernel runs its plain twin.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.detector import Detector, _batch_pyramid, _match_batch_class
from .ops.similarity import (coarse_extract, coarse_route, pack_level_bank,
                             refine_candidates)
from .utils.synthetic import (build_rotated_detector, synthetic_scene,
                              synthetic_shape_image)

H = W = 1024
T_LEVELS = (4, 8)
CAP = 256
THRESHOLD = 85.0
WEAK_THRESHOLD = 30.0


def entry(num_templates: int = 360, *, device="cuda"):
    """(match_step, example_args): the flagship match step and its inputs
    on `device` (the card unless the caller asks for "cpu"; "cuda"
    without a card raises).

    The bank is read from its committed ``bench_banks/`` snapshot where
    there is one (trained otherwise); the frame is ``synthetic_scene(1024,
    1024, star, n_instances=4)``. ``match_step(image, bank0, bank1)``
    runs, in order: the frontend kernel, responses, linearize and the
    zero tail at both levels (``_batch_pyramid``); coarse scores (the
    delta chain where the planner takes the bank, the 10,000-template
    one, else ``coarse.cu``) with counted extraction at level 1,
    threshold 85 and cap 256; the window refine at level 0. It returns
    ``(k, x, y, score, valid, n_above)``, each [1, 256] but n_above [1],
    on `device`; ``match_step.coarse_route`` names the coarse route.

    The JAX step refines through the level maps where its window kernel
    does not fit the TPU's VMEM and off the TPU; ``refine.cu`` has no
    such limit, so this step always takes the window, whose sets equal
    the map route's on banks that are not pathological."""
    device = torch.device(device)
    det, templ_img = build_rotated_detector(num_templates, 63, cache=True,
                                            device=device)
    banks = det._get_banks("bench")
    sizes = tuple(det._level_sizes((H, W)))
    chain = det._get_chain("bench", sizes[-1])
    thr = torch.full((), THRESHOLD, dtype=torch.float32, device=device)
    scene = synthetic_scene(H, W, templ_img, n_instances=4)

    def match_step(image, bank0, bank1):
        lmflat0, lmflat1 = _batch_pyramid(image[None], T_LEVELS, 2,
                                          WEAK_THRESHOLD)
        k, x, y, sc, valid, n_above = coarse_extract(
            lmflat1, bank1, T_LEVELS[1], sizes[1], thr, CAP, chain)
        k, x, y, sc, valid = refine_candidates(
            lmflat0, bank0, T_LEVELS[0], sizes[0], k, x, y, valid, thr)
        return k, x, y, sc, valid, n_above

    match_step.coarse_route = coarse_route(banks[1], T_LEVELS[1], sizes[1],
                                           chain=chain is not None)
    return match_step, (torch.from_numpy(scene).to(device), banks[0],
                        banks[1])


def match_sets(k, x, y, sc, valid) -> list[set]:
    """Per-frame sets of (template, x, y, score bits) of the valid
    candidates ([B, C] tensors), for exact parity."""
    k, x, y, valid = (t.cpu().numpy() for t in (k, x, y, valid))
    scb = sc.view(torch.int32).cpu().numpy()
    out = []
    for b in range(k.shape[0]):
        idx = np.nonzero(valid[b])[0]
        out.append({(int(k[b, i]), int(x[b, i]), int(y[b, i]),
                     int(scb[b, i])) for i in idx})
    return out


def _check(ok: bool, what: str) -> None:
    """A parity check of the dry run (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def _random_templates(K: int, N: int, wh: int, seed: int) -> list:
    """K templates of N random features in a wh x wh box (the JAX dry
    run's banks, draw for draw)."""
    rng = np.random.RandomState(seed)
    templates = []
    for _ in range(K):
        feats = [(int(rng.randint(0, wh)), int(rng.randint(0, wh)),
                  int(rng.randint(0, 8))) for _ in range(N)]
        templates.append({"features": feats, "width": wh, "height": wh})
    return templates


def _mesh_inputs(n_data: int, n_templ: int):
    """The mesh half's inputs: (rng, frames [2 n_data, 128, 128], level
    templates). The spatial half draws its frame from `rng` next.
    wh=24 on 128px frames keeps the bank not pathological (width <=
    image - 16*T_0)."""
    rng = np.random.RandomState(0)
    images = (rng.rand(2 * n_data, 128, 128) * 255).astype(np.uint8)
    return rng, images, [_random_templates(4 * n_templ, 8, wh, level)
                         for level, wh in ((0, 24), (1, 12))]


def _spatial_inputs(rng, n_sp: int, K: int):
    """The spatial half's inputs: (frame [hs n_sp, 128], level templates,
    halo). The halo covers template height, refinement reach and
    frontend support; hs >= 128 keeps every tile not pathological for
    the 16px templates."""
    from .parallel.spatial import required_halo

    templates = [_random_templates(K, 8, wh, level + 7)
                 for level, wh in ((0, 16), (1, 8))]
    stride = T_LEVELS[-1] * 2 ** (len(T_LEVELS) - 1)
    halo = -(-required_halo([pack_level_bank(t) for t in templates],
                            T_LEVELS) // stride) * stride
    if n_sp > 1:
        hs = max(128, -(-(2 * halo) // ((n_sp - 1) * stride)) * stride)
    else:
        hs, halo = 128, 0  # single shard: tile == band == frame
    big = (rng.rand(hs * n_sp, 128) * 255).astype(np.uint8)
    return big, templates, halo


def _single(images: np.ndarray, banks: list, cand_cap: int, threshold,
            device):
    """The single-device reference: ``Detector.match_batch``'s first step
    (pyramid, coarse scores and extraction, the window refine) on one
    device over the whole bank, for gray frames [B, H, W]."""
    h, w = images.shape[1:]
    sizes = tuple((w >> l, h >> l) for l in range(len(T_LEVELS)))
    lms = _batch_pyramid(torch.from_numpy(images).to(device), T_LEVELS,
                         len(T_LEVELS), WEAK_THRESHOLD)
    thr = torch.full((), threshold, dtype=torch.float32, device=device)
    on_dev = [type(b)(*(f.to(device) for f in b)) for b in banks]
    return _match_batch_class(lms, on_dev, thr, T_LEVELS, len(T_LEVELS),
                              sizes, cand_cap)


def dryrun_multichip(n_devices: int, *, devices=None) -> None:
    """Run the full multi-device step over an n-device mesh (data x templ
    sharding, the gathers on the first device) once on tiny shapes, and
    assert EXACT parity of the (template, x, y, score) match sets against
    the same pipeline on one device, for the mesh and the spatial halves;
    the sharded training sweep and the production tier likewise, field
    for field. Prints one ``dryrun_multichip ok: ...`` line.

    `devices`: the devices the shards go on, round-robin past them
    (``parallel/mesh.make_mesh``); None takes every visible card and
    raises without CUDA. The single-device references run on the first
    of them, at the JAX references' candidate caps; the port's path has
    no distinct-template cap (``Detector.match_batch`` takes one and
    uses none). The JAX dry run's shapes, seeds and asserts."""
    from .models.icp import match_refine_batch
    from .parallel.mesh import (add_templates_sharded, make_mesh,
                                multichip_match_step, multichip_refine_step,
                                shard_banks, shard_pad_bank)
    from .parallel.spatial import (make_spatial_mesh, slice_tiles,
                                   spatial_match_step)

    mesh = make_mesh(n_devices, devices=devices)
    dev0 = mesh.devices.flat[0]
    n_data, n_templ = mesh.devices.shape

    H_, W_ = 128, 128
    B = 2 * n_data
    K = 4 * n_templ

    rng, images, templates = _mesh_inputs(n_data, n_templ)
    banks = [shard_pad_bank(pack_level_bank(t), n_templ) for t in templates]

    # the sharded match: pyramid per data row, coarse scores, extraction
    # and refinement per templ slice, gathered on the first device.
    # cand_cap = K_loc * M_last truncates no candidate, so a cap-order
    # difference cannot pass for (or hide) a sharding fault.
    M_last = (H_ // 2 // T_LEVELS[-1]) * (W_ // 2 // T_LEVELS[-1])
    cap_loc = (K // n_templ) * M_last
    step = multichip_match_step(mesh, T_LEVELS, (H_, W_), cand_cap=cap_loc,
                                distinct_cap=K)
    k, x, y, sc, valid, n_above = step(images, WEAK_THRESHOLD, 30.0,
                                       shard_banks(mesh, banks))
    _check(tuple(k.shape) == (B, cap_loc * n_templ),
           f"mesh candidates of shape {tuple(k.shape)}")

    # single-device reference: the same pipeline over the unsharded bank
    rk, rx, ry, rsc, rvalid, _ = _single(images, banks, K * M_last, 30.0,
                                         dev0)
    got, want = match_sets(k, x, y, sc, valid), match_sets(rk, rx, ry, rsc,
                                                           rvalid)
    _check(got == want, "mesh-sharded match != single-device match")
    n_mesh_matches = sum(len(s) for s in want)

    # training over every device (data x templ flattened), equal to
    # single-device add_templates template for template
    B2 = 2 * n_data * n_templ + 1  # deliberately not divisible by n_dev
    frames2 = np.stack([synthetic_shape_image(96, seed=900 + i)
                        for i in range(B2)])
    det_local = Detector(num_features=63, device=dev0)
    ids_local = det_local.add_templates(frames2, "cls")
    det_mesh = Detector(num_features=63, device=dev0)
    ids_mesh = add_templates_sharded(det_mesh, frames2, "cls", mesh=mesh,
                                     chunk_per_dev=1)
    _check(ids_mesh == ids_local, "mesh-sharded training ids != "
           "single-device ids")

    def _flat_bank(det):
        return [[(t.width, t.height, t.tl_x, t.tl_y, t.pyramid_level,
                  [(f.x, f.y, f.label) for f in t.features])
                 for t in tp] for tp in det.class_templates["cls"]]

    _check(_flat_bank(det_mesh) == _flat_bank(det_local),
           "mesh-sharded training != single-device training")
    n_train = sum(i >= 0 for i in ids_mesh)

    # the production tier (detect, device top-k, batched sim2 ICP)
    # data-parallel over frames, every output equal to per-frame
    # match_refine_batch on one device
    templ_img = synthetic_shape_image(96, seed=2)
    det_r = Detector(num_features=31, T=T_LEVELS, device=dev0)
    _check(det_r.add_template(templ_img, "r",
                              np.full_like(templ_img, 255)) == 0,
           "the production template did not train")
    det_r.add_templates_rotate("r", 0, [30.0, 60.0, 120.0], (48, 48))
    r_banks = det_r._get_banks("r")
    B3 = n_devices
    frames3 = np.stack([synthetic_scene(128, 128, templ_img,
                                        n_instances=1, seed=40 + i)
                        for i in range(B3)])
    refine_step = multichip_refine_step(mesh, det_r.T_at_level,
                                        (128, 128), cand_cap=64,
                                        distinct_cap=8, top_c=4)
    r_got = refine_step(frames3, WEAK_THRESHOLD, 80.0,
                        shard_banks(mesh, r_banks, split=False))
    for b in range(B3):
        r = match_refine_batch(det_r, frames3[b:b + 1], 80.0, top_c=4,
                               iters=10, radius=8, cand_cap=64)["r"][0]
        want_b = [*r["icp"], r["k"], r["x"], r["y"], r["score"]]
        for i, (g, w_) in enumerate(zip(r_got, want_b)):
            g = g[b]
            if w_.dtype == torch.float32:
                g, w_ = g.view(torch.int32), w_.view(torch.int32)
            _check(torch.equal(g, w_),
                   f"mesh-sharded refine field {i} != single-device")
    n_refined = int(r_got[6].sum())
    _check(n_refined > 0, "sharded production tier refined no matches")

    # spatial scale-out: ONE huge frame row-sharded over all devices (halo
    # tiles, band-owned candidates). The halo covers template height,
    # refinement reach and frontend support, so the band candidates are
    # EXACTLY the single-device full-frame match.
    n_sp = n_devices
    big, sp_templates, halo = _spatial_inputs(rng, n_sp, K)
    sp_banks = [pack_level_bank(t) for t in sp_templates]
    h_big, w_big = big.shape
    hs = h_big // n_sp
    tile_h = hs + 2 * halo
    M_tile = (tile_h // 2 // T_LEVELS[-1]) * (w_big // 2 // T_LEVELS[-1])
    sp_cap = K * M_tile
    sp_mesh = make_spatial_mesh(n_sp, devices=devices)
    sp_step = spatial_match_step(sp_mesh, T_LEVELS, (h_big, w_big), n_sp,
                                 halo, cand_cap=sp_cap, distinct_cap=K)
    ks, xs, ys, scs, vs, na = sp_step(
        slice_tiles(big, n_sp, halo), WEAK_THRESHOLD, 30.0,
        shard_banks(sp_mesh, sp_banks, split=False))
    _check(ks.shape[0] == sp_cap * n_sp,
           f"spatial candidates of shape {tuple(ks.shape)}")

    # single-device full-frame reference for the spatial half
    M_big = (h_big // 2 // T_LEVELS[-1]) * (w_big // 2 // T_LEVELS[-1])
    fk, fx, fy, fsc, fvalid, _ = _single(big[None], sp_banks, K * M_big,
                                         30.0, dev0)
    (sp_got,) = match_sets(ks[None], xs[None], ys[None], scs[None],
                           vs[None])
    (sp_want,) = match_sets(fk, fx, fy, fsc, fvalid)
    _check(sp_got == sp_want,
           "spatial-sharded match != single-device match")

    print(f"dryrun_multichip ok: mesh {mesh.devices.shape} "
          f"(data={n_data}, templ={n_templ}), candidates "
          f"{tuple(k.shape)}, n_above {n_above.cpu().tolist()}, "
          f"spatial {n_sp}-shard candidates {int(vs.sum())}; "
          f"parity ok: mesh match set == single-device "
          f"({n_mesh_matches} matches over {B} frames), spatial match set "
          f"== single-device full frame ({len(sp_want)} matches), "
          f"sharded training bank == single-device bank bit-exact "
          f"({n_train} templates over {B2} frames), sharded production "
          f"detect+ICP poses == single-device bit-exact "
          f"({n_refined} refined matches over {B3} frames)")
