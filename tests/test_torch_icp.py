"""The production refine path of the PyTorch port (``models/icp.py``)
against the JAX package's ``models/icp.py``, on the CPU.

Bitwise: the octant of every integer gradient, the edge mask, the
offsets to the nearest edge and the within-radius mask, the jump flood's
seed planes (a Gauss-Seidel sweep: a Jacobi flood differs on the same
frame), the top_c selection order and every match key. Within float32
rounding (XLA contracts multiply-adds and sums in its own order): unit
normals to 2 ulps, subpixel offsets to 2^-22, and poses within the
tolerance of JAX's own host-vs-packed tests (tests/test_icp.py):
|d dtheta| < 1e-3 degrees, |d dscale| < 1e-4, |d tx|, |d ty| < 1e-2 px.
The port alone meets tests/test_icp.py's accuracy contract.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shape_based_matching_tpu import Detector as JDetector
from shape_based_matching_tpu.models import icp as jicp
from shape_based_matching_tpu.utils import verify as jverify
from shape_based_matching_tpu.utils.synthetic import (
    synthetic_scene as jscene)
from shape_based_matching_tpu_torch import Detector, Match
from shape_based_matching_tpu_torch.models import icp
from shape_based_matching_tpu_torch.ops.cuda import icp_field
from shape_based_matching_tpu_torch.utils import profiling
from shape_based_matching_tpu_torch.utils import synthetic as tsyn
from shape_based_matching_tpu_torch.utils.verify import bgr2gray_u8

from .test_icp import _forward, _warp_into
from .torch_csrc import constants

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "torch_port_production_icp.json")
TOL = {"dtheta_deg": 1e-3, "dscale": 1e-4, "tx": 1e-2, "ty": 1e-2}
SUBPIX_ABS = 2.0 ** -22  # 4 ulps of 0.5, the largest |subpix|


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _pose_dev(got: list, want: list) -> dict:
    """Largest |difference| of each pose field of two result lists of the
    refine_matches_icp schema; valid and inliers must be equal."""
    dev = {f: 0.0 for f in TOL}
    for g, w in zip(got, want, strict=True):
        assert g["valid"] == w["valid"] and g["inliers"] == w["inliers"]
        for f in TOL:
            dev[f] = max(dev[f], abs(g[f] - w[f]))
    return dev


def _within(dev: dict) -> bool:
    return all(v < TOL[f] for f, v in dev.items())


def _key(m):
    return (m.template_id, m.x, m.y,
            int(np.float32(m.similarity).view(np.uint32)))


def test_octant_every_integer_gradient():
    """The NMS direction of every integer (dx, dy) in [-1020, 1020]^2 (the
    Sobel range of uint8 frames) equals JAX's jitted arctan2 octant: no
    pair lies within an ulp of an octant boundary, so torch.atan2 and
    XLA's may differ in the last bit and still agree."""
    g = np.arange(-1020, 1021, dtype=np.float32)
    dx, dy = (a.reshape(-1) for a in np.meshgrid(g, g, indexing="ij"))
    want = jax.jit(lambda x, y: jnp.round(jnp.arctan2(y, x) / (jnp.pi / 4))
                   .astype(jnp.int32) % 4)(dx, dy)
    got = icp.octant(torch.from_numpy(dx), torch.from_numpy(dy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) == {0, 1, 2, 3}


def _square():
    img = np.full((64, 64), 10, np.uint8)
    img[20:44, 20:44] = 200  # tests/test_icp.py's square
    return img


def _warped_star():
    templ = tsyn.synthetic_shape_image(96, 3)
    return _warp_into(np.full((128, 160), 10, np.uint8), templ, 7.0, 1.0,
                      (12.0, 9.0))


@pytest.mark.parametrize("frame", [_square, _warped_star])
def test_edge_field_equals_jax(frame):
    img = frame()
    want = jicp.edge_nearest_field(jnp.asarray(img), 30.0, 8)
    got = icp.edge_nearest_field(torch.from_numpy(img), 30.0, 8)
    off, normal, edge, has, subpix = (t.numpy() for t in got)
    np.testing.assert_array_equal(edge, np.asarray(want[2]))
    np.testing.assert_array_equal(has, np.asarray(want[3]))
    np.testing.assert_array_equal(off, np.asarray(want[0]))
    assert edge.sum() > 50 and has.mean() > 0.2
    assert _ulps(normal, want[1]) <= 2
    assert np.abs(subpix - np.asarray(want[4])).max() <= SUBPIX_ABS


def _jacobi_flood(edge: np.ndarray, radius: int) -> np.ndarray:
    """The textbook jump flood: every neighbour of a stride reads the
    seeds as they were before the stride."""
    h, w = edge.shape
    big = icp.BIG
    rows, cols = np.mgrid[0:h, 0:w]
    seed = np.stack([np.where(edge, rows, big), np.where(edge, cols, big)])

    def dist2(s):
        d = (s - np.stack([rows, cols])).astype(np.float32)
        return np.where(s[0] >= big, np.float32(1e18), d[0] * d[0]
                        + d[1] * d[1])

    for s in icp._strides(radius):
        pad = np.pad(seed, ((0, 0), (s, s), (s, s)), constant_values=big)
        best, new = dist2(seed), seed.copy()
        for dr in (-s, 0, s):
            for dc in (-s, 0, s):
                cand = pad[:, s + dr:s + dr + h, s + dc:s + dc + w]
                d = dist2(cand)
                take = d < best
                best = np.where(take, d, best)
                new = np.where(take, cand, new)
        seed = new
    return seed


def test_jump_flood_is_jax_gauss_seidel():
    """Random sparse seeds give many ties and near-ties: the port's seed
    planes equal JAX's bit for bit, where a Jacobi flood differs."""
    edge = np.random.RandomState(1).rand(64, 64) < 0.01
    want = jax.jit(jicp._jump_flood_impl, static_argnames=("radius",))(
        jnp.asarray(edge), radius=8)
    got = icp._jump_flood(torch.from_numpy(edge), 8).numpy()
    np.testing.assert_array_equal(got, np.stack([np.asarray(w)
                                                 for w in want]))
    assert (_jacobi_flood(edge, 8) != got).any(axis=0).sum() > 0


FIELD_K = constants("icp_field.cu")


def _sub_sweeps(seed, y, x, h, w, s):
    """The 8 neighbours of stride s, in order, over a region of the seed
    planes [2, R, C] whose frame coordinates are y [R, 1], x [1, C]: each
    neighbour read as the ones before it left the region (Jacobi within
    one); cells outside the frame hold BIG and stay, and a neighbour
    outside the region is BIG (never taken: the kernel keeps the seed)."""
    big = icp.BIG
    R, C = seed.shape[1:]
    frame = (y >= 0) & (y < h) & (x >= 0) & (x < w)

    def dist2(sd):
        dr = (sd[0] - y).astype(np.float32)
        dc = (sd[1] - x).astype(np.float32)
        return np.where(sd[0] >= big, np.float32(1e18), dr * dr + dc * dc)

    for dr in (-s, 0, s):
        for dc in (-s, 0, s):
            if dr == 0 and dc == 0:
                continue
            pad = np.pad(seed, ((0, 0), (s, s), (s, s)), constant_values=big)
            cand = pad[:, s + dr:s + dr + R, s + dc:s + dc + C]
            take = frame & (dist2(cand) < dist2(seed))
            seed = np.where(take, cand, seed)
    return seed


def _tiled_flood(edge: np.ndarray, radius: int, th: int, tw: int,
                 halo_max: int) -> np.ndarray:
    """icp_field.cu's flood replayed in NumPy: a stride s <= halo_max as
    th x tw tiles that each stage their seeds and a 3s halo (BIG outside
    the frame), run the 8 neighbours on that region and write their tile
    to another buffer; a larger stride as 8 frame-wide ping-pong sweeps."""
    h, w = edge.shape
    big = icp.BIG
    rows, cols = np.mgrid[0:h, 0:w]
    seed = np.stack([np.where(edge, rows, big),
                     np.where(edge, cols, big)]).astype(np.int32)
    for s in icp._strides(radius):
        if s > halo_max:
            seed = _sub_sweeps(seed, rows[:, :1], cols[:1], h, w, s)
            continue
        g = 3 * s
        pad = np.pad(seed, ((0, 0), (g, g + th), (g, g + tw)),
                     constant_values=big)
        out = np.empty_like(seed)
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                y = np.arange(ty - g, ty + th + g)[:, None]
                x = np.arange(tx - g, tx + tw + g)[None, :]
                reg = _sub_sweeps(pad[:, ty:ty + th + 2 * g,
                                      tx:tx + tw + 2 * g], y, x, h, w, s)
                oh, ow = min(th, h - ty), min(tw, w - tx)
                out[:, ty:ty + oh, tx:tx + ow] = reg[:, g:g + oh, g:g + ow]
        seed = out
    return seed


def _flood_edges(kind: str) -> np.ndarray:
    if kind == "star":  # a real edge map: many ties along the contours
        img = _warped_star()[16:112, 16:144]
        return icp._edge_frontend(torch.from_numpy(
            np.ascontiguousarray(img)), 30.0)[0].numpy()
    h, w, density = {"sparse": (64, 64, 0.01), "strip": (40, 90, 0.03),
                     "none": (33, 47, 0.0)}[kind]
    return np.random.RandomState(h + w).rand(h, w) < density


@pytest.mark.parametrize("kind,radius,tile", [
    ("sparse", 8, "kernel"), ("star", 8, "kernel"), ("strip", 8, (7, 9)),
    ("sparse", 4, (16, 32)), ("star", 16, (13, 20)), ("strip", 1, (5, 64)),
    ("none", 8, "kernel")])
def test_tiled_flood_replay_equals_jump_flood(kind, radius, tile):
    """The flood kernel's decomposition (per stride, tiles with a 3s halo
    and ping-pong buffers; above HALO_STRIDE_MAX, one launch a neighbour)
    gives ``_jump_flood``'s seed planes bit for bit: at the kernel's tile
    and at tiles that the frame's edges cut anywhere."""
    th, tw = ((FIELD_K["FLOOD_TH"], FIELD_K["FLOOD_TW"]) if tile == "kernel"
              else tile)
    edge = _flood_edges(kind)
    want = icp._jump_flood(torch.from_numpy(edge), radius).numpy()
    got = _tiled_flood(edge, radius, th, tw, FIELD_K["HALO_STRIDE_MAX"])
    np.testing.assert_array_equal(got, want)
    assert (want[0] < icp.BIG).sum() > edge.sum() or not edge.any()


def test_field_constants_and_span_strides():
    """The source's BIG is the twin's, and the span's stride count is
    len(_strides(radius)) at every radius."""
    assert FIELD_K["BIG"] == icp.BIG
    for radius in (-1, 0, 1, 2, 3, 4, 5, 8, 9, 63, 64, 65):
        with profiling.recording() as rec:
            icp.edge_nearest_field(torch.zeros((1, 1), dtype=torch.uint8),
                                   30.0, radius)
        (sp,) = rec.spans
        assert sp.attrs["strides"] == len(icp._strides(radius)), radius


def _octant4(dx: np.ndarray, dy: np.ndarray) -> np.ndarray:
    """icp_field.cu's octant4 in int32 NumPy: 0 where (|dx| + |dy|)^2 <=
    2 dx^2, 2 where it is < 2 dy^2, else 1 for dx, dy of one sign and 3
    for opposite signs."""
    ax, ay = np.abs(dx), np.abs(dy)
    s = (ax + ay) * (ax + ay)
    return np.where(s <= 2 * ax * ax, 0, np.where(
        s < 2 * ay * ay, 2, np.where((dx > 0) == (dy > 0), 1, 3))).astype(
            np.int32)


def test_octant4_equals_twin_octant_every_integer_gradient():
    """The frontend kernel's exact integer octant test, replayed, gives
    the twin's atan2 octant for every integer (dx, dy) in [-1020, 1020]^2
    (the Sobel range of uint8 frames)."""
    g = np.arange(-1020, 1021, dtype=np.int32)
    dx, dy = (a.reshape(-1) for a in np.meshgrid(g, g, indexing="ij"))
    want = icp.octant(torch.from_numpy(dx.astype(np.float32)),
                      torch.from_numpy(dy.astype(np.float32))).numpy()
    np.testing.assert_array_equal(_octant4(dx, dy), want)
    assert set(np.unique(want)) == {0, 1, 2, 3}


def test_field_cpu_route_is_the_twin_and_its_span():
    img = torch.from_numpy(_warped_star())
    before = icp_field.edge_field.launches
    with profiling.recording() as rec:
        got = icp.edge_nearest_field(img, 30.0, 8)
    want = icp.edge_nearest_field_plain(img, 30.0, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))
    assert icp_field.edge_field.launches == before
    assert [s.attrs for s in rec.spans if s.name == "sbm.icp.field"] == [
        {"route": "plain", "H": 128, "W": 160, "strides": 4}]


@pytest.mark.parametrize("shape,dtype,radius", [
    ((0, 5), torch.uint8, 8), ((5, 0), torch.uint8, 8),
    ((4, 4), torch.uint8, icp.BIG + 1), ((4, 4), torch.int16, 8),
    ((2, 4, 4), torch.uint8, 8)])
def test_field_rejects_what_the_kernel_does_not_take(shape, dtype, radius):
    with pytest.raises(ValueError):
        icp.edge_nearest_field(torch.zeros(shape, dtype=dtype), 30.0, radius)


def _icp_both(img, pts, origins, pv, **kw):
    jf = jicp.edge_nearest_field(jnp.asarray(img), 30.0, 8)
    tf = icp.edge_nearest_field(torch.from_numpy(img), 30.0, 8)
    want = jicp.icp_refine_points(jf[0], jf[1], jf[3], jf[4],
                                  jnp.asarray(pts), jnp.asarray(origins),
                                  jnp.asarray(pv), **kw)
    got = icp.icp_refine_points(tf[0], tf[1], tf[3], tf[4],
                                torch.from_numpy(pts),
                                torch.from_numpy(origins),
                                torch.from_numpy(pv), **kw)
    return got, want


def test_icp_refine_points_random_equals_jax():
    """bench.py _measure_icp's input at a small size: random points in a
    48 px box at random origins on a synthetic scene. Random
    correspondences drive some candidates' scale far below 0.5, where the
    pose is ill-conditioned and rounding differences grow without bound
    in both packages; those are held to equal inliers and validity, the
    others (most of them) to the pose tolerance too."""
    img = jscene(192, 192, tsyn.synthetic_shape_image(64, 0), n_instances=3,
                 seed=5)
    rng = np.random.RandomState(6)
    pts = (rng.rand(24, 40, 2) * 48).astype(np.float32)
    origins = rng.randint(8, 140, (24, 2)).astype(np.float32)
    pv = rng.rand(24, 40) < 0.9
    got, want = _icp_both(img, pts, origins, pv, iters=10, radius=8)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    sim = (np.asarray(want.dscale) >= 0.5) & (np.asarray(want.dscale) <= 2)
    assert sim.sum() >= 16
    for f in TOL:
        d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f)))
        assert d[sim].max() < TOL[f], (f, d[sim].max())


def test_icp_refine_points_template_equals_jax():
    """A trained template's level-0 points at the scene's instances, the
    origins off by up to 3 px and a random tenth of the points dead:
    every candidate's pose agrees."""
    templ = tsyn.synthetic_shape_image(64, 0)
    det = Detector(num_features=48, device="cpu")
    assert det.add_template(templ, "t", np.full_like(templ, 255)) == 0
    t0 = det.get_templates("t", 0)[0]
    feats = np.array([(f.x, f.y) for f in t0.features], np.float32)
    img = np.full((192, 192), 10, np.uint8)
    tops = [(10, 20), (100, 30), (40, 110)]
    for x, y in tops:
        img[y:y + 64, x:x + 64] = np.maximum(img[y:y + 64, x:x + 64], templ)
    rng = np.random.RandomState(7)
    C = 24
    pts = np.broadcast_to(feats, (C, *feats.shape)).copy()
    base = np.array([(x + t0.tl_x, y + t0.tl_y) for x, y in tops])
    origins = (base[np.arange(C) % 3] + rng.randint(-3, 4, (C, 2))).astype(
        np.float32)
    pv = rng.rand(C, feats.shape[0]) < 0.9
    got, want = _icp_both(img, pts, origins, pv, iters=12, radius=8)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert got.valid.numpy().all() and np.asarray(want.valid).all()
    for f in TOL:
        d = np.abs(getattr(got, f).numpy() - np.asarray(getattr(want, f)))
        assert d.max() < TOL[f], (f, d.max())


@pytest.fixture(scope="module")
def warped():
    """tests/test_icp.py's setup: a template trained on the star, in the
    port and in JAX, and three scenes warped by (angle, scale) at offset
    (61, 47)."""
    templ = tsyn.synthetic_shape_image(128, 6)
    det = Detector(num_features=63, device="cpu")
    jdet = JDetector(num_features=63)
    for d in (det, jdet):
        assert d.add_template(templ, "s", np.full_like(templ, 255)) == 0
    scenes = {(a, s): _warp_into(np.full((256, 256), 12, np.uint8), templ,
                                 a, s, (61.0, 47.0))
              for a, s in [(2.5, 1.02), (-3.0, 0.985), (0.0, 1.0)]}
    return det, jdet, scenes


@pytest.mark.parametrize("angle,scale", [(2.5, 1.02), (-3.0, 0.985),
                                         (0.0, 1.0)])
def test_icp_accuracy_contract_and_jax(warped, angle, scale):
    """tests/test_icp.py's contract on the port alone (pose within 0.1
    degree and 0.5% scale, median point error under 0.35 px), and the
    port's poses against JAX's on the same match."""
    det, jdet, scenes = warped
    scene = scenes[(angle, scale)]
    matches = det.match(scene, 55.0)
    assert matches and matches[0].template_id == 0
    assert [_key(m) for m in matches] == [_key(m)
                                          for m in jdet.match(scene, 55.0)]
    res = icp.refine_matches_icp(det, scene, matches[:1])[0]
    assert res["valid"] and res["inliers"] >= 30
    t0 = det.get_templates("s", 0)[0]
    feats = np.array([(f.x, f.y) for f in t0.features], np.float64)
    truth = _forward(feats + np.array([t0.tl_x, t0.tl_y]), angle, scale,
                     np.array([63.5, 63.5]), (61.0, 47.0))
    phi, s = np.deg2rad(res["dtheta_deg"]), res["dscale"]
    pred = np.stack([
        s * (np.cos(phi) * feats[:, 0] - np.sin(phi) * feats[:, 1])
        + res["tx"],
        s * (np.sin(phi) * feats[:, 0] + np.cos(phi) * feats[:, 1])
        + res["ty"]], axis=1)
    assert np.median(np.sqrt(((pred - truth) ** 2).sum(1))) < 0.35
    assert abs(res["dtheta_deg"] - angle) < 0.1
    assert abs(res["dscale"] - scale) < 0.005
    assert res["rmse"] < 0.5
    want = jicp.refine_matches_icp(jdet, scene, matches[:1])
    assert _within(_pose_dev([res], want))


def test_bgr_frame_refines_as_its_gray(warped):
    """A BGR frame goes through the exact OpenCV gray conversion (JAX's
    utils/verify.bgr2gray_u8, bit for bit) before the edge field."""
    det, _, scenes = warped
    gray = scenes[(2.5, 1.02)]
    rng = np.random.RandomState(2)
    bgr = np.stack([gray, rng.randint(0, 256, gray.shape), gray // 2],
                   axis=-1).astype(np.uint8)
    want = jverify.bgr2gray_u8(bgr)
    np.testing.assert_array_equal(
        bgr2gray_u8(torch.from_numpy(bgr)).numpy(), want)
    matches = det.match(want, 40.0)[:2]
    assert matches
    assert icp.refine_matches_icp(det, bgr, matches) == \
        icp.refine_matches_icp(det, want, matches)


def test_icp_invalid_when_no_edges(warped):
    det = warped[0]
    flat = np.full((128, 128), 50, np.uint8)
    assert not icp.refine_matches_icp(
        det, flat, [Match(10, 10, 90.0, "s", 0)])[0]["valid"]


def test_match_icp_one_download_equals_two_download_flow(warped,
                                                         monkeypatch):
    """match_icp equals match -> refine_matches_icp (the scene holds one
    class whose candidates fit the cap), with one download; its async
    form downloads nothing at dispatch, equals it, and memoizes."""
    det, _, scenes = warped
    downloads = []
    real = icp._to_host
    monkeypatch.setattr(icp, "_to_host",
                        lambda t: downloads.append(1) or real(t))
    frames = list(scenes.values())
    want = [icp.refine_matches_icp(det, f, det.match(f, 55.0)[:8])
            for f in frames]
    downloads.clear()
    got = [det.match_icp(f, 55.0, top_c=8) for f in frames]
    assert len(downloads) == len(frames)
    for g, w in zip(got, want):
        assert [_key(r["match"]) for r in g] == [_key(r["match"])
                                                 for r in w]
        assert _within(_pose_dev(g, w))
        keys = [r["match"].sort_key() for r in g]
        assert keys == sorted(keys)
    downloads.clear()
    handles = [det.match_icp_async(f, 55.0, top_c=8) for f in frames]
    assert not downloads
    results = [h.result() for h in handles]
    assert len(downloads) == len(frames)
    assert results == got
    assert handles[0].result() is results[0]


def test_match_refine_batch_equals_refine_matches_icp(warped):
    det, _, scenes = warped
    frames = np.stack(list(scenes.values()))
    out = icp.match_refine_batch(det, frames, 55.0, top_c=8)["s"]
    assert len(out) == len(frames)
    for b, res in enumerate(out):
        assert not bool(res["overflow"])
        live = torch.isfinite(res["score"]).numpy()
        assert live.any() and not live.all()
        assert not res["icp"].valid.numpy()[~live].any()
        rows = np.nonzero(live)[0]
        want = icp.refine_matches_icp(det, frames[b], [
            Match(int(res["x"][i]), int(res["y"][i]),
                  float(res["score"][i]), "s", int(res["k"][i]))
            for i in rows])
        got = [{f: (getattr(res["icp"], f)[i].item()) for f in
                ("dtheta_deg", "dscale", "tx", "ty", "inliers", "valid")}
               for i in rows]
        assert _within(_pose_dev(got, want))


def test_top_c_ties_follow_lax_top_k():
    """LINE-2D scores tie often; the selection takes the lower index
    first among equal scores, as lax.top_k does (a stable sort)."""
    rng = np.random.RandomState(3)
    C = 64
    sc = rng.choice(np.float32([90.0, 87.5, 85.0]), C)
    valid = rng.rand(C) < 0.8
    k = rng.randint(0, 4, C).astype(np.int32)
    x = rng.randint(0, 200, C).astype(np.int32)
    y = rng.randint(0, 200, C).astype(np.int32)
    img = jscene(256, 256, tsyn.synthetic_shape_image(64, 0), n_instances=2,
                 seed=4)
    bank = JDetector(num_features=32)
    bank.add_template(tsyn.synthetic_shape_image(64, 0), "t",
                      np.full((64, 64), 255, np.uint8))
    bank.add_templates_rotate("t", 0, [90.0, 180.0, 270.0], (32.0, 32.0))
    jb = bank._get_banks("t")[0]
    jf = jicp.edge_nearest_field(jnp.asarray(img), 30.0, 8)
    _, jkk, jox, joy, jsc = jicp.refine_packed_candidates(
        jf[0], jf[1], jf[3], jf[4], jb.fx, jb.fy, jb.valid, *(
            jnp.asarray(a) for a in (k, x, y, sc, valid)), top_c=24)
    tf = icp.edge_nearest_field(torch.from_numpy(img), 30.0, 8)
    _, kk, ox, oy, tsc = icp.refine_packed_candidates(
        tf[0], tf[1], tf[3], tf[4], *(torch.from_numpy(np.array(a)) for a
                                      in (jb.fx, jb.fy, jb.valid, k, x, y,
                                          sc, valid)), top_c=24)
    for a, b in ((kk, jkk), (ox, jox), (oy, joy), (tsc, jsc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(set(sc[valid].tolist())) < int(valid.sum())  # ties


def test_retraining_drops_the_class_icp_points(warped):
    det = Detector(num_features=32, device="cpu")
    img = tsyn.synthetic_shape_image(64, 0)
    for cid in ("a", "b"):
        det.add_template(img, cid, np.full_like(img, 255))
        icp._template_icp_points(det, cid, 0)
    assert set(det._icp_pts) == {("a", 0), ("b", 0)}
    det.add_templates_rotate("a", 0, [45.0], (32.0, 32.0))
    assert set(det._icp_pts) == {("b", 0)}
    det.add_template(img, "b")
    assert not det._icp_pts


def test_production_golden():
    """bench.py's production configuration at full width: the committed
    1000 x 128 bank on a 1024^2 frame at threshold 85, top 32 candidates,
    cap 256. match_icp equals the JAX golden: match keys bitwise and in
    order, poses within the tolerance."""
    golden = json.load(open(GOLDEN))
    cfg = golden["config"]
    det = Detector(num_features=cfg["num_features"], T=tuple(cfg["T"]),
                   device="cpu")
    det.class_templates[golden["class_id"]] = tsyn.load_bank_cache(
        os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     cfg["bank"]))
    frame, _ = tsyn.config_frame(cfg)
    got = det.match_icp(frame, cfg["threshold"], top_c=cfg["top_c"],
                        iters=cfg["iters"], radius=cfg["radius"],
                        cand_cap=cfg["cand_cap"])
    assert [list(_key(r["match"])) for r in got] == [
        e["match"] for e in golden["entries"]]
    assert _within(_pose_dev(got, golden["entries"]))
