"""The port's data x templ mesh (``parallel/mesh.py``) against the JAX
package's, on shards of the CPU.

Mesh shapes, bank padding and the sharded chain plans' decisions are held
to the JAX functions themselves (host code, or eager JAX ops); the match
lists to the golden that JAX's own ``match_images_sharded`` made on
meshes (2, 4), (4, 2) and (1, 2) of virtual devices
(``tests/goldens/torch_port_mesh_matches.json``) and to the port's own
``Detector.match``; sharded training to ``add_templates`` field for
field; the sharded production tier to per-frame ``match_refine_batch``
bit for bit. No JAX ``shard_map`` program runs here.
"""

import importlib.util
import json
import os
import warnings

import numpy as np
import pytest
import torch

from shape_based_matching_tpu.ops.pallas import chain_plan as jchain_plan
from shape_based_matching_tpu.ops.similarity import LevelBank as JLevelBank
from shape_based_matching_tpu.parallel import mesh as jmesh
from shape_based_matching_tpu_torch import Detector, match_refine_batch
from shape_based_matching_tpu_torch.models.detector import (
    _planar, _strong_lower_bound, _train_levels)
from shape_based_matching_tpu_torch.ops.chain_plan import plan_chain_sharded
from shape_based_matching_tpu_torch.ops.similarity import coarse_similarity
from shape_based_matching_tpu_torch.parallel import mesh
from shape_based_matching_tpu_torch.utils import synthetic as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens",
                      "torch_port_mesh_matches.json")
_spec = importlib.util.spec_from_file_location(
    "gen_torch_port_golden",
    os.path.join(ROOT, "tools", "gen_torch_port_golden.py"))
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

CPU = [torch.device("cpu")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(matches) -> list:
    return [[m.class_id, m.template_id, m.x, m.y,
             int(np.float32(m.similarity).view(np.uint32))]
            for m in matches]


def cpu_mesh(data: int, templ: int) -> mesh.Mesh:
    return mesh.make_mesh(data * templ, data=data, devices=CPU)


@pytest.fixture(scope="module")
def fixture():
    """tests/test_sharding.py's fixture on the CPU: 6 rotations of the
    star, four 192^2 frames, and JAX's sharded lists."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["config"] == gen.SHARDED["mesh"]
    det, frames = gen.build_fixture(golden["config"], Detector, tsyn,
                                    device="cpu")
    return det, frames, golden


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_equal_jax(n):
    got = mesh.make_mesh(n, devices=CPU)
    want = jmesh.make_mesh(n)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(zip(want.axis_names, want.devices.shape))


def test_make_mesh_round_robin_and_cuda():
    """More shards than devices go round-robin; a data axis that does not
    divide raises; without CUDA and without devices= the mesh raises."""
    two = [torch.device("cpu"), torch.device("meta")]
    m = mesh.make_mesh(8, devices=two)
    assert m.devices.shape == (2, 4)
    assert [d.type for d in m.devices.flat] == ["cpu", "meta"] * 4
    assert mesh.make_mesh(devices=two).devices.shape == (1, 2)
    with pytest.raises(ValueError, match="data rows"):
        mesh.make_mesh(6, data=4, devices=CPU)
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in mesh.make_mesh(2).devices.flat)
        return
    with pytest.raises(RuntimeError, match="needs CUDA"):
        mesh.make_mesh(2)


@pytest.mark.parametrize("n_shards", [1, 4, 5, 8])
def test_shard_pad_bank_equals_jax(fixture, n_shards):
    det, _, _ = fixture
    for bank in det._get_banks("s"):
        got = mesh.shard_pad_bank(bank, n_shards)
        want = jmesh.shard_pad_bank(JLevelBank(*(f.numpy() for f in bank)),
                                    n_shards)
        assert got.fx.shape[0] % n_shards == 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", ["2x4", "4x2", "1x2"])
def test_match_images_sharded_equals_jax_golden(fixture, shape):
    det, frames, golden = fixture
    data, templ = map(int, shape.split("x"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = mesh.match_images_sharded(det, frames, golden["config"][
            "threshold"], mesh=cpu_mesh(data, templ))
    assert [rows(ms) for ms in got] == golden["matches"][shape]
    for frame, ms in zip(frames, got):
        assert ms and rows(ms) == rows(det.match(frame, 70.0))


def test_patch_2843_detector_sharded_equals_its_match(fixture):
    """A Detector(patch_2843=True) keeps its vote on every shard."""
    _, frames, golden = fixture
    det, _ = gen.build_fixture(golden["config"], Detector, tsyn,
                               device="cpu", patch_2843=True)
    got = mesh.match_images_sharded(det, frames, 70.0, mesh=cpu_mesh(2, 2))
    assert [rows(ms) for ms in got] == [rows(det.match(f, 70.0))
                                        for f in frames]


def test_return_scores_equal_coarse_similarity(fixture):
    """The step's coarse scores, concatenated over templ (padding rows
    dropped), equal each frame's coarse_similarity of the whole bank."""
    det, frames, _ = fixture
    m = cpu_mesh(2, 4)
    banks = det._get_banks("s")
    step = mesh.multichip_match_step(m, det.T_at_level, (192, 192),
                                     cand_cap=64, return_scores=True)
    out = step(frames, 30.0, 80.0, mesh.shard_banks(m, banks))
    assert len(out) == 7 and out[0].shape == (4, 4 * 64)
    lms = _batch_pyramid_of(det, frames)
    for b in range(4):
        want, _ = coarse_similarity(lms[-1][b], banks[-1], 8, (96, 96))
        assert torch.equal(out[6][b, :banks[-1].fx.shape[0]], want)
        assert not out[6][b, banks[-1].fx.shape[0]:].any()


def _batch_pyramid_of(det, frames):
    from shape_based_matching_tpu_torch.models.detector import _batch_pyramid

    return _batch_pyramid(_planar(frames, "cpu"), det.T_at_level, 2,
                          det.weak_threshold)


def test_multi_class_merged_and_clamped():
    """tests/test_sharding.py's two-class scene: one merged bank on the
    mesh equals Detector.match; a merged cap past 4096 warns."""
    det = Detector(num_features=48, T=(4, 8), device="cpu")
    t_a = tsyn.synthetic_shape_image(96, seed=1)
    t_b = tsyn.synthetic_shape_image(96, seed=2)
    det.add_template(t_a, "a", np.full_like(t_a, 255))
    det.add_template_rotate("a", 0, 90.0, (48.0, 48.0))
    det.add_template(t_b, "b", np.full_like(t_b, 255))
    frames = []
    for s in (3, 4):
        scene = tsyn.synthetic_scene(256, 256, t_a, n_instances=1, seed=s)
        scene[140:236, 20:116] = np.maximum(scene[140:236, 20:116], t_b)
        frames.append(scene)
    frames = np.stack(frames)
    got = mesh.match_images_sharded(det, frames, 80.0, mesh=cpu_mesh(2, 4))
    for f, ms in zip(frames, got):
        assert {m.class_id for m in ms} == {"a", "b"}
        assert rows(ms) == rows(det.match(f, 80.0))
    with pytest.warns(UserWarning, match="clamped to 4096"):
        again = mesh.match_images_sharded(det, frames, 80.0,
                                          mesh=cpu_mesh(1, 2),
                                          cand_cap=4096)
    assert [rows(m) for m in again] == [rows(m) for m in got]


@pytest.fixture(scope="module")
def dense():
    """A dense bank (the star at 600 rotations 0.025 degree apart) and two
    160^2 frames."""
    det = Detector(num_features=48, T=(4, 8), device="cpu")
    templ = tsyn.synthetic_shape_image(56, seed=0)
    det.add_template(templ, "d", np.full_like(templ, 255))
    det.add_templates_rotate("d", 0, [0.025 * i for i in range(1, 600)],
                             (28.0, 28.0))
    frames = np.stack([tsyn.synthetic_scene(160, 160, templ, n_instances=1,
                                            seed=s) for s in (1, 2)])
    return det, frames


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_plan_chain_sharded_decides_as_jax(dense, n):
    """Engaged or declined slice by slice as JAX decides, with the padded
    bank (the JAX package's _get_chain_sharded plans the padded one); K
    not a multiple of n declines; each slice's plan is plan_chain's."""
    det, _ = dense
    bank = mesh.shard_pad_bank(det._get_banks("d")[-1], n)
    fields = [f.numpy() for f in bank]
    ours = plan_chain_sharded(JLevelBank(*fields), n, 8, (80, 80), 8)
    theirs = jchain_plan.plan_chain_sharded(JLevelBank(*fields), n, 8,
                                            (80, 80), 8)
    assert (ours is None) == (theirs is None)
    # slices of 200 or 86 templates are below the planner's 256
    assert (ours is not None) == (n <= 2)
    assert plan_chain_sharded(JLevelBank(*(f[:-1] for f in fields)), 2, 8,
                              (80, 80), 8) is None


def test_dense_bank_per_slice_chain_plans(dense):
    det, frames = dense
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = mesh.match_images_sharded(det, frames, 90.0,
                                        mesh=cpu_mesh(1, 2), cand_cap=1024)
    plans = det._sharded[("d", "plans", 2, (80, 80))]
    assert plans is not None and len(plans) == 2
    for f, ms in zip(frames, got):
        assert len(ms) > 50 and rows(ms) == rows(det.match(f, 90.0))


def test_match_errors(fixture):
    det, frames, _ = fixture
    with pytest.raises(ValueError, match="not divisible by the mesh data"):
        mesh.match_images_sharded(det, frames[:3], 70.0, mesh=cpu_mesh(2, 1))
    with pytest.raises(ValueError, match="not tileable"):
        mesh.match_images_sharded(det, frames[:, :100], 70.0,
                                  mesh=cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="no trained class"):
        mesh.match_images_sharded(Detector(device="cpu"), frames, 70.0,
                                  mesh=cpu_mesh(1, 2))


def flat(det, cid):
    return [[(t.width, t.height, t.tl_x, t.tl_y, t.pyramid_level, t.sscale,
              t.orientation, t.tag_field_id, t.fiducial_src,
              [(f.x, f.y, f.label, f.theta) for f in t.features])
             for t in tp] for tp in det.class_templates[cid]]


@pytest.mark.parametrize("case", ["gray96", "masked64", "bgr64",
                                  "patch64"])
def test_add_templates_sharded_equals_add_templates(case):
    """tests/test_sharding.py's sweeps (19 gray 96^2 frames; 9 masked 64^2
    frames), a BGR one and a #2843 one on a (2, 4) mesh, one frame a
    device a chunk: the same ids and templates, field for field."""
    n, size, nfeat, seed = {"gray96": (19, 96, 63, 500),
                            "masked64": (9, 64, 31, 700),
                            "bgr64": (9, 64, 31, 800),
                            "patch64": (9, 64, 31, 900)}[case]
    frames = np.stack([tsyn.synthetic_shape_image(size, seed=seed + i)
                       for i in range(n)])
    masks = None
    if case == "masked64":
        masks = np.full(frames.shape, 255, np.uint8)
        masks[:, :8] = 0
    if case == "bgr64":
        frames = np.stack([frames, np.roll(frames, 1, axis=2), 255 - frames],
                          -1)
    meta = {"sscales": np.linspace(0.9, 1.1, n), "tag_field_ids": range(n)}
    patch = case == "patch64"  # the #2843 vote in training
    local = Detector(num_features=nfeat, patch_2843=patch, device="cpu")
    ids = local.add_templates(frames, "cls", masks, **meta)
    sharded = Detector(num_features=nfeat, patch_2843=patch, device="cpu")
    got = mesh.add_templates_sharded(sharded, frames, "cls", masks,
                                     mesh=cpu_mesh(2, 4), chunk_per_dev=1,
                                     **meta)
    assert got == ids and -1 not in ids
    assert flat(sharded, "cls") == flat(local, "cls")


def test_train_step_gathers_the_local_device_half():
    """multichip_train_step's gathered lists equal _train_levels of the
    whole batch, array for array; its count is their strong pixels."""
    frames = np.stack([tsyn.synthetic_shape_image(64, seed=100 + i)
                       for i in range(16)])
    step = mesh.multichip_train_step(cpu_mesh(2, 4), (64, 64))
    levels, total = step(frames)
    want = _train_levels(_planar(frames, "cpu"), None, 2, 30.0,
                         _strong_lower_bound(60.0), 8)
    assert len(levels) == 2
    for ((host, n_e, n_s), hw), ((w_host, w_e, w_s), w_hw) in zip(levels,
                                                                 want):
        assert (n_e, n_s, hw) == (w_e, w_s, w_hw)
        np.testing.assert_array_equal(host, w_host)
    assert total == sum(n_s for (_, _, n_s), _ in want)
    with pytest.raises(ValueError, match="not divisible"):
        step(frames[:15])
    with pytest.raises(ValueError, match="has_mask=False"):
        step(frames, np.zeros_like(frames))


def test_refine_step_equals_match_refine_batch():
    """tests/test_sharding.py's production fixture at 128^2 on a (2, 2)
    mesh: every output of every frame equals per-frame
    match_refine_batch, bit for bit."""
    det = Detector(num_features=31, T=(4, 8), device="cpu")
    templ = tsyn.synthetic_shape_image(96, seed=2)
    assert det.add_template(templ, "cls", np.full_like(templ, 255)) == 0
    det.add_templates_rotate("cls", 0, [30.0, 60.0, 120.0], (48, 48))
    frames = np.stack([tsyn.synthetic_scene(128, 128, templ, n_instances=1,
                                            seed=40 + i) for i in range(4)])
    m = cpu_mesh(2, 2)
    banks = det._get_banks("cls")
    step = mesh.multichip_refine_step(m, det.T_at_level, (128, 128),
                                      cand_cap=64, distinct_cap=8, top_c=4)
    got = step(frames, 30.0, 80.0, mesh.shard_banks(m, banks, False),
               mesh.shard_chains(m, banks[-1], 8, (64, 64), 8, False))
    assert len(got) == 11 and all(g.shape[:2] == (4, 4) for g in got)
    assert int(got[6].sum()) > 0
    for b in range(4):
        r = match_refine_batch(det, frames[b:b + 1], 80.0, top_c=4,
                               iters=10, radius=8, cand_cap=64)["cls"][0]
        for g, w in zip(got, [*r["icp"], r["k"], r["x"], r["y"],
                              r["score"]]):
            if w.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g[b], w)
    with pytest.raises(ValueError, match="not divisible by the 4 mesh"):
        step(frames[:3], 30.0, 80.0, mesh.shard_banks(m, banks, False))
