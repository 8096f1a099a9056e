"""The port's row-sharded huge-frame match (``parallel/spatial.py``)
against the JAX package's, on shards of the CPU.

The tile geometry and the halo are held to the JAX functions themselves
(host code); the match lists to the goldens that JAX's own
``match_huge_frame`` made on 4 virtual devices
(``tests/goldens/torch_port_spatial{1,3}_matches.json``, from
``tools/gen_torch_port_golden.py``), rows (class, template id, x, y,
float32 similarity bits), and to the port's own ``Detector.match`` of the
whole frame. No JAX ``shard_map`` program runs here.
"""

import importlib.util
import json
import os
import warnings

import numpy as np
import pytest
import torch

from shape_based_matching_tpu.ops.similarity import LevelBank as JLevelBank
from shape_based_matching_tpu.parallel import spatial as jspatial
from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.cli import main as tmain
from shape_based_matching_tpu_torch.parallel import mesh, spatial
from shape_based_matching_tpu_torch.utils import synthetic as tsyn
from shape_based_matching_tpu_torch.utils.imageio import save_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
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


@pytest.fixture(scope="module")
def fixtures():
    """name -> (port detector on the CPU, frame, golden) of the two
    spatial goldens."""
    out = {}
    for name in ("spatial1", "spatial3"):
        with open(os.path.join(GOLDENS,
                               f"torch_port_{name}_matches.json")) as f:
            golden = json.load(f)
        assert golden["config"] == gen.SHARDED[name]
        det, frames = gen.build_fixture(golden["config"], Detector, tsyn,
                                        device="cpu")
        out[name] = det, frames[0], golden
    return out


@pytest.mark.parametrize("shape,n,halo", [
    ((64, 4), 4, 8), ((64, 4, 3), 4, 8), ((640, 256), 4, 208),
    ((96, 5), 2, 16), ((256, 3), 1, 0)])
def test_slice_tiles_equal_jax(shape, n, halo):
    img = np.random.RandomState(0).randint(0, 256, shape, dtype=np.uint8)
    got = spatial.slice_tiles(img, n, halo)
    np.testing.assert_array_equal(got, jspatial.slice_tiles(img, n, halo))
    assert got.shape == (n, shape[0] // n + 2 * halo) + shape[1:]


@pytest.mark.parametrize("name", ["spatial1", "spatial3"])
def test_halo_equals_jax(fixtures, name):
    det, _, _ = fixtures[name]
    group = det.class_ids()[0]
    banks = det._get_banks(group)
    jbanks = [JLevelBank(*(f.numpy() for f in b)) for b in banks]
    T = det.T_at_level
    for port, jax_ in ((banks, jbanks), (banks[0], jbanks[0])):
        assert spatial.required_halo(port, T) == jspatial.required_halo(
            jax_, T)
        assert spatial.default_halo(port, T) == jspatial.default_halo(
            jax_, T)
    assert spatial.default_halo(banks, T) % 16 == 0


@pytest.mark.parametrize("name", ["spatial1", "spatial3"])
def test_match_huge_frame_equals_jax_golden(fixtures, name):
    """4 tiles with the default halo, instances across the band edges:
    JAX's match_huge_frame list, and the port's own whole-frame match."""
    det, frame, golden = fixtures[name]
    cfg = golden["config"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no tile may overflow
        got = spatial.match_huge_frame(
            det, frame, cfg["threshold"],
            mesh=spatial.make_spatial_mesh(cfg["n_shards"], CPU))
    assert got and rows(got) == golden["matches"]
    assert rows(got) == rows(det.match(frame, cfg["threshold"]))
    if name == "spatial3":
        assert {m.class_id for m in got} == {"c0", "c1", "c2"}


def test_match_huge_frame_bgr_and_two_shards(fixtures):
    """A BGR frame (gray=False tiles) of 1024 rows on 2 and 4 shards
    equals the whole frame's match."""
    det, frame, golden = fixtures["spatial1"]
    frame = np.concatenate([frame, frame[:384]])
    bgr = np.stack([frame, np.roll(frame, 1, axis=1), 255 - frame], -1)
    want = rows(det.match(bgr, 75.0))
    assert want
    for n in (2, 4):
        assert rows(spatial.match_huge_frame(
            det, bgr, 75.0, mesh=spatial.make_spatial_mesh(n, CPU))) == want


def test_match_huge_frame_patch_2843(fixtures):
    """A Detector(patch_2843=True) keeps its vote on every tile."""
    _, frame, golden = fixtures["spatial1"]
    det, _ = gen.build_fixture(golden["config"], Detector, tsyn,
                               device="cpu", patch_2843=True)
    want = rows(det.match(frame, 80.0))
    assert want and rows(spatial.match_huge_frame(
        det, frame, 80.0, mesh=spatial.make_spatial_mesh(4, CPU))) == want


@pytest.fixture(scope="module")
def dense():
    """A dense bank (the star at 300 rotations 0.05 degree apart) whose
    coarse level the chain planner takes at the tile's size."""
    det = Detector(num_features=48, T=(4, 8), device="cpu")
    templ = tsyn.synthetic_shape_image(56, seed=0)
    det.add_template(templ, "d", np.full_like(templ, 255))
    det.add_templates_rotate("d", 0, [0.05 * i for i in range(1, 300)],
                             (28.0, 28.0))
    scene = tsyn.synthetic_scene(640, 256, templ, n_instances=0, seed=5)
    for yy, xx in ((150, 40), (300, 150)):  # on the band edges
        scene[yy:yy + 56, xx:xx + 56] = np.maximum(
            scene[yy:yy + 56, xx:xx + 56], templ)
    return det, scene


def test_match_huge_frame_dense_bank_takes_the_tile_chain(dense):
    det, scene = dense
    m4 = spatial.make_spatial_mesh(4, CPU)
    halo = spatial.default_halo(det._get_banks("d"), det.T_at_level)
    tile_wh = (256 // 2, (640 // 4 + 2 * halo) // 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = spatial.match_huge_frame(det, scene, 90.0, mesh=m4,
                                       cand_cap=1024)
    plans = det._sharded[("d", "plans", 1, tile_wh)]
    assert plans is not None and len(plans) == 1
    assert [k for k in det._sharded if k[1] == "chain"] == [
        ("d", "chain", 1, 0, tile_wh, torch.device("cpu"))]
    want = det.match(scene, 90.0)
    assert len(want) > 100 and rows(got) == rows(want)
    # the cache goes with the class's other caches
    det.add_template_rotate("d", 0, 20.0, (28.0, 28.0))
    assert not [k for k in det._sharded if k[0] == "d"]


def test_overflow_warns_and_is_not_rerun(dense):
    det, scene = dense
    with pytest.warns(UserWarning, match="candidate overflow"):
        got = spatial.match_huge_frame(
            det, scene, 90.0, mesh=spatial.make_spatial_mesh(4, CPU),
            cand_cap=64)
    assert 0 < len(got) < len(det.match(scene, 90.0))
    # cand_cap=None (the CLI's) re-runs the frame at a cap that holds all
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        whole = spatial.match_huge_frame(
            det, scene, 90.0, mesh=spatial.make_spatial_mesh(4, CPU),
            cand_cap=None)
    assert rows(whole) == rows(det.match(scene, 90.0))


@pytest.mark.parametrize("size_hw,n,halo,what", [
    ((600, 256), 4, 208, "multiples"),   # band 150
    ((640, 256), 4, 200, "multiples"),   # halo 200
    ((256, 256), 4, 224, "tile"),        # tile 512 > 256
])
def test_step_errors_equal_jax(size_hw, n, halo, what):
    jmesh = jspatial.make_spatial_mesh(n)
    with pytest.raises(ValueError, match=what) as jerr:
        jspatial.spatial_match_step(jmesh, (4, 8), size_hw, n, halo)
    with pytest.raises(ValueError, match=what) as err:
        spatial.spatial_match_step(spatial.make_spatial_mesh(n, CPU),
                                   (4, 8), size_hw, n, halo)
    assert str(err.value) == str(jerr.value)


def test_match_huge_frame_errors(fixtures):
    det, frame, _ = fixtures["spatial1"]
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        spatial.match_huge_frame(det, frame, 80.0,
                                 mesh=spatial.make_spatial_mesh(3, CPU))
    with pytest.raises(ValueError, match="required"):
        spatial.match_huge_frame(det, frame, 80.0, halo=16,
                                 mesh=spatial.make_spatial_mesh(2, CPU))
    with pytest.raises(ValueError, match="tile"):
        spatial.match_huge_frame(det, frame[:256], 80.0, halo=224,
                                 mesh=spatial.make_spatial_mesh(4, CPU))
    with pytest.raises(ValueError, match="spatial mesh of 4"):
        spatial.spatial_match_step(mesh.make_mesh(4, devices=CPU), (4, 8),
                                   (640, 256), 4, 208)


def test_spatial_mesh_needs_cuda_or_devices():
    """Round-robin past the devices; without CUDA and without devices=
    the mesh raises (there is no CPU fallback)."""
    two = [torch.device("cpu"), torch.device("meta")]
    m = spatial.make_spatial_mesh(5, two)
    assert m.axis_names == ("spatial",) and m.devices.shape == (5,)
    assert [d.type for d in m.devices] == ["cpu", "meta"] * 2 + ["cpu"]
    assert spatial.make_spatial_mesh(devices=two).devices.shape == (2,)
    if torch.cuda.is_available():
        m = spatial.make_spatial_mesh(4)
        assert all(d.type == "cuda" for d in m.devices)
        return
    with pytest.raises(RuntimeError, match="needs CUDA"):
        spatial.make_spatial_mesh(4)


def test_cli_spatial_shards_prints_the_single_device_lines(tmp_path):
    """tests/test_cli.py's --spatial-shards setup on the port's CLI: the
    lines of --spatial-shards 2 equal those without the flag (the port's
    CLI lines equal the JAX CLI's: tests/test_torch_cli.py)."""
    import contextlib
    import io
    import re

    templ = tsyn.synthetic_shape_image(96, seed=2)
    scene = tsyn.synthetic_scene(1024, 256, templ, n_instances=2, seed=11)
    save_image(templ, str(tmp_path / "templ.png"))
    (tmp_path / "frames").mkdir()
    save_image(scene, str(tmp_path / "frames" / "scene.png"))
    model_dir = str(tmp_path / "models")
    with contextlib.redirect_stdout(io.StringIO()):
        assert tmain(["--device", "cpu", "train", "--model-dir", model_dir,
                      "--class-id", "shape", "--image",
                      str(tmp_path / "templ.png"), "--angles", "0",
                      "--scales", "1.0", "--num-features", "48",
                      "--gray"]) == 0

    def run(extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert tmain(["--device", "cpu", "match", "--model-dir",
                          model_dir, "--test-dir", str(tmp_path / "frames"),
                          "--threshold", "80", "--nms", "0.5",
                          "--gray"] + extra) == 0
        return [re.sub(r"\[match [0-9.]+ ms\]", "", l)
                for l in buf.getvalue().splitlines()]

    single = run([])
    assert any("class=" in l for l in single)
    assert run(["--spatial-shards", "2"]) == single
