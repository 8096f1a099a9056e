"""The reference: its torch match against the frozen scalar oracle, and
against the port on the CPU twins at a small size; its training against
the port's; its control fails the comparison."""

import numpy as np
import pytest
import torch

from portbench import control, frames, harness
from portbench.reference import line2d, oracle_np, training

from .conftest import SEED, TINY_CONFIG, TINY_TRAFFIC

MIX = dict(TINY_TRAFFIC["b1"], pool=3)


@pytest.fixture(scope="module")
def scene():
    shape = frames.shape_image(TINY_CONFIG, SEED)
    bank = training.train_bank(shape, frames.template_angles(TINY_CONFIG),
                               48, 2, 30.0, 60.0)
    pool = frames.frame_pool(TINY_CONFIG, MIX, shape, SEED)
    return shape, bank, pool


def test_linear_memories_equal_the_oracle(scene):
    _, _, pool = scene
    img = pool[0][:160, :192]
    lms, sizes = line2d.lm_pyramid(torch.from_numpy(img.copy()), (4, 8),
                                   30.0)
    want, want_sizes = oracle_np.build_lm_pyramid(img, 30.0, (4, 8))
    assert sizes == want_sizes
    for a, b in zip(lms, want):
        assert np.array_equal(a.numpy(), b)


def _oracle_views(bank, level):
    return [{"features": [(f["x"], f["y"], f["label"])
                          for f in tp[level]["features"]],
             "width": tp[level]["width"], "height": tp[level]["height"]}
            for tp in bank]


def test_match_equals_the_scalar_oracle(scene):
    _, bank, pool = scene
    sub = bank[::6]  # 12 templates: the scalar oracle is slow
    img = pool[1]
    banks = [line2d.pack_bank(training.level_views(sub, l), "cpu")
             for l in range(2)]
    got = line2d.match_frame(torch.from_numpy(img.copy()), banks, (4, 8),
                             30.0, 60.0)
    lms, sizes = oracle_np.build_lm_pyramid(img, 30.0, (4, 8))
    tps = [[_oracle_views(sub, l)[k] for l in range(2)]
           for k in range(len(sub))]
    want = {(m["template_id"], m["x"], m["y"],
             int(np.float32(m["similarity"]).view(np.int32)))
            for m in oracle_np.match_class(lms, sizes, (4, 8), tps, 60.0)}
    assert want and got == want


def test_bank_and_match_equal_the_port_on_the_cpu(scene):
    from shape_based_matching_tpu_torch import Detector

    shape, bank, pool = scene
    det = Detector(48, (4, 8), 30.0, 60.0, device="cpu")
    det.add_template(shape, "bench", np.full_like(shape, 255))
    det.add_templates_rotate("bench", 0,
                             frames.template_angles(TINY_CONFIG)[1:],
                             (64.0, 64.0))
    assert harness.port_fingerprint(det) == training.fingerprint(bank)
    banks = [line2d.pack_bank(training.level_views(bank, l), "cpu")
             for l in range(2)]
    total = 0
    for img in pool:
        got, repeats = harness.answer_set(harness.answer_rows(
            det.match(img, 75.0)))
        want = line2d.match_frame(torch.from_numpy(img.copy()), banks,
                                  (4, 8), 30.0, 75.0)
        assert repeats == 0 and got == want
        total += len(want)
    assert total > 0


def test_rotation_is_addtemplate_rotate(scene):
    _, bank, _ = scene
    base = bank[0]
    # by 0 deg: the positions and the box stay; each label is recomputed
    # from the feature's raw gradient angle, int(angle * 16 / 360 + 0.5) & 7
    again = training.rotate(base, 0.0, (64.0, 64.0))
    for t0, t1 in zip(base, again):
        assert (t0["width"], t0["height"], t0["tl_x"], t0["tl_y"]) == (
            t1["width"], t1["height"], t1["tl_x"], t1["tl_y"])
        assert [(f["x"], f["y"]) for f in t0["features"]] == [
            (f["x"], f["y"]) for f in t1["features"]]
        assert [int(np.float32(f["theta"]) * np.float32(16) / np.float32(360)
                    + np.float32(0.5)) & 7 for f in t0["features"]] == [
            f["label"] for f in t1["features"]]
    # by 90 deg about the centre: (x, y) -> (y, -x) about it, labels + 4
    quarter = training.rotate(base, 90.0, (64.0, 64.0))
    q0 = quarter[0]
    got = sorted((f["x"] + q0["tl_x"], f["y"] + q0["tl_y"])
                 for f in q0["features"])
    b0 = base[0]
    want = sorted((int(f["y"] + b0["tl_y"]), int(128 - (f["x"] + b0["tl_x"])))
                  for f in b0["features"])
    assert got == want


def test_the_control_fails_the_comparison(tiny_root):
    readings = [control.control_readings("tiny.b1", s, "cpu", tiny_root)
                for s in (SEED, SEED + 1, SEED + 2)]
    for r in readings:
        assert r["lists_checked"] == 4 and r["lists_missing"] == 0
        assert r["list_mismatch"] > 0, r
        assert r["bank_mismatch"] > 0, r
