"""The traffic generator: determinism per seed, the same work for every
seed, the rotation."""

import numpy as np

from portbench import frames

from .conftest import TINY_CONFIG, TINY_TRAFFIC

MIX = dict(TINY_TRAFFIC["b1"], pool=12, instances=[1, 2, 3, 4],
           check_frames=5)


def test_same_seed_same_inputs_other_seed_other_inputs():
    for seed in (0, 7, 2 ** 31 + 3, 2 ** 40 + 1, -5):
        a = frames.shape_image(TINY_CONFIG, seed)
        b = frames.shape_image(TINY_CONFIG, seed)
        assert np.array_equal(a, b)
        pa = frames.frame_pool(TINY_CONFIG, MIX, a, seed)
        assert np.array_equal(pa, frames.frame_pool(TINY_CONFIG, MIX, b,
                                                    seed))
        assert pa.shape == (12, 320, 320) and pa.dtype == np.uint8
    p1 = frames.frame_pool(TINY_CONFIG, MIX,
                           frames.shape_image(TINY_CONFIG, 1), 1)
    p2 = frames.frame_pool(TINY_CONFIG, MIX,
                           frames.shape_image(TINY_CONFIG, 2), 2)
    assert not np.array_equal(p1, p2)


def test_every_seed_gets_the_same_instance_counts_in_its_own_order():
    orders = [frames.instance_counts(MIX, s) for s in range(6)]
    for o in orders:
        assert sorted(o.tolist()) == sorted(orders[0].tolist())
        assert sorted(o.tolist()) == [1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4]
    assert len({tuple(o.tolist()) for o in orders}) > 1


def test_check_sample_holds_the_longest_frame():
    for seed in range(20):
        counts = frames.instance_counts(MIX, seed)
        s = frames.check_sample(MIX, seed, counts)
        assert len(s) == 5 == len(set(s))
        assert int(np.argmax(counts)) in s
        assert s == frames.check_sample(MIX, seed, counts)


def test_rotation_about_the_centre():
    img = np.zeros((10, 10), np.uint8)
    img[5, 5] = 200  # the centre (w/2, h/2) = (5, 5)
    img[5, 8] = 100  # 3 px right of it
    assert np.array_equal(frames.rotate_linear(img, 0.0), img)
    r = frames.rotate_linear(img, 90.0)
    # counter-clockwise on screen (y down): right of the centre goes up
    assert r[2, 5] == 100 and r[5, 5] == 200
    assert frames.rotate_linear(img, 180.0)[5, 2] == 100
    assert frames.rotate_linear(img, 45.0)[5, 5] == 200


def test_template_angles():
    cfg = dict(TINY_CONFIG, num_templates=361, angle_step=1.0)
    a = frames.template_angles(cfg)
    assert len(a) == 361 and a[0] == 0.0 and a[-1] == 360.0
