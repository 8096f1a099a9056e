"""The roofline arithmetic on hand-counted shapes, and the readers."""

import pytest
import torch

from portbench import harness
from portbench.metrics import roofline
from portbench.trace import Window


def test_pyramid_bytes_by_hand():
    # 1024^2 gray, T=(4, 8): the frame, 8 x 1024^2 and 8 x 512^2 bytes
    assert roofline.pyramid_bytes((1, 1024, 1024), (4, 8), 8) == (
        1048576 + 8388608 + 2097152)
    # 8 planar color frames of 64^2: 8*3*4096 in, 8*8*4096 + 8*8*1024 out
    assert roofline.pyramid_bytes((8, 3, 64, 64), (4, 8), 8) == (
        98304 + 262144 + 65536)
    # a level whose size T does not divide: 20 -> 5 cells of 4; 10 -> 1
    # cell of 8 (8 x 8 pixels)
    assert roofline.pyramid_bytes((1, 20, 20), (4, 8), 8) == (
        400 + 8 * 400 + 8 * 64)


def test_coarse_bytes_by_hand():
    # 512^2 top level, T=8: 64 x 64 cells, 8 x 64 x 4096 bytes of linear
    # memories; 361 templates of 64 features; 30 candidates
    assert roofline.coarse_bytes(1, 8, 8, (512, 512), 361 * 64, 361,
                                 30) == (2097152 + 4 * 23104 + 8 * 361
                                         + 16 * 30)
    assert roofline.coarse_bytes(8, 8, 8, (512, 512), 10, 1, 0) == (
        8 * 2097152 + 40 + 8)


def test_refine_work_by_hand():
    b, o = roofline.refine_work(100, 100 * 128, 5 * 128, 5)
    assert b == 4 * 640 + 8 * 5 + 2 * 16 * 100
    assert o == 256 * 12800


def test_bound_and_share():
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert roofline.share_pct(1e-6, 4e-6) == pytest.approx(25.0)
    assert roofline.share_pct(1e-6, 0.0) is None
    assert roofline.share_pct(1e-6, None) is None


def _window(records, span_device, busy_s=0.004, frames=2):
    return Window(frames, 0.01, busy_s, 600, [("k", busy_s)], records,
                  span_device, [("host", 0.006)])


def test_readers_on_a_hand_made_window():
    read = {n: harness.load_reader(harness.ROOT, n) for n in (
        "device_idle_pct", "device_ops_per_frame", "coarse_steps_per_frame",
        "pyramid_roofline_pct", "coarse_roofline_pct",
        "refine_roofline_pct")}
    nfeat = torch.full((361,), 64, dtype=torch.int32)
    bank = type("Bank", (), {"nfeat": nfeat})()
    k = torch.tensor([[3, 3, 7, 0]], dtype=torch.int32)
    valid = torch.tensor([[True, True, True, False]])
    records = {
        "pyramid": [{"frame_shape": (1, 1024, 1024), "T": (4, 8),
                     "n_ori": 8}] * 2,
        "coarse_extract": [{"frames": 1, "bank": bank, "T": 8,
                            "size_wh": (512, 512), "cap": 256, "n_ori": 8,
                            "n_above": torch.tensor([30])}] * 3,
        "refine.window": [{"bank": bank, "k": k, "valid": valid}],
    }
    w = _window(records, {"pyramid": 1e-3, "coarse_extract": 2e-3,
                          "refine.window": 1e-4})
    # busy 2 ms a frame against 5 ms a frame of untraced passes
    assert read["device_idle_pct"](w) is None
    w.untraced_s_per_frame = 0.005
    assert read["device_idle_pct"](w) == pytest.approx(60.0)
    w.untraced_s_per_frame = 0.004
    assert read["device_idle_pct"](w) == pytest.approx(50.0)
    assert read["device_ops_per_frame"](w) == 300
    assert read["coarse_steps_per_frame"](w) == 1.5
    pyr = 2 * 11534336 / 3.35e12
    assert read["pyramid_roofline_pct"](w) == pytest.approx(100 * pyr / 1e-3)
    coarse = 3 * (2097152 + 4 * 23104 + 8 * 361 + 16 * 30) / 3.35e12
    assert read["coarse_roofline_pct"](w) == pytest.approx(
        100 * coarse / 2e-3)
    # 3 live candidates of 64 features over templates {3, 7}
    ops = 256 * 3 * 64 / 67e12
    by = (4 * 128 + 8 * 2 + 2 * 16 * 3) / 3.35e12
    assert read["refine_roofline_pct"](w) == pytest.approx(
        100 * max(ops, by) / 1e-4)
    # no device events: nothing to read, never 0
    cpu = _window(records, {}, busy_s=None)
    for name in ("device_idle_pct", "device_ops_per_frame",
                 "pyramid_roofline_pct", "coarse_roofline_pct",
                 "refine_roofline_pct"):
        assert read[name](cpu) is None
    assert read["coarse_steps_per_frame"](_window({}, {})) is None
