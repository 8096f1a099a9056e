"""The port's ``match_icp`` against the plain pose reference
(``portbench/reference/icp.py``) on the CPU at a small size: a 256^2
frame with three instances of a 96^2 star, 16 templates at 2 deg.

Exact: the refined candidates' keys, the edge mask, the unit normals, the
subpixel shifts and the jump flood's offsets. The poses: within the
harness's ``POSE_TOL``, inlier counts and valid flags equal. The flood
against the exact nearest edge (a brute-force scan): never nearer; where
it stops farther out, the pixels are reported (a warning), not hidden.
"""

import warnings

import numpy as np
import pytest
import torch

from portbench import frames, harness
from portbench.reference import icp as ricp
from portbench.reference import line2d, training

from .conftest import SEED

from shape_based_matching_tpu_torch import Detector  # noqa: E402
from shape_based_matching_tpu_torch.models import icp as picp  # noqa: E402

ANGLES = [2.0 * i for i in range(16)]
THRESHOLD = 80.0


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(2)
    rng = frames.rng_for(SEED, 0)
    shape = frames.star_image(96, rng)
    frame = rng.integers(0, 25, size=(256, 256), dtype=np.uint8)
    for ang, (y, x) in ((7.3, (20, 30)), (21.6, (130, 120)),
                        (13.0, (10, 150))):
        rot = frames.rotate_linear(shape, ang)
        np.maximum(frame[y:y + 96, x:x + 96], rot,
                   out=frame[y:y + 96, x:x + 96])
    det = Detector(48, (4, 8), 30.0, 60.0, device="cpu")
    det.add_template(shape, "c", np.full_like(shape, 255))
    det.add_templates_rotate("c", 0, ANGLES[1:], (48.0, 48.0))
    bank = training.train_bank(shape, ANGLES, 48, 2, 30.0, 60.0)
    banks = [line2d.pack_bank(training.level_views(bank, l), "cpu")
             for l in range(2)]
    return frame, det, banks


def _port(det, frame, **kw) -> dict:
    rows = harness.icp_rows(det.match_icp(frame, THRESHOLD, top_c=32,
                                          iters=12, radius=8, **kw))
    out = {}
    for r in rows.tolist():
        pose = np.array(r[4:8], np.int64).astype(np.int32).view(np.float32)
        out[tuple(r[:4])] = tuple(pose.tolist()) + (r[8], bool(r[9]))
    return out


def _reference(frame, banks, cand_cap=256) -> dict:
    return ricp.match_icp_frame(torch.from_numpy(frame), banks, (4, 8), 30.0,
                                THRESHOLD, 32, 12, 8, cand_cap)


def test_edge_planes_equal_the_port(scene):
    frame = torch.from_numpy(scene[0])
    _, normal, edge, _, subpix = picp.edge_nearest_field(frame, 30.0, 8)
    f = ricp.edge_field(frame, 30.0, 8)
    assert int(edge.sum()) > 500
    assert torch.equal(f.edge, edge)
    assert torch.equal(torch.stack([f.nx, f.ny], -1), normal)
    assert torch.equal(torch.stack([f.sx, f.sy], -1), subpix)


def test_the_reference_flood_equals_the_port(scene):
    frame = torch.from_numpy(scene[0])
    off, _, edge, has, _ = picp.edge_nearest_field(frame, 30.0, 8)
    f = ricp.edge_field(frame, 30.0, 8)
    assert int(has.sum()) > 5000
    assert torch.equal(f.off_x, off[..., 0].long())
    assert torch.equal(f.off_y, off[..., 1].long())
    assert torch.equal(f.has, has)


@pytest.mark.parametrize("radius", [3, 8, 12])
def test_the_reference_flood_on_random_edges(radius):
    g = torch.Generator().manual_seed(radius)
    for share in (0.002, 0.02, 0.2):
        edge = torch.rand(97, 131, generator=g) < share
        off, has = picp._flood_epilogue(picp._jump_flood(edge, radius),
                                        radius)
        ox, oy, rhas = ricp.jump_flood(edge, radius)
        assert torch.equal(ox, off[..., 0].long())
        assert torch.equal(oy, off[..., 1].long())
        assert torch.equal(rhas, has)


def test_the_flood_against_the_nearest_edge(scene):
    edge = ricp.edge_field(torch.from_numpy(scene[0]), 30.0, 8).edge
    fx, fy, fhas = ricp.jump_flood(edge, 8)
    sx, sy, shas = ricp.nearest_edge_scan(edge, 8)
    flood, exact = fx ** 2 + fy ** 2, sx ** 2 + sy ** 2
    # every offset lands on an edge pixel, on both sides
    h, w = edge.shape
    rows, cols = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
    for ox, oy, where in ((fx, fy, fhas), (sx, sy, shas)):
        assert edge[(rows + oy)[where], (cols + ox)[where]].all()
    assert not (fhas & (flood < exact)).any()  # the scan is the nearest
    # the flood breaks a tie by its order, or stops farther out, at a few
    # pixels in a hundred; the rest agree offset for offset
    other = fhas & ((fx != sx) | (fy != sy))
    assert int(other.sum()) < int(fhas.sum()) // 20
    farther = fhas & (flood > exact)
    if farther.any():
        where = torch.nonzero(farther).tolist()
        warnings.warn(f"jump flood farther than the nearest edge at "
                      f"{len(where)} pixels (row, column): {where}")


def test_the_flood_rules_by_hand():
    edge = torch.zeros((40, 40), dtype=torch.bool)
    edge[10, 2] = edge[10, 18] = True     # (10, 10): 8 left and 8 right
    edge[30, 30] = True                   # alone
    ox, oy, has = ricp.jump_flood(edge, 8)
    # a tie goes to the neighbour read first: dr, then dc, ascending
    assert (int(ox[10, 10]), int(oy[10, 10]), bool(has[10, 10])) == (
        -8, 0, True)
    # one seed reaches every pixel of its square, offset exact
    for r in range(22, 39):
        for c in range(22, 39):
            assert (int(ox[r, c]), int(oy[r, c])) == (30 - c, 30 - r)
            assert bool(has[r, c]) == (max(abs(30 - c), abs(30 - r)) <= 8)
    assert (int(ox[30, 30]), int(oy[30, 30])) == (0, 0)
    # no seed at all
    ox, oy, has = ricp.jump_flood(torch.zeros((9, 9), dtype=torch.bool), 8)
    assert not has.any() and not ox.any() and not oy.any()


def test_nearest_edge_scan_rules_by_hand():
    edge = torch.zeros((40, 40), dtype=torch.bool)
    edge[4, 5] = edge[5, 4] = True           # above and left of (5, 5)
    edge[5, 16] = edge[6, 15] = True         # right and below of (5, 15)
    edge[30, 19] = edge[38, 15] = True       # (30, 10): 9 right; 8 down 5
    edge[20, 32] = True                      # (20, 20): 12 right
    ox, oy, has = ricp.nearest_edge_scan(edge, 8)
    assert (int(ox[5, 5]), int(oy[5, 5])) == (0, -1)  # the least dy
    assert (int(ox[5, 15]), int(oy[5, 15])) == (1, 0)
    # the nearest edge lies outside the square: none within it
    assert (int(ox[30, 10]), int(oy[30, 10]), bool(has[30, 10])) == (
        9, 0, False)
    assert (int(ox[30, 11]), int(oy[30, 11]), bool(has[30, 11])) == (
        8, 0, True)
    # 12 px away lies outside the disc of radius 8 * sqrt(2)
    assert not has[20, 20] and not has[20, 19]


def _held(got, want):
    assert set(got) == set(want)
    r = harness.compare_poses({0: [harness.pose_rows(got)]}, {0: want})
    assert r["poses_checked"] == len(want)
    assert (r["pose_mismatch"], r["inliers_mismatch"]) == (0, 0), r
    return r


def test_keys_and_poses_against_the_port(scene):
    frame, det, banks = scene
    want = _reference(frame, banks)
    assert len(want) >= 10
    _held(_port(det, frame), want)


def test_overflow_takes_the_match_list_path(scene):
    """Past cand_cap coarse candidates, the port refines the first top_c
    of its match list; the reference does the same."""
    frame, det, banks = scene
    want = _reference(frame, banks, cand_cap=8)
    assert len(want) > 8
    _held(_port(det, frame, cand_cap=8), want)


def test_selection_is_a_stable_sort():
    k = torch.tensor([0, 1, 2, 3, 4])
    x = torch.tensor([10, 11, 12, 13, 14])
    sc = torch.tensor([85.0, 90.0, 85.0, 90.0, 80.0])
    kk, xx, _, ss = ricp.select(k, x, x, sc, 5, 3, 256)
    assert kk.tolist() == [1, 3, 0] and ss.tolist() == [90.0, 90.0, 85.0]
    # past the cap: the sorted, de-duplicated list (score, template, x, y)
    k2 = torch.tensor([4, 1, 1, 0])
    x2 = torch.tensor([7, 9, 9, 3])
    s2 = torch.tensor([90.0, 90.0, 90.0, 85.0])
    kk, xx, _, _ = ricp.select(k2, x2, x2, s2, 300, 3, 256)
    assert kk.tolist() == [1, 4, 0] and xx.tolist() == [9, 7, 3]
