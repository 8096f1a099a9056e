"""The port's CUDA kernels against their plain PyTorch twins on the card.

Marked ``cuda``: these need an NVIDIA GPU and skip elsewhere. They import
neither JAX nor the JAX package, so they run on a machine without JAX:

    SBM_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -o addopts= -q

(SBM_TEST_TPU=1 keeps tests/conftest.py from importing JAX.) Every
comparison is exact: the kernels compute the same integer sums and the
same float32 steps as the twins.
"""

import numpy as np
import pytest
import torch

from shape_based_matching_tpu_torch import Detector
from shape_based_matching_tpu_torch.ops.cuda.coarse import (
    coarse_scores, coarse_scores_plain)
from shape_based_matching_tpu_torch.ops.cuda.frontend import (
    quant_spread, quant_spread_plain)
from shape_based_matching_tpu_torch.ops.cuda.refine import (
    refine_windows, refine_windows_plain)
from shape_based_matching_tpu_torch.ops.similarity import (
    _flat_offsets, _positions, _rmin_for_threshold, pack_level_bank)
from shape_based_matching_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bank(rng, K, n_max, size, device):
    templates = []
    for i in range(K):
        wt, ht = int(rng.randint(4, size)), int(rng.randint(4, size))
        n = int(rng.randint(1, n_max))
        feats = [(int(rng.randint(-6, wt + 1)), int(rng.randint(-2, ht + 1)),
                  int(rng.randint(0, 8))) for _ in range(n)]
        feats[0] = (wt, ht, 1)
        templates.append({"features": [] if i == 2 else feats,
                          "width": wt, "height": ht})
    return pack_level_bank(templates, device=device)


def _lmflat(rng, B, T, w, h, device):
    M = (w // T) * (h // T)
    lm = rng.choice(np.array([0, 0, 3, 4], np.uint8), (B, 8 * T * T * M))
    flat = np.concatenate([lm, np.zeros((B, M), np.uint8)], axis=1)
    return torch.from_numpy(flat).to(device)


@pytest.mark.parametrize("h,w", [(37, 53), (72, 200), (256, 256)])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 16])
def test_frontend_kernel_equals_plain(dev, h, w, T):
    rng = np.random.RandomState(h + w + T)
    noise = rng.randint(0, 256, (h, w), dtype=np.uint8)
    smooth = synthetic.synthetic_scene(h, w, synthetic.synthetic_shape_image(
        24, T), n_instances=2, seed=T)
    frames = torch.from_numpy(np.stack([noise, smooth, noise // 4])).to(dev)
    for thr in (30.0, 10.0):
        got = quant_spread(frames, thr, T)
        torch.cuda.synchronize()
        assert torch.equal(got, quant_spread_plain(frames, thr, T))


@pytest.mark.parametrize("T,w,h,K,n_max", [
    (4, 96, 64, 37, 70), (8, 128, 72, 37, 70), (4, 1024, 1024, 37, 70),
    (4, 64, 64, 5, 3000),  # more slots than one shared-memory chunk
])
@pytest.mark.parametrize("threshold", [60.0, -5.0])
def test_coarse_kernel_equals_plain(dev, T, w, h, K, n_max, threshold):
    rng = np.random.RandomState(T * w + K)
    bank = _bank(rng, K, n_max, 48, dev)
    lmflat = _lmflat(rng, 2, T, w, h, dev)
    W, H = w // T, h // T
    off = _flat_offsets(bank, T, W, W * H, (w, h))
    pos = _positions(bank, T, W, H)
    rmin, _ = _rmin_for_threshold(
        bank.nfeat, torch.tensor(threshold, device=dev))
    got = coarse_scores(lmflat, off, pos, rmin, W * H)
    torch.cuda.synchronize()
    want = coarse_scores_plain(lmflat, off, pos, rmin, W * H)
    for g, e in zip(got, want):
        assert torch.equal(g, e)


@pytest.mark.parametrize("T,size", [(4, 40), (4, 110), (8, 40)])
def test_refine_kernel_equals_plain(dev, T, size):
    """size 110 at 128^2 is a pathological bank (wider than 128 - 16T)."""
    rng = np.random.RandomState(T + size)
    hw = 128
    bank = _bank(rng, 9, 300, size, dev)
    lmflat = _lmflat(rng, 2, T, hw, hw, dev)
    C = 70
    k = torch.from_numpy(rng.randint(0, 9, (2, C)).astype(np.int32)).to(dev)
    wx, wy = (torch.from_numpy(rng.randint(-12, hw // T, (2, C))
                               .astype(np.int32)).to(dev) for _ in range(2))
    live = torch.from_numpy(rng.rand(2, C) > 0.3).to(dev)
    args = (lmflat, bank, T, (hw, hw), k, wx, wy, live)
    got = refine_windows(*args)
    torch.cuda.synchronize()
    for g, e in zip(got, refine_windows_plain(*args)):
        assert torch.equal(g, e)


def test_detector_cuda_equals_cpu(dev):
    pyramids = synthetic.load_bank_cache(synthetic.bank_cache_path(360, 63))
    frames = np.stack([synthetic.synthetic_scene(
        512, 512, synthetic.synthetic_shape_image(256, 0), n_instances=1,
        seed=s) for s in (2, 3, 4)])
    out = []
    for device in ("cpu", "cuda"):
        det = Detector(num_features=63, T=(4, 8), device=device)
        det.class_templates["c"] = pyramids
        out.append(det.match_batch(frames, 80.0, cand_cap=64))
    key = [[(m.template_id, m.x, m.y, m.similarity) for m in ms]
           for ms in out[0]]
    assert any(key)
    assert key == [[(m.template_id, m.x, m.y, m.similarity) for m in ms]
                   for ms in out[1]]
