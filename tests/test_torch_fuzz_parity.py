"""Randomized end-to-end parity: the port's Detector.match (CPU) against
its copy of the scalar oracle's matchClass.

The scenes are ``tests/test_fuzz_parity.py``'s (``tests/torch_fuzz.py``):
image sizes 160-384 px, 31/63/100 features, thresholds 75/85/92, BGR,
masks, 16 orientations and the three-level pyramid T=(2, 4, 8) that no
golden covers, plus the merged three-class case. Training is the port's
and feeds both sides, so a difference isolates to the match path. Lists
compare as distinct (class, template, x, y, float32 bits of the
similarity): both sides compute the score in float32 the same way
(oracle ``match_class``; ``ops/window.window_result``). The JAX fuzz test
holds the JAX package to the same oracle, so port = oracle gives port =
JAX here without running the JAX package's Detector.

The same scenes at threshold 20 hold many more matches (every list
non-empty) and send several frames past the candidate cap of 256 into the
overflow re-run.
"""

import pytest
import torch

from .torch_fuzz import (FUZZ_CASES, MERGED_THRESHOLD, fuzz_case, merged_case,
                         oracle_keys, oracle_matches, oracle_pyramid,
                         port_keys)

LOW_THRESHOLD = 20.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases():
    """(seed, variant) -> (det, scene, mask, threshold, oracle pyramid),
    trained and built once for both tests of a case."""
    store = {}

    def get(seed, variant):
        if (seed, variant) not in store:
            det, scene, mask, thr = fuzz_case(seed, variant, "cpu")
            store[seed, variant] = (det, scene, mask, thr,
                                    oracle_pyramid(det, scene, mask))
        return store[seed, variant]
    return get


@pytest.mark.parametrize("seed,variant", FUZZ_CASES)
def test_fuzz_match_parity(cases, seed, variant):
    det, scene, mask, thr, pyramid = cases(seed, variant)
    got = port_keys(det.match(scene, thr, ["fuzz"], mask=mask))
    want = oracle_keys(oracle_matches(det, pyramid, thr, ["fuzz"]))
    assert got == want, (seed, variant, scene.shape, det.num_features, thr)


@pytest.mark.parametrize("seed,variant", FUZZ_CASES)
def test_fuzz_match_parity_low_threshold(cases, seed, variant):
    det, scene, mask, _, pyramid = cases(seed, variant)
    det.counters.clear()
    got = port_keys(det.match(scene, LOW_THRESHOLD, ["fuzz"], mask=mask))
    want = oracle_keys(oracle_matches(det, pyramid, LOW_THRESHOLD, ["fuzz"]))
    assert got == want, (seed, variant, scene.shape, det.num_features)
    assert got
    if seed in (0, 1, 5, 6):  # these overflow the cap of 256
        assert det.counters["reruns"] == 1


def test_fuzz_multi_class_merged_parity():
    """The merged multi-class step against the oracle class by class."""
    det, scene = merged_case("cpu")
    got = port_keys(det.match(scene, MERGED_THRESHOLD))
    assert ("a", "b", "c") in det._merged
    want = oracle_keys(oracle_matches(det, oracle_pyramid(det, scene),
                                      MERGED_THRESHOLD))
    assert got == want
    assert len({k[0] for k in got}) >= 2
