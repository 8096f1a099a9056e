"""The port's entry points (``shape_based_matching_tpu_torch/
entry.py``) against the JAX package's ``__graft_entry__.py`` on the CPU:
the flagship match step's sets, float32 bits included; the multi-device
dry run's parity asserts on CPU shards and its printed line against the
JAX dry run's (its golden file); and the dry run's single-device
references, which every sharded set is held to, against JAX's
``_local_match`` on the same inputs, run here."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as jentry  # noqa: E402

from shape_based_matching_tpu_torch import entry as tentry  # noqa: E402
from shape_based_matching_tpu_torch.ops.similarity import \
    pack_level_bank  # noqa: E402
from shape_based_matching_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, shard_pad_bank)

CPU = [torch.device("cpu")]

# The line that the JAX package's __graft_entry__.dryrun_multichip(n)
# prints on n virtual CPU devices, by n (tools/gen_torch_port_golden.py
# dryrun): the port's dry run draws the same inputs, so its shapes,
# counts and parity figures are the same.
with open(os.path.join(ROOT, "tests", "goldens",
                       "torch_port_dryrun.json")) as _f:
    JAX_DRYRUN_LINES = {int(n): line
                        for n, line in json.load(_f)["lines"].items()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: torch's intra-op threads buy nothing here and, beside
    the other test workers, make every small op wait for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_equals_jax_entry():
    """entry(16): the same frame as JAX's, and the step's match sets
    (template, x, y, float32 bits) and n_above equal to JAX's jitted
    match_step on the CPU (its map route; the port's window route)."""
    import jax

    fn, args = tentry.entry(16, device="cpu")
    jfn, jargs = jentry.entry(16)
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert fn.coarse_route == "packed4"
    out = fn(*args)
    assert all(t.shape == (1, tentry.CAP) for t in out[:5])
    assert out[5].shape == (1,)
    jout = jax.jit(jfn)(*jargs)
    got = tentry.match_sets(*out[:5])
    want = jentry._match_sets(*(np.asarray(a)[None] for a in jout[:5]))
    assert got == want and got[0]
    assert int(out[5][0]) == int(jout[5])


def test_entry_runs_on_the_card_by_default():
    """Without a device argument the step's tensors live on the card; a
    machine without CUDA raises."""
    if torch.cuda.is_available():
        _, args = tentry.entry(16)
        assert args[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry(16)


@pytest.mark.parametrize("n", [8, 1])
def test_dryrun_multichip_on_cpu_shards(n, capsys):
    """dryrun_multichip(n) on CPU shards passes every parity assert and
    prints the JAX dry run's line; n=1 takes the single-shard spatial
    branch (tile == band == frame)."""
    tentry.dryrun_multichip(n, devices=CPU * n)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [JAX_DRYRUN_LINES[n]]


def _jax_single(images, templates, n_templ, cand_cap, K):
    """JAX's single-device reference of its dry run (parallel/mesh.
    _local_match, its XLA path on the CPU) on the same frames and
    templates."""
    import jax.numpy as jnp

    from shape_based_matching_tpu.ops.similarity import pack_level_bank
    from shape_based_matching_tpu.parallel.mesh import (_local_match,
                                                        shard_pad_bank)

    banks = [pack_level_bank(t) for t in templates]
    if n_templ:
        banks = [shard_pad_bank(b, n_templ) for b in banks]
    h, w = images.shape[1:]
    sizes = [(w >> l, h >> l) for l in range(len(tentry.T_LEVELS))]
    out = _local_match(jnp.asarray(images), banks, tentry.T_LEVELS, sizes,
                       jnp.float32(30.0), jnp.float32(30.0), cand_cap, K,
                       True, 8)
    return jentry._match_sets(*out[:5])


@pytest.mark.parametrize("half", ["mesh", "spatial"])
@pytest.mark.parametrize("n", [8, 1])
def test_dryrun_reference_equals_jax(n, half):
    """The dry run's single-device references (the port's pyramid, coarse
    extraction and window refine over the unsharded bank), which every
    sharded set is held to, equal JAX's _local_match on the same inputs:
    (template, x, y, float32 bits) sets per frame, on the mesh half's
    frames and padded bank and on the spatial half's full frame, with
    JAX's halo."""
    from shape_based_matching_tpu.ops.similarity import \
        pack_level_bank as jpack
    from shape_based_matching_tpu.parallel.spatial import required_halo

    n_data, n_templ = make_mesh(n, devices=CPU * n).devices.shape
    K = 4 * n_templ
    rng, images, templates = tentry._mesh_inputs(n_data, n_templ)
    if half == "spatial":
        big, templates, halo = tentry._spatial_inputs(rng, n, K)
        stride = tentry.T_LEVELS[-1] * 2 ** (len(tentry.T_LEVELS) - 1)
        jhalo = -(-required_halo([jpack(t) for t in templates],
                                 tentry.T_LEVELS) // stride) * stride
        assert halo == (jhalo if n > 1 else 0)
        images, n_templ = big[None], 0
    h, w = images.shape[1:]
    cap = K * (h // 2 // tentry.T_LEVELS[-1]) * (w // 2 // tentry.T_LEVELS[-1])
    banks = [pack_level_bank(t) for t in templates]
    if n_templ:
        banks = [shard_pad_bank(b, n_templ) for b in banks]
    got = tentry.match_sets(*tentry._single(images, banks, cap, 30.0,
                                            CPU[0])[:5])
    want = _jax_single(images, templates, n_templ, cap, K)
    assert got == want and sum(map(len, want)) > 0


def test_dryrun_multichip_needs_cuda_or_devices():
    """Without devices= the dry run takes the visible cards; without CUDA
    it raises."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tentry.dryrun_multichip(2)
