"""The port's BIRRD switch model and RIR oracle against the JAX package's.

``repro_torch.core.birrd`` is ``repro.core.birrd`` copied with only its
imports changed: its topology, routed configurations, simulations and
costs must equal the original's exactly, over the cases of
``tests/test_birrd.py``, and ``compile_switch_program`` must lower each
routed configuration to the same stage matrices, byte for byte.
``repro_torch.core.rir`` is the oracle rewritten in torch
(``index_add_`` for ``segment_sum``, index assignment for ``.at[].set``);
on the same numpy inputs it must equal ``repro.core.rir`` exactly.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import birrd as jbirrd
from repro.core import rir as jrir
from repro.kernels.birrd_reduce import \
    compile_switch_program as jcompile_switch_program
from repro_torch.core import birrd, rir
from repro_torch.kernels.birrd_reduce import compile_switch_program


def _reorder_cases(aw, n=10):
    rng = np.random.default_rng(0)
    return [(list(range(aw)), [int(x) for x in rng.permutation(aw)])
            for _ in range(n)]


def _relayout_cases(aw):
    k = int(math.log2(aw))
    return [(list(range(aw)),
             [((i << r) | (i >> (k - r))) & (aw - 1) for i in range(aw)])
            for r in range(1, k)]


#: (aw, group_ids, out_ports) of ``tests/test_birrd.py``'s routing tests
GROUPED = [
    (16, [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4, [0, 4, 8, 12]),
    (16, sum([[g] * 2 for g in range(8)], []), [0, 2, 4, 6, 8, 10, 12, 14]),
    (16, [0] * 8 + [1] * 8, [0, 8]),
    (16, [0] * 16, [5]),
    (16, [0, 0, 0, 1, 1, 2, 2, 2] + [3] * 4 + [-1] * 4, [1, 5, 9, 13]),
] + [(4, [0, 0, 0, 0], [t]) for t in range(4)]
CASES = (
    [("reorder", aw, g, p) for aw in (4, 8, 16)
     for g, p in _reorder_cases(aw)]
    + [("relayout", aw, g, p) for aw in (32, 64, 128)
       for g, p in _relayout_cases(aw)]
    + [("grouped", aw, g, p) for aw, g, p in GROUPED])


@pytest.mark.parametrize("aw", [2, 4, 8, 16, 32, 64, 128])
def test_topology_equals_jax(aw):
    mine, theirs = birrd.BirrdTopology(aw), jbirrd.BirrdTopology(aw)
    assert mine.num_stages == theirs.num_stages
    assert mine.switches_per_stage == theirs.switches_per_stage
    for s in range(mine.num_stages):
        assert mine.permutation(s) == theirs.permutation(s)
    assert birrd.Birrd(aw).perms == jbirrd.Birrd(aw).perms


@pytest.mark.parametrize("kind", ["reorder", "relayout", "grouped"])
def test_routes_and_simulations_equal_jax(kind):
    """``Birrd.route`` gives the original's configs; ``simulate`` and
    ``check`` agree on them."""
    n = 0
    for k, aw, gids, ports in CASES:
        if k != kind:
            continue
        mine, theirs = birrd.Birrd(aw), jbirrd.Birrd(aw)
        cfg = mine.route(gids, ports)
        assert cfg is not None, (aw, gids, ports)
        assert cfg == theirs.route(gids, ports), (aw, gids, ports)
        assert mine.check(gids, ports, cfg)
        vals = np.arange(1.0, aw + 1)
        assert np.array_equal(mine.simulate(vals, cfg),
                              theirs.simulate(vals, cfg))
        n += 1
    assert n >= 4


@pytest.mark.parametrize("kind", ["reorder", "relayout", "grouped"])
def test_compile_switch_program_bytes_equal_jax(kind):
    for k, aw, gids, ports in CASES:
        if k != kind or aw > 64:
            continue
        cfg = birrd.Birrd(aw).route(gids, ports)
        mine = compile_switch_program(aw, cfg)
        theirs = jcompile_switch_program(aw, cfg)
        assert mine.dtype == theirs.dtype == np.float32
        assert mine.shape == theirs.shape == (len(cfg), aw, aw)
        assert mine.tobytes() == theirs.tobytes()
        # a row of a routed stage has at most two entries, each 1.0: the
        # reason the kernel's sums are exact copies or one f32 addition
        assert set(np.unique(mine)) <= {0.0, 1.0}
        assert (mine.sum(axis=-1) <= 2).all()


def test_network_costs_equal_jax():
    for n in (4, 8, 16, 32, 256):
        for f in ("birrd_cost", "fan_cost", "art_cost"):
            mine, theirs = getattr(birrd, f)(n), getattr(jbirrd, f)(n)
            assert dataclasses.astuple(mine) == dataclasses.astuple(theirs)


@pytest.mark.parametrize("aw,gids,ports", [
    (8, [0, 0, 1, 1, 2, 2, 3, 3], [6, 0, 2, 4]),
    (16, [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4, [0, 4, 8, 12]),
    (8, [0, 0, -1, 1, 1, 1, -1, 2], [3, 7, 1]),
    (4, [-1, -1, -1, -1], [0]),
])
@pytest.mark.parametrize("tail", [(), (5, 3)])
def test_rir_reduce_reorder_equals_jax(aw, gids, ports, tail):
    x = np.random.default_rng(aw).normal(size=(aw,) + tail).astype(
        np.float32)
    mine = rir.rir_reduce_reorder(torch.from_numpy(x),
                                  torch.tensor(gids, dtype=torch.int32),
                                  torch.tensor(ports, dtype=torch.int32), aw)
    theirs = jrir.rir_reduce_reorder(jnp.asarray(x, jnp.float32),
                                     jnp.asarray(gids, jnp.int32),
                                     jnp.asarray(ports, jnp.int32), aw)
    assert mine.shape == (aw,) + tail and mine.dtype == torch.float32
    assert np.array_equal(mine.numpy(), np.asarray(theirs))


def test_rir_layout_write_and_group_ids_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 7)).astype(np.float32)
    perm = [int(p) for p in rng.permutation(16)]
    mine = rir.rir_layout_write(torch.from_numpy(x), torch.tensor(perm))
    theirs = jrir.rir_layout_write(jnp.asarray(x), jnp.asarray(perm))
    assert np.array_equal(mine.numpy(), np.asarray(theirs))
    for sizes, n in (([4, 4, 4, 4], 16), ([3, 2, 3], 12), ([], 4)):
        got = rir.make_group_ids(sizes, n)
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(jrir.make_group_ids(sizes, n)
                                          ).tolist()
    with pytest.raises(ValueError, match="exceed"):
        rir.make_group_ids([3, 3], 4)
