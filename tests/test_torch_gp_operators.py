"""The port's GP operators (libpga_tpu_torch/gp/operators.py) against the
JAX package's (libpga_tpu/gp/operators.py): the same parents and uniform
blocks give exactly the same children, every child of well-formed
parents is well-formed and no longer than max_nodes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.gp import encoding as jenc
from libpga_tpu.gp import operators as jops
from libpga_tpu_torch.gp import encoding as enc
from libpga_tpu_torch.gp import operators as ops

CONFIGS = [
    dict(max_nodes=10, n_vars=2),
    dict(max_nodes=8, n_vars=2, consts=(1.0, 2.0), unary=("neg",), binary=("add", "sub", "mul")),
    dict(max_nodes=12, n_vars=3, unary=(), binary=("add", "mul")),
    dict(max_nodes=6, n_vars=1, consts=()),
    dict(max_nodes=32, n_vars=2),
]
IDS = ["default10", "small", "no_unary", "no_consts", "main32"]
MUTATIONS = [
    ("make_subtree_mutate", dict(rate=0.9)),
    ("make_gp_point_mutate", dict(rate=0.9)),
    ("make_gp_mutate", dict(subtree_rate=0.7, point_rate=0.7)),
]


def _parents(gp, kind, n=200, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.uniform(0, 1, (n, gp.genome_len)).astype(np.float32)
    rand = rng.uniform(0, 1, (n, jenc.grow_rand_cols(gp))).astype(np.float32)
    return np.array(jenc.random_program_genes(jnp.asarray(rand), gp))


def _check_children(kids, pgp, kind):
    assert np.isfinite(kids).all()
    if kind == "programs":
        assert all(enc.is_well_formed(r, pgp) for r in kids)
        assert max(enc.program_length(r, pgp) for r in kids) <= pgp.max_nodes


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
@pytest.mark.parametrize("kind", ["programs", "noise"])
def test_subtree_crossover_equals_jax(kw, kind):
    jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
    p1 = _parents(jgp, kind, seed=1)
    p2 = p1[np.random.default_rng(2).permutation(len(p1))]
    rand = np.random.default_rng(3).uniform(0, 1, (len(p1), 2)).astype(np.float32)
    jxo, pxo = jops.make_subtree_crossover(jgp), ops.make_subtree_crossover(pgp)
    assert pxo.rand_cols == jxo.rand_cols and pxo.xla_only and pxo.kernel_cache_key == jxo.kernel_cache_key
    want = np.asarray(jxo.batched(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(rand)))
    got = pxo.batched(torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(rand)).numpy()
    np.testing.assert_array_equal(got, want)
    _check_children(got, pgp, kind)
    one = pxo(torch.from_numpy(p1[0]), torch.from_numpy(p2[0]), torch.from_numpy(rand[0])).numpy()
    np.testing.assert_array_equal(one, want[0])


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
@pytest.mark.parametrize("kind", ["programs", "noise"])
@pytest.mark.parametrize("make,args", MUTATIONS, ids=[m for m, _ in MUTATIONS])
def test_mutations_equal_jax(kw, kind, make, args):
    jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
    g = _parents(jgp, kind, seed=4)
    jm, pm = getattr(jops, make)(jgp, **args), getattr(ops, make)(pgp, **args)
    assert pm.rand_cols == jm.rand_cols and pm.kernel_cache_key == jm.kernel_cache_key
    rand = np.random.default_rng(5).uniform(0, 1, (len(g), jm.rand_cols)).astype(np.float32)
    want = np.asarray(jm.batched(jnp.asarray(g), jnp.asarray(rand)))
    got = pm.batched(torch.from_numpy(g), torch.from_numpy(rand)).numpy()
    np.testing.assert_array_equal(got, want)
    _check_children(got, pgp, kind)
    want_p = np.asarray(jm.param_batched(jnp.asarray(g), jnp.asarray(rand), 0.5, 0.25))
    got_p = pm.param_batched(torch.from_numpy(g), torch.from_numpy(rand), 0.5, 0.25).numpy()
    np.testing.assert_array_equal(got_p, want_p)


def test_registries_match():
    assert set(ops.CROSSOVER_KINDS) == set(jops.CROSSOVER_KINDS)
    assert set(ops.MUTATE_KINDS) == set(jops.MUTATE_KINDS)
