"""The port's panmictic path (libpga_tpu_torch/ops/select.py,
ops/step.py, ops/crossover.py, ops/mutate.py, engine.make_run_loop)
against the JAX package's XLA path, and the run loops' stop rule.

The JAX functions draw from ``jax.random`` keys. The tests draw the same
numbers from the same keys, as the JAX functions split them, and inject
them into the port, so both packages work on identical noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu
import libpga_tpu_torch as port
from libpga_tpu.gp import encoding as jenc
from libpga_tpu.gp import operators as jgpo
from libpga_tpu.ops import crossover as jxo
from libpga_tpu.ops import mutate as jmut
from libpga_tpu.ops import select as jsel
from libpga_tpu.ops import step as jstep
from libpga_tpu_torch.gp import encoding as enc
from libpga_tpu_torch.gp import operators as gpo
from libpga_tpu_torch.ops import crossover as xo
from libpga_tpu_torch.ops import mutate as mut
from libpga_tpu_torch.ops import select as sel
from libpga_tpu_torch.ops.evaluate import evaluate
from libpga_tpu_torch.ops.step import BreedDraws, make_breed

CPU = port.PGAConfig(device="cpu")


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jax_select_draws(key, pop, num, kind, k):
    """The draws ``select_parent_pairs(key, ...)`` takes, as the port's
    SelectDraws."""
    if kind == "tournament":
        if k == 2:
            k1, k2 = jax.random.split(key)
            i1 = jax.random.randint(k1, (num,), 0, pop, dtype=jnp.int32)
            i2 = jax.random.randint(k2, (num,), 0, pop, dtype=jnp.int32)
            return sel.SelectDraws(idx=_t(np.stack([i1, i2], 1), torch.int64))
        return sel.SelectDraws(idx=_t(jax.random.randint(key, (num, k), 0, pop, dtype=jnp.int32), torch.int64))
    k_tie, k_u = jax.random.split(key)
    return sel.SelectDraws(
        tie=_t(np.asarray(jax.random.bits(k_tie, (pop,))).astype(np.int64)),
        u=_t(jax.random.uniform(k_u, (num,))),
    )


def jax_breed_draws(key, P, L, kind, k, cross_cols, mut_cols):
    """The draws ``ops/step.make_breed``'s breed takes from ``key``."""
    k_sel, k_cross, k_mut = jax.random.split(key, 3)
    return BreedDraws(
        select=jax_select_draws(k_sel, P, 2 * P, kind, k),
        cross=_t(jax.random.uniform(k_cross, (P, cross_cols or L))),
        mut=_t(jax.random.uniform(k_mut, (P, mut_cols or L))),
    )


def _scores(P, seed, special=True):
    """Scores with ties, and with NaN, -inf and both zeros when
    ``special``."""
    s = np.random.default_rng(seed).integers(-3, 4, P).astype(np.float32)
    if special:
        s[:4] = [np.nan, -np.inf, -0.0, 0.0]
    return s


SELECTIONS = [("tournament", 2, None), ("tournament", 3, None), ("tournament", 5, None),
              ("truncation", 2, 0.3), ("linear_rank", 2, 1.7)]


@pytest.mark.parametrize("kind,k,param", SELECTIONS)
def test_selection_equals_jax_on_the_same_draws(kind, k, param):
    P = 257
    s = _scores(P, 1)
    key = jax.random.key(7)
    want = np.asarray(jsel.select_parent_pairs(key, jnp.asarray(s), P, k=k, kind=kind, param=param))
    got = sel.select_parent_pairs(
        _t(s), P, k=k, kind=kind, param=param, draws=jax_select_draws(key, P, 2 * P, kind, k)
    )
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


def test_rank_order_follows_jax_sort_order():
    """Score descending with -0.0 equal to +0.0 and NaN last, then the
    tie word, then the row (JAX's lax.sort of (-scores, bits, iota))."""
    s = _scores(300, 2)
    tie = np.random.default_rng(3).integers(0, 4, 300).astype(np.uint32)  # many ties
    _, _, want = jax.lax.sort(
        (-jnp.asarray(s), jnp.asarray(tie), jnp.arange(300, dtype=jnp.int32)), num_keys=2
    )
    got = sel.rank_order(_t(s), _t(tie.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_selection_draws_from_a_generator():
    s = torch.from_numpy(_scores(100, 4, special=False))
    for kind, k, param in SELECTIONS:
        a = sel.select_parent_pairs(s, 50, k, kind, param, generator=torch.Generator().manual_seed(1))
        b = sel.select_parent_pairs(s, 50, k, kind, param, generator=torch.Generator().manual_seed(1))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert all(int(x.min()) >= 0 and int(x.max()) < 100 for x in a)


def test_default_operators_equal_jax():
    rng = np.random.default_rng(5)
    p1, p2, r = (rng.uniform(0, 1, (40, 12)).astype(np.float32) for _ in range(3))
    np.testing.assert_array_equal(
        xo.uniform_crossover.batched(_t(p1), _t(p2), _t(r)).numpy(),
        np.asarray(jxo.uniform_crossover.batched(p1, p2, r)),
    )
    rm = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    pm, jm = mut.make_point_mutate(0.5), jmut.make_point_mutate(0.5)
    assert pm.rand_cols == jm.rand_cols
    np.testing.assert_array_equal(pm.batched(_t(p1), _t(rm)).numpy(), np.asarray(jm.batched(p1, rm)))


BREEDS = [
    ("default", "tournament", 2, None, 0),
    ("default", "linear_rank", 2, 1.5, 3),
    ("gp", "truncation", 2, 0.5, 2),
    ("gp", "tournament", 4, None, 1),
]


@pytest.mark.parametrize("ops,kind,k,param,elitism", BREEDS)
def test_one_breed_equals_jax_make_breed(ops, kind, k, param, elitism):
    """One ``make_breed`` generation on JAX's own draws: the same
    children, the elites in slots 0..e-1. Scores are integer-valued, so
    many tie: the elites are ``lax.top_k``'s rows, the lower index first
    among equal scores (``ops/topk.py``), and tournaments take the first
    of equal candidates in both packages."""
    P = 96
    rng = np.random.default_rng(6)
    if ops == "gp":
        kw = dict(max_nodes=10, n_vars=2)
        jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
        g = np.array(jenc.random_program_genes(
            jnp.asarray(rng.uniform(0, 1, (P, jenc.grow_rand_cols(jgp))).astype(np.float32)), jgp))
        jc, jm = jgpo.make_subtree_crossover(jgp), jgpo.make_gp_mutate(jgp)
        pc, pm = gpo.make_subtree_crossover(pgp), gpo.make_gp_mutate(pgp)
    else:
        g = rng.uniform(0, 1, (P, 16)).astype(np.float32)
        jc, jm = jxo.uniform_crossover, jmut.make_point_mutate(0.3)
        pc, pm = xo.uniform_crossover, mut.make_point_mutate(0.3)
    s = rng.integers(0, 6, P).astype(np.float32)
    kws = dict(tournament_size=k, selection_param=param, elitism=elitism)
    key = jax.random.key(11)
    want = np.asarray(jstep.make_breed(jc, jm, selection_kind=kind, **kws)(jnp.asarray(g), jnp.asarray(s), key))
    draws = jax_breed_draws(key, P, g.shape[1], kind, k,
                            getattr(jc, "rand_cols", None), getattr(jm, "rand_cols", None))
    got = make_breed(pc, pm, selection_kind=kind, **kws)(_t(g), _t(s), draws=draws).numpy()
    np.testing.assert_array_equal(got, want)
    if elitism:
        np.testing.assert_array_equal(got[:elitism], g[np.argsort(-s, kind="stable")[:elitism]])


def test_small_population_runs_the_panmictic_path_like_jax():
    """P=64 is under the deme kernel's 128 rows: both packages take the
    panmictic path. Generation-0 scores agree, and one generation on the
    same noise gives the same population."""
    jp = libpga_tpu.PGA(seed=0)
    jh = jp.create_population(64, 16)
    jp.set_objective("onemax")
    jp.evaluate(jh)
    g = np.array(jp.population(jh).genomes)
    p = port.pga_init(0, CPU)
    h = p.install_population(g)
    p.set_objective("onemax")
    assert not p.uses_deme_kernel(64, 16)
    s0 = evaluate(p._objective, p.population(h).genomes)
    np.testing.assert_allclose(s0.numpy(), np.asarray(jp.population(jh).scores), rtol=1e-6)
    key = jax.random.key(3)
    want = jstep.make_breed(jxo.uniform_crossover, jmut.make_point_mutate(0.01))(
        jnp.asarray(g), jnp.asarray(s0.numpy()), key)
    got = make_breed(xo.uniform_crossover, mut.make_point_mutate(0.01))(
        _t(g), s0, draws=jax_breed_draws(key, 64, 16, "tournament", 2, None, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert p.run(5) == 5 and p.launches == 0
    assert p.get_best_with_score(h)[1] >= float(s0.max())


def _nan_objectives(theta):
    def jax_obj(x):
        s = jnp.sum(x)
        return jnp.where(s >= theta, jnp.nan, s)

    def port_obj(m):
        s = m.sum(dim=1)
        return torch.where(s >= theta, torch.nan, s)

    return jax_obj, port_obj


@pytest.mark.parametrize("size,theta", [(64, 11.5), (1024, 14.0)])  # panmictic; deme kernel
def test_nan_best_stops_where_the_target_would(size, theta):
    """A NaN best score stops the run without a target, at the
    generation a target at the NaN threshold stops the same run: the
    JAX rule ``max(s) < target`` with target = inf. Shown for both
    packages, each against its own target run."""
    L, n = 16, 200
    jax_obj, port_obj = _nan_objectives(theta)

    def jax_run(obj, target):
        jp = libpga_tpu.PGA(seed=2)
        jh = jp.create_population(size, L)
        jp.set_objective(obj)
        return jp.run(n, target=target), np.asarray(jp.population(jh).scores)

    def port_run(obj, target):
        p = port.pga_init(2, CPU)
        h = p.create_population(size, L)
        p.set_objective(obj)
        assert p.uses_deme_kernel(size, L) == (size >= 128)
        return p.run(n, target=target), p.population(h).scores.numpy()

    for run, obj, plain in ((jax_run, jax_obj, lambda x: jnp.sum(x)),
                            (port_run, port_obj, lambda m: m.sum(dim=1))):
        gens_target, _ = run(plain, theta)
        gens_nan, scores = run(obj, None)
        assert 0 < gens_nan == gens_target < n
        assert np.isnan(scores).any()


def test_nan_at_generation_zero_runs_no_generation_like_jax():
    jax_obj, port_obj = _nan_objectives(0.0)
    jp = libpga_tpu.PGA(seed=0)
    jp.create_population(200, 8)
    jp.set_objective(jax_obj)
    assert jp.run(50) == 0
    for size in (64, 200):
        p = port.pga_init(0, CPU)
        p.create_population(size, 8)
        p.set_objective(port_obj)
        assert p.run(50) == 0 and p.launches == 0
