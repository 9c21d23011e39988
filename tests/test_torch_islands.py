"""The port's island model (libpga_tpu_torch/parallel/islands.py and
PGA.run_islands, migrate, migrate_between, get_best_all,
get_best_top_all) against the JAX package's (libpga_tpu/parallel/
islands.py, engine.py) on the same numpy inputs, and the solver's island
runs on the CPU.

Migration and best extraction must pick JAX's rows exactly, ties, -inf
and both NaNs included. The panmictic island run replays JAX's own key
schedule (``split(key, I + 1)``, a split per generation, and
``fold_in(mig_key, 7)`` for the remainder) through the port's injected
draws, so both packages breed on the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu
import libpga_tpu_torch as port
from libpga_tpu.objectives import get as jax_objective
from libpga_tpu.ops import crossover as jxo
from libpga_tpu.ops import mutate as jmut
from libpga_tpu.ops import step as jstep
from libpga_tpu.parallel import islands as jis
from libpga_tpu.engine import PopulationHandle as JaxHandle
from libpga_tpu.population import Population as JaxPopulation
from libpga_tpu_torch.interop import state_from_numpy
from libpga_tpu_torch.objectives import get as port_objective
from libpga_tpu_torch.ops import crossover as xo
from libpga_tpu_torch.ops import kernels
from libpga_tpu_torch.ops import mutate as mut
from libpga_tpu_torch.ops.step import make_breed
from libpga_tpu_torch.parallel import islands as pis
from test_torch_step import jax_breed_draws

CPU = port.PGAConfig(device="cpu")


def _islands(I, S, L, seed):
    """Genomes (I, S, L) and integer-valued scores (I, S) with many ties,
    and in every island -inf, +NaN, -NaN and both zeros."""
    rng = np.random.default_rng(seed)
    g = rng.random((I, S, L), dtype=np.float32)
    s = rng.integers(-3, 4, (I, S)).astype(np.float32)
    s[:, :5] = [np.nan, np.copysign(np.nan, -1.0), -np.inf, -0.0, 0.0]
    for i in range(I):
        s[i] = rng.permutation(s[i])
    return g, s


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("count", [1, 3, 7])
def test_select_emigrants_equals_jax(count):
    g, s = _islands(3, 40, 6, count)
    want_g, want_s = jis._select_emigrants(jnp.asarray(g), jnp.asarray(s), count)
    got_g, got_s = pis.select_emigrants(torch.from_numpy(g), torch.from_numpy(s), count)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))


@pytest.mark.parametrize("count", [1, 4, 9])
def test_immigrate_replaces_jax_worst_rows(count):
    """The worst are ``lax.top_k(-scores)``'s rows: -NaN and -inf first,
    then the lowest scores, the lower index first among ties."""
    g, s = _islands(4, 32, 5, 10 + count)
    rng = np.random.default_rng(count)
    im_g = rng.random((4, count, 5), dtype=np.float32)
    im_s = rng.random((4, count), dtype=np.float32) + 10
    want_g, want_s = jis._immigrate(jnp.asarray(g), jnp.asarray(s), jnp.asarray(im_g),
                                    jnp.asarray(im_s))
    got_g, got_s = pis.immigrate(torch.from_numpy(g.copy()), torch.from_numpy(s.copy()),
                                 torch.from_numpy(im_g), torch.from_numpy(im_s))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))


@pytest.mark.parametrize("n", [2, 5, 8])
def test_shuffled_ring_sources_equals_jax(n):
    key = jax.random.key(n)
    order = torch.from_numpy(np.asarray(jax.random.permutation(key, n)).astype(np.int64))
    np.testing.assert_array_equal(
        pis.shuffled_ring_sources(order).numpy(), np.asarray(jis._shuffled_ring_sources(key, n)))


@pytest.mark.parametrize("topology", ["ring", "random"])
def test_migrate_local_equals_jax(topology):
    g, s = _islands(5, 48, 7, 3)
    key = jax.random.key(4)
    want_g, want_s = jis._migrate_local(jnp.asarray(g), jnp.asarray(s), key, 4, topology)
    order = torch.from_numpy(np.asarray(jax.random.permutation(key, 5)).astype(np.int64))
    got_g, got_s = pis.migrate_local(torch.from_numpy(g.copy()), torch.from_numpy(s.copy()), 4,
                                     topology, order)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))


def _twin_solvers(shapes, seed):
    """A JAX PGA and a port PGA holding the same populations and scores
    (the scores with ties and NaNs)."""
    jp, pp = libpga_tpu.PGA(seed=0), port.PGA(seed=0, config=CPU)
    rng = np.random.default_rng(seed)
    for i, (S, L) in enumerate(shapes):
        g, s = _islands(1, S, L, seed + i)
        g, s = g[0], s[0]
        s[rng.random(S) < 0.2] = 9.0  # ties at the top
        jp.install_population(g)
        jp._populations[i] = JaxPopulation(genomes=jnp.asarray(g), scores=jnp.asarray(s))
        pp.install_population(state_from_numpy(g, s, device="cpu"))
    return jp, pp


def _same_populations(jp, pp):
    for jpop, ppop in zip(jp._populations, pp._populations):
        np.testing.assert_array_equal(ppop.genomes.numpy(), np.asarray(jpop.genomes))
        np.testing.assert_array_equal(_bits(ppop.scores.numpy()), _bits(jpop.scores))


def test_best_extraction_across_populations_equals_jax():
    jp, pp = _twin_solvers([(40, 6), (64, 6), (33, 6)], 20)
    np.testing.assert_array_equal(pp.get_best_all(), jp.get_best_all())
    for k in (1, 5, 40, 200):
        np.testing.assert_array_equal(pp.get_best_top_all(k), jp.get_best_top_all(k))
    h = port.PopulationHandle(1)
    np.testing.assert_array_equal(port.pga_get_best_top(pp, h, 7),
                                  libpga_tpu.api.pga_get_best_top(jp, h, 7))
    np.testing.assert_array_equal(port.pga_get_best_all(pp), jp.get_best_all())
    np.testing.assert_array_equal(port.pga_get_best_top_all(pp, 9), jp.get_best_top_all(9))


@pytest.mark.parametrize("pct", [0.0, 0.05, 0.3])
def test_migrate_between_equals_jax(pct):
    jp, pp = _twin_solvers([(64, 8), (50, 8), (64, 8)], 30)
    for src, dst in ((0, 1), (2, 0), (1, 2)):
        jp.migrate_between(JaxHandle(src), JaxHandle(dst), pct)
        port.pga_migrate_between(pp, port.PopulationHandle(src), port.PopulationHandle(dst), pct)
    _same_populations(jp, pp)


def test_migrate_with_jax_permutation_equals_jax():
    jp, pp = _twin_solvers([(64, 8), (48, 8), (64, 8)], 40)
    for pct in (0.1, 0.25):
        # JAX's migrate draws permutation(next_key(), n): replay that key.
        _, sub = jax.random.split(jp._key)
        order = np.asarray(jax.random.permutation(sub, jnp.arange(3)))
        jp.migrate(pct)
        pp.migrate(pct, order=torch.from_numpy(order.astype(np.int64)))
        _same_populations(jp, pp)
    with pytest.raises(ValueError):
        pp.migrate(1.5)


def test_panmictic_island_run_equals_jax_on_jax_draws():
    """3 islands x 64 x 8, m = 3, n = 7 (two epochs of three generations
    with a ring migration of int(64 * 0.1) = 6 each, then one remainder
    generation): the port's run_islands_stacked over make_breed on JAX's
    own draws gives JAX's genomes and scores."""
    I, S, L, n, m, pct = 3, 64, 8, 7, 3, 0.1
    stacked = np.random.default_rng(5).random((I, S, L), dtype=np.float32)
    key = jax.random.key(9)
    want_g, want_s, want_n = jis.run_islands_stacked(
        jstep.make_breed(jxo.uniform_crossover, jmut.make_point_mutate(0.2)),
        jax_objective("onemax"), jnp.asarray(stacked), key, n=n, m=m, pct=pct)

    keys = jax.random.split(key, I + 1)
    chains = {("main", i): keys[1 + i] for i in range(I)}
    rem = jax.random.split(jax.random.fold_in(keys[0], 7), I)
    chains.update({("rem", i): rem[i] for i in range(I)})

    def draws(stage, i):
        chains[stage, i], sub = jax.random.split(chains[stage, i])
        return jax_breed_draws(sub, S, L, "tournament", 2, None, 3)

    got_g, got_s, got_n = pis.run_islands_stacked(
        make_breed(xo.uniform_crossover, mut.make_point_mutate(0.2)), port_objective("onemax"),
        torch.from_numpy(stacked), torch.Generator(), n=n, m=m, pct=pct, draws=draws)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)


# --------------------------------------------------------------- the solver


def _solver(I, S, L, seed=0, config=CPU, objective="onemax"):
    p = port.pga_init(seed, config)
    for _ in range(I):
        port.pga_create_population(p, S, L)
    port.pga_set_objective_function(p, objective)
    return p


@pytest.mark.parametrize("S,layout", [(256, "pingpong"), (2100, "riffle")])
def test_run_islands_counts_one_launch_per_generation(S, layout):
    """Equal islands on the deme path: n generations (two epochs and a
    remainder of three), one breed per generation for all islands, no
    kernel launched on the CPU; the best rises and scores describe the
    genomes."""
    before = dict(kernels.LAUNCHES)
    p = _solver(3, S, 16)
    start = max(float(pop.genomes.sum(dim=1).max()) for pop in p._populations)
    breed = p._island_breed(S, 16, 3)
    assert breed.geom.layout == layout and breed.fused
    assert port.pga_run_islands(p, 13, 5, 0.05) == 13
    assert p.launches == 13 and kernels.LAUNCHES == before
    assert float(port.pga_get_best_all(p).sum()) > start + 1.0
    for pop in p._populations:
        assert pop.genomes.shape == (S, 16)
        torch.testing.assert_close(pop.scores, pop.genomes.sum(dim=1), rtol=1e-5, atol=1e-4)


def test_run_islands_stops_at_a_target_with_epoch_granularity():
    """The run stops at the first epoch whose best reaches the target:
    a multiple of m, and one epoch fewer stays below it."""
    target, m = 25.0, 4
    p = _solver(4, 512, 32, seed=1)
    gens = p.run_islands(10_000, m, 0.05, target=target)
    assert 0 < gens < 10_000 and gens % m == 0
    best = max(p.get_best_with_score(h)[1] for h in p._handles())
    assert best >= target
    q = _solver(4, 512, 32, seed=1)
    assert q.run_islands(gens - m, m, 0.05, target=target) == gens - m
    assert max(q.get_best_with_score(h)[1] for h in q._handles()) < target


def test_run_islands_runs_the_remainder_and_skips_it_at_the_target():
    p = _solver(2, 256, 8, seed=2)
    assert p.run_islands(7, 3, 0.1) == 7
    assert p.run_islands(2, 3, 0.1) == 2  # no epoch: the remainder alone
    q = _solver(2, 256, 8, seed=2)
    assert q.run_islands(7, 3, 0.1, target=0.0) == 0  # reached before any epoch


@pytest.mark.parametrize("S", [64, 256])  # panmictic; deme path
def test_migration_spreads_a_planted_best(S):
    """A super-individual in island 0 reaches island 1 after one epoch of
    one generation."""
    p = port.pga_init(0, CPU)
    rng = np.random.default_rng(0)
    for i in range(4):
        g = rng.random((S, 8), dtype=np.float32) * 0.1
        if i == 0:
            g[0] = 0.999
        p.install_population(g)
    p.set_objective("onemax")
    assert p.run_islands(2, 1, 0.05) == 2
    assert p.get_best_with_score(port.PopulationHandle(1))[1] > 4.0
    assert p.launches == (0 if S < 128 else 2)


def test_run_islands_random_topology_and_elitism():
    """Random rings keep every island finite; with elitism each island's
    best never falls (the deme breed without fused scores carries its
    elites in the epoch)."""
    config = port.PGAConfig(device="cpu", migration_topology="random", elitism=2)
    p = _solver(4, 256, 8, config=config, objective=lambda g: g.sum(dim=1) ** 2)
    assert not p._island_breed(256, 8, 4).fused
    best = []
    for _ in range(4):
        assert p.run_islands(4, 2, 0.1) == 4
        best.append([p.get_best_with_score(h)[1] for h in p._handles()])
    assert np.all(np.diff(np.max(best, axis=1)) >= 0)
    assert all(bool(torch.isfinite(pop.scores).all()) for pop in p._populations)


def test_run_islands_several_generations_per_launch():
    """At generations_per_launch = 4 an epoch of m = 5 is two launches;
    13 generations are two epochs and a one-launch remainder."""
    config = port.PGAConfig(device="cpu", generations_per_launch=4)
    p = _solver(3, 1024, 32, config=config)
    assert getattr(p._island_breed(1024, 32, 3), "multigen", False)
    assert p.run_islands(13, 5, 0.05) == 13 and p.launches == 2 * 2 + 1
    with pytest.warns(UserWarning, match="no in-kernel"):
        q = _solver(3, 256, 8, config=config, objective=lambda g: g.sum(dim=1) ** 2)
        assert q.run_islands(6, 3, 0.1) == 6 and q.launches == 6


def test_run_islands_with_an_expression_hook_launches_once_per_generation():
    """An expression hook breeds every island in one launch per
    generation, as a builtin island breed does."""
    p = _solver(3, 256, 16)
    p.set_mutate(port.mutate_from_expression(
        "where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05, sigma=0.1))
    assert p.run_islands(4, 2, 0.1) == 4 and p.launches == 4


def test_unequal_islands_run_epoch_by_epoch():
    p = port.pga_init(0, CPU)
    port.pga_create_population(p, 64, 8)
    port.pga_create_population(p, 256, 8)
    port.pga_set_objective_function(p, "onemax")
    assert p.run_islands(10, 5, 0.1) == 10
    assert p.launches == 10  # the 256-row population breeds on the deme path
    assert p.get_best_all().shape == (8,)


def test_island_errors_and_the_population_cap():
    p = port.pga_init(0, port.PGAConfig(device="cpu", max_populations=10))
    with pytest.raises(RuntimeError):
        p.run_islands(5, 5, 0.1)
    for _ in range(10):
        port.pga_create_population(p, 64, 8)
    with pytest.raises(RuntimeError, match="max_populations"):
        port.pga_create_population(p, 64, 8)
    port.pga_set_objective_function(p, "onemax")
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        p.run_islands(5, 5, 0.1, mesh=object())
    with pytest.raises(ValueError):
        p.run_islands(5, 0, 0.1)
    with pytest.raises(ValueError):
        port.PGAConfig(device="cpu", migration_topology="star")
