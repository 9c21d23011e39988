"""The island form of the port's deme breeds (libpga_tpu_torch/ops/
fused_step.py: compute_ranks over (I, Pp) scores, deme_breed /
deme_breed_reference and multigen_breed / multigen_breed_reference over
(I, Pp, L), make_island_breed) on the CPU.

The JAX package's fused island tests fail under jax 0.9.0 in interpret
mode, so the island form is anchored on the port's own single-population
plain version, which the other test files hold against JAX: an island
breed must equal I single-population breeds, each with the island's
draws (its seed, or its slice of the injected draws), bit for bit. The
island geometry is JAX's ``kernel_plan`` at the island size."""

import math

import numpy as np
import pytest
import torch

import libpga_tpu_torch as port
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch.objectives import make_tsp_coords, onemax, random_tsp_coords, rastrigin
from libpga_tpu_torch.ops import fused_step as fs

I = 3


def _islands(geom, seed, integer_scores=False):
    """Genomes (I, Pp, L) with zero pad rows and scores (I, Pp) with -inf
    pad rows."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.random((I, geom.Pp, geom.L), dtype=np.float32))
    s = g.sum(dim=2)
    if integer_scores:
        s = torch.floor(s / 2)
    g[:, geom.P:] = 0.0
    s[:, geom.P:] = -torch.inf
    return g, s


def _seeds(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2**62, I))


# (S, L, crossover, mutate, objective, layout)
ONE_GEN = [
    (1024, 16, "uniform", "point", onemax, "pingpong"),
    (600, 20, "uniform", "gaussian", rastrigin, "pingpong"),  # padded
    (2100, 16, "uniform", "swap", None, "riffle"),
    (512, 24, "order", "swap", "tsp", "riffle"),
]


def _kw(cross, mutate, obj, L):
    kw = dict(tournament_size=3, mutate=mutate, crossover=cross,
              mparams=torch.tensor([0.3, 0.1]))
    if obj == "tsp":
        tsp = make_tsp_coords(random_tsp_coords(L, seed=2), duplicate_mode="genes")
        kw.update(obj_id=tsp.fused_id, coords=tsp.coords, penalty=tsp.penalty)
    else:
        kw.update(obj_id=0 if obj is None else obj.fused_id)
    return kw


@pytest.mark.parametrize("case", ONE_GEN, ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}-{c[3]}")
def test_island_breed_equals_single_breeds(case):
    """Island ranks are each island's single-population ranks; the island
    breed (Philox: one seed per island; injected: the island's slice of
    the draws) is I single-population breeds, children and scores."""
    S, L, cross, mutate, obj, layout = case
    geom = fs.resolve_geometry(S, L, crossover=cross, fused=obj is not None)
    assert geom.layout == layout
    g, s = _islands(geom, S, integer_scores=True)
    tie = torch.from_numpy(np.random.default_rng(1).integers(0, 2**31, (I, geom.Pp)))
    kw = _kw(cross, mutate, obj, L)
    G = geom.G
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, tie)
        assert ranks.shape == (I * G, geom.K)
        seeds = _seeds(parity)
        got = fs.deme_breed(g, ranks, geom, parity, seed=seeds, islands=I, **kw)
        draws = fs.stack_draws([
            fs.philox_draws(seeds[i:i + 1] + 7, G, geom.K, L, mutate, cross) for i in range(I)])
        got_inj = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        for i in range(I):
            r = ranks[i * G:(i + 1) * G]
            assert torch.equal(r, fs.compute_ranks(s[i], geom, parity, tie[i]))
            for res, want in (
                (got, fs.deme_breed(g[i], r, geom, parity, seed=seeds[i:i + 1], **kw)),
                (got_inj, fs.deme_breed_reference(g[i], r, geom, parity, draws.island(i), **kw)),
            ):
                assert torch.equal(res[0][i], want[0])
                if obj is None:
                    assert res[1] is None and want[1] is None
                else:
                    assert torch.equal(res[1][i], want[1])


# (S, L, crossover, objective, layout, elitism)
MULTIGEN = [
    (2048, 16, "uniform", onemax, "pingpong", 0),
    (600, 20, "uniform", onemax, "riffle", 2),
    (512, 16, "order", onemax, "riffle", 1),
]


@pytest.mark.parametrize("case", MULTIGEN, ids=lambda c: f"{c[0]}x{c[1]}-{c[2]}-{c[4]}")
@pytest.mark.parametrize("steps", [0, 1, 3])
def test_island_multigen_equals_single_launches(case, steps):
    """The multi-generation island launch is I single launches, with the
    island's seed or its slice of the injected (I, T, ...) draws, and a
    target that freezes some groups."""
    S, L, cross, obj, layout, elitism = case
    geom = fs.resolve_geometry(S, L, crossover=cross, multigen=True, elitism=elitism)
    assert geom.layout == layout
    g, s = _islands(geom, S + steps)
    target = float(torch.quantile(s[:, :S].amax(dim=1), 0.5)) + 0.5
    mutate = "swap" if cross == "order" else "point"
    kw = dict(mutate=mutate, crossover=cross, obj_id=obj.fused_id, elitism=elitism,
              mparams=torch.tensor([0.2, 0.0]))
    seeds = _seeds(steps)
    T = max(steps, 1)
    draws = fs.stack_draws([fs.stack_draws([
        fs.philox_draws(seeds[i:i + 1] + 3, geom.G, geom.K, L, mutate, cross,
                        sub_generation=t, tie=True) for t in range(T)]) for i in range(I)])
    for parity in range(geom.parities):
        got = fs.multigen_breed(g, s, geom, parity, steps, target, seed=seeds, islands=I, **kw)
        got_inj = fs.multigen_breed_reference(g, s, geom, parity, steps, target, draws=draws, **kw)
        for i in range(I):
            for res, want in (
                (got, fs.multigen_breed(g[i], s[i], geom, parity, steps, target,
                                        seed=seeds[i:i + 1], **kw)),
                (got_inj, fs.multigen_breed_reference(g[i], s[i], geom, parity, steps, target,
                                                      draws=draws.island(i), **kw)),
            ):
                assert torch.equal(res[0][i], want[0])
                assert torch.equal(res[1][i], want[1])


def test_one_island_draws_equal_the_single_population_draws():
    geom = fs.resolve_geometry(1024, 16)
    seed = torch.tensor([12345])
    one = fs.island_philox_draws(seed, geom.G, geom.K, 16, "gaussian")
    single = fs.philox_draws(seed, geom.G, geom.K, 16, "gaussian")
    flat = one.flat()
    for name in ("sel_u", "cross", "mut_u", "gauss"):
        assert torch.equal(getattr(one.island(0), name), getattr(single, name))
        assert torch.equal(getattr(flat, name), getattr(single, name))


# The islands of the repo's island workloads: bench.py's 8 x 131,072 x 100,
# tools/bench_rastrigin.py's 8 x 16,384 x 30, 40,000-row islands (157
# demes: riffle), the TSP islands at 8,192 x 200, and the test shapes.
GEOMETRY = [
    (131_072, 100, "uniform", True, ("pingpong", 512, 8)),
    (16_384, 30, "uniform", True, ("pingpong", 512, 8)),
    (40_000, 100, "uniform", True, ("riffle", 256, 1)),
    (8_192, 200, "order", False, ("riffle", 512, 1)),
    (256, 16, "uniform", True, ("pingpong", 256, 1)),
]


@pytest.mark.parametrize("S,L,cross,fused,want", GEOMETRY, ids=lambda v: str(v))
def test_island_geometry_equals_kernel_plan(S, L, cross, fused, want):
    plan = ps.kernel_plan(S, L, crossover_kind=cross, fused=fused)
    geom = fs.resolve_geometry(S, L, crossover=cross, fused=fused)
    assert (geom.layout, geom.K, geom.D, geom.Pp) == (
        plan["layout"], plan["deme_size"], plan["demes_per_step"], plan["Pp"])
    assert (geom.layout, geom.K, geom.D) == want


def test_engine_island_breed_takes_the_island_geometry():
    p = port.PGA(seed=0, config=port.PGAConfig(device="cpu"))
    for _ in range(2):
        p.create_population(40_000, 100)
    p.set_objective("onemax")
    breed = p._island_breed(40_000, 100, 2)
    assert (breed.geom.layout, breed.geom.K, breed.geom.Pp, breed.islands) == (
        "riffle", 256, 40_192, 2)
    assert p._island_breed(40_000, 100, 2) is breed
    p.set_mutate(None)  # an operator change drops the cached breed
    assert p._island_breed(40_000, 100, 2) is not breed


def test_island_breed_scores_unfused_objectives_on_the_real_rows():
    """An objective without a fused form is scored on the real rows after
    the launch; pad rows stay -inf; no elites inside the breed."""
    breed = fs.make_island_breed(600, 20, lambda g: (g * g).sum(dim=1), I, elitism=2,
                                 device="cpu")
    assert not breed.fused
    geom = breed.geom
    g, s = _islands(geom, 3)
    g2, s2 = breed(g, s, 0, torch.Generator().manual_seed(0))
    torch.testing.assert_close(s2[:, :600], (g2[:, :600] ** 2).sum(dim=2), rtol=0, atol=0)
    assert bool(torch.isinf(s2[:, 600:]).all()) and breed.launches == 1
    assert not math.isinf(float(s2.max()))
