"""Parity of the port's knapsack, NK landscape and deceptive trap
(libpga_tpu_torch/objectives/classic.py) with the JAX package's
(libpga_tpu/objectives/classic.py:103-149, 402-499), of their
expression-fused forms with their direct forms, and of the deme
geometry the port picks for them with JAX's ``kernel_plan``.

Genomes are numpy arrays made from a seed. Knapsack and trap scores are
small integers and compare exactly; NK scores are means of 64 float32
table entries summed in another order, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.objectives import classic as jc
from libpga_tpu.ops import breed_expr as jbx
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch import PGA, PGAConfig
from libpga_tpu_torch import objectives as po
from libpga_tpu_torch.engine import PGA as PortPGA
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import fused_step as fs

T = torch.from_numpy


def _genomes(P, L, seed):
    g = np.random.default_rng(seed).random((P, L), dtype=np.float32)
    g[0, :4] = [0.5, 0.25, 0.0, 0.75]
    return g


@pytest.mark.parametrize("n,k,seed", [(64, 3, 0), (16, 3, 3), (20, 1, 7), (12, 0, 1), (16, 6, 2)])
def test_nk_equals_jax(n, k, seed):
    g = _genomes(33, n, n + k)
    j = jc.make_nk_landscape(n, k, seed=seed)
    p = po.make_nk_landscape(n, k, seed=seed)
    want = np.asarray(jax.vmap(j)(jnp.asarray(g)))
    np.testing.assert_allclose(p(T(g)).numpy(), want, rtol=1e-6, atol=1e-6)
    fused = 2 ** (k + 1) <= 64
    assert hasattr(j, "kernel_rowwise") == fused == (getattr(p, "expr_fused", None) is not None)
    np.testing.assert_array_equal(p.kernel_rowwise_consts[0].numpy(), jc_table_t(n, k, seed))
    if fused:
        np.testing.assert_allclose(
            p(T(g)).numpy(), np.asarray(j.kernel_rowwise(jnp.asarray(g))), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(p.expr_fused(T(g)).numpy(), p(T(g)).numpy(), rtol=1e-6, atol=1e-6)


def jc_table_t(n, k, seed):
    """JAX's NK table, transposed: the same default_rng draw."""
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray(rng.uniform(0.0, 1.0, size=(n, 2 ** (k + 1))).astype(np.float32).T)


@pytest.mark.parametrize("L,trap", [(60, 5), (62, 5), (12, 3), (10, 1), (9, 4)])
def test_trap_equals_jax_and_its_fused_form(L, trap):
    g = _genomes(40, L, L * trap)
    g[1] = 0.9  # the optimum
    j = jc.make_deceptive_trap(trap)
    p = po.make_deceptive_trap(trap)
    want = np.asarray(j.kernel_rowwise(jnp.asarray(g)))
    np.testing.assert_array_equal(p(T(g)).numpy(), want)
    np.testing.assert_array_equal(p.expr_fused(T(g)).numpy(), want)
    assert want[1] == (L // trap) * trap
    assert len(p.expr_fused.kernel_rowwise_consts) == 0  # not const-carrying, as in JAX


@pytest.mark.parametrize("which", ["default", "random"])
def test_knapsack_equals_jax_and_its_fused_form(which):
    if which == "default":
        j, p, n = jc.default_knapsack, po.default_knapsack, 6
    else:
        rng = np.random.default_rng(4)
        v, w = rng.integers(1, 50, 9), rng.integers(1, 20, 9)
        j, p, n = jc.make_knapsack(v, w, 40.0, 3), po.make_knapsack(v, w, 40.0, 3), 9
    g = _genomes(200, n, 5)
    want = np.asarray(j.kernel_rowwise(jnp.asarray(g)))
    np.testing.assert_array_equal(p(T(g)).numpy(), want)
    np.testing.assert_array_equal(p.expr_fused(T(g)).numpy(), want)
    for a, b in zip(p.kernel_rowwise_consts, j.kernel_rowwise_consts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert po.get("knapsack") is po.default_knapsack
    best = np.array([[0.1, 0.1, 0.6, 0.6, 0.1, 0.1]], np.float32)  # items 2 and 3
    if which == "default":
        assert float(p(T(best))[0]) == 285.0


CX = "where(i < floor(q * L), p1, p2)"
SHAPES = [
    # (name, P, L, objective, crossover, const-carrying, (layout, K, D))
    ("nk-4M", 4_194_304, 64, "nk", None, True, ("riffle", 256, 16)),
    ("trap-1M", 1_048_576, 60, "trap", None, False, ("pingpong", 512, 8)),
    ("knapsack", 4096, 6, "knapsack", None, True, ("pingpong", 256, 16)),
    ("onemax-1M-one-point", 1_048_576, 100, "onemax", CX, False, ("pingpong", 512, 8)),
    ("nk-small", 1024, 64, "nk", None, True, ("pingpong", 256, 4)),
]


@pytest.mark.parametrize("name,P,L,obj,cx,const,want", SHAPES, ids=[s[0] for s in SHAPES])
def test_geometry_equals_kernel_plan(name, P, L, obj, cx, const, want):
    kind = jbx.crossover_from_expression(cx) if cx else "uniform"
    plan = ps.kernel_plan(P, L, crossover_kind=kind, const_carrying=const)
    geom = fs.resolve_geometry(P, L, crossover=pbx.crossover_from_expression(cx) if cx else "uniform",
                               const_carrying=const)
    assert (geom.layout, geom.K, geom.D, geom.Pp) == (
        plan["layout"], plan["deme_size"], plan["demes_per_step"], plan["Pp"])
    assert (geom.layout, geom.K, geom.D) == want


@pytest.mark.parametrize("obj", ["nk", "trap", "knapsack"])
def test_engine_geometry_follows_the_objective(obj):
    """The solver passes the objective's const-carrying flag: the fused
    breed it builds has the JAX geometry of the table above."""
    P, L, want = {"nk": (4096, 64, (256, 16)), "trap": (4096, 60, (512, 8)),
                  "knapsack": (4096, 6, (256, 16))}[obj]
    objective = {"nk": po.make_nk_landscape(64, 3), "trap": po.make_deceptive_trap(5),
                 "knapsack": po.default_knapsack}[obj]
    breed = fs.make_fused_breed(P, L, objective, device="cpu")
    assert (breed.geom.K, breed.geom.D) == want
    assert breed.kw["objective"] is objective.expr_fused


def test_nk_run_improves_on_cpu():
    pga = PGA(seed=0, config=PGAConfig(device="cpu"))
    h = pga.create_population(1024, 64)
    nk = po.make_nk_landscape(64, 3, seed=0)
    pga.set_objective(nk)
    start = float(nk(pga.population(h).genomes).max())
    assert pga.uses_deme_kernel(1024, 64)
    assert pga.run(10) == 10 and pga.launches == 10
    genome, best = pga.get_best_with_score(h)
    assert best > start
    np.testing.assert_allclose(float(nk(T(genome[None]))[0]), best, rtol=1e-6)


def test_knapsack_run_reaches_the_optimum_on_cpu():
    pga = PGA(seed=0, config=PGAConfig(device="cpu"))
    h = pga.create_population(4096, 6)
    pga.set_objective("knapsack")
    pga.run(30)
    assert pga.get_best_with_score(h)[1] == 285.0


def test_builtin_crossover_equivalents_run_on_cpu():
    for cx in ("one_point", "arithmetic"):
        pga = PGA(seed=1, config=PGAConfig(device="cpu"))
        h = pga.create_population(1024, 32)
        pga.set_objective("onemax")
        from libpga_tpu_torch.ops import crossover as pcx

        pga.set_crossover(getattr(pcx, f"{cx}_crossover"))
        assert pga._crossover_kind().expression == PortPGA.CROSSOVER_EXPRS[cx]
        pga.run(5)
        pop = pga.population(h)
        assert pga.launches == 5
        np.testing.assert_allclose(pop.scores.numpy(), pop.genomes.sum(1).numpy(), rtol=1e-5)
