"""GP symbolic regression through the port's ``PGA.run`` on the CPU:
generation-0 scores of a population carried across from the JAX package
equal JAX's, and the recovery case of tools/gp_smoke.py (``a*a + b``,
the restricted function set, 128 programs, truncation, elitism 2)
reaches score exactly 0.0 within 80 generations, deterministically."""

import jax
import numpy as np
import pytest
import torch

import libpga_tpu
import libpga_tpu_torch as port
from libpga_tpu.gp import encoding as jenc
from libpga_tpu.gp.sr import symbolic_regression as jax_sr
from libpga_tpu_torch import interop
from libpga_tpu_torch.gp import encoding as enc
from libpga_tpu_torch.gp import operators as gpo
from libpga_tpu_torch.gp.sr import make_dataset, symbolic_regression
from libpga_tpu_torch.ops import kernels

SMOKE = dict(max_nodes=8, n_vars=2, consts=(1.0, 2.0), unary=("neg",), binary=("add", "sub", "mul"))


@pytest.mark.parametrize("optimize", [True, False])
def test_generation_zero_scores_of_a_jax_population_equal_jax(optimize):
    jgp = jenc.GPConfig(max_nodes=16, n_vars=2, optimize=optimize)
    X, y = make_dataset(lambda a, b: a * b + a, n_samples=64, n_vars=2, seed=0)
    jp = libpga_tpu.PGA(seed=0)
    jh = jp.install_population(jenc.random_population(jax.random.key(1), 256, jgp))
    jp.set_objective(jax_sr(X, y, gp=jgp, fused=False))
    jp.evaluate(jh)
    want = np.asarray(jp.population(jh).scores)

    gp = interop.gp_config_from_fields(jgp)
    p = port.PGA(seed=0, config=port.PGAConfig(device="cpu"))
    h = p.install_population(interop.state_from_numpy(np.asarray(jp.population(jh).genomes), device="cpu"))
    p.set_objective(symbolic_regression(X, y, gp=gp))
    p.set_crossover(gpo.make_subtree_crossover(gp))
    assert p.run(0) == 0
    np.testing.assert_allclose(p.population(h).scores.numpy(), want, rtol=1e-5, atol=1e-5)


def _solver(gp, seed=0):
    X, y = make_dataset(lambda a, b: a * a + b, n_samples=32, n_vars=2, seed=0)
    p = port.PGA(seed=seed, config=port.PGAConfig(device="cpu", selection="truncation", elitism=2))
    p.set_objective(symbolic_regression(X, y, gp=gp))
    p.set_crossover(gpo.make_subtree_crossover(gp))
    p.set_mutate(gpo.make_gp_mutate(gp, 0.4, 0.6))
    h = p.install_population(enc.random_population(torch.Generator().manual_seed(seed), 128, gp))
    return p, h


def _solve(gp, seed=0):
    p, h = _solver(gp, seed)
    gens = p.run(80, target=0.0)
    best, score = p.get_best_with_score(h)
    return gens, best, score, p


def test_exact_recovery_is_deterministic():
    gp = enc.GPConfig(**SMOKE)
    before = dict(kernels.LAUNCHES)
    gens1, best1, s1, p = _solve(gp)
    assert gens1 < 80 and np.float32(s1) == np.float32(0.0)
    assert not p.uses_deme_kernel(128, gp.genome_len) and p.launches == 0
    assert kernels.LAUNCHES == before  # CPU tensors launch nothing
    assert enc.is_well_formed(best1, gp)
    # The elites among tied scores are lax.top_k's rows (ops/topk.py),
    # which pins this run's trajectory to this form of a*a + b.
    assert enc.decode_expression(best1, gp) == "(x1 + (x0 * x0))"
    gens2, best2, s2, _ = _solve(gp)
    assert gens2 == gens1 and best1.tobytes() == best2.tobytes()


def test_exact_recovery_with_the_optimizer_off():
    gp = enc.GPConfig(**SMOKE, optimize=False)
    gens, best, score, _ = _solve(gp)
    assert gens < 80 and np.float32(score) == np.float32(0.0)


def test_best_rises_and_target_stops_at_the_first_reaching_generation():
    gp = enc.GPConfig(**SMOKE)
    gens, _, score, _ = _solve(gp)
    p, h = _solver(gp)
    first = float(p._objective.rows(p.population(h).genomes).max())
    assert p.run(gens - 1) == gens - 1
    earlier = p.get_best_with_score(h)[1]
    assert first <= earlier < 0.0
    assert np.float32(score) == np.float32(0.0)
