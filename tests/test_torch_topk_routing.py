"""Best and top-k extraction, large tournaments and the panmictic-fallback
warning of the port (libpga_tpu_torch/ops/topk.py, config.py, engine.py,
ops/fused_step.carry_elites) against the JAX package (libpga_tpu/ops/
topk.py, config.py, engine.py, ops/pallas_step._carry_elites).

Scores are integer-valued, so many tie, and some are NaN of either sign:
``lax.top_k`` puts the lower index first among equal scores and orders
by the IEEE total order, which every top-k site of the port must
reproduce row for row. Inputs are numpy arrays made from a seed and
handed to both packages.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu
import libpga_tpu_torch as port
from libpga_tpu.ops import crossover as jxo
from libpga_tpu.ops import mutate as jmut
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu.ops import step as jstep
from libpga_tpu.ops import topk as jtopk
from libpga_tpu_torch import interop
from libpga_tpu_torch.gp import encoding as enc
from libpga_tpu_torch.gp import operators as gpo
from libpga_tpu_torch.ops import crossover as xo
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import mutate as mut
from libpga_tpu_torch.ops import topk
from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
from libpga_tpu_torch.ops.step import make_breed
from test_torch_step import jax_breed_draws

CPU = port.PGAConfig(device="cpu")


def tied_scores(n, seed, nan=True):
    """Integer-valued float32 scores in 0..4 (many ties), with +NaN,
    -NaN, -inf and -0.0 planted where ``nan``."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 5, n).astype(np.float32)
    if nan:
        m = rng.random(n)
        s[m < 0.08] = np.nan
        s[(m >= 0.08) & (m < 0.12)] = -np.nan
        s[(m >= 0.12) & (m < 0.16)] = -np.inf
        s[(m >= 0.16) & (m < 0.2)] = -0.0
    return s


# ------------------------------------------------------------------ C2: top-k


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("nan", [False, True])
def test_top_k_picks_lax_top_k_rows_in_its_order(seed, nan):
    s = tied_scores(64, seed, nan)
    for k in (1, 2, 7, 33, 64):
        want_s, want_i = jax.lax.top_k(jnp.asarray(s), k)
        got_s, got_i = topk.top_k(torch.from_numpy(s), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_s.numpy().view(np.int32), np.asarray(want_s).view(np.int32))


def _both_solvers(seed):
    """A JAX and a port solver holding the same genomes and tied scores."""
    rng = np.random.default_rng(seed)
    g = rng.random((96, 8), dtype=np.float32)
    s = tied_scores(96, seed + 10)
    jp = libpga_tpu.PGA(seed=0)
    jh = jp.install_population(jnp.asarray(g))
    jp._populations[jh.index] = libpga_tpu.Population(genomes=jnp.asarray(g), scores=jnp.asarray(s))
    p = port.pga_init(0, CPU)
    h = p.install_population(interop.state_from_numpy(g, s, device="cpu"))
    return (jp, jh), (p, h), g, s


@pytest.mark.parametrize("seed", range(4))
def test_best_and_top_genomes_are_jax_rows(seed):
    (jp, jh), (p, h), g, s = _both_solvers(seed)
    for k in (1, 5, 40, 200):
        np.testing.assert_array_equal(p.get_best_top(h, k), np.asarray(jp.get_best_top(jh, k)))
    got_g, got_s = p.get_best_with_score(h)
    want_g, want_s = jp.get_best_with_score(jh)
    np.testing.assert_array_equal(got_g, np.asarray(want_g))
    assert np.float32(got_s).view(np.int32) == np.float32(want_s).view(np.int32)
    np.testing.assert_array_equal(p.get_best(h), got_g)
    bg, bs = topk.best_genome(torch.from_numpy(g), torch.from_numpy(s))
    jg, js = jtopk.top_k_genomes(jnp.asarray(g), jnp.asarray(s), 1)
    np.testing.assert_array_equal(bg.numpy(), np.asarray(jg)[0])


@pytest.mark.parametrize("elitism", [1, 3, 9])
def test_carried_elites_are_jax_rows(elitism):
    """The one-generation deme path's global elites (``carry_elites``)
    against ``_carry_elites`` on tied scores with NaN."""
    rng = np.random.default_rng(elitism)
    g_prev, g2 = rng.random((2, 128, 6), dtype=np.float32)
    s_prev = tied_scores(128, elitism + 3)
    s2 = rng.random(128, dtype=np.float32)
    wg, ws = ps._carry_elites(jnp.asarray(g_prev), jnp.asarray(s_prev), jnp.asarray(g2),
                              jnp.asarray(s2), elitism)
    pg, pss = torch.from_numpy(g2.copy()), torch.from_numpy(s2.copy())
    fs.carry_elites(torch.from_numpy(g_prev), torch.from_numpy(s_prev), pg, pss, elitism)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(pss.numpy().view(np.int32), np.asarray(ws).view(np.int32))


@pytest.mark.parametrize("elitism", [2, 6])
def test_panmictic_elites_are_jax_rows(elitism):
    """``make_breed``'s elites on tied scores with NaN, on JAX's draws."""
    P, L = 64, 10
    rng = np.random.default_rng(elitism)
    g = rng.random((P, L), dtype=np.float32)
    s = tied_scores(P, elitism + 5)
    key = jax.random.key(elitism)
    want = np.asarray(jstep.make_breed(jxo.uniform_crossover, jmut.make_point_mutate(0.2),
                                       elitism=elitism)(jnp.asarray(g), jnp.asarray(s), key))
    draws = jax_breed_draws(key, P, L, "tournament", 2, None,
                            getattr(jmut.make_point_mutate(0.2), "rand_cols", None))
    got = make_breed(xo.uniform_crossover, mut.make_point_mutate(0.2), elitism=elitism)(
        torch.from_numpy(g), torch.from_numpy(s), draws=draws).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:elitism], g[np.asarray(jax.lax.top_k(jnp.asarray(s), elitism)[1])])


# ------------------------------------------------------- C1: large tournaments


@pytest.mark.parametrize("k", [17, 32])
def test_large_tournament_takes_the_panmictic_path_in_both(k, monkeypatch):
    """JAX's gate declines k > 16 even on a TPU (stood in for); the port
    accepts the config and runs the panmictic path."""
    monkeypatch.setattr(libpga_tpu.PGA, "_pallas_backend_ok", lambda self: True)
    jp = libpga_tpu.PGA(seed=0, config=libpga_tpu.PGAConfig(tournament_size=k, use_pallas=True))
    jp.set_objective("onemax")
    assert not jp._pallas_gate()
    assert libpga_tpu.PGA(seed=0, config=libpga_tpu.PGAConfig(use_pallas=True))._pallas_gate()
    p = port.PGA(seed=0, config=port.PGAConfig(device="cpu", tournament_size=k))
    h = p.create_population(1024, 16)
    p.set_objective("onemax")
    assert not p.uses_deme_kernel(1024, 16)
    assert fs.resolve_geometry(1024, 16, tournament_size=k) is None
    start = float(p.population(h).scores.max())
    assert p.run(3) == 3 and p.launches == 0
    assert p.get_best_with_score(h)[1] >= start
    with pytest.raises(ValueError, match=">= 1"):
        port.PGAConfig(tournament_size=0)


def test_large_tournament_children_equal_jax():
    """k = 32 tournaments breed JAX's children on JAX's draws."""
    P, L, k = 128, 12, 32
    rng = np.random.default_rng(32)
    g = rng.random((P, L), dtype=np.float32)
    s = tied_scores(P, 32, nan=False)
    key = jax.random.key(5)
    cross, mutate = jxo.uniform_crossover, jmut.make_point_mutate(0.1)
    want = np.asarray(jstep.make_breed(cross, mutate, tournament_size=k, elitism=1)(
        jnp.asarray(g), jnp.asarray(s), key))
    draws = jax_breed_draws(key, P, L, "tournament", k, getattr(cross, "rand_cols", None),
                            getattr(mutate, "rand_cols", None))
    got = make_breed(xo.uniform_crossover, mut.make_point_mutate(0.1), tournament_size=k,
                     elitism=1)(torch.from_numpy(g), torch.from_numpy(s), draws=draws).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------- C3: the panmictic-path warning


def _opaque_crossover(p1, p2, rand):
    return p1


_opaque_crossover.batched = lambda p1, p2, rand: p1
_opaque_crossover.rand_cols = 0


def _opaque_mutate(g, rand):
    return g


_opaque_mutate.batched = lambda g, rand: g
_opaque_mutate.rand_cols = 0


def _gp_ops():
    gp = enc.GPConfig(max_nodes=8, n_vars=2)
    return gpo.make_subtree_crossover(gp), gpo.make_gp_mutate(gp)


OPERATOR_CASES = {
    # name: (port crossover, port mutate) -> the JAX pair built alike
    "builtin": (None, None),
    "opaque_crossover": (_opaque_crossover, None),
    "opaque_mutation": (None, _opaque_mutate),
    "both_opaque": (_opaque_crossover, _opaque_mutate),
    "expression_mutation": (None, "expr"),
    "gp": ("gp", "gp"),
}


def _jax_ops(case):
    from libpga_tpu.gp import encoding as jenc
    from libpga_tpu.gp import operators as jgpo
    from libpga_tpu.ops import breed_expr as jbx

    c, m = OPERATOR_CASES[case]
    if c == "gp":
        gp = jenc.GPConfig(max_nodes=8, n_vars=2)
        return jgpo.make_subtree_crossover(gp), jgpo.make_gp_mutate(gp)
    jm = {None: None, "expr": jbx.mutate_from_expression("where(r < rate, r2, g)")}.get(m, m)
    return c, jm


def _port_ops(case):
    c, m = OPERATOR_CASES[case]
    if c == "gp":
        return _gp_ops()
    return c, mutate_from_expression("where(r < rate, r2, g)") if m == "expr" else m


def _warnings_of(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught if "in-kernel form" in str(w.message)]


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_fallback_warning_fires_where_jax_warns(case, monkeypatch):
    """Where the kernels could run (JAX: a TPU; the port: a card, both
    stood in for), the same operators warn in both packages, naming the
    same operators, and the GP operators (``xla_only``) stay quiet."""
    monkeypatch.setattr(libpga_tpu.PGA, "_pallas_backend_ok", lambda self: True)
    monkeypatch.setattr(port.PGA, "_deme_backend_ok", lambda self: True)
    jp = libpga_tpu.PGA(seed=0, config=libpga_tpu.PGAConfig(use_pallas=True))
    jc, jm = _jax_ops(case)
    if jc is not None:
        jp.set_crossover(jc)
    if jm is not None:
        jp.set_mutate(jm)
    p = port.PGA(seed=0, config=CPU)
    pc, pm = _port_ops(case)
    p.set_crossover(pc)
    p.set_mutate(pm)
    want = _warnings_of(jp._warn_xla_fallback)
    got = _warnings_of(p._warn_panmictic_fallback)
    assert len(got) == len(want) == (case.startswith(("opaque", "both")))
    for w, g in zip(want, got):
        assert g.split(" have no")[0] == w.split(" have no")[0]  # "custom <ops> operator(s)"


def test_fallback_warning_on_the_run_path_and_not_on_the_cpu(monkeypatch):
    """``run`` warns once per run function it builds on the panmictic
    path where a card would take the kernels, and never where the
    solver's device is the CPU."""
    p = port.PGA(seed=0, config=CPU)
    p.create_population(256, 8)
    p.set_objective("onemax")
    p.set_crossover(_opaque_crossover)
    assert _warnings_of(lambda: p.run(2)) == []
    monkeypatch.setattr(port.PGA, "_deme_backend_ok", lambda self: True)
    p.set_mutate(_opaque_mutate)
    got = _warnings_of(lambda: p.run(2))
    assert len(got) == 1 and got[0].startswith("custom crossover and mutation operator(s)")
    assert _warnings_of(lambda: p.run(2)) == []  # the run function is cached
    off = port.PGA(seed=0, config=port.PGAConfig(device="cpu", use_deme_kernel=False))
    off.create_population(256, 8)
    off.set_objective("onemax")
    off.set_crossover(_opaque_crossover)
    assert _warnings_of(lambda: off.run(2)) == []
