"""Population sharding in the port (libpga_tpu_torch/parallel/shard_pop.py
and ``PGA.run`` at ``pop_shards`` > 1) against the JAX package's
(libpga_tpu/parallel/shard_pop.py, ``PGA._run_sharded``), on the CPU.

- The algebra (admissibility, the comb mix) equals JAX's numpy functions,
  and keeps their properties: the mix is a bijection, every deme group
  ships rows, and a lineage reaches every shard in at most S generations.
- The loop equals JAX's ``make_sharded_run`` on the 8-device harness
  (``tests/conftest.py``) when both packages get the same deterministic
  local step: the port's on the stacked (S, P/S, L) tensor, JAX's per
  shard. Genomes and generation counts are equal, scores within 1e-5 per
  gene (float32 sums in another order).
- The kernel route (B9: the island breed over the S shards at elitism 0)
  equals JAX's interpret-mode sharded Pallas route at 4,096x128, S = 4,
  both on zero draws (JAX's interpret mode zeroes the kernel's random
  bits; the port's Philox twin is patched to zeros) and mutation rate 0,
  genomes within the gather tolerance. Both rank sorts break ties with
  their own random words, which cannot differ here: at zero draws the
  only ties are between identical copies (float ``onemax``, not
  ``onemax_bits``, whose L+1 levels would tie distinct rows).
- The route is taken exactly where JAX takes its fused per-shard kernel,
  and the rest of ``run``'s contract holds at S > 1.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu.parallel import shard_pop as jsp
from libpga_tpu_torch import PGA, PGAConfig, interop
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.parallel import shard_pop as sp

GENE_ATOL = 1e-5  # JAX gathers parents with a bf16 hi/lo one-hot matmul
POPS = [96, 100, 256, 4096, 16_384]


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _zero_philox(monkeypatch):
    def zero_draws(seed, G, K, L, mutate="point", crossover="uniform", sub_generation=0,
                   tie=False):
        return fs.zero_draws(G, K, L, mutate, crossover=crossover, steps=1).at(0)

    monkeypatch.setattr(fs, "philox_draws", zero_draws)


# ------------------------------------------------------------- the algebra


@pytest.mark.parametrize("P", POPS)
def test_admissibility_equals_jax(P):
    """With no device cap, the admissible counts are JAX's at a cap of
    ``isqrt(P)`` (every S with S² | P), and the refusal's text is JAX's
    without its device clause."""
    cap = math.isqrt(P)
    assert sp.admissible_shards(P) == jsp.admissible_shards(P, cap)
    assert sp.admissible_shards(P) == [s for s in range(1, P + 1) if P % (s * s) == 0]
    for S in range(1, 20):
        try:
            jsp.validate_shards(P, S, cap)
            want = None
        except ValueError as e:
            want = str(e).replace(f" on {cap} devices", "").replace("S <= devices and ", "")
        if want is None:
            sp.validate_shards(P, S)
        else:
            with pytest.raises(ValueError) as e:
                sp.validate_shards(P, S)
            assert str(e.value) == want
    bad = next(s for s in range(2, 20) if P % (s * s))
    with pytest.raises(ValueError, match=r"valid shard counts: \[1"):
        sp.validate_shards(P, bad)


@pytest.mark.parametrize("P", POPS)
def test_mix_algebra_equals_jax(P):
    for S in sp.admissible_shards(P):
        mix = sp.mix_rows(P, S)
        assert mix == jsp.mix_rows(P, S)
        assert sp.comb_chunks(mix) == jsp.comb_chunks(mix)
        np.testing.assert_array_equal(sp.comb_interleave_rows(mix), jsp.comb_interleave_rows(mix))
        np.testing.assert_array_equal(sp.shard_mix_perm(P, S), jsp.shard_mix_perm(P, S))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_mix_perm_is_a_permutation_with_comb_interleave(S):
    """JAX's property: the comb hops one shard to its interleaved slot,
    the other rows stay, and the comb has stride S."""
    P = 64 * S * S
    perm = sp.shard_mix_perm(P, S)
    assert sorted(perm) == list(range(P))
    Ps, mix = P // S, sp.mix_rows(P, S)
    inv = np.argsort(sp.comb_interleave_rows(mix))
    for s in range(S):
        m = np.arange(mix)
        np.testing.assert_array_equal(perm[s * Ps + m * S], (s + 1) % S * Ps + inv[m] * S)
        off = np.array([j for j in range(Ps) if j % S])
        np.testing.assert_array_equal(perm[s * Ps + off], s * Ps + off)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_lineage_reaches_every_shard(S):
    """JAX's lineage BFS: a child anywhere in a shard descends from any of
    its rows, then the mix moves the comb; every shard is reached from
    shard 0 within S generations."""
    P = 16 * S * S
    perm, Ps = sp.shard_mix_perm(P, S), P // S
    reach = {0}
    for _ in range(S):
        reach |= {int(perm[s * Ps + j]) // Ps for s in reach for j in range(Ps)}
    assert reach == set(range(S))


def test_comb_interleave_rows_is_a_slab_permutation():
    for mix in (1, 4, 8, 16, 48):
        assert sorted(sp.comb_interleave_rows(mix)) == list(range(mix))


def test_refusals():
    with pytest.raises(ValueError, match="pop_shards"):
        PGAConfig(device="cpu", pop_shards=0)
    step = lambda g, s, gen, generator: (g.clone(), None)  # noqa: E731
    with pytest.raises(ValueError, match="per-shard rows 128"):
        sp.make_sharded_run(lambda g: g.sum(-1), step, 256, 16, 2, elitism=129)
    with pytest.raises(ValueError, match=r"valid shard counts: \[1, 2, 4, 8, 16\]"):
        sp.make_sharded_run(lambda g: g.sum(-1), step, 256, 16, 3)


# -------------------------------------- the loop against JAX's make_sharded_run

LOOP_P, LOOP_L = 512, 16


def _jax_step(scored: bool):
    """A local step with no draws: every shard's rows roll by one and
    gene ``gen % L`` flips to ``1 - g``; scored steps return the rowwise
    sum (pre-mix, so the loop must re-score the comb)."""
    def step(g, s, sub, mparams, gen):
        g2 = jnp.roll(g, 1, axis=0)
        g2 = jnp.where(jnp.arange(LOOP_L)[None, :] == gen % LOOP_L, 1.0 - g2, g2)
        return g2, (jnp.sum(g2, axis=-1) if scored else None)

    return step


def _port_step(scored: bool):
    def step(g, s, gen, generator):
        g2 = torch.roll(g, 1, dims=1)
        g2 = torch.where(torch.arange(LOOP_L) == gen % LOOP_L, 1.0 - g2, g2)
        return g2, (g2.sum(dim=-1) if scored else None)

    return step


def _loops_agree(S, elitism, scored, n, target=None):
    g = np.random.default_rng(S * 10 + elitism).random((LOOP_P, LOOP_L), dtype=np.float32)
    jrun = jsp.make_sharded_run(lambda x: jnp.sum(x, axis=-1), _jax_step(scored), LOOP_P,
                                LOOP_L, S, elitism=elitism)
    jg, js, jgens = jrun(jnp.asarray(g), jax.random.key(0), jnp.int32(n),
                         jnp.float32(jnp.inf if target is None else target), jnp.zeros(2))
    prun = sp.make_sharded_run(lambda x: x.sum(dim=-1), _port_step(scored), LOOP_P, LOOP_L,
                               S, elitism=elitism)
    pg, pscores, pgens = prun(torch.from_numpy(g), n, target, None)
    assert (prun.shards, prun.mix, prun.k_sync) == (jrun.shards, jrun.mix, jrun.k_sync)
    assert pgens == int(jgens)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(pscores.numpy(), np.asarray(js), rtol=0, atol=1e-5 * LOOP_L)
    return pgens


@pytest.mark.parametrize("scored", [True, False], ids=["scored", "unscored"])
@pytest.mark.parametrize("elitism", [0, 2])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_loop_equals_jax(S, elitism, scored):
    assert _loops_agree(S, elitism, scored, n=6) == 6


@pytest.mark.parametrize("S", [2, 4, 8])
def test_loop_stops_at_the_target_as_jax(S):
    """A target above the first best stops both loops at the same
    generation, before n."""
    g = np.random.default_rng(S * 10 + 2).random((LOOP_P, LOOP_L), dtype=np.float32)
    target = float(g.sum(axis=1).max()) + 0.5
    assert _loops_agree(S, 2, True, n=40, target=target) < 40


# ------------------------------------------- B9: the kernel route against JAX


def _jax_sharded_run(P, L, S, elitism, n, genomes):
    with _interpret():
        jp = libpga_tpu.PGA(seed=0, config=libpga_tpu.PGAConfig(
            pop_shards=S, use_pallas=True, fallback="raise", mutation_rate=0.0,
            elitism=elitism))
        jh = jp.install_population(jnp.asarray(genomes))
        jp.set_objective("onemax")
        gens = jp.run(n)
    return gens, np.asarray(jp.population(jh).genomes), np.asarray(jp.population(jh).scores)


@pytest.mark.parametrize("P,elitism", [(4096, 0), (4096, 2), (16_384, 0)])
def test_kernel_route_equals_jax_interpret(monkeypatch, P, elitism):
    """``PGA.run(3)`` at ``pop_shards=4``, Px128: the port's island breed
    over 4 shards (its plain version on the CPU) against JAX's
    interpret-mode per-shard ``make_pallas_breed``, both on zero draws."""
    monkeypatch.setattr(libpga_tpu.PGA, "_pallas_backend_ok", lambda self: True)
    _zero_philox(monkeypatch)
    L, S, n = 128, 4, 3
    pp = PGA(seed=0, config=PGAConfig(device="cpu", pop_shards=S, mutation_rate=0.0,
                                      elitism=elitism))
    h = pp.create_population(P, L)
    pp.set_objective("onemax")
    g0 = pp.population(h).genomes.numpy().copy()
    assert pp.run(n) == n and pp.launches == n
    step, per_gen = pp._sharded_local_step(P // S, L)
    geom = step.breed.geom
    assert per_gen == 1
    jgens, jg, js = _jax_sharded_run(P, L, S, elitism, n, g0)
    assert jgens == n
    jbreed = _closure_breed(libpga_tpu.PGA(seed=0, config=libpga_tpu.PGAConfig(
        pop_shards=S, use_pallas=True, fallback="raise")), P // S, L)
    assert (geom.layout, geom.K, geom.D, geom.Pp) == (jbreed.layout, jbreed.K, jbreed.D,
                                                       jbreed.Pp)
    pop = pp.population(h)
    np.testing.assert_allclose(pop.genomes.numpy(), jg, rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(pop.scores.numpy(), js, rtol=0, atol=1e-5 * L)
    if elitism:
        assert pop.scores.max() >= g0.sum(axis=1).max() - 1e-3


# ---------------------------------------------------------- routing


def _closure_breed(jp, shard_size, L):
    """The fused breed JAX's ``_sharded_local_step`` closes over, or None
    on its XLA route."""
    jp.set_objective("onemax")
    step = jp._sharded_local_step(shard_size, L)
    cells = [c.cell_contents for c in step.__closure__ or ()]
    return next((c for c in cells if hasattr(c, "Pp")), None)


# (P, L, S, gene dtype, kernel route): the shard plans of the bench and test shapes.
ROUTES = [
    (1 << 20, 128, 4, "float32", True),
    (1 << 20, 128, 8, "float32", True),
    (1 << 20, 128, 4, "bfloat16", True),
    (1 << 24, 128, 8, "float32", True),
    (1 << 24, 128, 4, "float32", True),
    (1 << 20, 100, 4, "float32", False),
    (65_536, 64, 4, "float32", False),
    (4096, 128, 4, "float32", True),
]


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: f"{r[0]}x{r[1]}-S{r[2]}-{r[3]}")
def test_route_follows_kernel_plan_and_exact_fit(route):
    """At the shard shape the port's geometry is ``kernel_plan``'s, and
    the kernel route is taken exactly where JAX's exact fit holds."""
    P, L, S, dt, kernel = route
    pp = PGA(seed=0, config=PGAConfig(device="cpu", pop_shards=S,
                                      gene_dtype=getattr(torch, dt)))
    pp.set_objective("onemax")
    plan = ps.kernel_plan(P // S, L, gene_dtype=getattr(jnp, dt))
    geom = pp._deme_geometry(P // S, L)
    assert (geom.layout, geom.K, geom.D, geom.Pp) == (
        plan["layout"], plan["deme_size"], plan["demes_per_step"], plan["Pp"])
    exact = plan["Pp"] == P // S and plan["Lp"] == L
    assert pp.sharded_kernel_route(P // S, L) == exact == kernel


@pytest.mark.parametrize("L", [128, 100])
def test_route_equals_jax_sharded_local_step(monkeypatch, L):
    """At 4,096xL, S = 4, the port takes the kernel route exactly where
    JAX's ``_sharded_local_step`` closes over a fused breed."""
    monkeypatch.setattr(libpga_tpu.PGA, "_pallas_backend_ok", lambda self: True)
    jp = libpga_tpu.PGA(seed=0, config=libpga_tpu.PGAConfig(
        pop_shards=4, use_pallas=True, fallback="raise"))
    jbreed = _closure_breed(jp, 1024, L)
    pp = PGA(seed=0, config=PGAConfig(device="cpu", pop_shards=4))
    pp.set_objective("onemax")
    assert pp.sharded_kernel_route(1024, L) == (jbreed is not None) == (L == 128)
    assert pp._sharded_local_step(1024, L)[1] == (L == 128)


def test_route_declines_without_a_fused_objective_or_kernel_kinds():
    pp = PGA(seed=0, config=PGAConfig(device="cpu", pop_shards=4))
    pp.set_objective(lambda g: g.sum(dim=1))
    assert not pp.sharded_kernel_route(1024, 128)
    pp.set_objective("onemax")
    assert pp.sharded_kernel_route(1024, 128)
    pp.set_crossover(lambda a, b, r: a)
    assert not pp.sharded_kernel_route(1024, 128)
    off = PGA(seed=0, config=PGAConfig(device="cpu", pop_shards=4, use_deme_kernel=False))
    off.set_objective("onemax")
    assert not off.sharded_kernel_route(1024, 128)


# ------------------------------------------------------- run at S > 1


def _solver(S, P=256, L=32, objective="onemax_bits", seed=7, **cfg):
    cfg.setdefault("selection", "truncation")
    cfg.setdefault("mutation_rate", 0.05)
    pp = PGA(seed=seed, config=PGAConfig(device="cpu", pop_shards=S, **cfg))
    h = pp.create_population(P, L)
    pp.set_objective(objective)
    return pp, h


def test_pop_shards_one_is_todays_run():
    a, ha = _solver(1, P=1024, objective="onemax")
    b = PGA(seed=7, config=PGAConfig(device="cpu", selection="truncation", mutation_rate=0.05))
    hb = b.create_population(1024, 32)
    b.set_objective("onemax")
    assert a.run(5) == b.run(5) == 5 and a.launches == b.launches == 5
    assert list(a._runs) == list(b._runs) == [(1024, 32)]
    assert torch.equal(a.population(ha).genomes, b.population(hb).genomes)


def test_inadmissible_shards_and_elitism_raise_at_run():
    pp, _ = _solver(4, P=100)
    with pytest.raises(ValueError, match=r"valid shard counts: \[1, 2, 5, 10\]"):
        pp.run(2)
    pp, _ = _solver(4, P=256, elitism=65)
    with pytest.raises(ValueError, match=r"elitism=65 must be in \[0, per-shard rows 64\]"):
        pp.run(2)


def test_sharded_final_best_equals_one_shard():
    """JAX's panmictic-equivalence test through the port, on the panmictic
    route as JAX's runs it (``use_pallas=False``): 2/4/8-shard runs of
    onemax_bits at 256x32 with truncation and elitism 2 reach the 1-shard
    run's final best, the optimum, with an optimal genome."""
    def final_best(S):
        pp, h = _solver(S, elitism=2, use_deme_kernel=False)
        gens = pp.run(400, target=32.0)
        g, s = pp.get_best_with_score(h)
        assert pp.launches == 0
        return gens, g, np.float32(s)

    gens1, g1, s1 = final_best(1)
    assert gens1 < 400 and s1 == np.float32(32.0) and (g1 >= 0.5).all()
    for S in (2, 4, 8):
        gens, g, s = final_best(S)
        assert gens < 400 and s.tobytes() == s1.tobytes() and (g >= 0.5).all(), S


@pytest.mark.parametrize("S", [4, 8])
def test_global_elitism_never_loses_the_best(S):
    pp, h = _solver(S, P=4096, L=128, objective="onemax", elitism=1)
    best = []
    for _ in range(12):
        assert pp.run(1) == 1
        best.append(pp.get_best_with_score(h)[1])
    assert pp.launches == 12
    assert all(b2 >= b1 for b1, b2 in zip(best, best[1:])), best


def test_target_stops_at_the_reaching_generation():
    """The stop reads the global best: the kept generation is the first
    whose best reaches the target (a same-seed run one generation shorter
    stays below it)."""
    def fresh():
        return _solver(4, P=4096, L=128, objective="onemax", seed=3, mutation_rate=0.01)

    pp, h = fresh()
    target = pp.population(h).genomes.sum(dim=1).max().item() + 6.0
    gens = pp.run(1000, target=target)
    assert 0 < gens < 1000 and pp.get_best_with_score(h)[1] >= target
    assert pp.launches == gens
    before, hb = fresh()
    before.run(gens - 1)
    assert before.get_best_with_score(hb)[1] < target


@pytest.mark.parametrize("P,L,kernel", [(4096, 128, True), (4096, 100, False)])
def test_run_installs_one_logical_population(P, L, kernel):
    pp, h = _solver(4, P=P, L=L, objective="onemax")
    assert pp.run(5) == 5 and pp.launches == 5 * kernel
    pop = pp.population(h)
    assert pop.genomes.shape == (P, L) and pop.scores.shape == (P,)
    torch.testing.assert_close(pop.scores, pop.genomes.sum(dim=1), rtol=0, atol=1e-4)
    run = pp._runs[("shards", 4, P, L)][0]
    assert (run.shards, run.mix, run.k_sync) == (4, P // 16, 1)
    assert pp.run(2) == 2 and list(pp._runs) == [("shards", 4, P, L)]


def test_generations_per_launch_is_ignored_at_several_shards():
    pp, h = _solver(4, P=4096, L=128, objective="onemax", generations_per_launch=4)
    assert pp.run(6) == 6 and pp.launches == 6


def test_bf16_and_expression_hooks_take_the_kernel_route():
    pp, h = _solver(4, P=4096, L=128, objective="onemax", gene_dtype=torch.bfloat16)
    assert pp.run(4) == 4 and pp.launches == 4
    assert pp.population(h).genomes.dtype == torch.bfloat16
    pp, h = _solver(4, P=4096, L=128, objective="onemax", selection="tournament")
    pp.set_mutate(pbx.mutate_from_expression(
        "where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05, sigma=0.1))
    start = pp.population(h).genomes.sum(dim=1).max().item()
    assert pp.sharded_kernel_route(1024, 128)
    assert pp.run(6) == 6 and pp.launches == 6
    assert pp.get_best_with_score(h)[1] > start


def test_interop_carries_pop_shards():
    cfg = interop.pga_config_from_fields(libpga_tpu.PGAConfig(pop_shards=4), device="cpu")
    assert cfg == dataclasses.replace(PGAConfig(device="cpu"), pop_shards=4)
    pp = PGA(seed=0, config=cfg)
    pp.create_population(256, 32)
    pp.set_objective("onemax")
    assert pp.run(3) == 3 and math.isfinite(pp.get_best_with_score(pp._handles()[0])[1])


def test_kernel_step_breeds_at_the_generation_parity():
    """The kernel route's step is one island breed over the shards at the
    parity ``gen & 1`` (a ping-pong geometry of two groups a shard): it
    equals the plain island breed on the draws its generator gives,
    replayed, and the two parities breed different children."""
    S, P, L = 4, 8192, 128
    pp = PGA(seed=0, config=PGAConfig(device="cpu", pop_shards=S, deme_size=128))
    pp.set_objective("onemax")
    step, _ = pp._sharded_local_step(P // S, L)
    geom, kw = step.breed.geom, step.breed.kw
    assert geom.layout == "pingpong" and geom.S == 2 and kw["obj_id"] != 0
    g = torch.from_numpy(np.random.default_rng(5).random((S, P // S, L), dtype=np.float32))
    s = g.sum(dim=-1)
    kids = []
    for gen in range(3):
        got = step(g, s, gen, torch.Generator().manual_seed(gen))
        replay = torch.Generator().manual_seed(gen)
        tie = fs.draw_tie_words(replay, S * geom.Pp, "cpu").view(S, geom.Pp)
        ranks = fs.compute_ranks(s, geom, gen % 2, tie)
        seeds = torch.randint(0, 2**63 - 1, (S,), generator=replay)
        draws = fs.island_philox_draws(seeds, geom.G, geom.K, L)
        want = fs.deme_breed_reference(g, ranks, geom, gen % 2, draws, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        kids.append(fs.deme_breed_reference(g, ranks, geom, 1 - gen % 2, draws, **kw)[0])
        assert not torch.equal(got[0], kids[-1])
