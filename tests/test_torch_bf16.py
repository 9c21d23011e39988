"""bfloat16 genomes in the port (``PGAConfig(gene_dtype=torch.bfloat16)``)
against the JAX package at ``gene_dtype=jnp.bfloat16`` on the same numpy
inputs and draws.

JAX's bf16 kernels gather parents exactly (a 0/1 one-hot matmul of bf16
genes, ``pallas_step.py:595-599``), breed the child in float32 and round
it once to bf16 where they store it, then score the stored genes. So the
breeding core is held bit for bit (no gene tolerance), the plain breeds
of the port at bf16 must be their float32 breeds of the widened genomes,
rounded, and the geometry must be JAX's bf16 geometry."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu
import libpga_tpu_torch as port
from libpga_tpu.objectives import classic as jc
from libpga_tpu.objectives import get as jax_objective
from libpga_tpu.ops import crossover as jxo
from libpga_tpu.ops import mutate as jmut
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu.ops import step as jstep
from libpga_tpu.ops.breed_expr import mutate_from_expression as jax_mutate_expr
from libpga_tpu.parallel import islands as jis
from libpga_tpu_torch import objectives
from libpga_tpu_torch.interop import pga_config_from_fields, state_from_numpy
from libpga_tpu_torch.objectives import onemax
from libpga_tpu_torch.ops import crossover as xo
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import mutate as mut
from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
from libpga_tpu_torch.ops.step import make_breed
from libpga_tpu_torch.parallel import islands as pis
from libpga_tpu_torch.population import create_population
from test_torch_deme_breed import CORE_CASES, _core_inputs, ps_select_param
from test_torch_step import jax_breed_draws

BF = torch.bfloat16
CPU_BF16 = port.PGAConfig(device="cpu", gene_dtype=BF)
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16, widened back to float32."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# (1) the breeding core, bit for bit ------------------------------------------


def _jax_child_bf16(x, *, V, sel, sel_param, tk, mutate, rate, sigma, elite_rows):
    """``_deme_child`` on bf16 genes (``bf16_genes=True``) with the numpy
    draws queued in JAX's draw order, its float32 child rounded to bf16
    as the kernel stores it."""
    K, L = x["g"].shape
    Lp = 128 * -(-L // 128)
    pad = ((0, 0), (0, Lp - L))
    queue = [x["sel_u"].T]
    if mutate in ("point", "swap"):
        queue.append(x["mut_u"].T)
    elif mutate == "gaussian":
        queue += [np.pad(p, pad) for p in x["gauss"]]

    def uniform(shape):
        a = queue.pop(0)
        assert a.shape == shape
        return jnp.asarray(a)

    lane_ok = jax.lax.broadcasted_iota(jnp.int32, (K, Lp), 1) < L if mutate == "gaussian" else None
    child = ps._deme_child(
        jnp.asarray(np.pad(x["g"], pad), jnp.bfloat16),
        jnp.asarray(x["ranks"], jnp.float32)[None, :], jnp.float32(V), uniform,
        jnp.asarray(np.pad(x["cross"], pad).astype(np.uint32)), 0,
        K=K, L=L, Lp=Lp, tk=tk, sel=sel, sel_param=sel_param, crossover="uniform",
        mutate=mutate, rate=jnp.float32(rate), sigma=jnp.float32(sigma), lane_ok=lane_ok,
        bf16_genes=True, elite_rows=elite_rows,
    )
    assert not queue
    return np.asarray(child.astype(jnp.bfloat16).astype(jnp.float32))[:, :L]


def _port_child_bf16(x, *, V, sel, sel_param, tk, mutate, rate, sigma, elite_rows):
    draws = fs.Draws(
        sel_u=torch.from_numpy(x["sel_u"])[None],
        cross=torch.from_numpy(x["cross"])[None],
        mut_u=torch.from_numpy(x["mut_u"])[None],
        gauss=None if x["gauss"] is None else torch.from_numpy(x["gauss"])[:, None],
    )
    g = torch.from_numpy(x["g"]).to(BF)
    child = fs.breed_children(
        g.float()[None], torch.from_numpy(x["ranks"])[None], torch.tensor([float(V)]), draws,
        tournament_size=tk, selection=sel, selection_param=sel_param, mutate=mutate,
        mparams=torch.tensor([rate, sigma], dtype=torch.float32), elite_rows=elite_rows,
    )
    return _f32(child[0].to(BF))


@pytest.mark.parametrize("sel,param,tk,mutate,elite,V", CORE_CASES)
def test_bf16_breeding_core_equals_deme_child_bit_for_bit(sel, param, tk, mutate, elite, V):
    x = _core_inputs(zlib.crc32(repr((sel, tk, mutate, elite, V)).encode()), mutate)
    x["g"] = _round(x["g"])
    kw = dict(V=V, sel=sel, sel_param=ps_select_param(sel, param), tk=tk,
              mutate=mutate, rate=0.3, sigma=0.1, elite_rows=elite)
    np.testing.assert_array_equal(_port_child_bf16(x, **kw), _jax_child_bf16(x, **kw))


# (2) whole-breed structure -----------------------------------------------------


def test_bf16_structure_equals_interpret_mode_breed():
    """``test_pallas.py::test_bf16_gene_mode_structure`` in both packages:
    512x16, K=128, zero draws, no mutation: every child copies its deme's
    row 0, the dtype stays bf16, and the port equals JAX's breed."""
    P, L, K = 512, 16, 128
    G = P // K
    genomes = (np.broadcast_to(np.arange(P, dtype=np.float32)[:, None], (P, L)) / P)
    scores = -(np.arange(P, dtype=np.float32) % K)
    with _interpret():
        breed = ps.make_pallas_breed(P, L, deme_size=K, mutation_rate=0.0,
                                     gene_dtype=jnp.bfloat16)
        want = breed(jnp.asarray(genomes, jnp.bfloat16), jnp.asarray(scores), jax.random.key(0))
    assert want.dtype == jnp.bfloat16
    geom = fs.resolve_geometry(P, L, deme_size=K, fused=False, gene_dtype=BF)
    assert (geom.layout, geom.K, geom.D, geom.Pp) == (breed.layout, breed.K, breed.D, breed.Pp)
    g = torch.from_numpy(genomes.copy()).to(BF)
    ranks = fs.compute_ranks(torch.from_numpy(scores), geom, 0, torch.zeros(P, dtype=torch.int64))
    got, _ = fs.deme_breed_reference(g, ranks, geom, 0, fs.zero_draws(G, K, L),
                                     mparams=torch.tensor([0.0, 0.0]))
    assert got.dtype == BF
    np.testing.assert_array_equal(_f32(got), np.asarray(want.astype(jnp.float32)))
    for r in range(0, P, 31):
        np.testing.assert_array_equal(_f32(got[r]), _f32(g[(r % G) * K]))


# (3) one generation at bf16 is the float32 generation, rounded ------------------


def _population(P, L, seed, islands=None):
    lead = () if islands is None else (islands,)
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(_round(rng.random(lead + (P, L), dtype=np.float32)))
    return g.to(BF)


def _assert_rounded(bf, f32, objective=None, obj_id=onemax.fused_id):
    """A bf16 breed's ``(genomes, scores)`` against the float32 breed's:
    genomes its children rounded, scores the objective of the stored
    genes, in the kernels' lane order."""
    assert bf[0].dtype == BF
    np.testing.assert_array_equal(_f32(bf[0]), _f32(f32[0].to(BF)))
    L = bf[0].shape[-1]
    stored = bf[0].float()
    if objective is not None:
        want = objective.kernel_rowwise(stored.reshape(-1, L), warp_order=True).reshape(stored.shape[:-1])
    else:
        want = fs.rowwise_scores(obj_id, stored, warp_order=True)
    real = torch.isfinite(bf[1])
    np.testing.assert_allclose(bf[1][real].numpy(), want[real].numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("P,L,mutate,parity", [
    (1024, 20, "point", 1), (1000, 20, "gaussian", 0), (2100, 24, "swap", 0),
])
def test_bf16_deme_breed_is_the_float32_breed_rounded(P, L, mutate, parity):
    geom = fs.resolve_geometry(P, L, gene_dtype=BF)
    assert geom.q == 16
    g = torch.zeros((geom.Pp, L), dtype=BF)
    g[:P] = _population(P, L, P + L)
    s = torch.full((geom.Pp,), -torch.inf)
    s[:P] = g[:P].float().sum(dim=1)
    ranks = fs.compute_ranks(s, geom, parity, torch.arange(geom.Pp) * 7919 % 1000)
    draws = fs.philox_draws(torch.tensor([12345]), geom.G, geom.K, L, mutate)
    kw = dict(mutate=mutate, obj_id=onemax.fused_id, mparams=torch.tensor([0.3, 0.1]))
    bf = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
    f32 = fs.deme_breed_reference(g.float(), ranks, geom, parity, draws, **kw)
    _assert_rounded(bf, f32)
    if mutate == "gaussian":
        assert bool((bf[0] == 1.0).any())  # the clip at 1 - 1e-7 rounds to 1.0, as in JAX


def test_bf16_multigen_one_step_is_the_float32_step_rounded():
    """One sub-generation is the float32 step rounded; after three the
    rows are still bf16 and each score is its stored row's."""
    P, L = 2048, 20
    geom = fs.resolve_geometry(P, L, multigen=True, gene_dtype=BF)
    g = _population(P, L, 3)
    s = g.float().sum(dim=1)
    kw = dict(seed=torch.tensor([99]), mparams=torch.tensor([0.2, 0.0]), obj_id=onemax.fused_id,
              elitism=1)
    bf = fs.multigen_breed_reference(g, s, geom, 0, 1, **kw)
    _assert_rounded(bf, fs.multigen_breed_reference(g.float(), s, geom, 0, 1, **kw))
    g3, s3 = fs.multigen_breed_reference(g, s, geom, 0, 3, **kw)
    assert g3.dtype == BF
    np.testing.assert_array_equal(
        s3.numpy(), fs.rowwise_scores(onemax.fused_id, g3.float(), warp_order=True).numpy())


def test_bf16_expression_breed_is_the_float32_breed_rounded():
    P, L = 1024, 20
    trap = objectives.make_deceptive_trap(5)
    creep = mutate_from_expression(CREEP, rate=0.3, sigma=0.1)
    geom = fs.resolve_geometry(P, L, gene_dtype=BF)
    g = _population(P, L, 4)
    s = trap(g.float())
    ranks = fs.compute_ranks(s, geom, 1, torch.arange(P) % 5)
    draws = fs.philox_draws(torch.tensor([5]), geom.G, geom.K, L, creep)
    kw = dict(mutate=creep, objective=trap.expr_fused, mparams=torch.tensor([0.3, 0.1]))
    bf = fs.deme_breed_reference(g, ranks, geom, 1, draws, **kw)
    _assert_rounded(bf, fs.deme_breed_reference(g.float(), ranks, geom, 1, draws, **kw),
                    objective=trap.expr_fused)
    mg = fs.resolve_geometry(P, L, multigen=True, gene_dtype=BF)
    kw = dict(seed=torch.tensor([6]), mutate=creep, objective=trap.expr_fused,
              mparams=torch.tensor([0.3, 0.1]))
    bf = fs.multigen_breed_reference(g, s, mg, 0, 1, **kw)
    _assert_rounded(bf, fs.multigen_breed_reference(g.float(), s, mg, 0, 1, **kw),
                    objective=trap.expr_fused)


def test_bf16_island_breed_is_the_float32_breed_rounded():
    I, S, L = 3, 512, 16
    geom = fs.resolve_geometry(S, L, gene_dtype=BF)
    g = _population(S, L, 8, islands=I)
    s = g.float().sum(dim=2)
    ranks = fs.compute_ranks(s, geom, 0, torch.arange(I * S).view(I, S) % 11)
    draws = fs.island_philox_draws(torch.tensor([1, 2, 3]), geom.G, geom.K, L)
    kw = dict(obj_id=onemax.fused_id, mparams=torch.tensor([0.5, 0.0]))
    bf = fs.deme_breed_reference(g, ranks, geom, 0, draws, **kw)
    _assert_rounded(bf, fs.deme_breed_reference(g.float(), ranks, geom, 0, draws, **kw))
    one = fs.deme_breed_reference(g[1], ranks[geom.G:2 * geom.G], geom, 0, draws.island(1), **kw)
    np.testing.assert_array_equal(_f32(bf[0][1]), _f32(one[0]))
    mg = fs.resolve_geometry(S, L, multigen=True, gene_dtype=BF)
    kw = dict(seed=torch.tensor([4, 5, 6]), obj_id=onemax.fused_id, mparams=torch.tensor([0.5, 0.0]))
    _assert_rounded(fs.multigen_breed_reference(g, s, mg, 0, 1, **kw),
                    fs.multigen_breed_reference(g.float(), s, mg, 0, 1, **kw))


# (4) geometry ----------------------------------------------------------------


@pytest.mark.parametrize("P,L", [(1 << 20, 100), (131_072, 100), (40_000, 100), (4096, 64)])
def test_bf16_geometry_equals_jax_factories(P, L):
    const = L == 64  # NK: an objective that carries kernel constants
    with _interpret():
        jobj = jc.make_nk_landscape(L, 3, seed=0) if const else jax_objective("onemax")
        kw = dict(fused_obj=jobj.kernel_rowwise,
                  fused_consts=tuple(getattr(jobj, "kernel_rowwise_consts", ())),
                  gene_dtype=jnp.bfloat16)
        one = ps.make_pallas_breed(P, L, **kw)
        multi = ps.make_pallas_multigen(P, L, **kw)
    for jb, mg in ((one, False), (multi, True)):
        geom = fs.resolve_geometry(P, L, multigen=mg, const_carrying=const, gene_dtype=BF)
        assert (geom.layout, geom.K, geom.D, geom.Pp) == (jb.layout, jb.K, jb.D, jb.Pp), mg
        assert geom.q == ps.pingpong_quantum(jnp.bfloat16) == 16


def test_bf16_geometry_of_the_main_shapes():
    """The table of the slice: at 1M bf16 breeds ping-pong D=8 in both
    kernels (the float32 multigen kernel runs the riffle D=4 there); at
    131,072 the one-generation D is 4 (float32: 8); 40,000 is riffle."""
    def plan(P, mg, dtype=BF):
        g = fs.resolve_geometry(P, 100, multigen=mg, gene_dtype=dtype)
        return g.layout, g.K, g.D, g.Pp

    assert plan(1 << 20, False) == ("pingpong", 512, 8, 1 << 20)
    assert plan(1 << 20, True) == ("pingpong", 512, 8, 1 << 20)
    assert plan(1 << 20, True, torch.float32) == ("riffle", 512, 4, 1 << 20)
    assert plan(131_072, False) == ("pingpong", 512, 4, 131_072)
    assert plan(131_072, False, torch.float32)[2] == 8
    assert plan(40_000, False) == plan(40_000, True) == ("riffle", 256, 1, 40_192)


def test_bf16_order_crossover_declines_as_in_jax():
    assert ps.make_pallas_breed(1024, 20, crossover_kind="order", gene_dtype=jnp.bfloat16) is None
    assert fs.resolve_geometry(1024, 20, crossover="order", gene_dtype=BF) is None
    assert fs.resolve_geometry(1024, 20, crossover="order", multigen=True, gene_dtype=BF) is None
    assert fs.resolve_geometry(1024, 20, crossover="order") is not None
    p = port.pga_init(0, CPU_BF16)
    h = p.create_population(1024, 20)
    p.set_objective("onemax")
    p.set_crossover(xo.order_preserving_crossover)
    p.set_mutate(mut.make_swap_mutate(0.5))
    assert not p.uses_deme_kernel(1024, 20)
    assert p.run(3) == 3 and p.launches == 0
    assert p.population(h).genomes.dtype == BF
    with pytest.raises(ValueError):
        fs.resolve_geometry(1024, 20, gene_dtype=torch.float16)


# (5) the panmictic path on JAX's draws -------------------------------------------


OPERATORS = [
    ("point", lambda m: m.make_point_mutate(0.3)),
    ("gaussian", lambda m: m.make_gaussian_mutate(rate=0.3, sigma=0.1)),
    ("gaussian-small", lambda m: m.make_gaussian_mutate(rate=0.3, sigma=0.003)),
    ("swap", lambda m: m.make_swap_mutate(0.5)),
    ("creep", None),
]


@pytest.mark.parametrize("name,make", OPERATORS)
def test_bf16_panmictic_breed_equals_jax_make_breed(name, make):
    """``make_breed`` on bf16 genes and JAX's own draws, bit for bit:
    the Gaussian's sigma meets the bf16 genes as JAX's weak-typed scalar
    does (rounded to bf16, a bf16 product)."""
    P, L = 256, 40
    rng = np.random.default_rng(31)
    g = _round(rng.random((P, L), dtype=np.float32))
    s = g.sum(axis=1)
    if make is None:
        jm, pm = jax_mutate_expr(CREEP, rate=0.3, sigma=0.1), mutate_from_expression(
            CREEP, rate=0.3, sigma=0.1)
    else:
        jm, pm = make(jmut), make(mut)
    key = jax.random.key(17)
    want = jstep.make_breed(jxo.uniform_crossover, jm)(
        jnp.asarray(g, jnp.bfloat16), jnp.asarray(s), key)
    assert want.dtype == jnp.bfloat16
    draws = jax_breed_draws(key, P, L, "tournament", 2, None, getattr(jm, "rand_cols", None))
    got = make_breed(xo.uniform_crossover, pm)(torch.from_numpy(g).to(BF), torch.from_numpy(s),
                                                draws=draws)
    assert got.dtype == BF
    np.testing.assert_array_equal(_f32(got), np.asarray(want.astype(jnp.float32)))


def test_bf16_gaussian_sigma_is_rounded_as_jax_rounds_it():
    """The repair: on bf16 genes sigma is a bf16 value. The float32
    product rounded once (the old promotion) differs from JAX in some
    genes; the operator now equals JAX on every gene."""
    rng = np.random.default_rng(0)
    g = _round(rng.random((512, 100), dtype=np.float32))
    r = rng.random((512, 100), dtype=np.float32)
    want = np.asarray(jmut.gaussian_mutate(jnp.asarray(g, jnp.bfloat16), jnp.asarray(r), 0.3, 0.1)
                      .astype(jnp.float32))
    got = _f32(mut.gaussian_mutate(torch.from_numpy(g).to(BF), torch.from_numpy(r), 0.3, 0.1))
    np.testing.assert_array_equal(got, want)


# (6) end to end ----------------------------------------------------------------


@pytest.mark.parametrize("T", [None, 4])
def test_bf16_run_keeps_the_dtype_and_the_best_rises(T):
    cfg = port.PGAConfig(device="cpu", gene_dtype=BF, generations_per_launch=T)
    p = port.pga_init(3, cfg)
    h = port.pga_create_population(p, 4096, 16)
    port.pga_set_objective_function(p, "onemax")
    start = float(p.population(h).genomes.float().sum(dim=1).max())
    assert p.uses_deme_kernel(4096, 16)
    assert port.pga_run(p, 8) == 8
    pop = p.population(h)
    assert pop.genomes.dtype == BF and pop.scores.dtype == torch.float32
    assert p.launches == (8 if T is None else 2)
    best = port.pga_get_best(p, h)
    assert best.dtype == np.float32 and best.shape == (16,)
    assert float(best.sum()) == p.get_best_with_score(h)[1] > start
    np.testing.assert_allclose(pop.scores.numpy(), pop.genomes.float().sum(dim=1).numpy(),
                               rtol=0, atol=1e-4)
    assert port.pga_get_best_top(p, h, 3).dtype == np.float32


def test_bf16_run_matches_jax_xla_run_in_dtype_and_shape():
    """``test_pallas.py::test_engine_bf16_genes_on_xla_path`` in both
    packages: 256x8, five generations."""
    jp = libpga_tpu.PGA(seed=0, config=libpga_tpu.PGAConfig(gene_dtype=jnp.bfloat16))
    jh = jp.create_population(256, 8)
    jp.set_objective("onemax")
    jp.run(5)
    p = port.pga_init(0, CPU_BF16)
    h = p.create_population(256, 8)
    p.set_objective("onemax")
    assert p.run(5) == 5
    assert str(jp.population(jh).genomes.dtype) == "bfloat16" and p.population(h).genomes.dtype == BF
    assert np.asarray(jp.get_best(jh)).shape == p.get_best(h).shape == (8,)


@pytest.mark.parametrize("topology", ["ring", "random"])
def test_bf16_migration_moves_jax_rows(topology):
    rng = np.random.default_rng(5)
    I, S, L, count = 4, 64, 8, 3
    g = _round(rng.random((I, S, L), dtype=np.float32))
    s = rng.integers(-3, 4, (I, S)).astype(np.float32)
    key = jax.random.key(9)
    want_g, want_s = jis._migrate_local(jnp.asarray(g, jnp.bfloat16), jnp.asarray(s), key, count,
                                        topology)
    order = torch.from_numpy(np.asarray(jax.random.permutation(key, I)).astype(np.int64))
    got_g, got_s = pis.migrate_local(torch.from_numpy(g).to(BF), torch.from_numpy(s), count,
                                     topology, order)
    assert got_g.dtype == BF
    np.testing.assert_array_equal(_f32(got_g), np.asarray(want_g.astype(jnp.float32)))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_bf16_run_islands():
    p = port.pga_init(4, CPU_BF16)
    for _ in range(4):
        p.create_population(1024, 16)
    p.set_objective("onemax")
    start = max(float(pop.genomes.float().sum(dim=1).max()) for pop in p._populations)
    assert port.pga_run_islands(p, 20, 5, 0.05) == 20
    assert p.launches == 20  # one island launch per generation
    assert all(pop.genomes.dtype == BF for pop in p._populations)
    assert p.get_best_all().dtype == np.float32
    assert max(p.get_best_with_score(h)[1] for h in p._handles()) > start
    assert p.get_best_top_all(5).shape == (5, 16)


def test_bf16_state_crosses_from_a_jax_solver_exactly():
    jp = libpga_tpu.PGA(seed=1, config=libpga_tpu.PGAConfig(gene_dtype=jnp.bfloat16))
    jh = jp.create_population(300, 12)
    jp.set_objective("onemax")
    jp.run(3)
    jg = jp.population(jh).genomes
    cfg = pga_config_from_fields(jp.config, device="cpu")
    assert cfg.gene_dtype == BF
    pop = state_from_numpy(np.asarray(jg), np.asarray(jp.population(jh).scores), device="cpu",
                           gene_dtype=BF)
    assert pop.genomes.dtype == BF
    want = np.asarray(jg).view(np.uint16)
    np.testing.assert_array_equal(pop.genomes.view(torch.int16).numpy().view(np.uint16), want)
    p = port.pga_init(0, cfg)
    h = p.install_population(pop)
    np.testing.assert_array_equal(p.population(h).genomes.view(torch.int16).numpy().view(np.uint16),
                                  want)


# (7) the initial population ----------------------------------------------------


def test_bf16_initial_population_is_on_jax_grid():
    got = create_population(torch.Generator().manual_seed(0), 2048, 64, dtype=BF).genomes
    want = np.asarray(jax.random.uniform(jax.random.key(0), (2048, 64), dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    assert got.dtype == BF
    vals = np.unique(_f32(got))
    grid = np.arange(128, dtype=np.float32) / 128
    np.testing.assert_array_equal(vals, np.unique(want))
    np.testing.assert_array_equal(vals, grid)
    assert float(got.float().max()) == 127 / 128 < 1.0
    assert abs(float(got.float().mean()) - float(want.mean())) < 0.01
    zeros = create_population(torch.Generator(), 4, 8, init="zeros", dtype=BF).genomes
    assert zeros.dtype == BF and not zeros.float().any()
