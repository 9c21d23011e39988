"""Parity of the port's expression breeding (libpga_tpu_torch/ops/
breed_expr.py, the expression branches of ops/fused_step.py and the
engine's routing) with the JAX package's (libpga_tpu/ops/breed_expr.py,
pallas_step.py, engine.py).

Inputs and noise are numpy arrays made from a seed and handed to both
packages. ``.batched`` is compared on the same uniform block (the
derived streams bit for bit). The breeding core is compared draw for
draw by calling JAX's ``_deme_child`` with an injected ``uniform``. The
whole one-generation breed runs JAX's ``make_pallas_breed`` under
``force_tpu_interpret_mode`` (all-zero PRNG bits: every parent is its
cohort's rank-0 row and every stream is 0) against the port's plain
version with all-zero draws, in the three row maps and on a padded
population: genes within 1e-5 (JAX gathers parents with a bf16 hi/lo
one-hot matmul), scores within L * 1e-5. The kernel itself runs only
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu import PGA as JaxPGA
from libpga_tpu.objectives import ExpressionError as JaxExpressionError
from libpga_tpu.objectives import from_expression as jax_from_expression
from libpga_tpu.objectives import get as jax_get
from libpga_tpu.ops import breed_expr as jbx
from libpga_tpu.ops import crossover as jcx
from libpga_tpu.ops import mutate as jmut
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch import PGA, PGAConfig
from libpga_tpu_torch.objectives import ExpressionError, from_expression, onemax
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import crossover as pcx
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import mutate as pmut

GENE_ATOL = 1e-5
T = torch.from_numpy

CROSS_EXPRS = [
    ("where(i < floor(q * L), p1, p2)", {}),
    ("r * p1 + (1 - r) * p2", {}),
    ("where(r2 < 0.5, min(p1, p2), max(p1, p2)) * m + q2 * (1 - m)",
     {"m": (np.arange(12) % 3 > 0).astype(np.float32)}),
    ("where(i < 3, 1 - p1, p2 * 0.5 + c)", {"c": 0.25}),
]
MUT_EXPRS = [
    ("where(r < rate, g + sigma * (2*r2 - 1), g)", {}),
    ("where(r < rate, r2, g)", {}),
    ("where(q < 0.5, g % 0.3 + sigma, round(g * 4) / 4) + 0 * q2", {}),
    ("where(i % 2 == 0, g * 0.75 + sigma, abs(g - w))", {"w": np.linspace(0, 1, 12).astype(np.float32)}),
]


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# (a) operators ------------------------------------------------------------


@pytest.mark.parametrize("expr,consts", CROSS_EXPRS)
def test_crossover_batched_equals_jax(expr, consts):
    s = zlib.crc32(expr.encode())
    p1, p2, rand = (_rand((16, 12), s + j) for j in range(3))
    j = jbx.crossover_from_expression(expr, **consts)
    p = pbx.crossover_from_expression(expr, **consts)
    np.testing.assert_array_equal(
        p.batched(T(p1), T(p2), T(rand)).numpy(),
        np.asarray(j.batched(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(rand))),
    )
    assert p.kernel_rows.uses == j.kernel_rows.uses
    assert p.pinned_genome_len == j.pinned_genome_len
    assert p.kernel_cache_key == j.kernel_cache_key


@pytest.mark.parametrize("expr,consts", MUT_EXPRS)
def test_mutate_batched_equals_jax(expr, consts):
    s = zlib.crc32(expr.encode())
    g, rand = _rand((16, 12), s), _rand((16, 12), s + 1)
    j = jbx.mutate_from_expression(expr, rate=0.3, sigma=0.1, **consts)
    p = pbx.mutate_from_expression(expr, rate=0.3, sigma=0.1, **consts)
    np.testing.assert_array_equal(
        p.batched(T(g), T(rand)).numpy(),
        np.asarray(j.batched(jnp.asarray(g), jnp.asarray(rand))),
    )
    assert (p.rate, p.sigma) == (j.rate, j.sigma)
    assert p.kernel_rows.uses == j.kernel_rows.uses
    assert p.kernel_cache_key == j.kernel_cache_key


def test_derived_streams_bit_for_bit():
    r = _rand((64, 33), 5)
    r[0, 0], r[1, 0] = 0.0, np.float32(1.0 - 2**-24)
    got = pbx.derived_streams(T(r))
    want = jbx._derived_streams(jnp.asarray(r))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_clip_keeps_nan_as_jnp_clip():
    cx = pbx.crossover_from_expression("log(p1 - 0.5) + 2 * p2")
    jx = jbx.crossover_from_expression("log(p1 - 0.5) + 2 * p2")
    p1, p2, rand = (_rand((8, 10), 40 + j) for j in range(3))
    got = cx.batched(T(p1), T(p2), T(rand)).numpy()
    want = np.asarray(jx.batched(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(rand)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(got).any() and got[~np.isnan(got)].max() <= np.float32(1 - 1e-7)


BAD_BREEDING = [
    ("crossover", "where(r < 0.5, g, p2)", {}),
    ("mutate", "p1 + g", {}),
    ("crossover", "p1 * rate", {}),
    ("mutate", "g * c", {"c": np.ones((2, 3))}),
    ("crossover", "p1 + sum(p2)", {}),
    ("mutate", "g + max(g) * 0", {}),
    ("crossover", "roll(p1, 1)", {}),
    ("mutate", "gather(t, g)", {"t": np.ones(4)}),
    ("crossover", "dot(p1, p2)", {}),
    ("mutate", "g * a + b", {"a": np.ones(3), "b": np.ones(4)}),
    ("crossover", "p1 +", {}),
]


@pytest.mark.parametrize("role,expr,consts", BAD_BREEDING)
def test_bad_breeding_expressions_raise_in_both(role, expr, consts):
    make_j = jbx.crossover_from_expression if role == "crossover" else jbx.mutate_from_expression
    make_p = pbx.crossover_from_expression if role == "crossover" else pbx.mutate_from_expression
    with pytest.raises(JaxExpressionError) as je:
        make_j(expr, **consts)
    with pytest.raises(ExpressionError) as pe:
        make_p(expr, **consts)
    assert str(pe.value) == str(je.value)


# (b) the breeding core, draw for draw --------------------------------------

CORE_K, CORE_L = 128, 12


def _jax_core(x, cx, mx, *, V, rate, sigma):
    """``_deme_child`` with the numpy draws in JAX's order: selection,
    the crossover's streams (r, r2 per gene, then the (2, K) row pair
    q, q2, each only if used), the mutation's."""
    K, L = x["g"].shape
    Lp = 128 * -(-L // 128)
    pad = ((0, 0), (0, Lp - L))
    queue = [x["sel_u"].T]
    for base, op in ((0, cx), (2, mx)):
        uses = op.kernel_rows.uses
        for j, v in ((0, "r"), (1, "r2")):
            if v in uses:
                queue.append(np.pad(x["gene"][base + j], pad))
        if uses & {"q", "q2"}:
            queue.append(x["row"][:, base:base + 2].T)

    def uniform(shape):
        a = queue.pop(0)
        assert a.shape == shape
        return jnp.asarray(a)

    crows, cconsts = ps._breeding_kind(cx, L, Lp)
    mrows, mconsts = ps._breeding_kind(mx, L, Lp)
    child = ps._deme_child(
        jnp.asarray(np.pad(x["g"], pad)), jnp.asarray(x["ranks"], jnp.float32)[None, :],
        jnp.float32(V), uniform, None, 0, K=K, L=L, Lp=Lp, tk=2, sel="tournament",
        sel_param=None, crossover=crows, mutate=mrows, rate=jnp.float32(rate),
        sigma=jnp.float32(sigma), lane_ok=None, bf16_genes=False,
        cross_consts=cconsts, mut_consts=mconsts,
    )
    assert not queue
    return np.asarray(child)[:, :L]


def _port_core(x, cx, mx, *, V, rate, sigma):
    K, L = x["g"].shape
    draws = fs.Draws(
        sel_u=T(x["sel_u"])[None], cross=None, mut_u=torch.zeros((1, K, 4)),
        expr_gene=T(x["gene"])[:, None], expr_row=T(x["row"])[None],
    )
    child = fs.breed_children(
        T(x["g"])[None], T(x["ranks"])[None], torch.tensor([float(V)]), draws,
        tournament_size=2, selection="tournament", selection_param=None, mutate=mx,
        mparams=torch.tensor([rate, sigma], dtype=torch.float32), crossover=cx,
    )
    return child[0].numpy()


@pytest.mark.parametrize("ci", range(len(CROSS_EXPRS)))
@pytest.mark.parametrize("mi", range(len(MUT_EXPRS)))
def test_breeding_core_equals_deme_child(ci, mi):
    (ce, cc), (me, mc) = CROSS_EXPRS[ci], MUT_EXPRS[mi]
    rng = np.random.default_rng(ci * 10 + mi)
    K, L = CORE_K, CORE_L
    x = dict(
        g=rng.random((K, L), dtype=np.float32), ranks=rng.permutation(K).astype(np.int32),
        sel_u=rng.random((K, 2), dtype=np.float32), gene=rng.random((4, K, L), dtype=np.float32),
        row=rng.random((K, 4), dtype=np.float32),
    )
    kw = dict(V=100 if mi % 2 else K, rate=0.3, sigma=0.1)
    got = _port_core(x, pbx.crossover_from_expression(ce, **cc),
                     pbx.mutate_from_expression(me, **mc), **kw)
    want = _jax_core(x, jbx.crossover_from_expression(ce, **cc),
                     jbx.mutate_from_expression(me, **mc), **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=GENE_ATOL)


# (c) the whole one-generation breed, interpret mode -------------------------


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


NK_T = np.random.default_rng(3).random((16, 20)).astype(np.float32)
OBJECTIVES = {
    # name: (expression, constants, threshold objective)
    "smooth": ("sum(g * g) + dot(w, g)", {"w": np.linspace(0, 1, 20).astype(np.float32)}, False),
    "nk": ("b = g >= 0.5; codes = b + 2*roll(b, 1) + 4*roll(b, 2) + 8*roll(b, 3);"
           " mean(gather(T, codes))", {"T": NK_T}, True),
    "onemax": (None, None, False),
}


def _whole_breed(P, L, parity, layout, objective, cx_expr, mx_expr):
    expr, consts, threshold = OBJECTIVES[objective]
    jcx_op = jbx.crossover_from_expression(cx_expr)
    jmx_op = jbx.mutate_from_expression(mx_expr, rate=0.3, sigma=0.1)
    pcx_op = pbx.crossover_from_expression(cx_expr)
    pmx_op = pbx.mutate_from_expression(mx_expr, rate=0.3, sigma=0.1)
    if expr is None:
        jobj, jconsts, pobj = jax_get("onemax").kernel_rowwise, (), None
    else:
        jf = jax_from_expression(expr, **consts)
        jobj, jconsts, pobj = jf.kernel_rowwise, jf.kernel_rowwise_consts, from_expression(expr, **consts)
    with _interpret():
        breed = ps.make_pallas_breed(
            P, L, crossover_kind=jcx_op, mutate_kind=jmx_op, fused_obj=jobj,
            fused_consts=jconsts, mutation_rate=0.3, mutation_sigma=0.1, _layout=layout,
        )
    geom = fs.resolve_geometry(P, L, layout=layout, crossover=pcx_op,
                               const_carrying=bool(jconsts))
    assert (breed.layout, breed.K, breed.D, breed.Pp) == (geom.layout, geom.K, geom.D, geom.Pp)
    Pp, Lp = breed.Pp, breed.Lp
    rng = np.random.default_rng(P + L + parity)
    genomes = np.zeros((Pp, L), np.float32)
    genomes[:P] = rng.random((P, L), dtype=np.float32)
    scores = -np.arange(Pp, dtype=np.float32)
    scores[P:] = -np.inf
    with _interpret():
        g_jax, s_jax = breed.padded(
            jnp.asarray(np.pad(genomes, ((0, 0), (0, Lp - L)))), jnp.asarray(scores),
            jax.random.key(0), None, parity,
        )
    g_jax, s_jax = np.asarray(g_jax)[:, :L], np.asarray(s_jax)
    ranks = fs.compute_ranks(T(scores), geom, parity, torch.zeros(Pp, dtype=torch.int64))
    kw = dict(objective=pobj) if pobj is not None else dict(obj_id=onemax.fused_id)
    g_port, s_port = fs.deme_breed_reference(
        T(genomes), ranks, geom, parity,
        fs.zero_draws(geom.G, geom.K, L, mutate=pmx_op, crossover=pcx_op),
        mparams=torch.tensor([0.3, 0.1]), crossover=pcx_op, mutate=pmx_op, **kw,
    )
    np.testing.assert_allclose(g_port.numpy(), g_jax, rtol=0, atol=GENE_ATOL)
    real = np.arange(Pp) < P
    assert np.isinf(s_port.numpy()[~real]).all() and np.isinf(s_jax[~real]).all()
    if threshold:
        # JAX's ~1e-5 gather error can move a gene across g >= 0.5: hold
        # the port's scores against JAX's rowwise form of its children.
        want = np.asarray(jobj(jnp.asarray(g_port.numpy()[real]), *jconsts))
    else:
        want = s_jax[real]
    np.testing.assert_allclose(s_port.numpy()[real], want, rtol=0, atol=L * 1e-5)
    return geom


WHOLE = [
    # (P, L, parity, layout, objective, layout expected, Pp expected)
    (4096, 20, 0, None, "smooth", "pingpong", 4096),
    (4096, 20, 1, None, "smooth", "pingpong", 4096),
    (4096, 20, 0, "riffle", "nk", "riffle", 4096),
    (1000, 20, 1, None, "nk", "pingpong", 1024),
    (1000, 20, 0, "riffle", "onemax", "riffle", 1024),
    (4096, 20, 1, None, "onemax", "pingpong", 4096),
]


@pytest.mark.parametrize("P,L,parity,layout,objective,want_layout,want_Pp", WHOLE)
def test_whole_breed_equals_interpret_kernel(P, L, parity, layout, objective, want_layout, want_Pp):
    geom = _whole_breed(P, L, parity, layout, objective,
                        "where(i < 3, 1 - p1, p2 * 0.5 + 0.25)",
                        "where(i % 2 == 0, g * 0.75 + sigma, where(r < rate, r2, g))")
    assert (geom.layout, geom.Pp) == (want_layout, want_Pp)


@pytest.mark.parametrize("name", ["one_point", "arithmetic"])
def test_whole_breed_builtin_equivalents(name):
    from libpga_tpu_torch.engine import PGA as PortPGA

    _whole_breed(2048, 20, 1, None, "smooth", PortPGA.CROSSOVER_EXPRS[name],
                 "where(r < rate, g + sigma * (2*r2 - 1), g)")


# (d) engine routing ---------------------------------------------------------


def _operators():
    """(JAX operator, port operator) pairs of every kind."""
    ce, me = "where(r < 0.5, p1, p2)", "where(r < rate, r2, g)"
    return {
        "crossover": [
            (None, None),
            (jcx.uniform_crossover, pcx.uniform_crossover),
            (jcx.order_preserving_crossover, pcx.order_preserving_crossover),
            (jcx.one_point_crossover, pcx.one_point_crossover),
            (jcx.arithmetic_crossover, pcx.arithmetic_crossover),
            (jbx.crossover_from_expression(ce), pbx.crossover_from_expression(ce)),
        ],
        "mutate": [
            (None, None),
            (jmut.make_point_mutate(0.2), pmut.make_point_mutate(0.2)),
            (jmut.make_gaussian_mutate(0.3, 0.05), pmut.make_gaussian_mutate(0.3, 0.05)),
            (jmut.make_swap_mutate(0.4), pmut.make_swap_mutate(0.4)),
            (jbx.mutate_from_expression(me, rate=0.07, sigma=0.2),
             pbx.mutate_from_expression(me, rate=0.07, sigma=0.2)),
            (jbx.mutate_from_expression(me), pbx.mutate_from_expression(me)),
        ],
    }


def _kind(k):
    return getattr(k, "expression", k)


@pytest.mark.parametrize("i", range(6))
def test_crossover_routing_equals_jax(i):
    jop, pop = _operators()["crossover"][i]
    jp, pp = JaxPGA(seed=0), PGA(seed=0, config=PGAConfig(device="cpu"))
    if jop is not None:
        jp.set_crossover(jop)
        pp.set_crossover(pop)
    assert _kind(pp._crossover_kind()) == _kind(jp._crossover_kind())
    if jop is jcx.one_point_crossover:
        assert pp._crossover_kind() is pp._crossover_kind()  # cached per engine


@pytest.mark.parametrize("i", range(6))
def test_mutate_routing_equals_jax(i):
    jop, pop = _operators()["mutate"][i]
    jp, pp = JaxPGA(seed=0), PGA(seed=0, config=PGAConfig(device="cpu"))
    if jop is not None:
        jp.set_mutate(jop)
        pp.set_mutate(pop)
    assert _kind(pp._mutate_kind()) == _kind(jp._mutate_kind())
    np.testing.assert_array_equal(
        np.asarray(pp._mutate_params(), np.float32), np.asarray(jp._mutate_params())[0])


def test_opaque_operator_has_no_kernel_kind():
    pp = PGA(seed=0, config=PGAConfig(device="cpu"))
    pp.set_crossover(lambda p1, p2, rand: p1)
    assert pp._crossover_kind() is None


# (e) several generations per launch; what is not ported raises; small
# populations go panmictic ------------------------------------------------


def _multigen_run_equals_jax(monkeypatch, objective, mutate, rate, n=6, T=4, P=1024, L=16):
    """``PGA.run(n)`` at ``generations_per_launch=T`` on the CPU (the
    multigen plain version, zero draws) against JAX's interpret-mode
    ``_multigen_run_loop`` from the same population: geometry, launches,
    generation count, genomes within GENE_ATOL and scores within L*1e-5.
    ``objective`` / ``mutate``: (JAX, port) pairs, mutate None = point."""
    pp = PGA(seed=0, config=PGAConfig(device="cpu", generations_per_launch=T))
    h = pp.create_population(P, L)
    pp.set_objective(objective[1])
    pp.set_mutate(mutate[1])
    g = pp.population(h).genomes.numpy().copy()

    def zero_draws(seed, G, K, L, mutate="point", crossover="uniform", sub_generation=0, tie=False):
        return fs.zero_draws(G, K, L, mutate, crossover=crossover, steps=1).at(0)

    monkeypatch.setattr(fs, "philox_draws", zero_draws)
    assert pp.run(n) == n and pp.launches == -(-n // T)
    jobj = objective[0]
    with _interpret():
        bm = ps.make_pallas_multigen(
            P, L, crossover_kind="uniform", mutate_kind=mutate[0] or "point",
            fused_obj=jobj.kernel_rowwise,
            fused_consts=tuple(getattr(jobj, "kernel_rowwise_consts", ())),
            mutation_rate=rate, mutation_sigma=0.0)
        run = ps._multigen_run_loop(jobj, bm, P, L, T, donate=False)
        gj, sj, gens = run(jnp.asarray(g), jax.random.key(0), jnp.int32(n), jnp.float32(jnp.inf),
                           bm.default_params)
    geom = pp._run_fn(P, L)[0].geom
    assert (geom.layout, geom.K, geom.D, geom.Pp) == (bm.layout, bm.K, bm.D, bm.Pp)
    assert int(gens) == n
    pop = pp.population(h)
    np.testing.assert_allclose(pop.genomes.numpy(), np.asarray(gj), rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(pop.scores.numpy(), np.asarray(sj), rtol=0, atol=L * 1e-5)


def test_expression_with_several_generations_per_launch_raises(monkeypatch):
    """An expression mutation at ``generations_per_launch=4``, once
    refused, now breeds through the multi-generation path (B6 x B4) and
    equals JAX's."""
    expr = "where(r < rate, g * 0.5 + r2 + 0.25, g)"
    _multigen_run_equals_jax(
        monkeypatch, (jax_get("onemax"), "onemax"),
        (jbx.mutate_from_expression(expr, rate=0.3), pbx.mutate_from_expression(expr, rate=0.3)),
        rate=0.3)


def test_const_objective_with_several_generations_per_launch_raises(monkeypatch):
    """An objective with kernel constants at ``generations_per_launch=4``,
    once refused, now breeds through the multi-generation path
    (const-carrying geometry) and equals JAX's."""
    w = np.linspace(0.0, 2.0, 16).astype(np.float32)
    _multigen_run_equals_jax(
        monkeypatch,
        (jax_from_expression("dot(w, g)", w=w), from_expression("dot(w, g)", w=w)),
        (None, None), rate=0.01)


@pytest.mark.parametrize("what", ["mutate", "objective"])
def test_order_crossover_with_expression_raises(what):
    """Order crossover with an expression mutation or objective, which
    once raised NotImplementedError, now breeds on the deme path (the
    expression order kernel's plain version on the CPU), one launch per
    generation, as JAX breeds it in its Pallas kernel."""
    pp = PGA(seed=0, config=PGAConfig(device="cpu"))
    pp.create_population(512, 16)
    pp.set_objective("onemax")
    pp.set_crossover(pcx.order_preserving_crossover)
    if what == "mutate":
        pp.set_mutate(pbx.mutate_from_expression("where(r < rate, r2, g)"))
    else:
        pp.set_objective(from_expression("sum(g * g)"))
    assert pp.uses_deme_kernel(512, 16)
    assert pp.run(1) == 1 and pp.launches == 1


def test_small_population_takes_the_panmictic_path_in_both():
    jp, pp = JaxPGA(seed=0), PGA(seed=0, config=PGAConfig(device="cpu"))
    for solver, make in ((jp, jbx.crossover_from_expression), (pp, pbx.crossover_from_expression)):
        solver.create_population(100, 10)
        solver.set_objective("onemax")
        solver.set_crossover(make("r * p1 + (1 - r) * p2"))
    with _interpret():
        assert ps.make_pallas_breed(100, 10, crossover_kind=jp._crossover_kind()) is None
    assert not pp.uses_deme_kernel(100, 10)
    assert pp.run(5) == 5 and pp.launches == 0
    assert pp.uses_deme_kernel(256, 10)
