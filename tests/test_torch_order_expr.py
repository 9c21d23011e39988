"""Parity of the port's one-generation order breed with expression hooks
(libpga_tpu_torch/ops/fused_step.py: ``deme_breed_reference`` and
``make_fused_breed`` with ``crossover="order"`` and an expression
mutation or objective; csrc/expr_breed.cu's ``expr_order_kernel``
computes the same function) with the JAX package's
(libpga_tpu/ops/pallas_step.py: ``make_pallas_breed(crossover_kind=
"order")`` with a callable mutation, a ``fused_obj`` that carries
constants, or ``fused_tsp``).

Inputs and noise are numpy arrays made from a seed and handed to both
packages. Two anchors:

- the whole breed against JAX's kernel under
  ``force_tpu_interpret_mode``, whose PRNG bits are all zero: every
  parent is its deme's rank-0 row, every fallback gene 0, the swap
  exchanges gene 0 with itself, and the expression streams r, r2, q, q2
  are 0; the port takes ``zero_draws`` through its injected mode;
- ``breed_children`` with random numpy draws against JAX's own pieces on
  the same draws (rank-space selection, the XLA order walk with the same
  fill, the mutation expression's ``kernel_rows``, the objective's
  ``kernel_rowwise``), which pins the draws the interpret mode zeroes.

Tolerances: genes within 2e-5 against the interpret kernel (JAX gathers
parents with a bf16 hi/lo one-hot matmul) and exact against JAX's XLA
pieces; tour scores within rtol 1e-5 (float32 sums in another order),
the coordinate TSP within JAX's rtol 1e-4 / atol 0.5 (its hi/lo
coordinates, ~1e-3 each). Geometry and launch counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu_torch as port
from libpga_tpu.objectives import classic as jax_classic
from libpga_tpu.objectives import from_expression as jax_from_expression
from libpga_tpu.ops import breed_expr as jbx
from libpga_tpu.ops import crossover as jax_crossover
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch.interop import expression_objective_from_jax
from libpga_tpu_torch.objectives import classic, from_expression
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import crossover, expr_cuda, fused_step as fs, kernels, mutate
from libpga_tpu_torch.ops.select import winner_fraction, winner_ranks

T = torch.from_numpy
GENE_ATOL = 2e-5
TOUR_RTOL = 1e-5
# The Euclidean tour cost of libpga_tpu/objectives/expr.py's docstring.
TOUR = ("c = floor(g * L);"
        "x = gather(X, c); y = gather(Y, c);"
        "dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
        "-sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))")
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
RATE, SIGMA = 0.3, 0.1


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _tour(L, seed=1):
    """The port's tour-expression objective over random_tsp_coords(L)."""
    c = classic.random_tsp_coords(L, seed=seed)
    return from_expression(TOUR, X=c[:, 0], Y=c[:, 1])


def _tours(L, seed=1):
    """(port, JAX) tour-expression objectives over random_tsp_coords(L)."""
    c = classic.random_tsp_coords(L, seed=seed)
    np.testing.assert_array_equal(c, jax_classic.random_tsp_coords(L, seed=seed))
    return _tour(L, seed), jax_from_expression(TOUR, X=c[:, 0], Y=c[:, 1])


def _perms(rng, P, L):
    return ((np.stack([rng.permutation(L) for _ in range(P)]) + 0.5) / L).astype(np.float32)


def _genomes(rng, P, L):
    """Permutations and random genomes (duplicate cities near certain)."""
    return np.concatenate([_perms(rng, P // 2, L), rng.random((P - P // 2, L), dtype=np.float32)])


# the whole breed against the interpret-mode Pallas kernel -------------------

WHOLE = [
    # (objective, mutation): case 1 with a builtin and with an expression
    # mutation, case 2 (the coordinate TSP after an expression mutation)
    ("tour", "swap"),
    ("tour", "creep"),
    ("tsp", "creep"),
]


@pytest.mark.parametrize("objective,mutation", WHOLE)
def test_whole_order_breed_equals_interpret_mode_kernel(objective, mutation):
    P, L = 256, 24
    if mutation == "creep":
        pm = pbx.mutate_from_expression(CREEP, rate=RATE, sigma=SIGMA)
        jm = jbx.mutate_from_expression(CREEP, rate=RATE, sigma=SIGMA)
    else:
        pm = jm = "swap"
    if objective == "tour":
        pobj, jobj = _tours(L)
        jkw = dict(fused_obj=jobj.kernel_rowwise, fused_consts=jobj.kernel_rowwise_consts)
        pkw = dict(objective=pobj)
    else:
        coords = classic.random_tsp_coords(L, seed=2)
        ptsp = classic.make_tsp_coords(coords, duplicate_mode="genes")
        jkw = dict(fused_tsp=jax_classic.make_tsp_coords(coords, duplicate_mode="genes")
                   .kernel_gene_major)
        pkw = dict(obj_id=ptsp.fused_id, coords=ptsp.coords, penalty=ptsp.penalty)
    with _interpret():
        breed = ps.make_pallas_breed(P, L, deme_size=128, crossover_kind="order", mutate_kind=jm,
                                     mutation_rate=RATE, mutation_sigma=SIGMA, **jkw)
    geom = fs.resolve_geometry(P, L, deme_size=128, crossover="order",
                               const_carrying=objective == "tour")
    assert breed.fused and (breed.layout, breed.K, breed.D, breed.Pp) == (
        geom.layout, geom.K, geom.D, geom.Pp)
    rng = np.random.default_rng(L + len(objective + mutation))
    genomes = _genomes(rng, P, L)
    scores = rng.permutation(P).astype(np.float32)
    with _interpret():
        g_jax, s_jax = breed(jnp.asarray(genomes), jnp.asarray(scores), jax.random.key(0))
    g_jax, s_jax = np.asarray(g_jax), np.asarray(s_jax)
    ranks = fs.compute_ranks(T(scores), geom, 0, torch.zeros(P, dtype=torch.int64))
    g_port, s_port = fs.deme_breed_reference(
        T(genomes), ranks, geom, 0, fs.zero_draws(geom.G, geom.K, L, pm, crossover="order"),
        mutate=pm, crossover="order", mparams=torch.tensor([RATE, SIGMA]), **pkw)
    np.testing.assert_allclose(g_port.numpy(), g_jax, rtol=0, atol=GENE_ATOL)
    if objective == "tour":
        np.testing.assert_allclose(s_port.numpy(), s_jax, rtol=TOUR_RTOL, atol=0)
        # the plain score is the kernels' lane order of the children's tour
        np.testing.assert_array_equal(
            s_port.numpy(), pobj.kernel_rowwise(g_port, warp_order=True).numpy())
    else:
        np.testing.assert_allclose(s_port.numpy(), s_jax, rtol=1e-4, atol=0.5)
        np.testing.assert_allclose(s_port.numpy(), ptsp.rows(g_port).numpy(), rtol=1e-5)
    assert (g_port.numpy() == 0.0).any()  # zero fallback genes were taken
    if mutation == "creep":  # r = 0 < rate: every gene moved down by sigma, clipped
        assert not np.isin(g_port.numpy(), genomes).all()


# the breed core on random draws, against JAX's own pieces -------------------


@pytest.mark.parametrize("V", [128, 77])
def test_order_walk_then_expression_mutation_and_objective_equal_jax_pieces(V):
    """``breed_children(crossover="order")`` with an expression mutation
    on random numpy draws equals: the rank-space winners, JAX's XLA order
    walk on the gathered parents with the same fill, then JAX's
    ``kernel_rows`` of the mutation with the same r, r2 planes; the
    tour score of those children equals JAX's ``kernel_rowwise``."""
    K, L = 128, 30
    rng = np.random.default_rng(V)
    cohort = _genomes(rng, K, L)
    ranks = rng.permutation(K).astype(np.int32)
    sel_u = rng.random((K, 2), dtype=np.float32)
    fill = rng.random((K, L), dtype=np.float32)
    mut_u = rng.random((K, 4), dtype=np.float32)
    r, r2 = rng.random((2, K, L), dtype=np.float32)
    pm = pbx.mutate_from_expression(CREEP, rate=RATE, sigma=SIGMA)
    jm = jbx.mutate_from_expression(CREEP, rate=RATE, sigma=SIGMA)
    expr_gene = np.zeros((4, 1, K, L), np.float32)
    expr_gene[2, 0], expr_gene[3, 0] = r, r2
    draws = fs.Draws(sel_u=T(sel_u)[None], cross=None, mut_u=T(mut_u)[None], fill=T(fill)[None],
                     expr_gene=T(expr_gene), expr_row=torch.zeros((1, K, 4)))
    got = fs.breed_children(
        T(cohort)[None], T(ranks)[None], torch.tensor([float(V)]), draws, tournament_size=2,
        selection="tournament", selection_param=None, mutate=pm,
        mparams=torch.tensor([RATE, SIGMA]), crossover="order",
    )[0].numpy()

    wr = winner_ranks(winner_fraction("tournament", None, 2, T(sel_u)), torch.tensor(float(V)))
    row_of_rank = np.argsort(ranks)
    p1, p2 = (cohort[row_of_rank[wr.numpy()[:, j]]] for j in (0, 1))
    walked = jax_crossover._order_preserving_batched(jnp.asarray(p1), jnp.asarray(p2),
                                                     jnp.asarray(fill))
    zero = jnp.zeros((K, 1), jnp.float32)
    want = np.asarray(jm.kernel_rows(walked, jnp.asarray(r), jnp.asarray(r2), zero, zero,
                                     jnp.float32(RATE), jnp.float32(SIGMA), true_len=L))
    np.testing.assert_array_equal(got, want)
    pobj, jobj = _tours(L)
    np.testing.assert_allclose(
        fs.fused_scores(0, T(got), objective=pobj).numpy(),
        np.asarray(jobj.kernel_rowwise(jnp.asarray(got), *jobj.kernel_rowwise_consts)),
        rtol=TOUR_RTOL)


# the tour expression: interop and lowering -----------------------------------


def test_tour_expression_crosses_from_jax_and_lowers_with_two_rows():
    """The tour's constants cross as numpy (interop), and the generated
    objective hook gathers over all L = 200 entries (kroA200's city
    count) and materialises x and y (two rows of erows) for their
    rolls."""
    pobj, jobj = _tours(48)
    rebuilt = expression_objective_from_jax(jobj)
    assert rebuilt.const_names == pobj.const_names == ("X", "Y")
    for a, b in zip(rebuilt.const_arrays, pobj.const_arrays):
        np.testing.assert_array_equal(a, b)
    g = _genomes(np.random.default_rng(0), 16, 48)
    np.testing.assert_array_equal(rebuilt(T(g)).numpy(), pobj(T(g)).numpy())
    np.testing.assert_allclose(
        pobj(T(g)).numpy(), np.asarray(jobj.kernel_rowwise(jnp.asarray(g))), rtol=TOUR_RTOL)
    L = 200
    prog = expr_cuda.generate(objective=_tour(L))
    assert prog.obj_rows == 2 and prog.consts.shape == (2 * L,)
    assert f"expr_code(" in prog.source and f", {L}))" in prog.source
    assert "#define EXPR_CROSS 0" in prog.source and "#define EXPR_OBJ 1" in prog.source


# geometry ---------------------------------------------------------------------


@pytest.mark.parametrize("P,L,tour", [
    (65_536, 200, True), (65_536, 200, False), (8192, 1000, False), (256, 24, True),
    (1000, 100, True), (1000, 100, False),
])
def test_geometry_equals_kernel_plan(P, L, tour):
    """``make_fused_breed``'s geometry for order crossover with the tour
    expression (const-carrying; its gather tables cap L at 512, as
    JAX's) or with the coordinate TSP and an expression mutation equals
    JAX's ``kernel_plan``; the tour at 65,536x200 is K=256, D=1, riffle,
    256 demes."""
    if tour:
        objective, mut = _tour(L), "swap"
    else:
        objective = classic.make_tsp_coords(classic.random_tsp_coords(L, seed=2),
                                            duplicate_mode="genes")
        mut = pbx.mutate_from_expression(CREEP, rate=RATE, sigma=SIGMA)
    plan = ps.kernel_plan(P, L, crossover_kind="order", mutate_kind="swap", const_carrying=tour)
    geom = fs.make_fused_breed(P, L, objective, crossover="order", mutate=mut, device="cpu").geom
    assert (geom.layout, geom.K, geom.D, geom.Pp, geom.G) == (
        plan["layout"], plan["deme_size"], plan["demes_per_step"], plan["Pp"],
        plan["grid_steps"])
    if (P, L, tour) == (65_536, 200, True):
        assert (geom.layout, geom.K, geom.D, geom.G) == ("riffle", 256, 1, 256)


# PGA.run on the CPU ------------------------------------------------------------


def _solver(P, L, objective, mutation, T_=None, seed=0):
    p = port.pga_init(seed, port.PGAConfig(device="cpu", generations_per_launch=T_))
    h = port.pga_create_population(p, P, L)
    port.pga_set_objective_function(p, objective)
    port.pga_set_crossover_function(p, crossover.order_preserving_crossover)
    port.pga_set_mutate_function(p, mutation)
    return p, h


def test_run_with_the_tour_expression_goes_through_the_plain_order_breed():
    """Case 1 at one generation per launch: no raise, the plain
    version runs (no kernel launch is counted on the CPU), one launch
    per generation, scores are the children's tour, the best rises."""
    L = 40
    pobj = _tour(L)
    p, h = _solver(256, L, pobj, mutate.make_swap_mutate(0.5))
    assert p.uses_deme_kernel(256, L)
    start = float(pobj(p.population(h).genomes).max())
    before = dict(kernels.LAUNCHES)
    assert port.pga_run(p, 8) == 8
    assert p.launches == 8 and kernels.LAUNCHES == before
    pop = p.population(h)
    torch.testing.assert_close(pop.scores, pobj(pop.genomes), rtol=TOUR_RTOL, atol=0)
    assert p.get_best_with_score(h)[1] > start


def test_run_coordinate_tsp_with_an_expression_mutation():
    """Case 2 at one generation per launch: the gene-major TSP score
    after the creep expression, one launch per generation."""
    L = 40
    tsp = classic.make_tsp_coords(classic.random_tsp_coords(L, seed=2), duplicate_mode="genes")
    p, h = _solver(256, L, tsp, pbx.mutate_from_expression(CREEP, rate=0.05, sigma=0.1))
    assert port.pga_run(p, 8) == 8 and p.launches == 8
    pop = p.population(h)
    torch.testing.assert_close(pop.scores, tsp.rows(pop.genomes), rtol=1e-5, atol=1e-3)
