"""Parity of the port's multi-generation breed with order crossover
(libpga_tpu_torch/ops/fused_step.py: ``multigen_breed_reference``,
``make_fused_multigen`` and ``make_multigen_run`` with
``crossover="order"``; csrc/deme_breed.cu's ``multigen_breed_kernel<true>``
and csrc/expr_breed.cu's ``expr_multigen_kernel<true>`` compute the same
function) with the JAX package's (libpga_tpu/ops/pallas_step.py:
``make_pallas_multigen(crossover_kind="order")``, whose
``_multigen_kernel`` hands ``order_refs`` to ``_deme_child``).

Inputs are numpy arrays made from a seed and handed to both packages.
JAX's kernel runs under ``force_tpu_interpret_mode``, whose PRNG bits are
all zero; the port takes ``zero_draws(steps=...)`` through its injected
mode: every parent is its deme's rank-0 row (elites: ranks 0..e-1,
verbatim), every fallback gene 0, the swap exchanges gene 0 with itself,
point mutation does not fire (u = 0 is not < 0) and score ties break by
the row's index. So the comparison pins the walk inside the resident
group, the elites set after the walk, the freeze, the scores and the step
count.

Tolerances: genes within 2e-5 (JAX gathers parents with a bf16 hi/lo
one-hot matmul), tour scores within rtol 1e-5 and onemax within L * 1e-5
(float32 sums in another order); the port's scores equal its own
objective in the kernels' lane order exactly. Geometry and launch counts
are exact.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu_torch as port
from libpga_tpu.objectives import classic as jax_classic
from libpga_tpu.objectives import from_expression as jax_from_expression
from libpga_tpu.objectives import get as jax_get
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch.objectives import classic, from_expression, onemax
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import crossover, fused_step as fs, kernels, mutate

T = torch.from_numpy
GENE_ATOL = 2e-5
TOUR_RTOL = 1e-5
TOUR = ("c = floor(g * L);"
        "x = gather(X, c); y = gather(Y, c);"
        "dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
        "-sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))")
P0, L0 = 512, 24


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


def _genomes(rng, P, L):
    perms = (np.stack([rng.permutation(L) for _ in range(P // 2)]) + 0.5) / L
    return np.concatenate([perms.astype(np.float32),
                           rng.random((P - P // 2, L), dtype=np.float32)])


# one launch against the interpret-mode Pallas kernel -------------------------

CASES = {
    # case: (objective, mutation, elitism): 3 = the tour expression (the
    # expression multigen kernel), 4 = a builtin rowwise id (the builtin one)
    "tour": ("tour", "swap", 2),
    "onemax": ("onemax", "point", 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_launch_equals_jax_at_0_1_3_steps_with_a_frozen_group(case):
    """One JAX build per case runs 0, 1 and 3 steps with group 2 of 4
    frozen at entry (a planted score above the target): the frozen group
    comes back unchanged up to the riffle, the others breed."""
    objective, mut, elitism = CASES[case]
    P, L = P0, L0
    if objective == "tour":
        pobj, jobj = _tours(L)
        jfused, jconsts = jobj.kernel_rowwise, tuple(jobj.kernel_rowwise_consts)
        pkw = dict(objective=pobj, obj_id=0)

        def score(g):
            return pobj.kernel_rowwise(T(g), warp_order=True).numpy()
    else:
        jfused, jconsts = jax_get("onemax").kernel_rowwise, ()
        pkw = dict(obj_id=onemax.fused_id)

        def score(g):
            return fs.rowwise_scores(onemax.fused_id, T(g), warp_order=True).numpy()
    with _interpret():
        bm = ps.make_pallas_multigen(P, L, deme_size=128, crossover_kind="order", mutate_kind=mut,
                                     fused_obj=jfused, fused_consts=jconsts, elitism=elitism,
                                     mutation_rate=0.5)
    geom = fs.resolve_geometry(P, L, deme_size=128, multigen=True, crossover="order",
                               elitism=elitism, const_carrying=bool(jconsts))
    assert (bm.layout, bm.K, bm.D, bm.Pp, bm.grid_steps) == (
        geom.layout, geom.K, geom.D, geom.Pp, geom.S) == ("riffle", 128, 1, P, 4)
    rng = np.random.default_rng(len(case))
    g = _genomes(rng, P, L)
    s = score(g)
    target = float(s.max()) + 1.0
    read, write = (m.numpy() for m in geom.row_maps(0, "cpu"))
    s[read[2, 5]] = target + 10.0  # group 2 (D = 1: deme 2) is frozen
    for steps in (0, 1, 3):
        with _interpret():
            gj, sj = bm.padded(jnp.asarray(np.pad(g, ((0, 0), (0, bm.Lp - L)))),
                               jnp.asarray(s), jax.random.key(0), steps, None, target, 0)
        gj, sj = np.asarray(gj)[:, :L], np.asarray(sj)
        gp, sp = fs.multigen_breed(
            T(g), T(s), geom, 0, steps, target,
            draws=fs.zero_draws(geom.G, geom.K, L, mut, crossover="order", steps=max(steps, 1)),
            mutate=mut, crossover="order", mparams=torch.tensor([0.5, 0.0]), elitism=elitism,
            **pkw)
        gp, sp = gp.numpy(), sp.numpy()
        np.testing.assert_allclose(gp, gj, rtol=0, atol=GENE_ATOL)
        np.testing.assert_array_equal(gp[write[2]], g[read[2]])
        np.testing.assert_array_equal(sp[write[2]], s[read[2]])
        bred = np.delete(np.arange(geom.G), 2)
        if objective == "tour":
            np.testing.assert_allclose(sp, sj, rtol=TOUR_RTOL, atol=0)
        else:
            np.testing.assert_allclose(sp, sj, rtol=0, atol=L * 1e-5)
        if steps:
            np.testing.assert_array_equal(sp[write[bred]], score(gp[write[bred].reshape(-1)])
                                          .reshape(len(bred), -1))
            # the elites are their rank-k parents, verbatim, after the walk
            for d in bred:
                best = np.argsort(-s[read[d]], kind="stable")[:elitism]
                if steps == 1:
                    np.testing.assert_array_equal(gp[write[d, :elitism]], g[read[d, best]])
            assert (gp[write[bred]] == 0.0).any()  # zero fallback genes were taken
        else:
            np.testing.assert_array_equal(gp[write.reshape(-1)], g[read.reshape(-1)])


def test_one_step_equals_the_one_generation_plain_breed():
    """steps = 1 with random draws (fill included) breeds the children
    ``deme_breed_reference`` breeds from the same in-kernel ranks."""
    P, L = 512, 24
    creep = pbx.mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)",
                                       rate=0.3, sigma=0.1)
    pobj = _tour(L)
    geom = fs.resolve_geometry(P, L, deme_size=128, multigen=True, crossover="order",
                               const_carrying=True)
    gen = torch.Generator().manual_seed(7)
    g, s = torch.rand((P, L), generator=gen), torch.rand(P, generator=gen)
    z = fs.zero_draws(geom.G, geom.K, L, creep, crossover="order", steps=1)
    draws = fs.Draws(**{f: None if v is None else (
        torch.randint(0, 2**32, v.shape, generator=gen) if f == "tie"
        else torch.rand(v.shape, generator=gen)) for f, v in vars(z).items()})
    kw = dict(mutate=creep, crossover="order", mparams=torch.tensor([0.3, 0.1]),
              objective=pobj, obj_id=0, tournament_size=3)
    got = fs.multigen_breed(g, s, geom, 0, 1, draws=draws, **kw)
    read, _ = geom.row_maps(0, "cpu")
    ranks = fs.kernel_ranks(s[read], draws.tie[0], read < P)
    want = fs.deme_breed_reference(g, ranks, geom, 0, draws.at(0), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_philox_fill_plane_carries_the_sub_generation():
    """The order walk's fallback plane counts the sub-generation in
    Philox's fourth word, like every multigen stream."""
    seed = torch.tensor([99], dtype=torch.int64)
    a = fs.philox_draws(seed, 2, 128, 30, "swap", "order", sub_generation=0, tie=True)
    b = fs.philox_draws(seed, 2, 128, 30, "swap", "order", sub_generation=1, tie=True)
    assert a.cross is None and a.fill.shape == (2, 128, 30)
    assert not torch.equal(a.fill, b.fill)
    assert torch.equal(a.fill, fs.philox_draws(seed, 2, 128, 30, "swap", "order").fill)


# geometry ----------------------------------------------------------------------


@pytest.mark.parametrize("P,L,objective", [
    (65_536, 200, "tour"), (8192, 1000, "onemax"), (40_000, 100, "onemax"), (512, 24, "tour"),
    (1000, 100, "onemax"),
])
def test_geometry_equals_make_pallas_multigen(P, L, objective):
    """``make_fused_multigen`` with order crossover picks JAX's K, D = 1
    and the riffle; the tour at 65,536x200 is K=256, 256 groups."""
    if objective == "tour":
        pobj, jobj = _tours(L)
        jkw = dict(fused_obj=jobj.kernel_rowwise, fused_consts=tuple(jobj.kernel_rowwise_consts))
    else:
        pobj, jkw = onemax, dict(fused_obj=jax_get("onemax").kernel_rowwise)
    with _interpret():
        bm = ps.make_pallas_multigen(P, L, crossover_kind="order", mutate_kind="swap", **jkw)
    launch = fs.make_fused_multigen(P, L, pobj, crossover="order", mutate="swap", device="cpu")
    geom = launch.geom
    assert (bm.layout, bm.K, bm.D, bm.grid_steps, bm.Pp) == (
        geom.layout, geom.K, geom.D, geom.S, geom.Pp)
    assert (geom.layout, geom.D) == ("riffle", 1)
    if objective == "tour" and P == 65_536:
        assert (geom.K, geom.S) == (256, 256)


# the engine ----------------------------------------------------------------------


def _solver(P, L, objective, T_, seed=0, **config):
    p = port.pga_init(seed, port.PGAConfig(device="cpu", generations_per_launch=T_, **config))
    h = port.pga_create_population(p, P, L)
    port.pga_set_objective_function(p, objective)
    port.pga_set_crossover_function(p, crossover.order_preserving_crossover)
    port.pga_set_mutate_function(p, mutate.make_swap_mutate(0.5))
    return p, h


@pytest.mark.parametrize("objective", ["tour", "onemax"])
def test_run_at_four_generations_per_launch(objective):
    """Cases 3 and 4 through PGA.run on the CPU: the plain multigen
    version runs (no kernel launch is counted), ceil(gens / T) launches,
    the scores are the genomes' objective, the best does not fall."""
    L = 24
    obj = _tour(L) if objective == "tour" else onemax
    p, h = _solver(512, L, obj, 4, elitism=1)
    start = float(obj(p.population(h).genomes).max())
    before = dict(kernels.LAUNCHES)
    assert port.pga_run(p, 10) == 10
    assert p.launches == math.ceil(10 / 4) and kernels.LAUNCHES == before
    geom = p._run_fn(512, L)[0].geom
    assert (geom.layout, geom.D) == ("riffle", 1)
    pop = p.population(h)
    torch.testing.assert_close(pop.scores, obj(pop.genomes), rtol=TOUR_RTOL, atol=L * 1e-5)
    assert p.get_best_with_score(h)[1] >= start


def test_coordinate_tsp_declines_several_generations_per_launch():
    """The coordinate TSP's fused score is gene-major, so JAX's
    ``make_pallas_multigen`` declines it: the run warns and breeds one
    generation per launch."""
    L = 24
    coords = classic.random_tsp_coords(L, seed=2)
    tsp = classic.make_tsp_coords(coords, duplicate_mode="genes")
    jtsp = jax_classic.make_tsp_coords(coords, duplicate_mode="genes")
    assert getattr(jtsp, "kernel_rowwise", None) is None  # JAX passes no fused_obj
    with _interpret():
        assert ps.make_pallas_multigen(256, L, crossover_kind="order", mutate_kind="swap",
                                       fused_obj=None) is None
    assert fs.make_fused_multigen(256, L, tsp, crossover="order", mutate="swap",
                                  device="cpu") is None
    p, _ = _solver(256, L, tsp, 4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert port.pga_run(p, 5) == 5
    assert any("one generation per launch" in str(w.message) for w in caught)
    assert p.launches == 5
