"""The floor harness's hook cases (B7) against the JAX package's on the CPU:
``make_fused_breed`` / ``make_fused_multigen(ablate=...)`` with an
expression crossover, mutation or objective and with order crossover
(``ops/fused_step.py``, their plain versions; ``csrc/expr_breed.cu``'s
``expr_breed_kernel``, ``expr_order_kernel`` and ``expr_multigen_kernel``
and ``csrc/deme_breed.cu``'s ``order_breed_kernel`` and
``multigen_breed_kernel<true>`` compute the same functions) against
``make_pallas_breed`` / ``make_pallas_multigen(_ablate=...)`` in interpret
mode, at ``tests/test_torch_ablate.py``'s toy shape (512x16, K=128); the
elite rule under sel_const and no_matmul (C7); the copy with hooks; the
masks and units the wrappers pick.

Interpret mode's PRNG bits are all zero, so the port takes all-zero
injected draws: every parent is its deme's rank-0 row (sel_const and
no_matmul: slot k's row), the expression streams are 0, the order walk's
fallback genes are 0 and point mutation sets gene 0 to 0.0. Tolerances:
genes within 1e-5 (order crossover 2e-5: JAX gathers parents with a bf16
hi/lo one-hot matmul), fused scores within L * 1e-5, the coordinate TSP
within JAX's rtol 1e-4 / atol 0.5 (its hi/lo coordinates); copies bit
for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.objectives import classic as jax_classic
from libpga_tpu.objectives import onemax as jax_onemax
from libpga_tpu.ops import breed_expr as jbx
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch.objectives import classic, onemax
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import expr_cuda
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels

POP, L, K, D = 512, 16, 128, 2
GENE_ATOL = 1e-5
ORDER_ATOL = 2e-5
TSP_RTOL, TSP_ATOL = 1e-4, 0.5
RATE, SIGMA = 0.3, 0.1
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
ONE_POINT = "where(i < floor(q * L), p1, p2)"
HALF = "0.5 * p1 + 0.25"  # not the identity on equal parents: shows an elite crossed
STAGES = ("sel_const", "no_matmul", "no_cross", "no_mut")
FLOOR = STAGES
COPY = ("copy_only", "no_rank_sort")
T_ = torch.from_numpy


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _hooks(name):
    """``(JAX factory kwargs, port factory kwargs, port objective,
    order)`` of a hook set: ``creep`` (expression mutation, onemax),
    ``one_point`` (expression crossover, onemax), ``trap`` (the trap(5)
    objective, fused through its expression form), ``order_swap`` (order
    crossover, swap, the coordinate TSP fused gene-major), ``order_creep``
    (order crossover with the creep hook and the TSP), ``half`` (the
    crossover expression 0.5 * p1 + 0.25, onemax), ``order_onemax``
    (order crossover, swap, onemax: the builtin multigen order case)."""
    j = dict(mutation_rate=RATE, mutation_sigma=SIGMA)
    p = dict(mparams=(RATE, SIGMA))
    obj, jobj = onemax, dict(fused_obj=jax_onemax.kernel_rowwise)
    order = name.startswith("order")
    if name in ("creep", "order_creep"):
        j["mutate_kind"] = jbx.mutate_from_expression(CREEP, rate=RATE, sigma=SIGMA)
        p["mutate"] = pbx.mutate_from_expression(CREEP, rate=RATE, sigma=SIGMA)
    if name in ("one_point", "half"):
        expr = ONE_POINT if name == "one_point" else HALF
        j["crossover_kind"] = jbx.crossover_from_expression(expr)
        p["crossover"] = pbx.crossover_from_expression(expr)
    if name == "trap":
        obj = classic.make_deceptive_trap(5)
        jobj = dict(fused_obj=jax_classic.make_deceptive_trap(5).kernel_rowwise)
    if order:
        j["crossover_kind"] = p["crossover"] = "order"
        if name != "order_creep":
            j["mutate_kind"] = p["mutate"] = "swap"
    if name in ("order_swap", "order_creep"):
        coords = classic.random_tsp_coords(L, seed=2)
        obj = classic.make_tsp_coords(coords, duplicate_mode="genes")
        jobj = dict(fused_tsp=jax_classic.make_tsp_coords(coords, duplicate_mode="genes")
                    .kernel_gene_major)
    j.update(jobj)
    return j, p, obj, order


def _genomes(rng, P, order):
    """Uniform genomes; for order crossover half permutations (no
    duplicate city) and half uniform (duplicates near certain)."""
    g = rng.random((P, L), dtype=np.float32)
    if order:
        perms = np.stack([rng.permutation(L) for _ in range(P // 2)])
        g[: P // 2] = ((perms + 0.5) / L).astype(np.float32)
    return g


def _breed_both(hooks, ablate, layout="riffle", seed=1):
    """One generation of the hook set under ``ablate`` in both packages on
    the same population (strictly decreasing scores, so no tie words);
    the port through ``make_fused_breed``'s keywords and its plain
    version on zero draws. Returns (geometry, genomes, JAX (genomes,
    scores), port (genomes, scores))."""
    j, p, obj, order = _hooks(hooks)
    with _interpret():
        jb = ps.make_pallas_breed(POP, L, deme_size=K, _ablate=tuple(ablate), _layout=layout, **j)
    breed = fs.make_fused_breed(POP, L, obj, deme_size=K, layout=layout, ablate=ablate,
                                device="cpu", **p)
    geom = breed.geom
    assert (jb.layout, jb.K, jb.Pp) == (geom.layout, geom.K, geom.Pp)
    g = _genomes(np.random.default_rng(seed), geom.Pp, order)
    s = -np.arange(geom.Pp, dtype=np.float32)
    copy = "copy_only" in ablate
    with _interpret():
        gj, sj = jb.padded(jnp.asarray(np.pad(g, ((0, 0), (0, jb.Lp - L)))), jnp.asarray(s),
                           jax.random.key(0))
    if copy:
        ranks = T_(s).view(geom.G, geom.K)
        draws = None
    else:
        ranks = fs.compute_ranks(T_(s), geom, 0, torch.zeros(geom.Pp, dtype=torch.int64))
        draws = fs.zero_draws(geom.G, geom.K, L, p.get("mutate", "point"),
                              crossover=p.get("crossover", "uniform"))
    got = fs.deme_breed_reference(T_(g), ranks, geom, 0, draws, **breed.kw)
    return geom, g, (np.asarray(gj)[:, :L], np.asarray(sj)), (got[0].numpy(), got[1].numpy())


def _assert_breed(hooks, want, got):
    order = hooks.startswith("order")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ORDER_ATOL if order else GENE_ATOL)
    if hooks in ("order_swap", "order_creep"):
        np.testing.assert_allclose(got[1], want[1], rtol=TSP_RTOL, atol=TSP_ATOL)
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=L * GENE_ATOL)


# ------------------------------------------------- one generation, each flag


@pytest.mark.parametrize("ablate", [(f,) for f in STAGES] + [FLOOR], ids="+".join)
@pytest.mark.parametrize("hooks", ["creep", "one_point", "trap"])
def test_expression_stage_case_equals_jax_interpret(hooks, ablate):
    """expr_breed_kernel's stage cases: each flag alone and the floor,
    with an expression mutation, crossover or objective. The objective
    always runs; a removed hook leaves its stage's genes untouched."""
    geom, g, want, got = _breed_both(hooks, ablate)
    _assert_breed(hooks, want, got)
    G = geom.G
    child = got[0][3 * G + 1]  # child 3 of deme 1 (the riffle's row)
    if set(ablate) & {"sel_const", "no_matmul"}:
        parent = g[1 * K + 3]  # slot 3's row
    else:
        parent = g[1 * K + 0]  # the deme's rank-0 row: slot 0 (scores decrease)
    if hooks == "creep":
        moved = np.clip(parent - SIGMA, 0.0, None)  # r = 0 < rate: g - sigma
        np.testing.assert_allclose(child, parent if "no_mut" in ablate else moved,
                                   rtol=0, atol=GENE_ATOL)
    elif hooks == "trap":
        np.testing.assert_allclose(child[1:], parent[1:], rtol=0, atol=GENE_ATOL)
        assert (child[0] == 0.0) == ("no_mut" not in ablate)  # point mutation at gene 0


@pytest.mark.parametrize("ablate", [(f,) for f in STAGES] + [FLOOR], ids="+".join)
def test_order_stage_case_equals_jax_interpret(ablate):
    """order_breed_kernel's stage cases (order crossover, swap, the fused
    TSP score): no_cross runs no walk, so no fallback gene is taken."""
    geom, g, want, got = _breed_both("order_swap", ablate)
    _assert_breed("order_swap", want, got)
    walked = "no_cross" not in ablate
    assert (got[0] == 0.0).any() == walked  # zero fallback genes only from the walk


def test_order_with_the_creep_hook_under_no_cross_equals_jax_interpret():
    """expr_order_kernel under no_cross: the child is parent 1, then the
    creep hook, then the TSP score."""
    geom, g, want, got = _breed_both("order_creep", ("no_cross",))
    _assert_breed("order_creep", want, got)
    np.testing.assert_allclose(got[0][2 * geom.G + 3], np.clip(g[3 * K] - SIGMA, 0.0, None),
                               rtol=0, atol=GENE_ATOL)


@pytest.mark.parametrize("hooks", ["creep", "order_swap"])
def test_copy_with_hooks_equals_jax_bit_for_bit(hooks):
    """copy_only launches the builtin copy whatever the hooks (JAX's copy
    branch returns before a hook runs), at the hooks' geometry (order
    crossover: the order geometry, riffle, D = 1); each copied row is
    handed its score."""
    geom, g, want, got = _breed_both(hooks, COPY)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    G = geom.G
    np.testing.assert_array_equal(got[0][5 * G + 2], g[2 * K + 5])


def test_two_flag_combination_equals_jax_interpret():
    """Any combination breeds in the plain version (the kernels build a
    unit of its own for it): sel_const with no_cross keeps the creep
    hook on slot k's row."""
    geom, g, want, got = _breed_both("creep", ("sel_const", "no_cross"))
    _assert_breed("creep", want, got)
    np.testing.assert_allclose(got[0][5 * geom.G + 2], np.clip(g[2 * K + 5] - SIGMA, 0.0, None),
                               rtol=0, atol=GENE_ATOL)


def test_stage_case_on_pingpong_equals_jax_interpret():
    """The stage flags do not pin the layout with a hook either."""
    geom, _, want, got = _breed_both("creep", ("no_cross",), layout=None)
    assert geom.layout == "pingpong"
    _assert_breed("creep", want, got)


# ----------------------------------------------------------- several steps


def _multigen_both(hooks, ablate, steps=2, target=None, elitism=0):
    """``steps`` generations in one launch in both packages on the same
    population, zero draws; the port through ``make_fused_multigen``'s
    keywords at JAX's pinned geometry (riffle, D demes a group, D = 1
    for order crossover)."""
    j, p, obj, order = _hooks(hooks)
    dps = 1 if order else D
    with _interpret():
        bm = ps.make_pallas_multigen(POP, L, deme_size=K, elitism=elitism, _demes_per_step=dps,
                                     _ablate=tuple(ablate), _layout="riffle", **j)
    launch = fs.make_fused_multigen(POP, L, obj, deme_size=K, elitism=elitism, layout="riffle",
                                    ablate=ablate, device="cpu", **p)
    geom = fs.resolve_geometry(POP, L, deme_size=K, multigen=True, demes_per_step=dps,
                               layout="riffle", elitism=elitism,
                               crossover=p.get("crossover", "uniform"))
    assert (bm.layout, bm.K, bm.D, bm.Pp) == (geom.layout, geom.K, geom.D, geom.Pp)
    g = _genomes(np.random.default_rng(3), geom.Pp, order)
    s = g.sum(axis=1)
    with _interpret():
        gj, sj = bm.padded(jnp.asarray(np.pad(g, ((0, 0), (0, bm.Lp - L)))), jnp.asarray(s),
                           jax.random.key(0), steps, None, target, 0)
    got = fs.multigen_breed(
        T_(g), T_(s), geom, 0, steps, target,
        draws=fs.zero_draws(geom.G, geom.K, L, p.get("mutate", "point"),
                            crossover=p.get("crossover", "uniform"), steps=steps),
        **launch.kw)
    return geom, g, (np.asarray(gj)[:, :L], np.asarray(sj)), (got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("ablate,target", [
    (("no_freeze",), 0.0), (("no_rank_cube",), None), (("no_mut",), None),
], ids=["no_freeze", "no_rank_cube", "no_mut"])
def test_multigen_creep_case_equals_jax_interpret(ablate, target):
    """expr_multigen_kernel<false>'s cases at T = 2 (no_freeze under a
    target every group has reached, so its groups breed where production
    would freeze them)."""
    geom, g, want, got = _multigen_both("creep", ablate, target=target)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=L * GENE_ATOL)
    assert np.isin(got[0], g).all() == ("no_mut" in ablate)  # creep moves every gene


@pytest.mark.parametrize("ablate,target", [(("no_cross",), None), (("no_freeze",), 0.0)],
                         ids=["no_cross", "no_freeze"])
def test_multigen_order_case_equals_jax_interpret(ablate, target):
    """multigen_breed_kernel<true>'s cases at T = 2 with elites: under
    no_cross no walk runs, so no fallback gene is taken."""
    geom, g, want, got = _multigen_both("order_onemax", ablate, target=target, elitism=2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ORDER_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=L * ORDER_ATOL)
    assert (got[0] == 0.0).any() == ("no_cross" not in ablate)


# ----------------------------------------------------- C7: the elite rule


@pytest.mark.parametrize("ablate", [("sel_const",), ("no_matmul",), ("no_mut",)],
                         ids=lambda a: a[0])
def test_elites_cross_under_sel_const_and_no_matmul_as_in_jax(ablate):
    """JAX resets an elite child to parent 1 only where neither sel_const
    nor no_matmul is set: under them the elite of each deme is crossed
    like any other child (0.5 * p + 0.25 of its own row here), still
    unmutated."""
    geom, g, want, got = _multigen_both("half", ablate, elitism=2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=L * GENE_ATOL)


def test_order_elites_walk_under_sel_const_as_in_jax():
    """The order twin: under sel_const an elite is walked from its own
    row twice (duplicate cities take fallback genes) and not reset."""
    geom, g, want, got = _multigen_both("order_onemax", ("sel_const",), elitism=2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ORDER_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=L * ORDER_ATOL)


def test_plain_elites_stay_verbatim_without_those_flags():
    """Without sel_const or no_matmul an elite is its rank-k parent
    verbatim in the plain breed, whatever the crossover."""
    _, p, _, _ = _hooks("half")
    cohorts = torch.rand((2, K, L), generator=torch.Generator().manual_seed(0))
    ranks = torch.arange(K, dtype=torch.int32).repeat(2, 1)
    kw = dict(tournament_size=2, selection="tournament", selection_param=None, mutate="point",
              mparams=torch.tensor([1.0, 0.0]), elite_rows=2, crossover=p["crossover"])
    draws = fs.zero_draws(2, K, L, crossover=p["crossover"])
    child = fs.breed_children(cohorts, ranks, torch.tensor([K, K], dtype=torch.float32), draws,
                              **kw)
    assert torch.equal(child[:, :2], cohorts[:, :2])
    crossed = fs.breed_children(cohorts, ranks, torch.tensor([K, K], dtype=torch.float32), draws,
                                ablate=("sel_const",), **kw)
    torch.testing.assert_close(crossed[:, :2], 0.5 * cohorts[:, :2] + 0.25, rtol=0, atol=1e-6)


# ------------------------------------------------------- masks and units


def test_expression_masks_pick_the_harness_unit_or_one_of_its_own():
    """mask 0 is the production unit; the harness's cases (each stage
    flag alone, the floor, and at several generations no_freeze and
    no_rank_cube) share one harness unit; any other combination gets a
    unit of its own, keyed by its mask."""
    bits = kernels.ABLATE_BITS
    assert kernels.expr_ablate_mask(()) == 0
    assert kernels.expr_ablate_mask(FLOOR) == kernels.ABLATE_FLOOR
    for flags in [(f,) for f in STAGES] + [FLOOR, ("no_freeze",), ("no_rank_cube",)]:
        mask = kernels.expr_ablate_mask(flags, multigen=True)
        assert mask in kernels.EXPR_HARNESS_MASKS
    two = kernels.expr_ablate_mask(("no_cross", "no_mut"))
    assert two == bits["no_cross"] | bits["no_mut"] and two not in kernels.EXPR_HARNESS_MASKS
    with pytest.raises(ValueError, match="copy"):
        kernels.expr_ablate_mask(COPY)
    with pytest.raises(ValueError, match="multi-generation"):
        kernels.expr_ablate_mask(("no_freeze",))


def test_production_expression_unit_text_is_unchanged_by_the_harness():
    """The production unit is the hooks then the template, with no
    harness macro, so the harness changes neither its text nor its hash;
    the harness unit and a combination's unit add one macro line each."""
    program = expr_cuda.program_for(
        mutate=pbx.mutate_from_expression(CREEP, rate=RATE, sigma=SIGMA))
    template = (kernels.CSRC / "expr_breed.cu").read_text()
    prod = kernels.expr_unit(program)
    assert prod == program.source + "\n" + template
    assert kernels.expr_unit(program, 0) == prod
    assert "EXPR_HARNESS" not in program.source and "EXPR_ABLATE_EXTRA" not in program.source
    harness = kernels.expr_unit(program, kernels.ABLATE_BITS["no_mut"])
    assert harness == program.source + "\n#define EXPR_HARNESS 1\n" + template
    assert kernels.expr_unit(program, kernels.ABLATE_FLOOR) == harness
    mask = kernels.ABLATE_BITS["no_cross"] | kernels.ABLATE_BITS["no_mut"]
    assert kernels.expr_unit(program, mask) == (
        program.source + f"\n#define EXPR_ABLATE_EXTRA {mask}u\n" + template)
    digests = {kernels._digest(kernels.expr_unit(program, m).encode()) for m in (0, 16, mask)}
    assert len(digests) == 3


def test_factory_breeds_a_hooked_stage_case_on_the_cpu():
    """Order crossover with the creep hook and the fused TSP under no_mut
    through the factory: the flags reach the launch, the scores are the
    children's tours, and nothing is counted as a launch on the CPU."""
    _, p, obj, _ = _hooks("order_creep")
    before = dict(kernels.LAUNCHES)
    breed = fs.make_fused_breed(POP, L, obj, deme_size=K, ablate=("no_mut",), device="cpu", **p)
    assert breed.kw["ablate"] == ("no_mut",) and breed.kw["obj_id"] == obj.fused_id
    g = torch.rand((breed.geom.Pp, L), generator=torch.Generator().manual_seed(1))
    s = obj.rows(g)
    g2, s2 = breed(g, s, 0, torch.Generator().manual_seed(2))
    torch.testing.assert_close(s2, obj.rows(g2), rtol=1e-5, atol=1e-3)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("hooks,steps", [("creep", 1), ("trap", 1), ("tour", 1), ("tsp", 1),
                                         ("creep", 2), ("tour", 2), ("order", 2)])
def test_stage_harness_hook_variants_run_at_the_toy_shape(hooks, steps):
    """The stage harness's hook variants (``ablate_kernel --hooks``) on the
    plain versions: each builds on ``PGA.run``'s geometry and runs its
    launches (the copy at the hooks' geometry, pinned to the riffle)."""
    from libpga_tpu_torch.tools import ablate_kernel as ak

    runners = ak.build_runners(hooks, torch.float32, K, POP, L, steps=steps, device="cpu")
    assert list(runners) == [label for label, _, _ in ak.variants(hooks, steps)]
    assert ("copy" in runners) == (steps == 1) and "no_eval" not in runners
    assert ("no_freeze" in runners) == (steps > 1)
    for (label, ablate, scored), run in zip(ak.variants(hooks, steps), runners.values()):
        run(2)
        assert scored and run.gens_per_call == steps and run.geom.K == K
        assert (run.geom.layout == "riffle") >= ("copy_only" in ablate)
