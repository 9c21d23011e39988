"""Parity of the port's multi-generation breed with expression hooks
(libpga_tpu_torch/ops/fused_step.py: ``multigen_breed_reference`` with an
expression crossover, mutation or objective, ``make_fused_multigen``,
``make_multigen_run``; csrc/expr_breed.cu's ``expr_multigen_kernel``
computes the same function) with the JAX package's
(libpga_tpu/ops/pallas_step.py: ``make_pallas_multigen`` with callable
crossover / mutate kinds and ``fused_consts``, ``_multigen_run_loop``).

Inputs are numpy arrays made from a seed and handed to both packages.
JAX's kernel runs under ``force_tpu_interpret_mode``, whose PRNG bits are
all zero; the port takes all-zero draws through its injected mode
(``zero_draws(steps=...)``): every parent is its deme's rank-0 row
(elites: ranks 0..e-1), the expression streams r, r2, q, q2 are 0, and
score ties break by the row's index. So the comparison pins ranks, row
maps, padding, the freeze, the elites, the hooks and the step count.

Tolerances, as in tests/test_torch_multigen.py: genes within 1e-5 (JAX
gathers parents with a bf16 hi/lo one-hot matmul), scores within L *
1e-5; for the thresholded NK objective the port's scores are held
against JAX's ``kernel_rowwise`` of the port's own children. Geometry,
row maps and generation counts are exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.objectives import from_expression as jax_from_expression
from libpga_tpu.objectives import get as jax_get
from libpga_tpu.ops import breed_expr as jbx
from libpga_tpu.ops import pallas_step as ps
import libpga_tpu.objectives as jax_objectives
import libpga_tpu_torch as port
from libpga_tpu_torch import objectives
from libpga_tpu_torch.objectives import from_expression
from libpga_tpu_torch.objectives.expr import warp_order_sum
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops.crossover import one_point_crossover
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels

GENE_ATOL = 1e-5
L0 = 20
NK_T = np.random.default_rng(3).random((16, L0)).astype(np.float32)
OBJECTIVES = {
    # name: (expression, constants, thresholded)
    "smooth": ("sum(g * g) + dot(w, g)", {"w": np.linspace(0, 1, L0).astype(np.float32)}, False),
    "nk": ("b = g >= 0.5; codes = b + 2*roll(b, 1) + 4*roll(b, 2) + 8*roll(b, 3);"
           " mean(gather(T, codes))", {"T": NK_T}, True),
}
CROSS = "where(i < 3, 1 - p1, p2 * 0.5 + 0.25)"
MUT = "where(i % 2 == 0, g * 0.75 + sigma, where(r < rate, r2, g))"
RATE, SIGMA = 0.3, 0.1


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _ops(cross, mut, obj):
    """(JAX kinds, port kinds): each a dict of crossover, mutate and the
    objective (JAX: (kernel_rowwise, consts); port: the expression
    objective, or None for onemax's builtin fused id)."""
    j = dict(crossover="uniform", mutate="point", obj=(jax_get("onemax").kernel_rowwise, ()))
    p = dict(crossover="uniform", mutate="point", obj=None)
    if cross:
        j["crossover"] = jbx.crossover_from_expression(CROSS)
        p["crossover"] = pbx.crossover_from_expression(CROSS)
    if mut:
        j["mutate"] = jbx.mutate_from_expression(MUT, rate=RATE, sigma=SIGMA)
        p["mutate"] = pbx.mutate_from_expression(MUT, rate=RATE, sigma=SIGMA)
    if obj:
        expr, consts, _ = OBJECTIVES[obj]
        jf = jax_from_expression(expr, **consts)
        j["obj"] = (jf.kernel_rowwise, tuple(jf.kernel_rowwise_consts))
        p["obj"] = from_expression(expr, **consts)
    return j, p


def _jax_multigen(P, L, j, **kw):
    fused_obj, consts = j["obj"]
    with _interpret():
        return ps.make_pallas_multigen(
            P, L, crossover_kind=j["crossover"], mutate_kind=j["mutate"],
            fused_obj=fused_obj, fused_consts=consts, mutation_rate=RATE,
            mutation_sigma=SIGMA, **kw)


def _port_scores(p, g):
    if p["obj"] is None:
        return g.sum(axis=1)
    return p["obj"](torch.from_numpy(g)).numpy()


def _both(P, L, steps, *, cross=True, mut=True, obj="smooth", K=128, parity=0, target=None,
          elitism=0, layout=None, dps=None, hot=None, seed=0):
    """One launch in both packages on the same population, zero draws.
    ``hot`` (group) plants a score above ``target`` in that group.
    Returns (geometry, inputs, JAX outputs, port outputs, port kinds)."""
    j, p = _ops(cross, mut, obj)
    bm = _jax_multigen(P, L, j, deme_size=K, elitism=elitism, _layout=layout,
                       _demes_per_step=dps)
    geom = fs.resolve_geometry(P, L, deme_size=K, multigen=True, elitism=elitism, layout=layout,
                               demes_per_step=dps, crossover=p["crossover"],
                               const_carrying=bool(j["obj"][1]))
    assert (bm.layout, bm.K, bm.D, bm.Pp) == (geom.layout, geom.K, geom.D, geom.Pp)
    rng = np.random.default_rng(seed)
    g = np.zeros((geom.Pp, L), np.float32)
    g[:P] = rng.random((P, L), dtype=np.float32)
    s = _port_scores(p, g).astype(np.float32)
    if hot is not None:
        read = geom.row_maps(parity, "cpu")[0].numpy()
        s[read[hot * geom.D, 5]] = target + 10.0
    s[P:] = -np.inf
    with _interpret():
        gj, sj = bm.padded(
            jnp.asarray(np.pad(g, ((0, 0), (0, bm.Lp - L)))), jnp.asarray(s),
            jax.random.key(0), steps, None, target, parity,
        )
    got = fs.multigen_breed(
        torch.from_numpy(g), torch.from_numpy(s), geom, parity, steps, target,
        draws=fs.zero_draws(geom.G, geom.K, L, p["mutate"], crossover=p["crossover"],
                            steps=max(steps, 1)),
        mparams=torch.tensor([RATE, SIGMA]), obj_id=1 if p["obj"] is None else 0,
        objective=p["obj"], crossover=p["crossover"], mutate=p["mutate"], elitism=elitism,
    )
    return geom, (g, s), (np.asarray(gj)[:, :L], np.asarray(sj)), \
        (got[0].numpy(), got[1].numpy()), (j, p)


def _assert_same(geom, jax_out, port_out, kinds, obj="smooth"):
    P, L = geom.P, geom.L
    np.testing.assert_allclose(port_out[0][:P], jax_out[0][:P], rtol=0, atol=GENE_ATOL)
    assert np.isneginf(port_out[1][P:]).all() and np.isneginf(jax_out[1][P:]).all()
    want = jax_out[1][:P]
    if obj and OBJECTIVES[obj][2]:
        # JAX's ~1e-5 gather error can move a gene across g >= 0.5: hold
        # the port's scores against JAX's rowwise form of its children.
        fused_obj, consts = kinds[0]["obj"]
        want = np.asarray(fused_obj(jnp.asarray(port_out[0][:P]), *consts))
    np.testing.assert_allclose(port_out[1][:P], want, rtol=0, atol=L * 1e-5)


# ---------------------------------------------------------------- geometry

def _workload(name):
    """(P, L, port objective, port crossover, port mutate, JAX objective,
    JAX crossover, JAX mutate) of the slice's chip workloads."""
    creep = "where(r < rate, g + sigma * (2*r2 - 1), g)"
    one_point = port.PGA.CROSSOVER_EXPRS["one_point"]
    P, L, obj, cross, mut = {
        "nk-4M": (1 << 22, 64, "nk", None, None),
        "trap-1M": (1 << 20, 60, "trap", None, None),
        "trap-40k": (40_000, 60, "trap", None, None),
        "knapsack": (4096, 6, "knapsack", None, None),
        "creep-40k": (40_000, 100, "onemax", None, creep),
        "creep-1M": (1 << 20, 100, "onemax", None, creep),
        "one_point-40k": (40_000, 100, "onemax", one_point, None),
        "one_point-1M": (1 << 20, 100, "onemax", one_point, None),
    }[name]
    pobj = {"nk": lambda: objectives.make_nk_landscape(64, 3, seed=0),
            "trap": lambda: objectives.make_deceptive_trap(5),
            "knapsack": lambda: objectives.default_knapsack,
            "onemax": lambda: objectives.onemax}[obj]()
    jobj = {"nk": lambda: jax_objectives.make_nk_landscape(64, 3, seed=0),
            "trap": lambda: jax_objectives.make_deceptive_trap(5),
            "knapsack": lambda: jax_get("knapsack"),
            "onemax": lambda: jax_get("onemax")}[obj]()
    pc = pbx.crossover_from_expression(cross) if cross else "uniform"
    jc = jbx.crossover_from_expression(cross) if cross else "uniform"
    pm = pbx.mutate_from_expression(mut, rate=0.05, sigma=0.1) if mut else "point"
    jm = jbx.mutate_from_expression(mut, rate=0.05, sigma=0.1) if mut else "point"
    return P, L, pobj, pc, pm, jobj, jc, jm


WORKLOAD_GEOMETRY = {
    # name: (layout, K, D, S)
    "nk-4M": ("riffle", 256, 8, 2048),
    "trap-1M": ("riffle", 512, 4, 512),
    "trap-40k": ("riffle", 256, 1, 157),
    "knapsack": ("pingpong", 256, 8, 2),
    "creep-40k": ("riffle", 256, 1, 157),
    "creep-1M": ("riffle", 512, 4, 512),
    "one_point-40k": ("riffle", 256, 1, 157),
    "one_point-1M": ("riffle", 512, 4, 512),
}


@pytest.mark.parametrize("name", sorted(WORKLOAD_GEOMETRY))
def test_workload_geometry_equals_make_pallas_multigen(name):
    P, L, pobj, pc, pm, jobj, jc, jm = _workload(name)
    with _interpret():
        bm = ps.make_pallas_multigen(
            P, L, crossover_kind=jc, mutate_kind=jm, fused_obj=jobj.kernel_rowwise,
            fused_consts=tuple(getattr(jobj, "kernel_rowwise_consts", ())))
    launch = fs.make_fused_multigen(P, L, pobj, crossover=pc, mutate=pm, device="cpu")
    geom = launch.geom
    assert (bm.layout, bm.K, bm.D, bm.grid_steps, bm.Pp) == (
        geom.layout, geom.K, geom.D, geom.S, geom.Pp)
    assert (geom.layout, geom.K, geom.D, geom.S) == WORKLOAD_GEOMETRY[name]


# ------------------------------------------------- whole launch, zero draws

LAUNCHES = [
    # (steps, cross, mut, obj, layout, parity, dps, elitism, P)
    (0, True, True, "smooth", "pingpong", 1, 2, 0, 1024),
    (1, True, True, "smooth", "riffle", 0, 2, 0, 1024),
    (3, True, True, "smooth", "riffle", 0, 2, 2, 1024),
    (3, True, True, "nk", "pingpong", 0, 2, 0, 1024),
    (3, True, True, "smooth", "pingpong", 1, 2, 0, 1024),
    (3, True, False, None, "pingpong", 1, 2, 0, 1024),
    (3, False, True, None, "riffle", 0, None, 2, 1024),
    (3, False, False, "nk", "riffle", 0, 2, 2, 1024),
    (2, True, True, "nk", None, 1, 2, 0, 1000),
    (3, True, True, "smooth", None, 0, None, 2, 1000),
]


@pytest.mark.parametrize("steps,cross,mut,obj,layout,parity,dps,elitism,P", LAUNCHES)
def test_launch_equals_jax(steps, cross, mut, obj, layout, parity, dps, elitism, P):
    geom, (g, s), jax_out, port_out, kinds = _both(
        P, L0, steps, cross=cross, mut=mut, obj=obj, layout=layout, parity=parity, dps=dps,
        elitism=elitism, seed=steps + P)
    if layout:
        assert geom.layout == layout
    if P == 1000:
        assert geom.Pp == 1024 and geom.layout == ("riffle" if elitism else "pingpong")
    _assert_same(geom, jax_out, port_out, kinds, obj)
    if steps == 0:
        read, write = (m.reshape(-1).numpy() for m in geom.row_maps(parity, "cpu"))
        np.testing.assert_array_equal(port_out[0][write], g[read])
    else:
        # scores are the children's, in the kernels' summation order
        p = kinds[1]
        want = (fs.rowwise_scores(1, torch.from_numpy(port_out[0]), True) if p["obj"] is None
                else p["obj"].kernel_rowwise(torch.from_numpy(port_out[0]), warp_order=True))
        np.testing.assert_array_equal(port_out[1][:P], want.numpy()[:P])


@pytest.mark.parametrize("layout,parity", [("riffle", 0), ("pingpong", 1)])
def test_target_freezes_one_group_and_not_the_other(layout, parity):
    """A frozen group comes back unchanged up to the row permutation
    while the other groups breed on, hooks and all."""
    target, D = 40.0, 2
    geom, (g, s), jax_out, port_out, kinds = _both(
        1024, L0, 3, layout=layout, parity=parity, dps=D, target=target, hot=2)
    _assert_same(geom, jax_out, port_out, kinds)
    read, write = (m.numpy() for m in geom.row_maps(parity, "cpu"))
    frozen = slice(2 * D, 3 * D)
    np.testing.assert_array_equal(port_out[0][write[frozen]], g[read[frozen]])
    np.testing.assert_array_equal(port_out[1][write[frozen]], s[read[frozen]])
    others = np.delete(np.arange(geom.G), np.arange(2 * D, 3 * D))
    # CROSS writes 1 - p1 at genes 0..2 and MUT halves it plus sigma: bred
    assert not np.array_equal(port_out[0][write[others]], g[read[others]])


# ----------------------------------- against the port's one-generation breed


@pytest.mark.parametrize("layout,parity,cross,mut,obj", [
    ("pingpong", 0, True, True, "smooth"), ("pingpong", 1, True, False, "nk"),
    ("riffle", 0, False, True, "nk"), (None, 0, True, True, None),
])
def test_one_step_equals_the_one_generation_plain_breed(layout, parity, cross, mut, obj):
    """steps = 1 with the same ranks and random draws breeds the same
    children as ``deme_breed_reference`` with the same hooks, and scores
    them within the reordering of the sums."""
    P, L = 1000 if layout is None else 1024, L0
    _, p = _ops(cross, mut, obj)
    geom = fs.resolve_geometry(P, L, deme_size=128, multigen=True, layout=layout,
                               crossover=p["crossover"])
    gen = torch.Generator().manual_seed(P + parity)
    G, K = geom.G, geom.K
    g = torch.rand((geom.Pp, L), generator=gen)
    s = torch.rand(geom.Pp, generator=gen)
    s[P:] = -torch.inf
    z = fs.zero_draws(G, K, L, p["mutate"], crossover=p["crossover"], steps=1)
    draws = fs.Draws(
        sel_u=torch.rand(z.sel_u.shape, generator=gen),
        cross=(torch.rand((1, G, K, L), generator=gen) < 0.5).to(torch.uint8),
        mut_u=torch.rand(z.mut_u.shape, generator=gen),
        tie=torch.randint(0, 2**32, (1, G, K), generator=gen),
        expr_gene=None if z.expr_gene is None else torch.rand(z.expr_gene.shape, generator=gen),
        expr_row=None if z.expr_row is None else torch.rand(z.expr_row.shape, generator=gen),
    )
    kw = dict(tournament_size=3, selection="linear_rank", selection_param=1.7,
              mutate=p["mutate"], crossover=p["crossover"], mparams=torch.tensor([0.3, 0.05]),
              obj_id=1 if p["obj"] is None else 0, objective=p["obj"])
    got = fs.multigen_breed(g, s, geom, parity, 1, draws=draws, **kw)
    read, _ = geom.row_maps(parity, "cpu")
    ranks = fs.kernel_ranks(s[read], draws.tie[0], read < P)
    want = fs.deme_breed_reference(g, ranks, geom, parity, draws.at(0), **kw)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=L * 1e-5)


def test_philox_sub_generations_draw_the_expression_streams_anew():
    """The expression planes and row words carry the sub-generation as
    the fourth counter word, and a launch is reproducible."""
    seed = torch.tensor([12345])
    cx = pbx.crossover_from_expression("where(r < q, p1, p2)")
    mx = pbx.mutate_from_expression("where(r < rate, r2, g) + 0 * q2", rate=0.2)
    a = fs.philox_draws(seed, 2, 128, 20, mx, cx, sub_generation=0, tie=True)
    b = fs.philox_draws(seed, 2, 128, 20, mx, cx, sub_generation=1, tie=True)
    for name in ("expr_gene", "expr_row", "sel_u", "tie"):
        assert not torch.equal(getattr(a, name), getattr(b, name))
    geom = fs.resolve_geometry(512, 20, deme_size=128, multigen=True, crossover=cx)
    gen = torch.Generator().manual_seed(2)
    g, s = torch.rand((512, 20), generator=gen), torch.rand(512, generator=gen)
    kw = dict(seed=seed, crossover=cx, mutate=mx, mparams=torch.tensor([0.2, 0.0]),
              objective=from_expression("sum(g * g)"))
    one, two = fs.multigen_breed(g, s, geom, 0, 3, **kw), fs.multigen_breed(g, s, geom, 0, 3, **kw)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


# ------------------------------------------------ the kernels' summation order


def _warp_sum_numpy(x):
    """Lane i adds terms i, i+32, ... from 0.0; then the xor butterfly."""
    L = x.shape[-1]
    x = np.pad(x, ((0, 0), (0, -L % 32))).reshape(x.shape[0], -1, 32)
    v = np.zeros((x.shape[0], 32), np.float32)
    for j in range(x.shape[1]):
        v = (v + x[:, j]).astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, np.arange(32) ^ o]).astype(np.float32)
    return v[:, 0]


@pytest.mark.parametrize("L", [6, 60, 64, 100, 130])
def test_warp_order_expression_sums_are_the_kernels_order(L):
    """``sum``, ``mean`` and ``dot`` in warp order equal the numpy model
    of the lane-strided butterfly bit for bit, and stay within float32
    reordering of the default (torch.sum) order."""
    rng = np.random.default_rng(L)
    m = rng.random((64, L), dtype=np.float32)
    w = rng.random(L, dtype=np.float32)
    obj = from_expression("sum(g * g) - 3 * mean(g) + dot(w, g) + max(g)", w=w)
    got = obj.kernel_rowwise(torch.from_numpy(m), warp_order=True).numpy()
    a = _warp_sum_numpy(m * m)
    b = (_warp_sum_numpy(m) / np.float32(L)).astype(np.float32)
    c = _warp_sum_numpy(w[None, :] * m)
    want = ((a - np.float32(3) * b) + c + m.max(axis=1)).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(warp_order_sum(torch.from_numpy(m)).numpy(), _warp_sum_numpy(m))
    np.testing.assert_allclose(got, obj(torch.from_numpy(m)).numpy(), rtol=1e-5)


# ------------------------------------------------------------------ run loop


def _zero_philox(monkeypatch):
    """The port's production draws made all zero, as JAX's are in
    interpret mode."""
    def draws(seed, G, K, L, mutate="point", crossover="uniform", sub_generation=0, tie=False):
        return fs.zero_draws(G, K, L, mutate, crossover=crossover, steps=1).at(0)

    monkeypatch.setattr(fs, "philox_draws", draws)


@pytest.mark.parametrize("n,target", [(10, math.inf), (10, 11.0), (7, 11.0)])
def test_run_loop_equals_jax_multigen_run_loop(n, target, monkeypatch):
    """``make_multigen_run`` with an expression crossover, mutation and
    objective against ``_multigen_run_loop``, zero draws in both: the
    generation count (a multiple of T at a target stop, the remainder
    launch otherwise), the population and the scores."""
    P, L, T = 512, L0, 3
    j, p = _ops(True, True, "smooth")
    bm = _jax_multigen(P, L, j, deme_size=128)
    expr, consts, _ = OBJECTIVES["smooth"]
    jobj = jax_from_expression(expr, **consts)
    g = np.random.default_rng(1).random((P, L), dtype=np.float32)
    with _interpret():
        run = ps._multigen_run_loop(jobj, bm, P, L, T, donate=False)
        gj, sj, gens_j = run(jnp.asarray(g), jax.random.key(0), jnp.int32(n),
                             jnp.float32(target), bm.default_params)
    _zero_philox(monkeypatch)
    prun = fs.make_multigen_run(P, L, p["obj"], T, deme_size=128, crossover=p["crossover"],
                                mutate=p["mutate"], mparams=(RATE, SIGMA), device="cpu")
    assert (prun.geom.layout, prun.geom.K, prun.geom.D) == (bm.layout, bm.K, bm.D)
    gp, sp, gens_p = prun(torch.from_numpy(g), n, None if math.isinf(target) else target,
                          torch.Generator().manual_seed(0))
    assert gens_p == int(gens_j)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=0, atol=L * 1e-5)
    if gens_p < n:
        assert gens_p % T == 0 and float(sp.max()) >= target


# -------------------------------------------------------------------- engine


def test_engine_knapsack_at_eight_generations_per_launch():
    """The reference's knapsack through PGA.run at T = 8: 30 generations
    in ceil(30 / 8) launches, the optimum 285 reached, scores equal to
    the rowwise form of the genomes."""
    p = port.PGA(seed=0, config=port.PGAConfig(device="cpu", generations_per_launch=8))
    h = p.create_population(4096, 6)
    p.set_objective(objectives.default_knapsack)
    assert p.run(30) == 30 and p.launches == 4
    pop = p.population(h)
    torch.testing.assert_close(pop.scores, objectives.default_knapsack(pop.genomes), rtol=0,
                               atol=1e-4)
    assert p.get_best_with_score(h)[1] == 285.0
    assert p._run_fn(4096, 6)[0].geom.layout == "pingpong"
    assert kernels.LAUNCHES["expr_multigen"] == 0  # on the CPU the plain version ran


def test_engine_expression_operators_and_trap_at_several_generations_per_launch():
    p = port.PGA(seed=1, config=port.PGAConfig(device="cpu", generations_per_launch=4,
                                               elitism=2))
    h = p.create_population(1024, 20)
    p.set_objective(objectives.make_deceptive_trap(5))
    p.set_crossover(one_point_crossover)
    p.set_mutate(pbx.mutate_from_expression("where(r < rate, 1 - g, g)", rate=0.02))
    start = float(objectives.make_deceptive_trap(5)(p.population(h).genomes).max())
    assert p.run(10) == 10 and p.launches == 3
    assert p.get_best_with_score(h)[1] >= start
