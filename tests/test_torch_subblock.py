"""The sub-block pipeline (B8) of the port on the CPU: ``PGAConfig.subblock``
(JAX's ``pallas_subblock``) through ``resolve_geometry``, the B-aware row
maps of ``Geometry`` and the plain breed (libpga_tpu_torch/ops/
fused_step.py), ``PGA.run`` and the island breed.

JAX's B > 1 kernel cannot run in interpret mode under jax 0.9.0
(``pltpu.TPUMemorySpace`` is missing, so ``tests/test_pingpong.py::
TestSubblockPipeline`` fails), so B8 is anchored on JAX's layout algebra
(``pingpong_perm`` / ``pingpong_child_rows``, plain numpy), on its dry-run
resolver ``kernel_plan``, and on the zero-draw structure of JAX's own
``test_subblock_children_match_algebra``, ported here; not on a JAX run.
``csrc/deme_breed.cu``'s ``deme_pipelined_kernel`` computes the plain
breed's function at these geometries (``tests/test_torch_kernels_cuda.py
-k pipelined`` holds it there on a card)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu
import libpga_tpu_torch as port
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch import interop
from libpga_tpu_torch.config import PGAConfig
from libpga_tpu_torch.objectives import onemax
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops.breed_expr import mutate_from_expression

CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
I = 3


def _expected_rank0_copy(parity, Pp, W, q, K, P, genome_col, D=None, B=1):
    """``tests/test_pingpong.py``'s zero-draw expectation, on JAX's
    algebra: every read deme's children copy its best alive row (scores
    strictly decreasing in physical row index, so rank 0 is the deme's
    smallest alive physical row) and land at JAX's write rows
    (``pingpong_child_rows``)."""
    if D is None:
        D = W // K
    perm = ps.pingpong_perm(parity, Pp, W, q)
    child = ps.pingpong_child_rows(parity, Pp, K, q, D, B)
    out = np.zeros(Pp, np.float32)
    for c in range(Pp // K):
        rows = perm[c * K:(c + 1) * K]
        dest = child[c * K:(c + 1) * K]
        alive = rows[rows < P]
        best = alive.min() if alive.size else rows.min()
        out[dest] = genome_col[min(best, len(genome_col) - 1)]
    return out


# --------------------------------------------------------------- the algebra


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("q", [8, 16])
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("Pp,K,D", [(4096, 128, 2), (8192, 256, 1), (16384, 128, 4)])
def test_maps_equal_jax_algebra(parity, q, B, Pp, K, D):
    """The port's read and write maps at group width B*D*K, and
    ``Geometry.row_maps`` at B, are JAX's exactly."""
    W = B * D * K
    read = fs.pingpong_perm(parity, Pp, W, q)
    write = fs.pingpong_child_rows(parity, Pp, K, q, D, B)
    np.testing.assert_array_equal(read, ps.pingpong_perm(parity, Pp, W, q))
    np.testing.assert_array_equal(write, ps.pingpong_child_rows(parity, Pp, K, q, D, B))
    geom = fs.Geometry("pingpong", Pp, 16, K, Pp // K, D, Pp, q, B)
    assert geom.S == Pp // W
    r, w = geom.row_maps(parity, "cpu")
    np.testing.assert_array_equal(r.numpy().reshape(-1), read)
    np.testing.assert_array_equal(w.numpy().reshape(-1), write)
    assert sorted(write.tolist()) == list(range(Pp))


@pytest.mark.parametrize("parity", [0, 1])
def test_subblock_moves_children_within_their_sub_block(parity):
    """At B > 1 the children of a sub-block's D demes land on that
    sub-block's rows only: the write map of a group of B sub-blocks is the
    B = 1 map of each sub-block's rows, as JAX's algebra states."""
    Pp, K, D, B, q = 4096, 128, 2, 4, 8
    geom = fs.Geometry("pingpong", Pp, 16, K, Pp // K, D, Pp, q, B)
    read, write = (m.numpy() for m in geom.row_maps(parity, "cpu"))
    for g in range(0, geom.G, D):
        assert set(write[g:g + D].reshape(-1)) == set(read[g:g + D].reshape(-1))


# ------------------------------------------------------------------ the plan


PLAN_SHAPES = [((1 << 20, 100), torch.float32, jnp.float32),
               ((1 << 20, 100), torch.bfloat16, jnp.bfloat16),
               ((131_072, 100), torch.float32, jnp.float32),
               ((40_000, 100), torch.float32, jnp.float32)]


def _same_plan(geom, plan):
    assert (geom.K, geom.D, geom.layout, geom.B, geom.S, geom.Pp) == (
        plan["deme_size"], plan["demes_per_step"], plan["layout"], plan["subblock"],
        plan["grid_steps"], plan["Pp"])


@pytest.mark.parametrize("B", [None, 1, 2, 4])
@pytest.mark.parametrize("shape,dtype,jdtype", PLAN_SHAPES,
                         ids=lambda v: str(v) if isinstance(v, tuple) else None)
def test_geometry_equals_kernel_plan(shape, dtype, jdtype, B):
    """Deme size, demes per step, layout, sub-block depth and grid steps
    (S) are JAX's ``kernel_plan(subblock=B)``'s: at bf16, B = 2 halves D
    to 4 and keeps the group width; the 40,000-row riffle drops B to 1."""
    geom = fs.resolve_geometry(*shape, gene_dtype=dtype, subblock=B)
    _same_plan(geom, ps.kernel_plan(*shape, gene_dtype=jdtype, subblock=B))


@pytest.mark.parametrize("kw,jkw", [
    (dict(demes_per_step=2, layout="pingpong"), dict(demes_per_step=2, layout="pingpong")),
    (dict(const_carrying=True), dict(const_carrying=True)),
    (dict(crossover="order"), dict(crossover_kind="order")),
    (dict(layout="riffle"), dict(layout="riffle")),
    (dict(fused=False), dict(fused=False)),
])
@pytest.mark.parametrize("B", [2, 4])
def test_geometry_equals_kernel_plan_knobs(kw, jkw, B):
    """A pinned demes-per-step, a const-carrying objective, order
    crossover, an explicit riffle and an unfused breed resolve B as JAX
    does (order, riffle and unfused: B = 1)."""
    P, L = (8192, 100) if "crossover" in kw else (65_536, 100)
    geom = fs.resolve_geometry(P, L, deme_size=256, subblock=B, **kw)
    _same_plan(geom, ps.kernel_plan(P, L, deme_size=256, subblock=B, **jkw))


def test_multigen_ignores_subblock():
    """The multi-generation geometry takes B = 1, as JAX's
    ``make_pallas_multigen`` ignores ``_subblock``."""
    from jax.experimental.pallas import tpu as pltpu

    geom = fs.resolve_geometry(512, 16, deme_size=128, multigen=True, subblock=4)
    with pltpu.force_tpu_interpret_mode():
        bm = ps.make_pallas_multigen(512, 16, deme_size=128,
                                     fused_obj=libpga_tpu.objectives.onemax.kernel_rowwise,
                                     _subblock=4)
    assert geom.B == bm.subblock == 1 and geom.D == bm.D and geom.layout == bm.layout
    assert fs.make_fused_multigen(512, 16, onemax, deme_size=128, subblock=4,
                                  device="cpu").geom.B == 1


def test_refusals_follow_jax():
    """An explicit ping-pong that no D admits at the sub-block depth
    raises in both packages, naming the depth; a depth below 1 raises in
    both configs, and a negative one in both resolvers (which, like JAX's,
    read 0 as None)."""
    with pytest.raises(ValueError, match="subblock=2"):
        fs.resolve_geometry(512, 16, deme_size=128, layout="pingpong", subblock=2)
    with pytest.raises(ValueError, match="subblock=2"):
        ps.kernel_plan(512, 16, deme_size=128, layout="pingpong", subblock=2)
    with pytest.raises(ValueError, match="subblock"):
        PGAConfig(subblock=0)
    with pytest.raises(ValueError, match="subblock"):
        libpga_tpu.PGAConfig(pallas_subblock=0)
    with pytest.raises(ValueError, match="subblock"):
        fs.resolve_geometry(1 << 20, 100, subblock=-1)
    with pytest.raises(ValueError, match="subblock"):
        ps.kernel_plan(1 << 20, 100, subblock=-1)


@pytest.mark.parametrize("shape", [(1 << 20, 100), (1000, 100), (40_000, 100), (4096, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_subblock_none_and_one_change_nothing(shape, dtype):
    """``subblock`` None and 1 resolve today's geometry: B = 1, the same
    fields and, at a small shape, the same row maps."""
    geom = fs.resolve_geometry(*shape, gene_dtype=dtype)
    assert geom.B == 1
    for B in (None, 1):
        other = fs.resolve_geometry(*shape, gene_dtype=dtype, subblock=B)
        assert other == geom
    if shape[0] <= 4096:
        for parity in range(geom.parities):
            for a, b in zip(geom.row_maps(parity, "cpu"),
                            fs.resolve_geometry(*shape, gene_dtype=dtype,
                                                subblock=1).row_maps(parity, "cpu")):
                assert torch.equal(a, b)


# ------------------------------------------------------------- the structure


@pytest.mark.parametrize("P", [1024, 1000], ids=["full", "padded"])
@pytest.mark.parametrize("parity", [0, 1])
def test_zero_draw_children_match_jax_algebra(parity, P):
    """JAX's ``test_subblock_children_match_algebra`` on the port's plain
    breed at B = 2 (1,024 rows, or 1,000 padded to 1,024; L = 12, K = 128,
    D = 2): with all-zero draws and mutation rate 0, every child copies its
    read deme's best row, scores falling with the row index, and lands
    where JAX's algebra says; the fused scores are the row sums."""
    L, K = 12, 128
    geom = fs.resolve_geometry(P, L, deme_size=K, demes_per_step=2, layout="pingpong",
                               subblock=2)
    assert (geom.layout, geom.D, geom.B, geom.Pp) == ("pingpong", 2, 2, 1024)
    rows = torch.arange(geom.Pp, dtype=torch.float32)
    g = (rows[:, None] / P).expand(geom.Pp, L).contiguous()
    s = torch.where(rows < P, -rows, -torch.inf)
    tie = torch.from_numpy(np.random.default_rng(parity).integers(0, 2**31, geom.Pp))
    ranks = fs.compute_ranks(s, geom, parity, tie)
    g2, s2 = fs.deme_breed_reference(
        g, ranks, geom, parity, fs.zero_draws(geom.G, K, L), mparams=torch.zeros(2),
        obj_id=onemax.fused_id)
    expect = _expected_rank0_copy(parity, geom.Pp, geom.B * geom.D * K, geom.q, K, P,
                                  np.arange(P, dtype=np.float32) / P, D=geom.D, B=geom.B)
    np.testing.assert_array_equal(g2[:P, 0].numpy(), expect[:P])
    np.testing.assert_allclose(s2[:P].numpy(), g2[:P].sum(dim=1).numpy(), atol=1e-4, rtol=0)
    assert bool(torch.isinf(s2[P:]).all())


@pytest.mark.parametrize("case", [
    ("f32-parity0", torch.float32, 8, (0,), 4, 4),
    ("bf16-both", torch.bfloat16, 16, (0, 1), 4, 2),
], ids=lambda c: c[0])
def test_subblock_moves_rows_only(case):
    """With the same ranks and draws, child (g, k) at B = 2 is child (g, k)
    at B = 1 wherever the two geometries read the same cohorts (parity 0
    always; at bf16, JAX's B = 2 halves D and keeps the group width, so
    both parities), each placed by its own write map."""
    _, dtype, q, parities, D1, D2 = case
    Pp, L, K = 4096, 24, 128
    g1 = fs.Geometry("pingpong", Pp, L, K, Pp // K, D1, Pp, q, 1)
    g2 = fs.Geometry("pingpong", Pp, L, K, Pp // K, D2, Pp, q, 2)
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.random((Pp, L), dtype=np.float32)).to(dtype)
    s = g.float().sum(dim=1)
    kw = dict(mparams=torch.tensor([0.3, 0.0]), obj_id=onemax.fused_id, tournament_size=3)
    for parity in parities:
        read1, write1 = g1.row_maps(parity, "cpu")
        read2, write2 = g2.row_maps(parity, "cpu")
        assert torch.equal(read1, read2)
        tie = torch.from_numpy(rng.integers(0, 2**31, Pp))
        ranks = fs.compute_ranks(s, g1, parity, tie)
        assert torch.equal(ranks, fs.compute_ranks(s, g2, parity, tie))
        seed = torch.tensor([parity + 11])
        a, sa = fs.deme_breed(g, ranks, g1, parity, seed=seed, **kw)
        b, sb = fs.deme_breed(g, ranks, g2, parity, seed=seed, **kw)
        assert torch.equal(write1, write2) == (D1 == D2)  # parity 0, same D: same rows
        assert torch.equal(a[write1.reshape(-1)], b[write2.reshape(-1)])
        assert torch.equal(sa[write1.reshape(-1)], sb[write2.reshape(-1)])


# --------------------------------------------------------- the run, islands


def _solver(subblock, size=16_384, L=16, **config):
    p = port.pga_init(3, PGAConfig(device="cpu", subblock=subblock, **config))
    h = port.pga_create_population(p, size, L)
    port.pga_set_objective_function(p, "onemax")
    return p, h


def test_run_follows_the_plain_subblock_breed():
    """``PGA.run`` with ``subblock=2`` is the B-aware plain breed, generation
    by generation: the same generator, the parity alternating."""
    n, size, L = 6, 16_384, 16
    p, h = _solver(2, size, L)
    g = p.population(h).genomes.clone()
    gen = torch.Generator().set_state(p.generator.get_state())
    assert port.pga_run(p, n) == n and p.launches == n
    breed = fs.make_fused_breed(size, L, onemax, mparams=(0.01, 0.0), device="cpu", subblock=2)
    geom = breed.geom
    assert (geom.layout, geom.B, geom.D) == ("pingpong", 2, 8) and geom.Pp == size
    s = onemax(g)
    for gen_i in range(n):
        g, s = breed(g, s, gen_i % 2, gen)
    got = p.population(h)
    assert torch.equal(got.genomes, g) and torch.equal(got.scores, s)


def test_run_subblock_none_and_one_are_today_s_run():
    """``subblock`` None and 1 give the same run; 2 another (its children
    land on other rows)."""
    runs = {}
    for sb in (None, 1, 2):
        p, h = _solver(sb)
        port.pga_run(p, 5)
        runs[sb] = p.population(h).genomes
    assert torch.equal(runs[None], runs[1])
    assert not torch.equal(runs[None], runs[2])


def test_run_several_generations_per_launch_ignores_subblock():
    """At ``generations_per_launch`` = 3 the multi-generation kernel breeds,
    whose geometry ignores the depth: the same run as without it."""
    runs = {}
    for sb in (None, 2):
        p, h = _solver(sb, generations_per_launch=3)
        assert port.pga_run(p, 7) == 7 and p.launches == 3
        runs[sb] = p.population(h).genomes
    assert torch.equal(runs[None], runs[2])


def test_expression_hook_at_subblock_breeds_on_the_b_aware_maps():
    """An expression mutation at B = 2 (the expression breed's path) is the
    plain breed at the B-aware geometry with the hook."""
    size, L, n = 16_384, 16, 3
    p, h = _solver(2, size, L)
    op = mutate_from_expression(CREEP, rate=0.05, sigma=0.1)
    port.pga_set_mutate_function(p, op)
    g = p.population(h).genomes.clone()
    gen = torch.Generator().set_state(p.generator.get_state())
    assert port.pga_run(p, n) == n and p.launches == n
    breed = fs.make_fused_breed(size, L, onemax, mutate=op, mparams=(0.05, 0.1), device="cpu",
                                subblock=2)
    assert breed.geom.B == 2
    s = onemax(g)
    for gen_i in range(n):
        g, s = breed(g, s, gen_i % 2, gen)
    assert torch.equal(p.population(h).genomes, g)


@pytest.mark.parametrize("parity", [0, 1])
def test_island_breed_at_subblock_equals_single_breeds(parity):
    """An island breed at B = 2 is I single-population breeds, each with
    its island's seed, bit for bit (``tests/test_torch_island_breed.py``
    holds the same at B = 1)."""
    S, L = 16_384, 16
    geom = fs.resolve_geometry(S, L, subblock=2)
    assert geom.B == 2
    rng = np.random.default_rng(parity)
    g = torch.from_numpy(rng.random((I, S, L), dtype=np.float32))
    s = g.sum(dim=2)
    tie = torch.from_numpy(rng.integers(0, 2**31, (I, S)))
    seeds = torch.from_numpy(rng.integers(0, 2**62, I))
    kw = dict(mparams=torch.tensor([0.3, 0.0]), obj_id=onemax.fused_id)
    ranks = fs.compute_ranks(s, geom, parity, tie)
    got_g, got_s = fs.deme_breed(g, ranks, geom, parity, seed=seeds, islands=I, **kw)
    for i in range(I):
        r = ranks[i * geom.G:(i + 1) * geom.G]
        want_g, want_s = fs.deme_breed(g[i], r, geom, parity, seed=seeds[i:i + 1], **kw)
        assert torch.equal(got_g[i], want_g) and torch.equal(got_s[i], want_s)


def test_run_islands_at_subblock_counts_one_launch_per_generation():
    """``run_islands`` with ``subblock=2`` breeds every island in one
    launch a generation, on the B-aware island geometry."""
    p = port.pga_init(0, PGAConfig(device="cpu", subblock=2))
    for _ in range(I):
        port.pga_create_population(p, 16_384, 16)
    port.pga_set_objective_function(p, "onemax")
    assert port.pga_run_islands(p, 20, 10, 0.05) == 20 and p.launches == 20
    assert p._island_breed(16_384, 16, I).geom.B == 2


def test_interop_carries_pallas_subblock():
    cfg = interop.pga_config_from_fields(libpga_tpu.PGAConfig(pallas_subblock=2), device="cpu")
    assert cfg == dataclasses.replace(PGAConfig(device="cpu"), subblock=2)
