"""Parity of the port's TSP path (libpga_tpu_torch: the TSP objectives,
the order walk, swap and gaussian mutation, the order branch of the deme
breed and its geometry, and the operator routing of ``PGA``) with the
JAX package. Inputs and noise are made with numpy from a seed and handed
to both packages as numpy arrays. The whole breed runs the JAX kernel as
the JAX package's own tests run it on the CPU: under
``force_tpu_interpret_mode``, whose PRNG bits are all zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu
import libpga_tpu_torch as port
from libpga_tpu import gp as jax_gp
from libpga_tpu.objectives import classic as jax_classic
from libpga_tpu.ops import crossover as jax_crossover
from libpga_tpu.ops import mutate as jax_mutate
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch import gp as port_gp
from libpga_tpu_torch.objectives import classic
from libpga_tpu_torch.ops import crossover, fused_step as fs, kernels, mutate
from libpga_tpu_torch.ops.select import winner_fraction, winner_ranks

CPU = port.PGAConfig(device="cpu")
PENALTY = 10_000.0
GENE_ATOL = 2e-5  # JAX gathers parents with a bf16 hi/lo one-hot matmul


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _perms(rng, P, L):
    """Permutation genomes: every gene decodes to a distinct city."""
    return ((np.stack([rng.permutation(L) for _ in range(P)]) + 0.5) / L).astype(np.float32)


def _tsp_genomes(seed, P, L):
    """Permutations, random genomes (duplicates near certain), and a
    planted triple (positions 3 and 7 repeat position 5's city)."""
    rng = np.random.default_rng(seed)
    g = np.concatenate([_perms(rng, P // 2, L), rng.random((P - P // 2, L), dtype=np.float32)])
    g[2, 3] = g[2, 7] = g[2, 5]
    return g


# objectives ---------------------------------------------------------------

OBJECTIVE_CASES = [
    # (kind, mode, C, L): L != C exercises the clamped lookup and the
    # max(C, L) duplicate buckets
    ("matrix", "pairs", 24, 24),
    ("matrix", "pairs", 16, 24),
    ("coords", "pairs", 30, 30),
    ("coords", "genes", 30, 30),
    ("coords", "genes", 20, 32),
    ("coords", "genes", 40, 25),
]


def _objectives(kind, mode, C, seed=3):
    if kind == "matrix":
        data = classic.random_tsp_matrix(C, seed=seed)
        np.testing.assert_array_equal(data, jax_classic.random_tsp_matrix(C, seed=seed))
        return classic.make_tsp(data), jax_classic.make_tsp(data)
    data = classic.random_tsp_coords(C, seed=seed)
    np.testing.assert_array_equal(data, jax_classic.random_tsp_coords(C, seed=seed))
    return (classic.make_tsp_coords(data, duplicate_mode=mode),
            jax_classic.make_tsp_coords(data, duplicate_mode=mode))


@pytest.mark.parametrize("kind,mode,C,L", OBJECTIVE_CASES)
def test_tsp_objectives_match_jax(kind, mode, C, L):
    """Port ``.rows`` against JAX ``.rows`` and the JAX per-genome form:
    rtol 1e-5 (the path lengths are summed in another order), atol 1e-3
    (scores are whole penalties plus lengths, far from zero)."""
    ours, theirs = _objectives(kind, mode, C)
    g = _tsp_genomes(C + L, 16, L)
    got = ours.rows(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(theirs.rows(jnp.asarray(g))), rtol=1e-5, atol=1e-3)
    per = np.asarray([float(theirs(jnp.asarray(r))) for r in g[:3]])
    np.testing.assert_allclose(got[:3], per, rtol=1e-5, atol=1e-3)
    assert ours.fused_id == (classic.FUSED_TSP if mode == "genes" else classic.FUSED_NONE)


def test_duplicate_modes_penalise_a_triple_as_jax_does():
    """genes mode counts 2 duplicate genes for a triple, pairs mode 6
    ordered pairs (tests/test_pallas.py:1111-1135)."""
    coords = classic.random_tsp_coords(16, seed=3)
    perm = _perms(np.random.default_rng(1), 1, 16)
    perm[0, 3] = perm[0, 7] = perm[0, 5]
    g = torch.from_numpy(perm)
    genes = classic.make_tsp_coords(coords, duplicate_mode="genes")(g)
    pairs = classic.make_tsp_coords(coords, duplicate_mode="pairs")(g)
    assert float(pairs - genes) == pytest.approx(-4 * PENALTY, rel=1e-6)


# the walk -----------------------------------------------------------------


def _walk_inputs(case, seed, N=24, L=40):
    rng = np.random.default_rng(seed)
    if case == "permutations":
        p1, p2 = _perms(rng, N, L), _perms(rng, N, L)
    elif case == "planted":  # city l % (L/2) at position l: half are repeats
        pattern = ((np.arange(L) % (L // 2)) + 0.5).astype(np.float32) / L
        p1 = np.tile(pattern, (N, 1))
        p2 = rng.random((N, L), dtype=np.float32)
        p2[::2] = pattern
    else:
        p1, p2 = rng.random((2, N, L), dtype=np.float32)
    return p1, p2, rng.random((N, L), dtype=np.float32)


@pytest.mark.parametrize("case", ["permutations", "planted", "random"])
def test_order_walk_equals_jax(case):
    p1, p2, fill = _walk_inputs(case, len(case))
    got = crossover.order_walk(*(torch.from_numpy(a) for a in (p1, p2, fill))).numpy()
    want = np.asarray(jax_crossover._order_preserving_batched(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(fill)))
    np.testing.assert_array_equal(got, want)
    for i in range(3):
        row = np.asarray(jax_crossover.order_preserving_crossover(
            jnp.asarray(p1[i]), jnp.asarray(p2[i]), jnp.asarray(fill[i])))
        np.testing.assert_array_equal(got[i], row)
        one = crossover.order_preserving_crossover(
            *(torch.from_numpy(a[i]) for a in (p1, p2, fill)))
        np.testing.assert_array_equal(one.numpy(), row)
    if case == "permutations":  # two permutations never fall back
        assert not np.isin(got, fill).any()


# mutation -----------------------------------------------------------------


def test_swap_and_gaussian_mutation_equal_jax():
    rng = np.random.default_rng(5)
    g = rng.random((64, 30), dtype=np.float32)
    rand = rng.random((64, 30), dtype=np.float32)
    got = mutate.make_swap_mutate(0.5).batched(torch.from_numpy(g), torch.from_numpy(rand[:, :3]))
    want = jax_mutate.swap_mutate_batched(jnp.asarray(g), jnp.asarray(rand[:, :3]), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Box-Muller of the bit-mixed streams: XLA's log and cos may differ
    # from torch's in the last ulp.
    got = mutate.make_gaussian_mutate(0.3, 0.2).batched(torch.from_numpy(g), torch.from_numpy(rand))
    want = jax_mutate.gaussian_mutate(jnp.asarray(g), jnp.asarray(rand), 0.3, 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert (got.numpy() != g).any()


# the breed core, draw for draw ---------------------------------------------


@pytest.mark.parametrize("elite,V", [(0, 128), (0, 77), (3, 128), (2, 50)])
def test_order_breed_core_equals_select_then_jax_walk_and_swap(elite, V):
    """``breed_children(crossover="order", mutate="swap")`` with injected
    draws equals the same rank-space selection, then JAX's XLA order walk
    and swap mutation on the gathered parents; elite rows are parent 1
    unmutated (order crossover is not the identity on equal parents)."""
    K, L, rate = 128, 36, 0.5
    rng = np.random.default_rng(K + V + elite)
    cohort = np.concatenate([_perms(rng, K // 2, L), rng.random((K // 2, L), dtype=np.float32)])
    ranks = rng.permutation(K).astype(np.int32)
    sel_u = rng.random((K, 2), dtype=np.float32)
    fill = rng.random((K, L), dtype=np.float32)
    mut_u = rng.random((K, 4), dtype=np.float32)
    draws = fs.Draws(sel_u=torch.from_numpy(sel_u)[None], cross=None,
                     mut_u=torch.from_numpy(mut_u)[None], fill=torch.from_numpy(fill)[None])
    got = fs.breed_children(
        torch.from_numpy(cohort)[None], torch.from_numpy(ranks)[None],
        torch.tensor([float(V)]), draws, tournament_size=2, selection="tournament",
        selection_param=None, mutate="swap", mparams=torch.tensor([rate, 0.0]),
        elite_rows=elite, crossover="order",
    )[0].numpy()

    x = winner_fraction("tournament", None, 2, torch.from_numpy(sel_u))
    wr = winner_ranks(x, torch.tensor(float(V))).numpy()
    wr[:elite] = np.minimum(np.arange(elite), V - 1)[:, None]
    row_of_rank = np.argsort(ranks)
    p1, p2 = cohort[row_of_rank[wr[:, 0]]], cohort[row_of_rank[wr[:, 1]]]
    want = np.array(jax_mutate.swap_mutate_batched(
        jax_crossover._order_preserving_batched(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(fill)),
        jnp.asarray(mut_u[:, :3]), rate))
    want[:elite] = p1[:elite]
    np.testing.assert_array_equal(got, want)
    assert (ranks[row_of_rank[wr]] < V).all()


# the whole breed against the interpret-mode Pallas kernel ------------------


@pytest.mark.parametrize("P,L", [(256, 40), (300, 24)])
def test_whole_order_breed_equals_interpret_mode_kernel(P, L):
    """Every PRNG bit is 0 in interpret mode: each child is the dedup
    walk of its deme's rank-0 row with zero fallback, swapped at 0 with
    itself, placed by the riffle map, and scored by the fused TSP
    scorer. Genes within 2e-5 (JAX's parent gather); scores within
    rtol 1e-4 / atol 0.5 (JAX's hi/lo coordinates, ~1e-3 each), and
    within rtol 1e-5 of the port's own ``.rows``."""
    coords = classic.random_tsp_coords(L, seed=2)
    ours = classic.make_tsp_coords(coords, duplicate_mode="genes")
    theirs = jax_classic.make_tsp_coords(coords, duplicate_mode="genes")
    with _interpret():
        breed = ps.make_pallas_breed(
            P, L, deme_size=128, crossover_kind="order", mutate_kind="swap",
            fused_tsp=theirs.kernel_gene_major,
        )
    geom = fs.resolve_geometry(P, L, deme_size=128, crossover="order")
    assert breed.fused and (breed.layout, breed.K, breed.D, breed.Pp) == (
        geom.layout, geom.K, geom.D, geom.Pp)
    rng = np.random.default_rng(P + L)
    genomes = np.zeros((geom.Pp, L), np.float32)
    genomes[:P] = _tsp_genomes(P, P, L)
    genomes[:P:5, 1::2] = genomes[:P:5, 0::2]  # every city twice
    scores = rng.permutation(P).astype(np.float32)
    with _interpret():
        g_jax, s_jax = breed(jnp.asarray(genomes[:P]), jnp.asarray(scores), jax.random.key(0))
    g_jax, s_jax = np.asarray(g_jax), np.asarray(s_jax)
    s_pad = np.full(geom.Pp, -np.inf, np.float32)
    s_pad[:P] = scores
    ranks = fs.compute_ranks(torch.from_numpy(s_pad), geom, 0, torch.zeros(geom.Pp, dtype=torch.int64))
    g_port, s_port = fs.deme_breed_reference(
        torch.from_numpy(genomes), ranks, geom, 0,
        fs.zero_draws(geom.G, geom.K, L, "swap", crossover="order"),
        mutate="swap", mparams=torch.tensor([0.01, 0.0]), obj_id=ours.fused_id,
        crossover="order", coords=ours.coords, penalty=ours.penalty,
    )
    np.testing.assert_allclose(g_port.numpy()[:P], g_jax, rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(s_port.numpy()[:P], s_jax, rtol=1e-4, atol=0.5)
    np.testing.assert_allclose(s_port.numpy()[:P], ours.rows(g_port[:P]).numpy(), rtol=1e-5)
    assert torch.isinf(s_port[P:]).all()
    assert (g_port.numpy()[:P] == 0.0).any()  # zero fallback genes were taken


def test_fused_onemax_with_order_crossover_scores_the_child():
    """The order kernel also fuses onemax (JAX: a rowwise objective wins
    over the TSP scorer)."""
    geom = fs.resolve_geometry(256, 20, crossover="order")
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.random((256, 20), dtype=np.float32))
    ranks = fs.compute_ranks(torch.from_numpy(rng.random(256, dtype=np.float32)), geom, 0,
                             torch.zeros(256, dtype=torch.int64))
    seed = torch.tensor([4], dtype=torch.int64)
    out, s = fs.deme_breed(g, ranks, geom, 0, seed=seed, mutate="point", crossover="order",
                           mparams=torch.tensor([0.5, 0.0]), obj_id=classic.FUSED_ONEMAX)
    torch.testing.assert_close(s, out.sum(dim=1), rtol=0, atol=1e-5)


# geometry -----------------------------------------------------------------


@pytest.mark.parametrize("P,L", [(8192, 1000), (1000, 100), (256, 300), (40_000, 100), (4096, 600)])
@pytest.mark.parametrize("fused", [True, False])
def test_order_geometry_equals_jax_kernel_plan(P, L, fused):
    """``resolve_geometry(crossover="order")`` equals JAX's
    ``_kernel_shape`` + ``_resolve_layout`` (``kernel_plan``)."""
    plan = ps.kernel_plan(P, L, crossover_kind="order", mutate_kind="swap", fused=fused)
    geom = fs.resolve_geometry(P, L, crossover="order", fused=fused)
    assert (geom.K, geom.G, geom.D, geom.Pp, geom.layout) == (
        plan["deme_size"], plan["Pp"] // plan["deme_size"], plan["demes_per_step"],
        plan["Pp"], plan["layout"])


def test_order_scratch_lowers_the_deme_and_long_walks_decline():
    assert fs.resolve_geometry(8192, 1000, crossover="order").K == 256
    assert (fs.resolve_geometry(1000, 100, crossover="order").K,
            fs.resolve_geometry(1000, 100, crossover="order").Pp) == (512, 1024)
    # 4096x600: the walk's scratch takes K from 512 to 256
    assert fs.resolve_geometry(4096, 600).K == 512
    assert fs.resolve_geometry(4096, 600, crossover="order").K == 256
    assert ps.kernel_plan(8192, 3000, crossover_kind="order", mutate_kind="swap") is None
    assert fs.resolve_geometry(8192, 3000, crossover="order") is None
    with pytest.raises(ValueError, match="riffle-only"):
        fs.resolve_geometry(8192, 100, crossover="order", layout="pingpong")


# the Philox twin's fill stream ---------------------------------------------


def test_philox_fill_stream_statistics():
    seed = torch.tensor([2024], dtype=torch.int64)
    d = fs.philox_draws(seed, 16, 256, 101, "swap", crossover="order")
    assert d.cross is None and d.fill.shape == (16, 256, 101)
    assert 0.0 <= d.fill.min().item() and d.fill.max().item() < 1.0
    assert abs(d.fill.mean().item() - 0.5) < 0.005
    assert abs(d.fill.var().item() - 1 / 12) < 0.002
    assert abs(torch.corrcoef(torch.stack([d.fill[..., :-1].flatten(), d.fill[..., 1:].flatten()]))[0, 1]) < 0.01
    again = fs.philox_draws(seed, 16, 256, 101, "swap", crossover="order")
    assert torch.equal(d.fill, again.fill) and torch.equal(d.sel_u, again.sel_u)
    other = fs.philox_draws(torch.tensor([2025], dtype=torch.int64), 16, 256, 101, crossover="order")
    assert not torch.equal(d.fill, other.fill)
    # the fill stream is its own: it repeats no other stream's words
    uni = fs.philox_draws(seed, 16, 256, 101, "gaussian")
    for words in (uni.sel_u, uni.mut_u, uni.gauss[0], uni.gauss[2]):
        n = words.shape[-1]
        assert (d.fill[..., :n] == words).float().mean().item() < 1e-3


# routing (the repair) -------------------------------------------------------


def _operators(gp_cfg_jax, gp_cfg_port):
    """(name, (jax crossover, jax mutate), (port crossover, port mutate));
    None leaves the default."""
    return [
        ("none", (None, None), (None, None)),
        ("uniform", (jax_crossover.uniform_crossover, None), (crossover.uniform_crossover, None)),
        ("order", (jax_crossover.order_preserving_crossover, None),
         (crossover.order_preserving_crossover, None)),
        ("point", (None, jax_mutate.make_point_mutate(0.3)), (None, mutate.make_point_mutate(0.3))),
        ("gaussian", (None, jax_mutate.make_gaussian_mutate()), (None, mutate.make_gaussian_mutate())),
        ("swap", (None, jax_mutate.make_swap_mutate(0.3)), (None, mutate.make_swap_mutate(0.3))),
        ("order+swap", (jax_crossover.order_preserving_crossover, jax_mutate.make_swap_mutate(0.5)),
         (crossover.order_preserving_crossover, mutate.make_swap_mutate(0.5))),
        ("gp_subtree", (jax_gp.make_subtree_crossover(gp_cfg_jax), None),
         (port_gp.make_subtree_crossover(gp_cfg_port), None)),
        ("gp_mutate", (None, jax_gp.make_gp_mutate(gp_cfg_jax)),
         (None, port_gp.make_gp_mutate(gp_cfg_port))),
    ]


def test_routing_by_operator_kind_matches_jax():
    """Explicitly set builtin operators keep the deme kernel, as JAX's
    ``_pallas_gate`` does; operators without a kernel kind (GP) take the
    panmictic path. The mutation's runtime [rate, sigma] equal JAX's."""
    gp_j, gp_p = jax_gp.GPConfig(max_nodes=8), port_gp.GPConfig(max_nodes=8)
    for name, (jc, jm), (pc, pm) in _operators(gp_j, gp_p):
        jp = libpga_tpu.PGA(seed=0)
        pp = port.PGA(seed=0, config=CPU)
        if jc is not None:
            jp.set_crossover(jc)
            pp.set_crossover(pc)
        if jm is not None:
            jp.set_mutate(jm)
            pp.set_mutate(pm)
        kinds = jp._crossover_kind() is not None and jp._mutate_kind() is not None
        assert pp.uses_deme_kernel(1024, 16) == kinds, name
        assert (pp._crossover_kind(), pp._mutate_kind()) == (
            jp._crossover_kind(), jp._mutate_kind()), name
        if kinds:
            np.testing.assert_array_equal(
                np.float32(pp._mutate_params()), np.asarray(jp._mutate_params())[0], err_msg=name)
    assert not port.PGA(seed=0, config=port.PGAConfig(device="cpu", use_deme_kernel=False)
                        ).uses_deme_kernel(1024, 16)


# the run on the CPU ---------------------------------------------------------


def _tsp_solver(P, L, objective, seed=0):
    p = port.pga_init(seed, CPU)
    h = port.pga_create_population(p, P, L)
    port.pga_set_objective_function(p, objective)
    port.pga_set_crossover_function(p, crossover.order_preserving_crossover)
    port.pga_set_mutate_function(p, mutate.make_swap_mutate(0.5))
    return p, h


def _distinct(genome):
    return len(set(classic.tsp_cities(torch.as_tensor(genome)[None])[0].tolist()))


def test_tsp_run_on_cpu_goes_through_the_plain_order_breed():
    L = 40
    tsp = classic.make_tsp_coords(classic.random_tsp_coords(L, seed=2), duplicate_mode="genes")
    p, h = _tsp_solver(256, L, tsp)
    assert p.uses_deme_kernel(256, L)
    assert port.pga_run(p, 1) == 1
    best0 = p.get_best_with_score(h)[1]
    before = dict(kernels.LAUNCHES)
    assert port.pga_run(p, 24) == 24
    assert p.launches == 25 and kernels.LAUNCHES == before  # the plain version ran
    assert p.get_best_with_score(h)[1] > best0
    s = p.population(h).scores
    torch.testing.assert_close(s, tsp.rows(p.population(h).genomes), rtol=1e-5, atol=1e-3)


def test_small_tsp_population_takes_the_panmictic_path_and_finds_a_tour():
    """Under 128 rows the panmictic order crossover runs, and the best
    tour visits every city (examples/tsp.py:78)."""
    L = 20
    p, h = _tsp_solver(100, L, classic.make_tsp(classic.random_tsp_matrix(L, seed=7)), seed=5)
    assert not p.uses_deme_kernel(100, L)
    assert port.pga_run(p, 60) == 60 and p.launches == 0
    assert _distinct(port.pga_get_best(p, h)) == L
