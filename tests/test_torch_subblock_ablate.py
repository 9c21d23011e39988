"""The floor harness at a sub-block depth B > 1 and in any combination of
its flags (B10), on the CPU.

(a) JAX's B > 1 kernel does not run in interpret mode under jax 0.9.0
(``tests/test_torch_subblock.py`` says why), so the stage cases at B = 2
are anchored as B8 is: with the same ranks and draws, child (g, k) of the
B = 2 geometry is child (g, k) of the B = 1 geometry that reads the same
cohorts, each placed by its own write map. That B = 1 function is the
ablated plain breed that ``tests/test_torch_ablate.py`` and
``tests/test_torch_ablate_hooks.py`` hold against JAX's interpret-mode
kernels; ``csrc/deme_breed.cu``'s ``deme_pipelined_kernel<Gene,
ABLATE>`` and ``csrc/expr_breed.cu``'s ``expr_breed_kernel<Gene, ABLATE>``
compute the B = 2 function (``tests/test_torch_kernels_cuda.py -k
"pipelined or combo"`` holds them there on a card).

(b) Combinations of the flags other than one alone or all four, held
directly against JAX's ``make_pallas_breed`` / ``make_pallas_multigen(
_ablate=...)`` in interpret mode on zero draws, with the tolerances of
``tests/test_torch_ablate_hooks.py``: genes within GENE_ATOL = 1e-5
(order crossover 2e-5: JAX gathers parents with a bf16 hi/lo one-hot
matmul), fused scores within L * GENE_ATOL (the coordinate TSP rtol
1e-4, atol 0.5)."""

import numpy as np
import pytest
import torch

from libpga_tpu_torch.objectives import onemax
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
from test_torch_ablate_hooks import (
    COPY, GENE_ATOL, K, L, ORDER_ATOL, _assert_breed, _breed_both, _multigen_both,
)

CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
STAGES = ("sel_const", "no_matmul", "no_cross", "no_mut")
# Each stage flag alone, the floor and two combinations.
B2_CASES = [(f,) for f in STAGES] + [STAGES, ("sel_const", "no_cross"), ("no_cross", "no_mut")]


def _kinds(hooks):
    """The breed keywords of a hook set: the builtin uniform crossover and
    point mutation, or the creep mutation expression."""
    if hooks == "creep":
        return dict(mutate=mutate_from_expression(CREEP, rate=0.3, sigma=0.1),
                    mparams=torch.tensor([0.3, 0.1]), obj_id=onemax.fused_id)
    return dict(mutate="point", mparams=torch.tensor([0.3, 0.0]), obj_id=onemax.fused_id)


@pytest.mark.parametrize("ablate", B2_CASES, ids="+".join)
@pytest.mark.parametrize("hooks", ["builtin", "creep"])
def test_b2_ablated_children_are_the_b1_function_on_mapped_rows(hooks, ablate):
    """At B = 2 every ablated child is the B = 1 ablated breed's child of
    the same cohort slot, with the same ranks and Philox draws, placed by
    the B = 2 write map; the fused scores travel with them. The maps are
    those of JAX's B = 2 geometry where D halves and the group width stays
    (4,096 rows, K=128, q=16, D 4 -> 2), so both parities read the B = 1
    cohorts and write other rows."""
    Pp, Lg = 4096, 24
    g1 = fs.Geometry("pingpong", Pp, Lg, K, Pp // K, 4, Pp, 16, 1)
    g2 = fs.Geometry("pingpong", Pp, Lg, K, Pp // K, 2, Pp, 16, 2)
    rng = np.random.default_rng(len(ablate))
    g = torch.from_numpy(rng.random((Pp, Lg), dtype=np.float32))
    s = g.sum(dim=1)
    kw = dict(_kinds(hooks), tournament_size=3, ablate=ablate)
    for parity in (0, 1):
        read1, write1 = g1.row_maps(parity, "cpu")
        read2, write2 = g2.row_maps(parity, "cpu")
        assert torch.equal(read1, read2) and not torch.equal(write1, write2)
        ranks = fs.compute_ranks(s, g1, parity, torch.from_numpy(rng.integers(0, 2**31, Pp)))
        seed = torch.tensor([17 + parity])
        a, sa = fs.deme_breed(g, ranks, g1, parity, seed=seed, **kw)
        b, sb = fs.deme_breed(g, ranks, g2, parity, seed=seed, **kw)
        assert torch.equal(a[write1.reshape(-1)], b[write2.reshape(-1)])
        assert torch.equal(sa[write1.reshape(-1)], sb[write2.reshape(-1)])
        full, _ = fs.deme_breed(g, ranks, g2, parity, seed=seed, **{**kw, "ablate": ()})
        assert not torch.equal(full, b)  # each case removes something


@pytest.mark.parametrize("ablate", [("no_mut",), STAGES], ids="+".join)
def test_b2_bf16_ablated_children_follow_the_maps_in_both_parities(ablate):
    """The same at bf16, JAX's geometry of these maps (q=16, D 4 -> 2):
    the children stay bf16."""
    Pp, Lg = 4096, 24
    g1 = fs.Geometry("pingpong", Pp, Lg, K, Pp // K, 4, Pp, 16, 1)
    g2 = fs.Geometry("pingpong", Pp, Lg, K, Pp // K, 2, Pp, 16, 2)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(rng.random((Pp, Lg), dtype=np.float32)).to(torch.bfloat16)
    s = g.float().sum(dim=1)
    kw = dict(_kinds("builtin"), ablate=ablate)
    for parity in (0, 1):
        read1, write1 = g1.row_maps(parity, "cpu")
        read2, write2 = g2.row_maps(parity, "cpu")
        assert torch.equal(read1, read2)
        ranks = fs.compute_ranks(s, g1, parity, torch.from_numpy(rng.integers(0, 2**31, Pp)))
        seed = torch.tensor([parity + 5])
        a, sa = fs.deme_breed(g, ranks, g1, parity, seed=seed, **kw)
        b, sb = fs.deme_breed(g, ranks, g2, parity, seed=seed, **kw)
        assert b.dtype == torch.bfloat16
        assert torch.equal(a[write1.reshape(-1)], b[write2.reshape(-1)])
        assert torch.equal(sa[write1.reshape(-1)], sb[write2.reshape(-1)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_b2_unscored_floor_is_one_index_select_of_the_rows(dtype):
    """With every stage flag and no objective, child (g, k) at B = 2 is
    slot k's staged row: the breed is the row permutation out[write] =
    g[read], which one ``torch.index_select`` computes (the library call
    ``chip_smoke.py`` times beside the pipelined kernel's floor)."""
    Pp, Lg = 4096, 24
    geom = fs.Geometry("pingpong", Pp, Lg, K, Pp // K, 2, Pp, 16, 2)
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.random((Pp, Lg), dtype=np.float32)).to(dtype)
    kw = dict(_kinds("builtin"), ablate=STAGES, obj_id=fs.FUSED_NONE)
    for parity in (0, 1):
        ranks = fs.compute_ranks(g.float().sum(dim=1), geom, parity,
                                 torch.from_numpy(rng.integers(0, 2**31, Pp)))
        out, scores = fs.deme_breed(g, ranks, geom, parity, seed=torch.tensor([parity]), **kw)
        read, write = geom.row_maps(parity, "cpu")
        rows = torch.empty(Pp, dtype=torch.long)
        rows[write.reshape(-1)] = read.reshape(-1)
        assert scores is None and torch.equal(out, torch.index_select(g, 0, rows))


@pytest.mark.parametrize("hooks", ["builtin", "creep"])
def test_factory_at_b2_breeds_the_ablated_plain_function(hooks):
    """``make_fused_breed(ablate=..., subblock=2)`` resolves the B = 2
    geometry, keeps the flags and breeds the plain B-aware function from
    its generator; ``copy_only`` with a stage flag is the copy (at B = 1,
    as every layout flag pins the riffle)."""
    P, Lg = 16_384, 16
    kinds = _kinds(hooks)
    mut, mp = kinds["mutate"], tuple(kinds["mparams"].tolist())
    ablate = ("sel_const", "no_cross")
    breed = fs.make_fused_breed(P, Lg, onemax, mutate=mut, mparams=mp, ablate=ablate,
                                subblock=2, device="cpu")
    geom = breed.geom
    assert (geom.layout, geom.B, geom.D) == ("pingpong", 2, 8)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.random((geom.Pp, Lg), dtype=np.float32))
    s = g.sum(dim=1)
    gen = torch.Generator().manual_seed(8)
    twin = torch.Generator().set_state(gen.get_state())
    got = breed(g, s, 0, gen)
    ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(twin, geom.Pp, "cpu"))
    seed = torch.randint(0, 2**63 - 1, (1,), generator=twin)
    want = fs.deme_breed_reference(g, ranks, geom, 0, fs.philox_draws(seed, geom.G, geom.K, Lg,
                                                                      mut), **breed.kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # sel_const with no_cross: child k is slot k's row, then mutated.
    read, write = geom.row_maps(0, "cpu")
    if hooks == "builtin":
        same = (got[0][write.reshape(-1)] == g[read.reshape(-1)]).all(dim=1)
        assert 0.5 < float(same.float().mean()) < 1.0  # rate 0.3: some rows mutated
    copy = fs.make_fused_breed(P, Lg, onemax, mutate=mut, mparams=mp, subblock=2,
                               ablate=("copy_only", "no_rank_sort", "no_mut"), device="cpu")
    assert copy.geom.B == 1 and "demes_per_block" in copy.kw
    out, scores = copy(g, s, 0, None)
    read, write = copy.geom.row_maps(0, "cpu")
    assert torch.equal(out[write.reshape(-1)], g[read.reshape(-1)])


# ------------------------------------------------ combinations against JAX


@pytest.mark.parametrize("ablate,layout", [
    (("sel_const", "no_cross"), "riffle"), (("no_cross", "no_mut"), "riffle"),
    (("no_matmul", "no_mut"), None), (("sel_const", "no_matmul", "no_cross"), None),
], ids=lambda v: "+".join(v) if isinstance(v, tuple) else str(v))
def test_one_generation_combination_equals_jax_interpret(ablate, layout):
    """deme_breed_kernel's combinations, on the riffle and on ping-pong
    (layout None: the fused breed's own), against JAX's interpret kernel
    on zero draws."""
    geom, g, want, got = _breed_both("builtin", ablate, layout=layout)
    assert geom.layout == (layout or "pingpong")
    _assert_breed("builtin", want, got)
    mutated = (got[0][:, 0] == 0.0).all()  # zero draws: point mutation sets gene 0
    assert mutated == ("no_mut" not in ablate)


def test_order_combination_equals_jax_interpret():
    """order_breed_kernel with no_matmul and no_mut: the walk of slot k's
    row with itself, unmutated, scored by the fused TSP."""
    geom, g, want, got = _breed_both("order_swap", ("no_matmul", "no_mut"))
    _assert_breed("order_swap", want, got)
    # Deme 1 holds permutations (no duplicate city): its slot 5 walked
    # with itself is itself.
    np.testing.assert_allclose(got[0][5 * geom.G + 1], g[1 * K + 5], rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("hooks,ablate,target,elitism", [
    ("builtin", ("no_freeze", "no_rank_cube"), 0.0, 0),
    ("order_onemax", ("no_freeze", "no_cross"), 0.0, 0),
    ("builtin", ("sel_const", "no_mut"), None, 2),
    ("builtin", ("no_rank_cube", "no_cross", "no_mut"), None, 0),
], ids=lambda v: "+".join(v) if isinstance(v, tuple) else str(v))
def test_multigen_combination_equals_jax_interpret(hooks, ablate, target, elitism):
    """multigen_breed_kernel<false> and <true>'s combinations at T = 2
    against JAX's interpret kernel on zero draws (no_freeze under a target
    every group has reached, so its groups breed where production would
    freeze them; sel_const with elitism: the elites are crossed and left
    unmutated, C7)."""
    geom, g, want, got = _multigen_both(hooks, ablate, target=target, elitism=elitism)
    atol = ORDER_ATOL if hooks.startswith("order") else GENE_ATOL
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=L * GENE_ATOL)


def test_copy_with_a_stage_flag_is_the_copy_in_both_packages():
    """copy_only with no_mut (or all four stage flags) is JAX's copy: its
    copy branch returns before any stage runs. Bit for bit."""
    _, g, want, got = _breed_both("builtin", COPY + ("no_mut",))
    _, _, want_all, got_all = _breed_both("builtin", COPY + STAGES)
    _, _, copy, _ = _breed_both("builtin", COPY)
    for w, p in ((want, got), (want_all, got_all)):
        np.testing.assert_array_equal(p[0], w[0])
        np.testing.assert_array_equal(p[1], w[1])
        np.testing.assert_array_equal(w[0], copy[0])


@pytest.mark.parametrize("hooks", ["builtin", "creep"])
def test_stage_harness_at_subblock_with_combos_runs_at_a_small_shape(hooks):
    """``ablate_kernel --subblock 2 --combo ...``'s runners on the plain
    versions (16,384x16, K=128): every variant but the copy breeds on the
    B = 2 ping-pong geometry, unscored ones included; the combinations
    are variants of their own."""
    from libpga_tpu_torch.tools import ablate_kernel as ak

    combos = [("sel_const", "no_cross"), ("copy_only", "no_mut")]
    runners = ak.build_runners(hooks, torch.float32, K, 16_384, 16, device="cpu", subblock=2,
                               combos=combos)
    assert list(runners)[-2:] == ["sel_const+no_cross", "copy_only+no_mut"]
    for label, run in runners.items():
        copy = label.startswith("copy")
        assert (run.geom.layout, run.geom.B) == (("riffle", 1) if copy else ("pingpong", 2))
        run(1)
