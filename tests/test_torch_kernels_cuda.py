"""The CUDA kernels (libpga_tpu_torch/csrc/deme_breed.cu: its uniform,
order and multi-generation breeds; expr_breed.cu with generated hooks;
each breed also with an island grid axis; and gp_eval.cu) against their plain
torch versions, on the card. These tests skip on a
machine without one. They import neither JAX nor the JAX package, so
they run where only torch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import math
from typing import Optional

import numpy as np
import pytest
import torch

from libpga_tpu_torch.gp import encoding as enc
from libpga_tpu_torch.gp.encoding import GPConfig
from libpga_tpu_torch.gp.optimize import optimize_for_eval
from libpga_tpu_torch.objectives import (
    ackley, make_tsp_coords, onemax, onemax_bits, random_tsp_coords, rastrigin, sphere,
)
from libpga_tpu_torch.ops import expr_cuda
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels
from libpga_tpu_torch.ops.gp_eval import gp_eval_reference, make_gp_eval


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _deme_key(geom, dtype=torch.float32, islands=False, ablate=False):
    """The LAUNCHES name of a builtin one-generation breed at ``geom``:
    deme_pipelined_kernel's wherever a cluster holds the deme
    (kernels.pipelined_holds, at any B), else deme_breed_kernel's."""
    if kernels.pipelined_holds(geom, dtype):
        key = ("ablate_pipelined" if ablate else "islands_deme_pipelined" if islands
               else "deme_pipelined")
    else:
        key = "ablate_breed" if ablate else "islands" if islands else geom.layout
    return key + ("_bf16" if dtype == torch.bfloat16 else "")


# (P, L, layout, selection, selection_param, k, mutate, objective, gene_atol)
# gene_atol is 0 (exact) except for gaussian mutation, whose log and cos
# may differ in the last ulp between the kernel and torch's own kernels.
VARIANTS = [
    (8192, 100, None, "tournament", None, 2, "point", onemax, 0.0),
    (1000, 100, None, "tournament", None, 2, "point", onemax, 0.0),
    (2100, 100, None, "tournament", None, 4, "swap", onemax_bits, 0.0),
    (1000, 300, "riffle", "truncation", 0.3, 2, "point", None, 0.0),
    (1000, 20, None, "linear_rank", 1.7, 3, "gaussian", onemax, 1e-6),
    (256, 3968, None, "tournament", None, 3, "point", onemax, 0.0),
    (8192, 100, None, "tournament", None, 2, "point", sphere, 0.0),
    (1000, 30, None, "tournament", None, 2, "swap", rastrigin, 0.0),
    (2100, 100, None, "truncation", 0.3, 2, "point", ackley, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: f"{v[0]}x{v[1]}-{v[3]}-{v[6]}")
def test_kernel_equals_plain_on_card(cuda_device, variant):
    """The kernel equals its plain version on the same inputs, in
    production (Philox) and injected mode, every parity of the layout."""
    P, L, layout, sel, param, k, mutate, obj, atol = variant
    geom = fs.resolve_geometry(
        P, L, layout=layout, tournament_size=k, selection=sel,
        selection_param=param, fused=obj is not None,
    )
    gen = torch.Generator(device=cuda_device).manual_seed(P + L)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.rand(geom.Pp, generator=gen, device=cuda_device)
    s[P:] = -torch.inf
    kw = dict(tournament_size=k, selection=sel, selection_param=param,
              mutate=mutate, mparams=torch.tensor([0.3, 0.05], device=cuda_device),
              obj_id=0 if obj is None else obj.fused_id)
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        draws = fs.philox_draws(seed, geom.G, geom.K, L, mutate)
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        for got in (fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw),
                    fs.deme_breed(g, ranks, geom, parity, draws=draws, **kw)):
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=atol)
            if obj is None:
                assert got[1] is None and want[1] is None
            else:
                # float32 sums in another order: 1e-3 absolute on
                # onemax's sums; 1e-5 relative besides only on the
                # wider-ranged sphere, rastrigin and ackley
                rtol = 0 if obj in (onemax, onemax_bits) else 1e-5
                torch.testing.assert_close(got[1], want[1], rtol=rtol, atol=1e-3)


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda_device):
    geom = fs.resolve_geometry(1000, 20)
    g = torch.rand((geom.Pp, 20), device=cuda_device)
    ranks = torch.zeros((geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    mp = torch.tensor([0.01, 0.0], device=cuda_device)
    with pytest.raises(ValueError, match="ranks"):
        fs.deme_breed(g, ranks.long(), geom, 0, seed=seed, mparams=mp)
    with pytest.raises(ValueError, match="alias"):
        fs.deme_breed(g, ranks, geom, 0, seed=seed, mparams=mp, out=g)
    with pytest.raises(ValueError, match="genomes"):
        fs.deme_breed(g[:, :10].contiguous(), ranks, geom, 0, seed=seed, mparams=mp)
    key = _deme_key(geom)
    before = kernels.LAUNCHES[key]
    fs.deme_breed(g, ranks, geom, 0, seed=seed, mparams=mp)
    assert kernels.LAUNCHES[key] == before + 1


@pytest.mark.cuda
def test_engine_on_card_counts_one_launch_per_generation(cuda_device):
    from libpga_tpu_torch import pga_create_population, pga_init, pga_run
    from libpga_tpu_torch import pga_set_objective_function

    p = pga_init(0)
    pga_create_population(p, 40_000, 100)
    pga_set_objective_function(p, "onemax")
    kernels.reset_launches()
    assert pga_run(p, 12) == 12
    torch.cuda.synchronize()
    key = _deme_key(fs.resolve_geometry(40_000, 100))
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), key: 12}


# ------------------------------------------------------------ order breed

# (P, L, C, selection, selection_param, k, mutate, objective): objective
# "tsp" is the fused coordinate TSP over C cities (C != L exercises the
# clamped lookup), "onemax" the fused onemax, None unfused. P=1000 pads.
ORDER_VARIANTS = [
    (8192, 1000, 1000, "tournament", None, 2, "swap", "tsp"),
    (1000, 100, 100, "tournament", None, 2, "swap", None),
    (1000, 100, 60, "truncation", 0.3, 3, "swap", "tsp"),
    (300, 40, 40, "linear_rank", 1.7, 2, "point", "onemax"),
    (256, 130, 200, "tournament", None, 4, "gaussian", "tsp"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ORDER_VARIANTS, ids=lambda v: f"{v[0]}x{v[1]}-{v[6]}-{v[7]}")
def test_order_kernel_equals_plain_on_card(cuda_device, variant):
    """The order kernel equals its plain version on the same inputs, in
    production (Philox) and injected mode: genomes exactly (gaussian
    within 1e-6: log and cos may differ in the last ulp), TSP scores
    within rtol 1e-5 (both sum the edges in l order), -inf on pad rows."""
    P, L, C, sel, param, k, mutate, obj = variant
    geom = fs.resolve_geometry(P, L, tournament_size=k, selection=sel,
                               selection_param=param, crossover="order")
    gen = torch.Generator(device=cuda_device).manual_seed(P + L)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    g[P:] = 0.0
    s = torch.rand(geom.Pp, generator=gen, device=cuda_device)
    s[P:] = -torch.inf
    kw = dict(tournament_size=k, selection=sel, selection_param=param, mutate=mutate,
              mparams=torch.tensor([0.5, 0.05], device=cuda_device), crossover="order")
    if obj == "tsp":
        tsp = make_tsp_coords(random_tsp_coords(C, seed=2), duplicate_mode="genes")
        kw.update(obj_id=tsp.fused_id, coords=tsp.coords.to(cuda_device), penalty=tsp.penalty)
    elif obj == "onemax":
        kw.update(obj_id=onemax.fused_id)
    ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(gen, geom.Pp, cuda_device))
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
    draws = fs.philox_draws(seed, geom.G, geom.K, L, mutate, crossover="order")
    want = fs.deme_breed_reference(g, ranks, geom, 0, draws, **kw)
    before = kernels.LAUNCHES["order"]
    for got in (fs.deme_breed(g, ranks, geom, 0, seed=seed, **kw),
                fs.deme_breed(g, ranks, geom, 0, draws=draws, **kw)):
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6 if mutate == "gaussian" else 0.0)
        if obj is None:
            assert got[1] is None and want[1] is None
            continue
        assert torch.equal(torch.isinf(got[1]), torch.isinf(want[1]))
        assert bool(torch.isinf(got[1][P:]).all()) and bool(torch.isfinite(got[1][:P]).all())
        tol = dict(rtol=1e-5, atol=0.0) if obj == "tsp" else dict(rtol=0.0, atol=1e-3)
        torch.testing.assert_close(got[1][:P], want[1][:P], **tol)
    assert kernels.LAUNCHES["order"] == before + 2


@pytest.mark.cuda
def test_order_kernel_rejects_bad_arguments(cuda_device):
    geom = fs.resolve_geometry(1000, 100, crossover="order")
    g = torch.rand((geom.Pp, 100), device=cuda_device)
    ranks = torch.zeros((geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    kw = dict(mparams=torch.tensor([0.5, 0.0], device=cuda_device), crossover="order")
    with pytest.raises(ValueError, match="coords"):
        fs.deme_breed(g, ranks, geom, 0, seed=seed, obj_id=3, **kw)
    with pytest.raises(ValueError, match="fill"):
        fs.deme_breed(g, ranks, geom, 0, draws=fs.zero_draws(
            geom.G, geom.K, 100, device=cuda_device), **kw)
    with pytest.raises(ValueError, match="riffle"):
        kernels.order_breed_cuda(g[:1024], ranks[:, :512].contiguous(),
                                 fs.resolve_geometry(1024, 100), 0, seed=seed, **kw)


@pytest.mark.cuda
def test_tsp_run_on_card_launches_the_order_kernel(cuda_device):
    from libpga_tpu_torch import (pga_create_population, pga_init, pga_run,
                                  pga_set_crossover_function, pga_set_mutate_function,
                                  pga_set_objective_function)
    from libpga_tpu_torch.ops.crossover import order_preserving_crossover
    from libpga_tpu_torch.ops.mutate import make_swap_mutate

    p = pga_init(0)
    h = pga_create_population(p, 2048, 200)
    tsp = make_tsp_coords(random_tsp_coords(200, seed=2), duplicate_mode="genes")
    pga_set_objective_function(p, tsp)
    pga_set_crossover_function(p, order_preserving_crossover)
    pga_set_mutate_function(p, make_swap_mutate(0.5))
    kernels.reset_launches()
    assert pga_run(p, 10) == 10
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["order"] == 10 and sum(kernels.LAUNCHES.values()) == 10
    torch.testing.assert_close(p.population(h).scores, tsp.rows(p.population(h).genomes),
                               rtol=1e-5, atol=1e-3)


# --------------------------------------------------------- multigen breed

# (P, L, layout, demes_per_step, steps, elitism, selection, param, k, mutate,
#  objective, target, exact): ``exact`` holds genomes and scores equal to
# the plain version bit for bit after every step (the plain version sums
# scores in the kernel's order); otherwise genomes within 1e-6 and scores
# within rtol 1e-5 at one step, because the card's cosf/logf/expf may
# differ from torch's in the last bit.
MULTIGEN_VARIANTS = [
    (8192, 100, None, None, 0, 0, "tournament", None, 2, "point", onemax, None, True),
    (8192, 100, None, None, 1, 0, "tournament", None, 2, "point", onemax, None, True),
    (8192, 100, None, None, 5, 0, "tournament", None, 2, "point", onemax, None, True),
    (8192, 100, "riffle", None, 4, 2, "tournament", None, 3, "point", onemax, None, True),
    (40_000, 100, None, None, 3, 0, "tournament", None, 2, "point", onemax, 58.0, True),
    (1000, 100, None, None, 3, 0, "tournament", None, 2, "swap", onemax, None, True),
    (1000, 100, None, None, 3, 2, "linear_rank", 1.7, 2, "point", onemax_bits, None, True),
    (1000, 20, None, 2, 4, 0, "truncation", 0.3, 2, "point", onemax_bits, 14.0, True),
    (2100, 300, None, None, 2, 0, "tournament", None, 4, "swap", sphere, None, True),
    (4096, 30, None, None, 1, 0, "tournament", None, 2, "point", rastrigin, None, False),
    (4096, 30, None, None, 1, 0, "tournament", None, 2, "point", ackley, None, False),
    (1000, 20, None, None, 1, 0, "tournament", None, 2, "gaussian", onemax, None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "variant", MULTIGEN_VARIANTS,
    ids=lambda v: f"{v[0]}x{v[1]}-{v[2]}-steps{v[4]}-e{v[5]}-{v[9]}-{v[10].__name__}")
def test_multigen_kernel_equals_plain_on_card(cuda_device, variant):
    """The multi-generation kernel equals its plain version on the same
    inputs, in production (Philox) and injected mode, every parity."""
    P, L, layout, dps, steps, e, sel, param, k, mutate, obj, target, exact = variant
    geom = fs.resolve_geometry(
        P, L, layout=layout, demes_per_step=dps, tournament_size=k, selection=sel,
        selection_param=param, multigen=True, elitism=e)
    gen = torch.Generator(device=cuda_device).manual_seed(P + L + steps)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.full((geom.Pp,), -torch.inf, device=cuda_device)
    s[:P] = obj(g[:P])
    kw = dict(tournament_size=k, selection=sel, selection_param=param, mutate=mutate,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device),
              obj_id=obj.fused_id, elitism=e)
    G, K, T = geom.G, geom.K, max(steps, 1)
    injected = fs.Draws(
        sel_u=torch.rand((T, G, K, 2), generator=gen, device=cuda_device),
        cross=(torch.rand((T, G, K, L), generator=gen, device=cuda_device) < 0.5).to(torch.uint8),
        mut_u=torch.rand((T, G, K, 4), generator=gen, device=cuda_device),
        gauss=(torch.rand((T, 3, G, K, L), generator=gen, device=cuda_device)
               if mutate == "gaussian" else None),
        tie=torch.randint(0, 2**32, (T, G, K), generator=gen, device=cuda_device),
    )
    for parity in range(geom.parities):
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        for mode in (dict(seed=seed), dict(draws=injected)):
            before = kernels.LAUNCHES["multigen"]
            got = fs.multigen_breed(g, s, geom, parity, steps, target, **mode, **kw)
            assert kernels.LAUNCHES["multigen"] == before + 1
            want = fs.multigen_breed_reference(g, s, geom, parity, steps,
                                               float("inf") if target is None else target,
                                               **mode, **kw)
            torch.cuda.synchronize()
            # (a frozen padded ping-pong group carries a pad's -inf to the
            # real row its slot is written to, in JAX too)
            assert bool(torch.isinf(got[1][P:]).all())
            assert torch.equal(torch.isinf(got[1]), torch.isinf(want[1]))
            if exact:
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
            else:
                torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
                torch.testing.assert_close(got[1][:P], want[1][:P], rtol=1e-5, atol=1e-5)
    assert steps == 0 or not torch.equal(got[0], g)


@pytest.mark.cuda
@pytest.mark.parametrize("P,L,K,steps", [(4096, 64, 512, 20), (1280, 130, 128, 12)])
def test_multigen_kernel_deme_sizes_and_many_steps(cuda_device, P, L, K, steps):
    """The multigen geometry's largest and smallest deme (its VMEM model
    admits no K = 1,024), many steps, a genome of two Philox tiles: equal to
    the plain version bit for bit, and the population improves."""
    geom = fs.resolve_geometry(P, L, deme_size=K, multigen=True, elitism=3)
    assert geom.K == K
    gen = torch.Generator(device=cuda_device).manual_seed(K)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.full((geom.Pp,), -torch.inf, device=cuda_device)
    s[:P] = onemax(g[:P])
    kw = dict(seed=torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device),
              mparams=torch.tensor([0.05, 0.0], device=cuda_device), obj_id=onemax.fused_id,
              elitism=3, tournament_size=4)
    for parity in range(geom.parities):
        got = fs.multigen_breed(g, s, geom, parity, steps, None, **kw)
        want = fs.multigen_breed_reference(g, s, geom, parity, steps, float("inf"), **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert float(got[1][:P].mean()) > float(s[:P].mean()) + 0.1 * L


@pytest.mark.cuda
def test_multigen_kernel_rejects_bad_arguments(cuda_device):
    geom = fs.resolve_geometry(1000, 20, multigen=True)
    g = torch.rand((geom.Pp, 20), device=cuda_device)
    s = g.sum(dim=1)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    kw = dict(seed=seed, mparams=torch.tensor([0.01, 0.0], device=cuda_device), obj_id=1)
    with pytest.raises(ValueError, match="alias"):
        fs.multigen_breed(g, s, geom, 0, 2, out=g, **kw)
    with pytest.raises(ValueError, match="work"):  # the one-block schedule's buffers
        fs.multigen_breed(g, s, geom, 0, 3, work=[g], cluster=False, **kw)
    with pytest.raises(ValueError, match="scores"):
        fs.multigen_breed(g, s[:100].contiguous(), geom, 0, 2, **kw)
    with pytest.raises(ValueError, match="rowwise"):
        fs.multigen_breed(g, s, geom, 0, 2, **{**kw, "obj_id": 3})
    draws = fs.zero_draws(geom.G, geom.K, 20, device=cuda_device, steps=1)
    draws.tie = None
    with pytest.raises(ValueError, match="tie"):
        fs.multigen_breed(g, s, geom, 0, 1, mparams=kw["mparams"], obj_id=1, draws=draws)
    with pytest.raises(ValueError, match="sub-generations"):
        fs.multigen_breed(g, s, geom, 0, 2, mparams=kw["mparams"], obj_id=1,
                          draws=fs.zero_draws(geom.G, geom.K, 20, device=cuda_device, steps=1))


@pytest.mark.cuda
def test_engine_on_card_counts_one_launch_per_chunk(cuda_device):
    from libpga_tpu_torch import PGAConfig, pga_create_population, pga_init, pga_run
    from libpga_tpu_torch import pga_set_objective_function

    p = pga_init(0, PGAConfig(generations_per_launch=8))
    h = pga_create_population(p, 40_000, 100)
    pga_set_objective_function(p, "onemax")
    start = float(p.population(h).genomes.sum(dim=1).max())
    kernels.reset_launches()
    assert pga_run(p, 27) == 27
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["multigen"] == 4 and sum(kernels.LAUNCHES.values()) == 4
    assert p.launches == 4
    pop = p.population(h)
    torch.testing.assert_close(pop.scores, pop.genomes.sum(dim=1), rtol=1e-5, atol=1e-3)
    assert float(pop.scores.max()) > start + 3.0
    kernels.reset_launches()
    best = float(pop.scores.max())
    assert best < 98.0
    gens = pga_run(p, 10_000, target=98.0)
    torch.cuda.synchronize()
    assert 0 < gens < 10_000 and gens % 8 == 0
    assert float(p.population(h).scores.max()) >= 98.0
    assert kernels.LAUNCHES["multigen"] == gens // 8 + 1  # one launch dropped by the stop


# ---------------------------------------------------------------- gp_eval

EXP_GP = GPConfig(max_nodes=8, n_vars=1, unary=("exp", "log", "sqrt"),
                  binary=("mul", "add", "min", "max"))


def _gp_case(name, device):
    """(gp, genomes, X, y) with numpy inputs from a seed: well-formed
    programs, uniform-noise genes (the skip rule), or exp chains over
    large inputs (the -inf path)."""
    rng = np.random.default_rng(len(name))
    if name == "overflow":
        gp = EXP_GP
        X = rng.uniform(-60, 90, (70, 1)).astype(np.float32)
        g = rng.uniform(0, 1, (500, gp.genome_len)).astype(np.float32)
        g[:50] = enc.encode_program([("var", 0), "exp", "exp"], gp)
    else:
        gp = GPConfig(max_nodes=16, n_vars=2)
        X = rng.uniform(-1, 1, (100, 2)).astype(np.float32)
        if name == "noise":
            g = rng.uniform(0, 1, (1000, gp.genome_len)).astype(np.float32)
        else:
            rand = rng.uniform(0, 1, (1000, enc.grow_rand_cols(gp))).astype(np.float32)
            g = enc.random_program_genes(torch.from_numpy(rand), gp).numpy()
    y = (X[:, 0] * X[:, -1] + X[:, 0]).astype(np.float32)
    return gp, torch.from_numpy(g).to(device), X, y


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["well_formed", "noise", "overflow"])
@pytest.mark.parametrize("knobs", [{}, {"stack_depth": 32, "opcode_block": 4}])
@pytest.mark.parametrize("optimize", [True, False])
def test_gp_eval_kernel_equals_plain_on_card(cuda_device, case, knobs, optimize):
    """B2 (compacted programs) and B2' (raw genomes, static trips) equal
    the plain version within rtol = atol = 1e-5 (the sums over samples
    run in another order); -inf exactly where the plain version has it."""
    gp, g, X, y = _gp_case(case, cuda_device)
    for B in (y.shape[0], 20):  # ragged warps; several programs per block
        fn = make_gp_eval(gp, X[:B], y[:B], optimize=optimize, **knobs)
        mode = "gp_eval_opt" if optimize else "gp_eval_static"
        before = kernels.LAUNCHES[mode]
        got = fn(g)
        assert kernels.LAUNCHES[mode] == before + 1
        xt = torch.from_numpy(np.ascontiguousarray(X[:B].T)).to(cuda_device)
        m = optimize_for_eval(g, gp) if optimize else g
        want = gp_eval_reference(m, xt, torch.from_numpy(y[:B]).to(cuda_device), gp, **knobs)
        torch.cuda.synchronize()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)
        if case == "overflow":
            assert bool(torch.isinf(got[:50]).all())


@pytest.mark.cuda
def test_gp_eval_kernel_rejects_bad_arguments(cuda_device):
    gp = GPConfig(max_nodes=8, n_vars=2)
    X = np.zeros((10, 2), np.float32)
    fn = make_gp_eval(gp, X, np.zeros(10, np.float32), optimize=False)
    with pytest.raises(ValueError, match="genomes"):
        fn(torch.zeros((4, 10), device=cuda_device))


# ------------------------------------------------------- expression breed


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 units in the last place between ``a`` and ``b``."""
    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(2**31) - i, i)

    return (key(a) - key(b)).abs()


def _expr_case(name):
    """(crossover, mutate, objective, obj_id) of an expression case."""
    from libpga_tpu_torch import objectives as po
    from libpga_tpu_torch.ops import breed_expr as bx

    creep = bx.mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05, sigma=0.1)
    one_point = bx.crossover_from_expression("where(i < floor(q * L), p1, p2)")
    arith = bx.crossover_from_expression("r * p1 + (1 - r) * p2")
    return {
        "nk": ("uniform", "point", po.make_nk_landscape(64, 3, seed=0).expr_fused, 0),
        "trap": ("uniform", "point", po.make_deceptive_trap(5).expr_fused, 0),
        "knapsack": ("uniform", "gaussian", po.default_knapsack.expr_fused, 0),
        "one_point+creep": (one_point, creep, None, onemax.fused_id),
        "arithmetic+swap": (arith, "swap", None, onemax_bits.fused_id),
        "uniform+creep+sin": ("uniform", creep, po.from_expression("sum(sin(g * 3)) + max(g)"), 0),
        "all+unscored": (arith, bx.mutate_from_expression("where(q2 < 0.5, g, r)"), None, 0),
        "swap+nk": ("uniform", "swap", po.make_nk_landscape(64, 3, seed=0).expr_fused, 0),
        "gaussian+trap": ("uniform", "gaussian", po.make_deceptive_trap(5).expr_fused, 0),
        "point+rolled": (one_point, "point", po.from_expression(
            "a = roll(g, -3); x = max(a) - min(g);"
            " sum(where(g < 0.3, a % 0.25, round(g*4.5))) + mean(g*g) * x + dot(i, g) / L"), 0),
    }[name]


def _expr_counter(cross, mut, objective, geom, dtype=torch.float32, base="expr"):
    """The counter a one-generation expression breed counts under:
    ``base``'s "expr_pipelined" twin where ``kernels.expr_breed_cuda``
    routes the shape to ``expr_pipelined_kernel``, else ``base``."""
    from libpga_tpu_torch.ops import expr_cuda

    program = expr_cuda.program_for(cross if fs.is_expression(cross) else None,
                                    mut if fs.is_expression(mut) else None, objective)
    mut_id = 0 if fs.is_expression(mut) else kernels.MUTATE_IDS[mut]
    if kernels.expr_pipelined_holds(program, geom, dtype, mut_id):
        return base.replace("expr", "expr_pipelined", 1)
    return base


EXPR_VARIANTS = [
    # (case, P, L, layout)
    ("nk", 4096, 64, None),
    ("nk", 1000, 64, "riffle"),
    ("trap", 4096, 60, None),
    ("knapsack", 1000, 6, None),
    ("one_point+creep", 8192, 100, None),
    ("one_point+creep", 1000, 100, "riffle"),
    ("arithmetic+swap", 2100, 130, None),
    ("uniform+creep+sin", 4096, 40, None),
    ("all+unscored", 1000, 20, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", EXPR_VARIANTS, ids=lambda v: f"{v[0]}-{v[1]}x{v[2]}-{v[3]}")
def test_expr_kernel_equals_plain_on_card(cuda_device, variant):
    """The generated expression kernel equals its plain version on the
    same inputs, in production (Philox) and injected mode, every parity
    of the layout: genomes exactly (within 2 ulp where a hook calls a
    transcendental or ``**``), scores within rtol 1e-5 / atol 1e-5 * L,
    -inf on pad rows; one launch counted in LAUNCHES["expr"], or
    LAUNCHES["expr_pipelined"] where the shape routes there."""
    from libpga_tpu_torch.ops import expr_cuda

    name, P, L, layout = variant
    cross, mut, objective, obj_id = _expr_case(name)
    expr_ops = [op for op in (cross, mut) if fs.is_expression(op)]
    program = expr_cuda.program_for(
        cross if fs.is_expression(cross) else None, mut if fs.is_expression(mut) else None, objective)
    geom = fs.resolve_geometry(
        P, L, layout=layout, crossover=cross,
        const_carrying=bool(getattr(objective, "kernel_rowwise_consts", ())),
    )
    gen = torch.Generator(device=cuda_device).manual_seed(P + L)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.rand(geom.Pp, generator=gen, device=cuda_device)
    s[P:] = -torch.inf
    kw = dict(crossover=cross, mutate=mut, obj_id=obj_id, objective=objective,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device))
    scored = objective is not None or obj_id != 0
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        draws = fs.philox_draws(seed, geom.G, geom.K, L, mut, cross)
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        injected = fs.zero_draws(geom.G, geom.K, L, mut, cuda_device, cross)
        for f in ("sel_u", "mut_u", "expr_row"):
            if getattr(injected, f) is not None:
                setattr(injected, f, torch.rand_like(getattr(injected, f)))
        if injected.expr_gene is not None:
            injected.expr_gene = torch.rand_like(injected.expr_gene)
        if mut == "gaussian":
            injected.gauss = torch.rand((3, geom.G, geom.K, L), generator=gen, device=cuda_device)
        injected.cross = (torch.rand((geom.G, geom.K, L), device=cuda_device) < 0.5).to(torch.uint8)
        want_inj = fs.deme_breed_reference(g, ranks, geom, parity, injected, **kw)
        key = _expr_counter(cross, mut, objective, geom)
        before = kernels.LAUNCHES[key]
        for got, ref in ((fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw), want),
                         (fs.deme_breed(g, ranks, geom, parity, draws=injected, **kw), want_inj)):
            torch.cuda.synchronize()
            if mut == "gaussian":  # log and cos of two libraries
                torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-6)
            elif program.transcendental:
                assert int(_ulps(got[0], ref[0]).max()) <= 2
            else:
                assert torch.equal(got[0], ref[0])
            if not scored:
                assert got[1] is None and ref[1] is None
                continue
            real = torch.arange(geom.Pp, device=cuda_device) < P
            assert bool(torch.isinf(got[1][~real]).all())
            torch.testing.assert_close(got[1][real], ref[1][real], rtol=1e-5, atol=1e-5 * L)
        assert kernels.LAUNCHES[key] == before + 2
        assert expr_ops or objective is not None


# (case, P, L, layout, B, gene dtype, islands): expr_pipelined_kernel's
# shapes, each row map, both gene types, an island grid axis, every hook
# kind (the objective's child row: swap re-scoring, roll of g and a later
# stage reading g), and the knapsack's L = 6, which stays on
# expr_breed_kernel.
EXPR_PIPELINED_VARIANTS = [
    ("nk", 4096, 64, None, 1, torch.float32, None),
    ("nk", 1000, 64, "riffle", 1, torch.float32, None),
    ("trap", 4096, 60, None, 1, torch.bfloat16, None),
    ("one_point+creep", 16_384, 100, None, 2, torch.float32, None),
    ("one_point+creep", 4096, 100, None, 1, torch.bfloat16, 3),
    ("uniform+creep+sin", 4096, 40, None, 1, torch.float32, 3),
    ("all+unscored", 1000, 20, None, 1, torch.float32, None),
    ("swap+nk", 4096, 64, None, 1, torch.float32, None),
    ("gaussian+trap", 4096, 60, "riffle", 1, torch.float32, None),
    ("point+rolled", 2100, 24, None, 1, torch.float32, None),
    ("knapsack", 1000, 6, None, 1, torch.float32, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", EXPR_PIPELINED_VARIANTS,
                         ids=lambda v: f"{v[0]}-{v[1]}x{v[2]}-{v[3]}-B{v[4]}-{str(v[5])[6:]}-i{v[6]}")
def test_expr_pipelined_kernel_equals_expr_breed_kernel_on_card(cuda_device, variant):
    """Where its plan holds the shape, ``expr_breed_cuda`` launches
    expr_pipelined_kernel (counted under "expr_pipelined"), whose children
    and scores equal expr_breed_kernel's (``pipelined=False``) on the same
    inputs bit for bit (children within 2 ulp where a hook calls a
    transcendental) and whose children equal the plain version's, Philox
    and injected draws, every parity; elsewhere (L = 6) it launches
    expr_breed_kernel."""
    from libpga_tpu_torch.ops import expr_cuda

    name, P, L, layout, B, dtype, I = variant
    cross, mut, objective, obj_id = _expr_case(name)
    program = expr_cuda.program_for(cross if fs.is_expression(cross) else None,
                                    mut if fs.is_expression(mut) else None, objective)
    geom = fs.resolve_geometry(P, L, layout=layout, crossover=cross, subblock=B, gene_dtype=dtype,
                               const_carrying=bool(getattr(objective, "kernel_rowwise_consts", ())))
    assert geom.B == B
    held = L % 4 == 0
    lead = () if I is None else (I,)
    base = ("islands_expr" if I else "expr") + ("_bf16" if dtype == torch.bfloat16 else "")
    key = base.replace("expr", "expr_pipelined", 1) if held else base
    assert _expr_counter(cross, mut, objective, geom, dtype) == ("expr_pipelined" if held else "expr")
    gen = torch.Generator(device=cuda_device).manual_seed(P + L + B)
    g = torch.rand(lead + (geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = torch.rand(lead + (geom.Pp,), generator=gen, device=cuda_device)
    s[..., P:] = -torch.inf
    kw = dict(crossover=cross, mutate=mut, obj_id=obj_id, objective=objective,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device))
    seeds = torch.randint(0, 2**62, (I or 1,), generator=gen, device=cuda_device)
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(
            gen, (I or 1) * geom.Pp, cuda_device).view(*lead, geom.Pp))
        injected = fs.zero_draws(geom.G, geom.K, L, mut, cuda_device, cross)
        if I:
            injected = fs.stack_draws([injected] * I)
        for f in ("sel_u", "mut_u", "expr_row", "expr_gene", "gauss"):
            if getattr(injected, f) is not None:
                setattr(injected, f, torch.rand_like(getattr(injected, f)))
        if injected.cross is not None:
            injected.cross = (torch.rand_like(injected.cross, dtype=torch.float32) < 0.5).to(
                torch.uint8)
        philox = (fs.philox_draws(seeds, geom.G, geom.K, L, mut, cross) if I is None
                  else fs.island_philox_draws(seeds, geom.G, geom.K, L, mut, cross))
        for x, draws in ((dict(seed=seeds), philox), (dict(draws=injected), injected)):
            before = kernels.LAUNCHES[key]
            got = fs.deme_breed(g, ranks, geom, parity, islands=I, **x, **kw)
            assert kernels.LAUNCHES[key] == before + 1
            old = fs.deme_breed(g, ranks, geom, parity, islands=I, pipelined=False, **x, **kw)
            want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
            torch.cuda.synchronize()
            if program.transcendental and dtype == torch.float32:
                assert int(_ulps(got[0], old[0]).max()) <= 2
            else:
                assert torch.equal(got[0], old[0])
            if torch.equal(got[0], old[0]) and got[1] is not None:
                assert torch.equal(got[1], old[1])
            if mut == "gaussian":  # log and cos of two libraries
                torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0, atol=1e-6)
            elif program.transcendental:
                assert int(_ulps(got[0].float(), want[0].float()).max()) <= 2
            else:
                assert torch.equal(got[0], want[0])


@pytest.mark.cuda
def test_expr_philox_streams_are_uniform(cuda_device):
    """The kernel's own expression draws, read from its output: a
    crossover ``r`` and a mutation ``r2`` per gene, a crossover ``q``
    per row. Means 1/2, a quarter below 1/4, neighbouring genes and the
    two per-gene streams uncorrelated (bands > 5 sigma at 2^20 x 64)."""
    from libpga_tpu_torch.ops import breed_expr as bx

    P, L = 1 << 20, 64
    geom = fs.resolve_geometry(P, L)
    g = torch.rand((geom.Pp, L), device=cuda_device)
    s = torch.rand(geom.Pp, device=cuda_device)
    ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(None, geom.Pp, cuda_device))
    seed = torch.tensor([12345], dtype=torch.int64, device=cuda_device)
    mp = torch.tensor([0.0, 0.0], device=cuda_device)
    r_cross, _ = fs.deme_breed(g, ranks, geom, 0, seed=seed, mparams=mp, mutate="point",
                               crossover=bx.crossover_from_expression("r + 0 * p1"))
    r2_mut, _ = fs.deme_breed(g, ranks, geom, 0, seed=seed, mparams=mp,
                              mutate=bx.mutate_from_expression("r2 + 0 * g"))
    q_row, _ = fs.deme_breed(g, ranks, geom, 0, seed=seed, mparams=mp, mutate="point",
                             crossover=bx.crossover_from_expression("q + 0 * p1"))
    torch.cuda.synchronize()
    for name, x in (("cross r", r_cross), ("mut r2", r2_mut)):
        assert abs(float(x.mean()) - 0.5) < 5e-4, name
        assert abs(float((x < 0.25).float().mean()) - 0.25) < 5e-4, name
        a, b = x[:, :-1].reshape(-1) - 0.5, x[:, 1:].reshape(-1) - 0.5
        assert abs(float((a * b).mean()) * 12) < 3e-3, name
    corr = float(((r_cross - 0.5) * (r2_mut - 0.5)).mean()) * 12
    assert abs(corr) < 3e-3
    assert bool((q_row == q_row[:, :1]).all())
    q = q_row[:, 0]
    assert abs(float(q.mean()) - 0.5) < 2e-3
    assert abs(float((q < 0.25).float().mean()) - 0.25) < 2e-3


@pytest.mark.cuda
def test_expr_kernel_rejects_bad_arguments(cuda_device):
    from libpga_tpu_torch.ops import breed_expr as bx

    geom = fs.resolve_geometry(1000, 20)
    g = torch.rand((geom.Pp, 20), device=cuda_device)
    ranks = torch.zeros((geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    mp = torch.tensor([0.01, 0.0], device=cuda_device)
    mx = bx.mutate_from_expression("where(r < rate, r2, g)")
    with pytest.raises(ValueError, match="alias"):
        kernels.expr_breed_cuda(g, ranks, geom, 0, seed=seed, mparams=mp, mutate=mx, out=g)
    with pytest.raises(ValueError, match="no expression hook"):
        kernels.expr_breed_cuda(g, ranks, geom, 0, seed=seed, mparams=mp)
    with pytest.raises(ValueError, match="pinned"):
        kernels.expr_breed_cuda(g, ranks, geom, 0, seed=seed, mparams=mp, mutate=bx.mutate_from_expression(
            "g * w", w=np.ones(7, np.float32)))
    draws = fs.zero_draws(geom.G, geom.K, 20, mx, cuda_device)
    draws.expr_gene = None
    with pytest.raises(ValueError, match="expr_gene"):
        kernels.expr_breed_cuda(g, ranks, geom, 0, draws=draws, mparams=mp, mutate=mx)


@pytest.mark.cuda
def test_engine_on_card_runs_expressions_through_the_expr_kernel(cuda_device):
    from libpga_tpu_torch import PGA
    from libpga_tpu_torch import objectives as po
    from libpga_tpu_torch.ops.crossover import one_point_crossover

    for objective, cross in ((po.make_nk_landscape(64, 3), None), ("onemax", one_point_crossover)):
        pga = PGA(seed=0)
        h = pga.create_population(4096, 64)
        pga.set_objective(objective)
        pga.set_crossover(cross)
        kernels.reset_launches()
        assert pga.run(7) == 7
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["expr_pipelined"] == 7 and sum(kernels.LAUNCHES.values()) == 7
        pop = pga.population(h)
        want = pga._objective(pop.genomes)
        torch.testing.assert_close(pop.scores, want, rtol=1e-5, atol=1e-4)


EXPR_MULTIGEN_VARIANTS = [
    # (case, P, L, layout, parity, steps, elitism)
    ("nk", 4096, 64, None, 0, 3, 0),
    ("nk", 1000, 64, None, 1, 2, 0),
    ("trap", 4096, 60, "riffle", 0, 5, 2),
    ("knapsack", 4096, 6, None, 1, 3, 2),
    ("one_point+creep", 8192, 100, None, 0, 3, 0),
    ("one_point+creep", 1000, 100, "riffle", 0, 1, 2),
    ("arithmetic+swap", 2100, 130, None, 0, 3, 0),
    ("all+unscored", 1024, 20, None, 0, 0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", EXPR_MULTIGEN_VARIANTS,
                         ids=lambda v: f"{v[0]}-{v[1]}x{v[2]}-{v[3]}-p{v[4]}-s{v[5]}-e{v[6]}")
def test_expr_multigen_kernel_equals_plain_on_card(cuda_device, variant):
    """The expression multi-generation kernel equals its plain version on
    the same inputs, Philox and injected draws: genomes and scores
    exactly (the plain version sums in the kernel's order), or within 2
    ulp / rtol 1e-5 after a transcendental hook at one step; one launch
    counted in LAUNCHES["expr_multigen"] per call."""
    from libpga_tpu_torch.ops import expr_cuda

    name, P, L, layout, parity, steps, e = variant
    cross, mut, objective, obj_id = _expr_case(name)
    if objective is None and obj_id == 0:
        obj_id = onemax.fused_id  # the multi-generation kernels always score
    program = expr_cuda.program_for(
        cross if fs.is_expression(cross) else None, mut if fs.is_expression(mut) else None, objective)
    geom = fs.resolve_geometry(
        P, L, layout=layout, crossover=cross, multigen=True, elitism=e,
        const_carrying=bool(getattr(objective, "kernel_rowwise_consts", ())),
    )
    gen = torch.Generator(device=cuda_device).manual_seed(P + L + steps)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.rand(geom.Pp, generator=gen, device=cuda_device)
    s[P:] = -torch.inf
    kw = dict(crossover=cross, mutate=mut, obj_id=obj_id, elitism=e,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device))
    if objective is not None:
        kw.update(objective=objective)
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
    draws = fs.zero_draws(geom.G, geom.K, L, mut, cuda_device, cross, steps=max(steps, 1))
    for f in ("sel_u", "mut_u", "expr_gene", "expr_row", "gauss"):
        if getattr(draws, f) is not None:
            setattr(draws, f, torch.rand_like(getattr(draws, f)))
    draws.cross = (torch.rand_like(draws.cross, dtype=torch.float32) < 0.5).to(torch.uint8)
    draws.tie = torch.randint(0, 2**32, draws.tie.shape, generator=gen, device=cuda_device)
    before = kernels.LAUNCHES["expr_multigen"]
    for mode in (dict(seed=seed), dict(draws=draws)):
        got = fs.multigen_breed(g, s, geom, parity, steps, None, **mode, **kw)
        want = fs.multigen_breed_reference(g, s, geom, parity, steps, **mode, **kw)
        torch.cuda.synchronize()
        if program.transcendental and steps > 1:
            continue  # a last-ulp score difference may reorder the next step's ranks
        if program.transcendental:
            assert int(_ulps(got[0], want[0]).max()) <= 2
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5 * L)
        else:
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        assert bool(torch.isinf(got[1][P:]).all())
    assert kernels.LAUNCHES["expr_multigen"] == before + 2


@pytest.mark.cuda
def test_expr_multigen_kernel_rejects_bad_arguments(cuda_device):
    from libpga_tpu_torch.ops import breed_expr as bx

    geom = fs.resolve_geometry(1024, 20, multigen=True)
    g = torch.rand((geom.Pp, 20), device=cuda_device)
    s = torch.rand(geom.Pp, device=cuda_device)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    mp = torch.tensor([0.01, 0.0], device=cuda_device)
    mx = bx.mutate_from_expression("where(r < rate, r2, g)")
    kw = dict(seed=seed, mparams=mp, obj_id=onemax.fused_id)
    with pytest.raises(ValueError, match="alias"):
        kernels.expr_multigen_cuda(g, s, geom, 0, 2, float("inf"), mutate=mx, out=g, **kw)
    with pytest.raises(ValueError, match="no expression hook"):
        kernels.expr_multigen_cuda(g, s, geom, 0, 2, float("inf"), **kw)
    with pytest.raises(ValueError, match="rowwise fused"):
        kernels.expr_multigen_cuda(g, s, geom, 0, 2, float("inf"), mutate=mx, seed=seed, mparams=mp,
                                   obj_id=0)
    draws = fs.zero_draws(geom.G, geom.K, 20, mx, cuda_device, steps=1)
    with pytest.raises(ValueError, match="sub-generations"):
        kernels.expr_multigen_cuda(g, s, geom, 0, 2, float("inf"), draws=draws, mparams=mp,
                                   obj_id=onemax.fused_id, mutate=mx)


@pytest.mark.cuda
def test_engine_on_card_runs_expressions_several_generations_per_launch(cuda_device):
    from libpga_tpu_torch import PGA, PGAConfig
    from libpga_tpu_torch import objectives as po

    pga = PGA(seed=0, config=PGAConfig(generations_per_launch=8))
    h = pga.create_population(4096, 6)
    pga.set_objective(po.default_knapsack)
    kernels.reset_launches()
    assert pga.run(30) == 30
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expr_multigen"] == 4 and sum(kernels.LAUNCHES.values()) == 4
    pop = pga.population(h)
    torch.testing.assert_close(pop.scores, pga._objective(pop.genomes), rtol=0, atol=1e-4)
    assert pga.get_best_with_score(h)[1] == 285.0


# Order crossover with expression hooks (expr_order_kernel) and at several
# generations per launch (multigen_breed_kernel<true>, expr_multigen_kernel<true>).

TOUR = ("c = floor(g * L);"
        "x = gather(X, c); y = gather(Y, c);"
        "dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
        "-sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))")


def _order_case(name, L):
    """(mutate, objective (an expression) or None, obj_id, coords, penalty)
    of an order-crossover case "objective+mutation" at genome length L."""
    from libpga_tpu_torch import objectives as po
    from libpga_tpu_torch.ops import breed_expr as bx

    creep = bx.mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)",
                                      rate=0.05, sigma=0.1)
    c = random_tsp_coords(L, seed=1)
    objective, mut = name.split("+")
    mut = creep if mut == "creep" else mut
    if objective == "tour":  # its gather tables hold L <= 512 entries
        return mut, po.from_expression(TOUR, X=c[:, 0], Y=c[:, 1]), 0, None, 0.0
    if objective == "tsp":
        tsp = make_tsp_coords(c, duplicate_mode="genes")
        return mut, None, tsp.fused_id, tsp.coords, tsp.penalty
    ids = {"onemax": onemax.fused_id, "sphere": sphere.fused_id, "unscored": 0}
    return mut, None, ids[objective], None, 0.0


def _order_draws(geom, L, mut, device, steps=None):
    """Random injected draws of an order breed (the fill plane included)."""
    z = fs.zero_draws(geom.G, geom.K, L, mut, device, "order", steps=steps)
    for f in ("sel_u", "mut_u", "fill", "expr_gene", "expr_row", "gauss"):
        if getattr(z, f) is not None:
            setattr(z, f, torch.rand_like(getattr(z, f)))
    if z.tie is not None:
        z.tie = torch.randint(0, 2**32, z.tie.shape, device=device)
    return z


ORDER_EXPR_VARIANTS = [
    # (case, P, L)
    ("tour+swap", 4096, 200),
    ("tour+point", 1000, 48),
    ("tour+gaussian", 2048, 100),
    ("tour+creep", 4096, 200),
    ("tsp+creep", 2048, 1000),
    ("onemax+creep", 1000, 130),
    ("unscored+creep", 1024, 40),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ORDER_EXPR_VARIANTS, ids=lambda v: f"{v[0]}-{v[1]}x{v[2]}")
def test_expr_order_kernel_equals_plain_on_card(cuda_device, variant):
    """expr_order_kernel equals its plain version on the same inputs, in
    production (Philox) and injected mode: genomes exactly (within 1e-6
    after builtin gaussian mutation: log and cos of two libraries),
    scores within rtol 1e-5 / atol 1e-5 * L, -inf on pad rows; one launch
    counted in LAUNCHES["expr_order"] per call."""
    name, P, L = variant
    mut, objective, obj_id, coords, penalty = _order_case(name, L)
    geom = fs.resolve_geometry(P, L, crossover="order",
                               const_carrying=objective is not None)
    gen = torch.Generator(device=cuda_device).manual_seed(P + L)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.rand(geom.Pp, generator=gen, device=cuda_device)
    s[P:] = -torch.inf
    kw = dict(crossover="order", mutate=mut, obj_id=obj_id, objective=objective,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device))
    if coords is not None:
        kw.update(coords=coords.to(cuda_device), penalty=penalty)
    ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(gen, geom.Pp, cuda_device))
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
    philox = fs.philox_draws(seed, geom.G, geom.K, L, mut, "order")
    injected = _order_draws(geom, L, mut, cuda_device)
    before = kernels.LAUNCHES["expr_order"]
    for mode, draws in ((dict(seed=seed), philox), (dict(draws=injected), injected)):
        got = fs.deme_breed(g, ranks, geom, 0, **mode, **kw)
        want = fs.deme_breed_reference(g, ranks, geom, 0, draws, **kw)
        torch.cuda.synchronize()
        if mut == "gaussian":
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
        else:
            assert torch.equal(got[0], want[0])
        if objective is None and obj_id == 0:
            assert got[1] is None and want[1] is None
            continue
        assert bool(torch.isinf(got[1][P:]).all())
        torch.testing.assert_close(got[1][:P], want[1][:P], rtol=1e-5, atol=1e-5 * L)
    assert kernels.LAUNCHES["expr_order"] == before + 2


ORDER_MULTIGEN_VARIANTS = [
    # (case, P, L, steps, elitism, freeze)
    ("tour+swap", 4096, 200, 3, 2, True),
    ("tour+creep", 2048, 100, 8, 0, False),
    ("tour+swap", 1000, 48, 0, 0, False),
    ("onemax+point", 4096, 100, 3, 2, True),
    ("onemax+swap", 1000, 130, 1, 0, False),
    ("sphere+gaussian", 2048, 60, 3, 1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ORDER_MULTIGEN_VARIANTS,
                         ids=lambda v: f"{v[0]}-{v[1]}x{v[2]}-s{v[3]}-e{v[4]}-f{int(v[5])}")
def test_order_multigen_kernels_equal_plain_on_card(cuda_device, variant):
    """The multi-generation kernels' order case (the builtin kernel for a
    builtin objective and mutation, the expression kernel for the tour)
    equals the plain version, Philox and injected draws: genomes and
    scores exactly (builtin gaussian mutation: genomes within 1e-6 at one
    step, not compared after it, as a last-ulp gene may reorder ranks);
    with ``freeze`` half the groups start above the target."""
    name, P, L, steps, e, freeze = variant
    mut, objective, obj_id, _, _ = _order_case(name, L)
    geom = fs.resolve_geometry(P, L, crossover="order", multigen=True, elitism=e,
                               const_carrying=objective is not None)
    gen = torch.Generator(device=cuda_device).manual_seed(P + L + steps)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.rand(geom.Pp, generator=gen, device=cuda_device)
    s[P:] = -torch.inf
    target = None
    if freeze:
        read, _ = geom.row_maps(0, cuda_device)
        best = torch.where(read < P, s[read], -torch.inf).amax(dim=1)
        target = float(best.median())
    kw = dict(crossover="order", mutate=mut, obj_id=obj_id, elitism=e,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device))
    if objective is not None:
        kw.update(objective=objective)
    key = "expr_multigen_order" if objective is not None or fs.is_expression(mut) else "multigen_order"
    before = kernels.LAUNCHES[key]
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
    draws = _order_draws(geom, L, mut, cuda_device, steps=max(steps, 1))
    for mode in (dict(seed=seed), dict(draws=draws)):
        got = fs.multigen_breed(g, s, geom, 0, steps, target, **mode, **kw)
        want = fs.multigen_breed_reference(
            g, s, geom, 0, steps, math.inf if target is None else target, **mode, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isinf(got[1][P:]).all())
        if mut == "gaussian":
            if steps == 1:
                torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
            continue
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert kernels.LAUNCHES[key] == before + 2


@pytest.mark.cuda
def test_engine_on_card_breeds_order_crossover_through_the_order_kernels(cuda_device):
    """PGA.run with order crossover: the tour expression at T = 1
    (expr_order_kernel) and T = 4 (expr_multigen_kernel<true>), onemax at
    T = 4 (multigen_breed_kernel<true>); launches counted where they
    launch and nowhere else; scores are the genomes' objective."""
    from libpga_tpu_torch import PGA, PGAConfig
    from libpga_tpu_torch.ops.crossover import order_preserving_crossover
    from libpga_tpu_torch.ops.mutate import make_swap_mutate

    _, tour, _, _, _ = _order_case("tour+swap", 100)
    for objective, T_, key, launches in ((tour, None, "expr_order", 9),
                                         (tour, 4, "expr_multigen_order", 3),
                                         (onemax, 4, "multigen_order", 3)):
        pga = PGA(seed=0, config=PGAConfig(generations_per_launch=T_))
        h = pga.create_population(4096, 100)
        pga.set_objective(objective)
        pga.set_crossover(order_preserving_crossover)
        pga.set_mutate(make_swap_mutate(0.5))
        kernels.reset_launches()
        assert pga.run(9) == 9
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[key] == launches and sum(kernels.LAUNCHES.values()) == launches
        pop = pga.population(h)
        torch.testing.assert_close(pop.scores, objective(pop.genomes), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------- islands

# (kind, S, L, layout, mutate, objective, steps, elitism): the deme-,
# order- and multi-generation kernels with an island grid axis.
ISLAND_VARIANTS = [
    ("deme", 4096, 100, "pingpong", "point", onemax, 1, 0),
    ("deme", 2100, 64, "riffle", "swap", onemax_bits, 1, 0),
    ("deme", 1000, 30, "pingpong", "gaussian", rastrigin, 1, 0),
    ("order", 1024, 100, "riffle", "swap", "tsp", 1, 0),
    ("multigen", 4096, 32, "pingpong", "point", onemax, 3, 0),
    ("multigen", 2100, 32, "riffle", "point", onemax, 3, 2),
    ("multigen", 1024, 50, "riffle", "swap", onemax, 3, 1),
]


def _island_case(kind, S, L, layout, mutate, obj, elitism, device):
    cross = "order" if kind == "order" or (kind == "multigen" and mutate == "swap") else "uniform"
    geom = fs.resolve_geometry(S, L, crossover=cross, multigen=kind == "multigen",
                               elitism=elitism, layout=layout)
    kw = dict(mutate=mutate, crossover=cross, mparams=torch.tensor([0.3, 0.05], device=device))
    if obj == "tsp":
        tsp = make_tsp_coords(random_tsp_coords(L, seed=2), duplicate_mode="genes")
        kw.update(obj_id=tsp.fused_id, coords=tsp.coords.to(device), penalty=tsp.penalty)
    else:
        kw.update(obj_id=obj.fused_id)
    if kind == "multigen":
        kw.update(elitism=elitism)
    return geom, cross, kw


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ISLAND_VARIANTS, ids=lambda v: f"{v[0]}-{v[1]}x{v[2]}-{v[4]}")
def test_island_launch_equals_plain_and_single_launches_on_card(cuda_device, variant):
    """One island launch (4 islands: the kernels' second grid axis) equals
    its plain version and 4 single-population launches, each with its
    island's seed or slice of the injected draws, bit for bit (scores of
    the one-generation plain version within the kernels' tolerances:
    sums in another order); one island equals a single launch; the
    island launch counts once under its own key."""
    kind, S, L, layout, mutate, obj, steps, elitism = variant
    I = 4
    geom, cross, kw = _island_case(kind, S, L, layout, mutate, obj, elitism, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(S + L)
    g = torch.rand((I, geom.Pp, L), generator=gen, device=cuda_device)
    g[:, S:] = 0.0
    s = g.sum(dim=2)
    s[:, S:] = -torch.inf
    seeds = torch.randint(0, 2**62, (I,), generator=gen, device=cuda_device)
    G, K = geom.G, geom.K
    gene_atol = 1e-6 if mutate == "gaussian" else 0.0
    for parity in range(geom.parities):
        if kind == "multigen":
            target = float(s[:, :S].amax()) - 0.5  # freezes some groups
            draws = fs.stack_draws([fs.stack_draws([
                fs.philox_draws(seeds[i:i + 1], G, K, L, mutate, cross, sub_generation=t, tie=True)
                for t in range(steps)]) for i in range(I)])
            want = fs.multigen_breed_reference(g, s, geom, parity, steps, target, draws=draws, **kw)
            key = "islands_multigen_order" if cross == "order" else "islands_multigen"
        else:
            tie = fs.draw_tie_words(gen, I * geom.Pp, cuda_device).view(I, -1)
            ranks = fs.compute_ranks(s, geom, parity, tie)
            draws = fs.island_philox_draws(seeds, G, K, L, mutate, cross)
            want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
            key = "islands_order" if cross == "order" else _deme_key(geom, islands=True)

        def launch(i, islands=None, **x):
            """Islands i .. i + islands - 1 in one launch, or island i alone
            in a single-population launch."""
            n = islands or 1
            pick = slice(i, i + n) if islands else i
            if kind == "multigen":
                return fs.multigen_breed(g[pick], s[pick], geom, parity, steps, target,
                                         islands=islands, **x, **kw)
            return fs.deme_breed(g[pick], ranks[i * G:(i + n) * G], geom, parity,
                                 islands=islands, **x, **kw)

        before = kernels.LAUNCHES[key]
        for got in (launch(0, islands=I, seed=seeds), launch(0, islands=I, draws=draws)):
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=gene_atol)
            real = torch.arange(geom.Pp, device=cuda_device) < S
            assert bool(torch.isinf(got[1][:, ~real]).all())
            if kind == "multigen":
                assert torch.equal(got[1], want[1])
            else:
                tol = dict(rtol=1e-5, atol=1e-3 if obj != "tsp" else 0.0)
                torch.testing.assert_close(got[1][:, real], want[1][:, real], **tol)
            for i in range(I):
                one = launch(i, seed=seeds[i:i + 1])
                assert torch.equal(got[0][i], one[0]) and torch.equal(got[1][i], one[1])
        assert kernels.LAUNCHES[key] == before + 2
        solo, one = launch(0, islands=1, seed=seeds[:1]), launch(0, seed=seeds[:1])
        assert torch.equal(solo[0][0], one[0]) and torch.equal(solo[1][0], one[1])


@pytest.mark.cuda
def test_engine_on_card_breeds_every_island_in_one_launch(cuda_device):
    from libpga_tpu_torch import PGAConfig, pga_create_population, pga_init
    from libpga_tpu_torch import pga_run_islands, pga_set_objective_function

    deme = _deme_key(fs.resolve_geometry(4096, 32), islands=True)
    for T, launches, key in ((None, 12, deme), (4, 3 * 1 + 1, "islands_multigen")):
        p = pga_init(0, PGAConfig(generations_per_launch=T))
        for _ in range(4):
            pga_create_population(p, 4096, 32)
        pga_set_objective_function(p, "onemax")
        kernels.reset_launches()
        assert pga_run_islands(p, 12 if T is None else 13, 4, 0.05) == (12 if T is None else 13)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), key: launches}
        assert p.launches == launches
        for pop in p._populations:
            torch.testing.assert_close(pop.scores, pop.genomes.sum(dim=1), rtol=0, atol=1e-3)


# ------------------------------------------------- islands with expressions

# (kernel, case, S, L, layout, steps, elitism, gene dtype): the island grid
# axis of expr_breed_kernel, expr_order_kernel and expr_multigen_kernel
# <false/true>, float32 and bf16.
ISLAND_EXPR_VARIANTS = [
    ("expr", "one_point+creep", 4096, 100, None, 1, 0, torch.float32),
    ("expr", "nk", 1000, 64, "riffle", 1, 0, torch.float32),
    ("expr", "trap", 4096, 60, None, 1, 0, torch.bfloat16),
    ("expr_order", "tour+swap", 1024, 100, None, 1, 0, torch.float32),
    ("expr_order", "tsp+creep", 1024, 200, None, 1, 0, torch.float32),
    ("expr_multigen", "trap", 4096, 60, "riffle", 3, 2, torch.float32),
    ("expr_multigen", "one_point+creep", 4096, 100, None, 3, 0, torch.float32),
    ("expr_multigen", "trap", 4096, 60, None, 3, 1, torch.bfloat16),
    ("expr_multigen_order", "tour+swap", 1024, 100, None, 3, 1, torch.float32),
]


def _island_expr_case(kernel, case, L, device):
    """(crossover, kw) of an island expression case."""
    order = kernel.endswith("order")
    if order:
        mut, objective, obj_id, coords, penalty = _order_case(case, L)
        kw = dict(crossover="order", mutate=mut, obj_id=obj_id)
        if coords is not None:
            kw.update(coords=coords.to(device), penalty=penalty)
    else:
        cross, mut, objective, obj_id = _expr_case(case)
        kw = dict(crossover=cross, mutate=mut, obj_id=obj_id)
    if objective is not None:
        kw.update(objective=objective)
    kw.update(mparams=torch.tensor([0.3, 0.05], device=device))
    return kw["crossover"], kw


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ISLAND_EXPR_VARIANTS,
                         ids=lambda v: f"{v[0]}-{v[1]}-{v[2]}x{v[3]}-s{v[5]}-{str(v[7])[6:]}")
def test_island_expr_launch_equals_plain_and_single_launches_on_card(cuda_device, variant):
    """One island launch of the expression kernels (3 islands, the second
    grid axis) equals its plain version (genomes bit for bit; scores
    within rtol 1e-5 / atol 1e-5 * L at one generation, exactly at
    several) and 3 single-population launches bit for bit, each with its
    island's seed or slice of the injected draws; one island equals a
    single launch; the launch counts once under its "islands_" key."""
    kernel, case, S, L, layout, steps, e, dtype = variant
    I = 3
    multigen = kernel.startswith("expr_multigen")
    cross, kw = _island_expr_case(kernel, case, L, cuda_device)
    objective = kw.get("objective")
    geom = fs.resolve_geometry(
        S, L, layout=layout, crossover=cross, multigen=multigen, elitism=e, gene_dtype=dtype,
        const_carrying=bool(getattr(objective, "kernel_rowwise_consts", ())))
    if multigen:
        kw.update(elitism=e)
    gen = torch.Generator(device=cuda_device).manual_seed(S + L + steps)
    g = torch.rand((I, geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    g[:, S:] = 0
    s = torch.rand((I, geom.Pp), generator=gen, device=cuda_device)
    s[:, S:] = -torch.inf
    seeds = torch.randint(0, 2**62, (I,), generator=gen, device=cuda_device)
    G, K = geom.G, geom.K
    mut = kw["mutate"]
    base = "islands_" + kernel
    if kernel == "expr":
        base = _expr_counter(cross, mut, objective, geom, dtype, base)
    key = base + ("_bf16" if dtype == torch.bfloat16 else "")
    real = torch.arange(geom.Pp, device=cuda_device) < S
    for parity in range(geom.parities):
        if multigen:
            target = float(s[:, :S].amax(dim=1).median())  # freezes some groups
            draws = fs.stack_draws([fs.stack_draws([
                fs.philox_draws(seeds[i:i + 1] + 5, G, K, L, mut, cross, sub_generation=t,
                                tie=True) for t in range(steps)]) for i in range(I)])
        else:
            ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(
                gen, I * geom.Pp, cuda_device).view(I, -1))
            draws = fs.island_philox_draws(seeds + 5, G, K, L, mut, cross)

        def launch(i, islands=None, plain=False, **x):
            """Islands i .. i + islands - 1 in one launch (or its plain
            version), or island i alone in a single-population launch."""
            pick = slice(i, i + islands) if islands else i
            if multigen:
                if plain:
                    return fs.multigen_breed_reference(g[pick], s[pick], geom, parity, steps,
                                                       target, **x, **kw)
                return fs.multigen_breed(g[pick], s[pick], geom, parity, steps, target,
                                         islands=islands, **x, **kw)
            r = ranks[i * G:(i + (islands or 1)) * G]
            if plain:
                d = x.get("draws") or fs.island_philox_draws(x["seed"], G, K, L, mut, cross)
                return fs.deme_breed_reference(g[pick], r, geom, parity, d, **kw)
            return fs.deme_breed(g[pick], r, geom, parity, islands=islands, **x, **kw)

        before = kernels.LAUNCHES[key]
        for x in (dict(seed=seeds), dict(draws=draws)):
            got, want = launch(0, I, **x), launch(0, I, plain=True, **x)
            torch.cuda.synchronize()
            assert got[0].dtype == dtype and torch.equal(got[0], want[0])
            assert bool(torch.isinf(got[1][:, ~real]).all())
            if multigen:
                assert torch.equal(got[1], want[1])
            else:
                torch.testing.assert_close(got[1][:, real], want[1][:, real], rtol=1e-5,
                                           atol=1e-5 * L)
            for i in range(I):
                one = launch(i, **(dict(seed=seeds[i:i + 1]) if "seed" in x
                                   else dict(draws=draws.island(i))))
                assert torch.equal(got[0][i], one[0]) and torch.equal(got[1][i], one[1])
        assert kernels.LAUNCHES[key] == before + 2
        solo, one = launch(0, 1, seed=seeds[:1]), launch(0, seed=seeds[:1])
        assert torch.equal(solo[0][0], one[0]) and torch.equal(solo[1][0], one[1])


@pytest.mark.cuda
def test_island_expr_kernels_reject_bad_arguments(cuda_device):
    from libpga_tpu_torch.ops import breed_expr as bx

    I = 2
    geom = fs.resolve_geometry(1024, 20)
    g = torch.rand((I, geom.Pp, 20), device=cuda_device)
    ranks = torch.zeros((I * geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    seeds = torch.tensor([1, 2], dtype=torch.int64, device=cuda_device)
    mx = bx.mutate_from_expression("where(r < rate, r2, g)")
    kw = dict(mparams=torch.tensor([0.01, 0.0], device=cuda_device), mutate=mx, obj_id=1)
    for bad in (0, 65_536):
        with pytest.raises(ValueError, match="islands"):
            kernels.expr_breed_cuda(g, ranks, geom, 0, seed=seeds, islands=bad, **kw)
    with pytest.raises(ValueError, match="seed"):
        kernels.expr_breed_cuda(g, ranks, geom, 0, seed=seeds[:1], islands=I, **kw)
    with pytest.raises(ValueError, match="ranks"):
        kernels.expr_breed_cuda(g, ranks[:geom.G], geom, 0, seed=seeds, islands=I, **kw)
    draws = fs.island_philox_draws(seeds, geom.G, geom.K, 20, mx)
    draws.expr_gene = draws.expr_gene[:1]  # one island's planes for two islands
    with pytest.raises(ValueError, match="expr_gene"):
        kernels.expr_breed_cuda(g, ranks, geom, 0, draws=draws, islands=I, **kw)
    mg = fs.resolve_geometry(1024, 20, multigen=True)
    gm = torch.rand((I, mg.Pp, 20), device=cuda_device)
    sm = gm.sum(dim=2)
    draws = fs.stack_draws([fs.stack_draws([fs.philox_draws(seeds[i:i + 1], mg.G, mg.K, 20, mx,
                                                            sub_generation=t, tie=True)
                                            for t in range(2)]) for i in range(I)])
    draws.expr_gene = draws.expr_gene[:, :1]  # one sub-generation's planes for two
    with pytest.raises(ValueError, match="expr_gene"):
        kernels.expr_multigen_cuda(gm, sm, mg, 0, 2, math.inf, draws=draws, islands=I, **kw)
    with pytest.raises(ValueError, match="islands"):
        kernels.expr_multigen_cuda(gm, sm, mg, 0, 2, math.inf, seed=seeds, islands=0, **kw)


@pytest.mark.cuda
def test_engine_on_card_breeds_expression_islands_in_one_launch(cuda_device):
    """run_islands with an expression hook: one island launch of the
    expression kernel per generation, or ceil(m / T) per epoch, and
    nothing else; scores are the genomes' objective."""
    from libpga_tpu_torch import PGAConfig, pga_init
    from libpga_tpu_torch import objectives as po
    from libpga_tpu_torch.ops import breed_expr as bx

    creep = bx.mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05,
                                      sigma=0.1)
    trap = po.make_deceptive_trap(5)
    for T, objective, mut, gens, key, launches in (
        (None, "onemax", creep, 12, "islands_expr_pipelined", 12),
        (None, trap, None, 12, "islands_expr_pipelined", 12),
        (4, trap, creep, 13, "islands_expr_multigen", 3 * 1 + 1),
    ):
        p = pga_init(0, PGAConfig(generations_per_launch=T))
        for _ in range(4):
            p.create_population(4096, 60)
        p.set_objective(objective)
        p.set_mutate(mut)
        kernels.reset_launches()
        assert p.run_islands(gens, 4, 0.05) == gens
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), key: launches}
        assert p.launches == launches
        for pop in p._populations:
            torch.testing.assert_close(pop.scores, p._objective(pop.genomes), rtol=1e-5,
                                       atol=1e-3)


# ---------------------------------------------------------------- bfloat16

BF16 = torch.bfloat16

# (kind, P, L, layout, mutate, expression case, steps, elitism, islands):
# the bf16 cases of the deme, multi-generation and expression kernels, the
# first two also with an island grid axis.
BF16_VARIANTS = [
    ("deme", 8192, 100, None, "point", None, 1, 0, None),
    ("deme", 1000, 20, "riffle", "swap", None, 1, 0, None),
    ("deme", 1000, 30, None, "gaussian", None, 1, 0, None),
    ("deme", 4096, 100, None, "point", None, 1, 0, 4),
    ("multigen", 8192, 100, None, "point", None, 3, 2, None),
    ("multigen", 2100, 32, "riffle", "gaussian", None, 1, 0, None),
    ("multigen", 4096, 32, None, "point", None, 3, 0, 4),
    ("expr", 4096, 60, None, "point", "trap", 1, 0, None),
    ("expr", 8192, 100, None, None, "one_point+creep", 1, 0, None),
    ("expr_multigen", 4096, 60, None, "point", "trap", 3, 2, None),
    ("expr_multigen", 8192, 100, None, None, "one_point+creep", 3, 0, None),
]


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 units in the last place between non-negative ``a`` and ``b``."""
    return (a.view(torch.int16).to(torch.int32) - b.view(torch.int16).to(torch.int32)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", BF16_VARIANTS,
                         ids=lambda v: f"{v[0]}-{v[1]}x{v[2]}-{v[4] or v[5]}-s{v[6]}-i{v[8]}")
def test_bf16_kernels_equal_plain_and_the_float32_kernel_rounded_on_card(cuda_device, variant):
    """A bf16 launch equals its plain version bit for bit (gaussian genes
    within one bf16 ulp: logf/cosf against torch's may move a rounding),
    in production and injected mode, every parity; at one step its
    children are the float32 kernel's on the widened genomes, rounded;
    it counts under the kernel's "_bf16" key."""
    kind, P, L, layout, mutate, case, steps, e, I = variant
    multigen = kind in ("multigen", "expr_multigen")
    cross, objective, obj_id = "uniform", None, onemax.fused_id
    if case is not None:
        cross, mutate, objective, obj_id = _expr_case(case)
        obj_id = obj_id or (0 if objective is not None else onemax.fused_id)
    geom = fs.resolve_geometry(
        P, L, layout=layout, crossover=cross, multigen=multigen, elitism=e, gene_dtype=BF16,
        const_carrying=bool(getattr(objective, "kernel_rowwise_consts", ())))
    lead = () if I is None else (I,)
    gen = torch.Generator(device=cuda_device).manual_seed(P + L + steps)
    g = torch.rand(lead + (geom.Pp, L), generator=gen, device=cuda_device).to(BF16)
    g[..., P:, :] = 0
    s = g.float().sum(dim=-1)
    s[..., P:] = -torch.inf
    kw = dict(crossover=cross, mutate=mutate, obj_id=obj_id,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device))
    if objective is not None:
        kw.update(objective=objective)
    if multigen:
        kw.update(elitism=e)
    seeds = torch.randint(0, 2**62, (I or 1,), generator=gen, device=cuda_device)
    G, K = geom.G, geom.K
    key = {"deme": _deme_key(geom, BF16, islands=bool(I)).removesuffix("_bf16"),
           "multigen": "islands_multigen" if I else "multigen",
           "expr": _expr_counter(cross, mutate, objective, geom, BF16),
           "expr_multigen": "expr_multigen"}[kind] + "_bf16"
    for parity in range(geom.parities):
        if multigen:
            def sub(seed):
                return fs.stack_draws([fs.philox_draws(seed, G, K, L, mutate, cross, sub_generation=t,
                                                       tie=True) for t in range(steps)])

            draws = sub(seeds) if I is None else fs.stack_draws(
                [sub(seeds[i:i + 1]) for i in range(I)])
            want = fs.multigen_breed_reference(g, s, geom, parity, steps, math.inf, draws=draws, **kw)

            def launch(genomes, **x):
                return fs.multigen_breed(genomes, s, geom, parity, steps, None, islands=I, **x, **kw)
        else:
            ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(
                gen, (I or 1) * geom.Pp, cuda_device).view(*lead, geom.Pp))
            draws = (fs.philox_draws(seeds, G, K, L, mutate, cross) if I is None
                     else fs.island_philox_draws(seeds, G, K, L, mutate, cross))
            want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)

            def launch(genomes, **x):
                return fs.deme_breed(genomes, ranks, geom, parity, islands=I, **x, **kw)

        before = kernels.LAUNCHES[key]
        for x in (dict(seed=seeds), dict(draws=draws)):
            got = launch(g, **x)
            torch.cuda.synchronize()
            assert got[0].dtype == BF16
            if mutate == "gaussian":
                assert int(_bf16_ulps(got[0], want[0]).max()) <= 1
            else:
                assert torch.equal(got[0], want[0])
            real = torch.arange(geom.Pp, device=cuda_device) < P
            assert bool(torch.isinf(got[1][..., ~real]).all())
            torch.testing.assert_close(got[1][..., real], want[1][..., real], rtol=1e-5,
                                       atol=1e-3 if objective is None else 1e-5 * L)
            if steps == 1:
                f32 = launch(g.float(), **x)
                assert torch.equal(got[0], f32[0].to(BF16))
        assert kernels.LAUNCHES[key] == before + 2


@pytest.mark.cuda
def test_engine_on_card_launches_the_bf16_kernels(cuda_device):
    """PGA.run, run at T > 1 and run_islands at gene_dtype=bfloat16 launch
    only the bf16 kernels; the genomes stay bf16 and each score is its
    stored genome's; order crossover takes the panmictic path."""
    from libpga_tpu_torch import PGAConfig, pga_init
    from libpga_tpu_torch import objectives as po
    from libpga_tpu_torch.ops.crossover import order_preserving_crossover
    from libpga_tpu_torch.ops.mutate import make_swap_mutate

    trap = po.make_deceptive_trap(5)
    deme = fs.resolve_geometry(4096, 60, gene_dtype=BF16)
    for T, objective, islands, gens, key, launches in (
        (None, "onemax", 1, 6, _deme_key(deme, BF16), 6),
        (4, "onemax", 1, 8, "multigen_bf16", 2),
        (None, trap, 1, 5, "expr_pipelined_bf16", 5),
        (4, trap, 1, 8, "expr_multigen_bf16", 2),
        (None, "onemax", 4, 6, _deme_key(deme, BF16, islands=True), 6),
    ):
        p = pga_init(0, PGAConfig(gene_dtype=BF16, generations_per_launch=T))
        for _ in range(islands):
            p.create_population(4096, 60)
        p.set_objective(objective)
        kernels.reset_launches()
        ran = p.run_islands(gens, 3, 0.05) if islands > 1 else p.run(gens)
        torch.cuda.synchronize()
        assert ran == gens
        assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), key: launches}
        for pop in p._populations:
            assert pop.genomes.dtype == BF16
            torch.testing.assert_close(pop.scores, p._objective(pop.genomes.float()), rtol=1e-5,
                                       atol=1e-3)
    p = pga_init(0, PGAConfig(gene_dtype=BF16))
    p.create_population(4096, 60)
    p.set_objective("onemax")
    p.set_crossover(order_preserving_crossover)
    p.set_mutate(make_swap_mutate(0.5))
    kernels.reset_launches()
    assert p.run(3) == 3 and sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_bf16_kernels_reject_bad_dtypes(cuda_device):
    geom = fs.resolve_geometry(1024, 20, gene_dtype=BF16)
    g = torch.rand((geom.Pp, 20), device=cuda_device).to(BF16)
    ranks = torch.zeros((geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    kw = dict(seed=seed, mparams=torch.tensor([0.01, 0.0], device=cuda_device), obj_id=1)
    with pytest.raises(ValueError, match="dtype"):
        kernels.deme_breed_cuda(g.half(), ranks, geom, 0, **kw)
    with pytest.raises(ValueError, match="out"):
        kernels.deme_breed_cuda(g, ranks, geom, 0, out=torch.empty_like(g, dtype=torch.float32),
                                **kw)
    riffle = fs.resolve_geometry(1024, 20, layout="riffle")
    with pytest.raises(ValueError, match="order crossover breeds float32"):
        kernels.order_breed_cuda(g, ranks[:riffle.G], riffle, 0, **kw)
    mg = fs.resolve_geometry(1024, 20, multigen=True, gene_dtype=BF16)
    s = g.float().sum(dim=1)
    with pytest.raises(ValueError, match="work"):  # the one-block schedule's buffers
        kernels.multigen_breed_cuda(g, s, mg, 0, 3, math.inf, cluster=False,
                                    work=[torch.empty((mg.Pp, 20), device=cuda_device)], **kw)


# ------------------------------------------------- the floor harness (B7)

ABLATE_COPY = ("copy_only", "no_rank_sort")
ABLATE_FLOOR = ("sel_const", "no_matmul", "no_cross", "no_mut")
# (name, ablate, P, L, scored, demes_per_block, warps_per_block)
ABLATE_VARIANTS = [
    ("copy_riffle", ABLATE_COPY, 8192, 100, False, 1, 0),
    ("copy_riffle_dc4", ABLATE_COPY, 8192, 100, False, 4, 0),
    ("copy_riffle_dc4_w4", ABLATE_COPY, 8192, 100, False, 4, 4),
    ("copy_contig_w1", ABLATE_COPY + ("no_riffle",), 1000, 100, True, 1, 1),
    ("copy_contig", ABLATE_COPY + ("no_riffle",), 8192, 100, False, 2, 0),
    ("copy_alias", ABLATE_COPY + ("no_riffle", "alias_io"), 8192, 100, False, 1, 0),
    ("copy_riffle_score", ABLATE_COPY, 1000, 100, True, 1, 0),
    ("copy_ranks_score", ("copy_only",), 8192, 100, True, 8, 0),
    ("floor", ABLATE_FLOOR, 1000, 100, False, 1, 0),
    ("floor_scored", ABLATE_FLOOR, 8192, 100, True, 1, 0),
    ("sel_const", ("sel_const",), 8192, 100, True, 1, 0),
    ("no_matmul", ("no_matmul",), 1000, 300, True, 1, 0),
    ("no_cross", ("no_cross",), 8192, 100, True, 1, 0),
    ("no_mut", ("no_mut",), 2100, 100, True, 1, 0),
    ("no_riffle_breed", ("no_riffle",), 1000, 100, True, 1, 0),
    ("no_rank_sort_breed", ("no_rank_sort", "no_mut"), 8192, 100, True, 1, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ABLATE_VARIANTS, ids=lambda v: v[0])
def test_ablated_breed_equals_plain_on_card(cuda_device, variant, dtype):
    """Each ablated case of deme_breed_kernel equals its plain version,
    in production (Philox) and injected mode, every parity; a copy equals
    its row permutation; the launches count apart from production."""
    name, ablate, P, L, scored, dc, wb = variant
    obj = onemax if scored else None
    breed = fs.make_fused_breed(P, L, obj, ablate=ablate, demes_per_block=dc, warps_per_block=wb,
                                device=cuda_device, gene_dtype=dtype,
                                mparams=(0.3, 0.0), mutate="swap" if name == "no_mut" else "point")
    geom, kw = breed.geom, breed.kw
    gen = torch.Generator(device=cuda_device).manual_seed(P + L)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = g.float().sum(dim=1)
    s[P:] = -torch.inf
    copy = "copy_only" in ablate
    before = dict(kernels.LAUNCHES)
    for parity in range(geom.parities):
        if copy:
            handed = s.view(geom.G, geom.K) if "no_rank_sort" in ablate else fs.compute_ranks(
                s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device)).float()
            src = g.clone()
            out = src if "alias_io" in ablate else None
            want = fs.deme_breed_reference(g, handed, geom, parity, None, **kw)
            got = fs.deme_breed(src, handed, geom, parity, out=out, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            _, write = geom.row_maps(parity, cuda_device)
            assert torch.equal(got[0][write.reshape(-1)], g)  # the row permutation
            if scored:
                assert torch.equal(got[1], want[1])
            continue
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        draws = fs.philox_draws(seed, geom.G, geom.K, L, kw["mutate"])
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        for got in (fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw),
                    fs.deme_breed(g, ranks, geom, parity, draws=draws, **kw)):
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            if scored:
                torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)
            else:
                assert got[1] is None
    key = ("ablate_copy" + ("_bf16" if dtype == torch.bfloat16 else "") if copy
           else _deme_key(geom, dtype, ablate=True))
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {key: geom.parities * (1 if copy else 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ablate_zero_is_the_production_kernel(cuda_device, dtype):
    """A factory given ``ablate=()`` launches the production instantiation
    (ABLATE = 0), counts it as production, and breeds what the plain
    version breeds (the plain version at ablate () is held unchanged
    against JAX on the CPU): genomes bit for bit in Philox and injected
    draws, every parity."""
    P, L = 8192, 100
    breed = fs.make_fused_breed(P, L, onemax, device=cuda_device, gene_dtype=dtype, ablate=(),
                                mparams=(0.3, 0.0))
    geom, kw = breed.geom, breed.kw
    assert "ablate" not in kw
    key = _deme_key(geom, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = g.float().sum(dim=1)
    s[P:] = -torch.inf
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        draws = fs.philox_draws(seed, geom.G, geom.K, L, kw["mutate"])
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        for mode in (dict(seed=seed), dict(draws=draws)):
            before = dict(kernels.LAUNCHES)
            got = fs.deme_breed(g, ranks, geom, parity, **mode, **kw)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
            assert launched == {key: 1}
            assert torch.equal(got[0], want[0])
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)
    before = kernels.LAUNCHES[key]
    breed(g, s, 0, gen)
    assert kernels.LAUNCHES[key] == before + 1


# (ablate, P, L, layout, elitism, target, dtype)
ABLATE_MULTIGEN_VARIANTS = [
    (("no_freeze",), 40_000, 100, None, 2, 55.0, torch.float32),
    (("no_rank_cube",), 40_000, 100, None, 2, None, torch.float32),
    (("no_freeze",), 65_536, 100, None, 0, 60.0, torch.bfloat16),
    (("no_rank_cube",), 65_536, 100, None, 0, None, torch.bfloat16),
    (("sel_const",), 8192, 100, None, 2, None, torch.float32),
    (("no_matmul",), 8192, 100, "riffle", 2, None, torch.float32),
    (("no_cross",), 1000, 100, None, 0, 60.0, torch.float32),
    (("no_mut",), 8192, 100, None, 2, None, torch.bfloat16),
    (ABLATE_FLOOR, 8192, 100, None, 2, None, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ABLATE_MULTIGEN_VARIANTS,
                         ids=lambda v: f"{'+'.join(v[0])}-{v[1]}-{v[6]}")
def test_ablated_multigen_equals_plain_on_card(cuda_device, variant):
    """Each ablated case of multigen_breed_kernel<false> equals its plain
    version at 3 steps, in production and injected mode, every parity;
    the launches count as "ablate_multigen"."""
    ablate, P, L, layout, e, target, dtype = variant
    launch = fs.make_fused_multigen(P, L, onemax, layout=layout, elitism=e, ablate=ablate,
                                    device=cuda_device, gene_dtype=dtype, mparams=(0.3, 0.0))
    geom, kw = launch.geom, launch.kw
    gen = torch.Generator(device=cuda_device).manual_seed(P)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = torch.full((geom.Pp,), -torch.inf, device=cuda_device)
    s[:P] = g[:P].float().sum(dim=1)
    steps, G, K = 3, geom.G, geom.K
    injected = fs.Draws(
        sel_u=torch.rand((steps, G, K, 2), generator=gen, device=cuda_device),
        cross=(torch.rand((steps, G, K, L), generator=gen, device=cuda_device) < 0.5).to(
            torch.uint8),
        mut_u=torch.rand((steps, G, K, 4), generator=gen, device=cuda_device),
        tie=torch.randint(0, 2**32, (steps, G, K), generator=gen, device=cuda_device),
    )
    key = "ablate_multigen" + ("_bf16" if dtype == torch.bfloat16 else "")
    for parity in range(geom.parities):
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        for mode in (dict(seed=seed), dict(draws=injected)):
            before = kernels.LAUNCHES[key]
            got = fs.multigen_breed(g, s, geom, parity, steps, target, **mode, **kw)
            assert kernels.LAUNCHES[key] == before + 1
            want = fs.multigen_breed_reference(
                g, s, geom, parity, steps, math.inf if target is None else target, **mode, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_ablated_kernels_reject_bad_arguments(cuda_device):
    geom = fs.resolve_geometry(8192, 100, ablate=("copy_only",))
    g = torch.rand((geom.Pp, 100), device=cuda_device)
    s = g.sum(dim=1).view(geom.G, geom.K)
    mp = torch.tensor([0.01, 0.0], device=cuda_device)
    with pytest.raises(ValueError, match="alias"):  # in place needs no_riffle
        kernels.deme_breed_cuda(g, s, geom, 0, out=g, mparams=mp, ablate=("copy_only", "alias_io"))
    with pytest.raises(ValueError, match="handed scores"):
        kernels.deme_breed_cuda(g, s.int(), geom, 0, mparams=mp, ablate=("copy_only",))
    with pytest.raises(ValueError, match="demes_per_block"):
        kernels.deme_breed_cuda(g, s, geom, 0, mparams=mp, ablate=("copy_only",),
                                demes_per_block=3)
    with pytest.raises(ValueError, match="warps_per_block"):
        kernels.deme_breed_cuda(g, s, geom, 0, mparams=mp, ablate=("copy_only",),
                                warps_per_block=9)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    ranks = torch.zeros((geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multi-generation"):
        kernels.deme_breed_cuda(g, ranks, geom, 0, seed=seed, mparams=mp, ablate=("no_freeze",))
    mg = fs.resolve_geometry(8192, 100, multigen=True)
    with pytest.raises(ValueError, match="no copy"):
        kernels.multigen_breed_cuda(g, g.sum(dim=1), mg, 0, 1, math.inf, seed=seed, mparams=mp,
                                    obj_id=onemax.fused_id, ablate=("copy_only",))


# ------------------------------------- the floor harness with hooks (B7)

HOOK_FLOOR = ("sel_const", "no_matmul", "no_cross", "no_mut")


def _hook_case(name, L):
    """``(objective, crossover, mutate)`` of a hook set for the factories:
    creep (an expression mutation), half (an expression crossover, 0.5 *
    p1 + 0.25, not the identity on equal parents), trap (an expression
    objective), tour (order crossover, swap,
    the tour expression), tsp and tsp_creep (order crossover, the
    coordinate TSP fused gene-major, swap or creep), order_onemax (order
    crossover, swap, onemax)."""
    from libpga_tpu_torch import objectives as po
    from libpga_tpu_torch.ops import breed_expr as bx

    creep = bx.mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)",
                                      rate=0.05, sigma=0.1)
    c = random_tsp_coords(L, seed=1)
    return {
        "creep": lambda: (onemax, "uniform", creep),
        "half": lambda: (onemax, bx.crossover_from_expression("0.5 * p1 + 0.25"), "point"),
        "trap": lambda: (po.make_deceptive_trap(5), "uniform", "point"),
        "tour": lambda: (po.from_expression(TOUR, X=c[:, 0], Y=c[:, 1]), "order", "swap"),
        "tsp": lambda: (make_tsp_coords(c, duplicate_mode="genes"), "order", "swap"),
        "tsp_creep": lambda: (make_tsp_coords(c, duplicate_mode="genes"), "order", creep),
        "order_onemax": lambda: (onemax, "order", "swap"),
    }[name]()


def _hook_key(kw, multigen, dtype, geom=None):
    """The LAUNCHES name of an ablated launch of these keywords (at
    ``geom``: a one-generation expression breed counts under
    "ablate_expr_pipelined" where its shape routes there)."""
    hooked = (fs.is_expression(kw["crossover"]) or fs.is_expression(kw["mutate"])
              or "objective" in kw)
    order = kw["crossover"] == "order"
    parts = ["ablate"] + ["expr"] * hooked + ["multigen"] * multigen + ["order"] * order
    if len(parts) == 1:
        parts.append("breed")
    key = "_".join(parts)
    if key == "ablate_expr" and geom is not None:
        key = _expr_counter(kw["crossover"], kw["mutate"], kw.get("objective"), geom, dtype, key)
    return key + ("_bf16" if dtype == torch.bfloat16 else "")


def _random_draws(geom, L, kw, device, steps=None):
    """Random injected draws for the keywords' hooks (every stream any
    stage of them may read)."""
    z = fs.zero_draws(geom.G, geom.K, L, kw["mutate"], device, kw["crossover"], steps=steps)
    for f in ("sel_u", "mut_u", "fill", "expr_gene", "expr_row", "gauss"):
        if getattr(z, f) is not None:
            setattr(z, f, torch.rand_like(getattr(z, f)))
    if z.cross is not None:
        z.cross = (torch.rand_like(z.cross, dtype=torch.float32) < 0.5).to(torch.uint8)
    if z.tie is not None:
        z.tie = torch.randint(0, 2**32, z.tie.shape, device=device)
    return z


# (hooks, ablate, P, L, gene dtype)
HOOK_ABLATE_VARIANTS = [
    ("creep", ("sel_const",), 8192, 100, torch.float32),
    ("creep", ("no_matmul",), 1000, 100, torch.float32),
    ("creep", ("no_cross",), 8192, 100, torch.bfloat16),
    ("creep", ("no_mut",), 2100, 130, torch.float32),
    ("creep", HOOK_FLOOR, 8192, 100, torch.float32),
    ("creep", ("no_cross", "no_mut"), 4096, 100, torch.float32),  # a unit of its own
    ("half", ("no_cross",), 8192, 100, torch.float32),
    ("half", HOOK_FLOOR, 1000, 100, torch.bfloat16),
    ("trap", ("no_mut",), 4096, 60, torch.float32),
    ("trap", HOOK_FLOOR, 4096, 60, torch.float32),
    ("tour", ("sel_const",), 4096, 200, torch.float32),
    ("tour", ("no_cross",), 4096, 200, torch.float32),
    ("tour", ("no_mut",), 1000, 200, torch.float32),
    ("tour", HOOK_FLOOR, 4096, 200, torch.float32),
    ("tsp_creep", ("no_cross",), 2048, 1000, torch.float32),
    ("tsp", ("sel_const",), 4096, 100, torch.float32),
    ("tsp", ("no_matmul",), 1000, 100, torch.float32),
    ("tsp", ("no_cross",), 4096, 100, torch.float32),
    ("tsp", ("no_mut",), 4096, 100, torch.float32),
    ("tsp", HOOK_FLOOR, 2048, 1000, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", HOOK_ABLATE_VARIANTS,
                         ids=lambda v: f"{v[0]}-{'+'.join(v[1])}-{v[2]}x{v[3]}-{str(v[4])[6:]}")
def test_hook_ablated_breed_equals_plain_on_card(cuda_device, variant):
    """Each ablated case of expr_breed_kernel (expr_pipelined_kernel where
    the shape routes there), expr_order_kernel and order_breed_kernel
    equals its plain version, in production (Philox) and injected mode,
    every parity: genomes bit for bit, scores within rtol 1e-5 / atol
    1e-5 * L; the launches count apart from production."""
    hooks, ablate, P, L, dtype = variant
    objective, cross, mut = _hook_case(hooks, L)
    breed = fs.make_fused_breed(P, L, objective, crossover=cross, mutate=mut, ablate=ablate,
                                device=cuda_device, gene_dtype=dtype, mparams=(0.3, 0.05))
    geom, kw = breed.geom, breed.kw
    gen = torch.Generator(device=cuda_device).manual_seed(P + L)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = torch.rand(geom.Pp, generator=gen, device=cuda_device)
    s[P:] = -torch.inf
    key = _hook_key(kw, False, dtype, geom)
    before = dict(kernels.LAUNCHES)
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        philox = fs.philox_draws(seed, geom.G, geom.K, L, mut, cross)
        injected = _random_draws(geom, L, kw, cuda_device)
        for mode, draws in ((dict(seed=seed), philox), (dict(draws=injected), injected)):
            got = fs.deme_breed(g, ranks, geom, parity, **mode, **kw)
            want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert bool(torch.isinf(got[1][P:]).all())
            torch.testing.assert_close(got[1][:P], want[1][:P], rtol=1e-5, atol=1e-5 * L)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {key: 2 * geom.parities}


# (hooks, ablate, P, L, elitism, freeze every group, gene dtype)
HOOK_MULTIGEN_VARIANTS = [
    ("creep", ("no_freeze",), 8192, 100, 2, True, torch.float32),
    ("creep", ("no_rank_cube",), 8192, 100, 0, False, torch.float32),
    ("creep", ("no_mut",), 4096, 100, 2, False, torch.bfloat16),
    ("creep", HOOK_FLOOR, 8192, 100, 0, False, torch.float32),
    ("creep", ("no_cross", "no_mut"), 4096, 100, 0, True, torch.float32),  # its own unit
    ("half", ("sel_const",), 8192, 100, 2, False, torch.float32),
    ("half", ("no_matmul",), 1000, 100, 2, False, torch.float32),
    ("trap", ("no_cross",), 4096, 60, 0, False, torch.float32),
    ("tour", ("no_cross",), 4096, 200, 2, False, torch.float32),
    ("tour", ("no_rank_cube",), 4096, 200, 0, False, torch.float32),
    ("tour", ("sel_const",), 4096, 200, 2, False, torch.float32),
    ("order_onemax", ("no_cross",), 4096, 100, 2, False, torch.float32),
    ("order_onemax", ("no_freeze",), 4096, 100, 0, True, torch.float32),
    ("order_onemax", ("sel_const",), 4096, 100, 2, False, torch.float32),
    ("order_onemax", HOOK_FLOOR, 1000, 130, 0, False, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", HOOK_MULTIGEN_VARIANTS,
                         ids=lambda v: f"{v[0]}-{'+'.join(v[1])}-{v[2]}x{v[3]}-e{v[4]}")
def test_hook_ablated_multigen_equals_plain_on_card(cuda_device, variant):
    """Each ablated case of expr_multigen_kernel<false/true> and
    multigen_breed_kernel<true> equals its plain version at 3 steps,
    Philox and injected draws, every parity: genomes and scores exactly.
    Under sel_const and no_matmul the elites are crossed or walked, not
    copied (C7); ``freeze``: a target every group has reached."""
    hooks, ablate, P, L, e, freeze, dtype = variant
    objective, cross, mut = _hook_case(hooks, L)
    launch = fs.make_fused_multigen(P, L, objective, crossover=cross, mutate=mut, elitism=e,
                                    ablate=ablate, device=cuda_device, gene_dtype=dtype,
                                    mparams=(0.3, 0.05))
    geom, kw = launch.geom, launch.kw
    gen = torch.Generator(device=cuda_device).manual_seed(P + L + e)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = torch.full((geom.Pp,), -torch.inf, device=cuda_device)
    s[:P] = torch.rand(P, generator=gen, device=cuda_device)
    target = float(s[:P].min()) if freeze else None
    key = _hook_key(kw, True, dtype)
    steps = 3
    draws = _random_draws(geom, L, kw, cuda_device, steps=steps)
    before = kernels.LAUNCHES[key]
    for parity in range(geom.parities):
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        for mode in (dict(seed=seed), dict(draws=draws)):
            got = fs.multigen_breed(g, s, geom, parity, steps, target, **mode, **kw)
            want = fs.multigen_breed_reference(
                g, s, geom, parity, steps, math.inf if target is None else target, **mode, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.LAUNCHES[key] == before + 2 * geom.parities


@pytest.mark.cuda
@pytest.mark.parametrize("hooks,L", [("creep", 100), ("trap", 60), ("tsp", 1000), ("tour", 200)])
def test_copy_with_hooks_launches_the_builtin_copy_on_card(cuda_device, hooks, L):
    """copy_only with any hooks is deme_breed_kernel's copy, at the hooks'
    geometry (order crossover: riffle, D = 1): the row permutation, each
    row handed its score, counted as "ablate_copy"."""
    objective, cross, mut = _hook_case(hooks, L)
    breed = fs.make_fused_breed(8192, L, objective, crossover=cross, mutate=mut,
                                ablate=("copy_only", "no_rank_sort"), device=cuda_device)
    geom, kw = breed.geom, breed.kw
    g = torch.rand((geom.Pp, L), device=cuda_device)
    s = torch.rand(geom.Pp, device=cuda_device)
    handed = s.view(geom.G, geom.K)
    before = dict(kernels.LAUNCHES)
    got = fs.deme_breed(g, handed, geom, 0, **kw)
    want = fs.deme_breed_reference(g, handed, geom, 0, None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _, write = geom.row_maps(0, cuda_device)
    assert torch.equal(got[0][write.reshape(-1)], g)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {"ablate_copy": 1}


# (hooks, multigen, P, L): a no_mut child is the production child before
# mutation, which the production kernel breeds at mutation rate 0.
NO_MUT_VARIANTS = [
    ("point", False, 8192, 100), ("creep", False, 8192, 100), ("tsp", False, 4096, 100),
    ("tour", False, 4096, 200), ("creep", True, 8192, 100), ("order_onemax", True, 4096, 100),
    ("tour", True, 4096, 200),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", NO_MUT_VARIANTS, ids=lambda v: f"{v[0]}-mg{int(v[1])}")
def test_removing_mutation_changes_only_mutation_on_card(cuda_device, variant):
    """Removing a stage changes that stage alone: the no_mut kernel at
    rate 0.3 breeds, bit for bit, the production kernel's children at
    rate 0 (no mutation fires; point, swap and the creep hook draw the
    same), scores included, with the same seed: the Philox counters of
    the stages that remain are unchanged."""
    hooks, multigen, P, L = variant
    objective, cross, mut = ((onemax, "uniform", "point") if hooks == "point"
                             else _hook_case(hooks, L))
    make = fs.make_fused_multigen if multigen else fs.make_fused_breed
    prod = make(P, L, objective, crossover=cross, mutate=mut, device=cuda_device,
                mparams=(0.0, 0.05))
    ablated = make(P, L, objective, crossover=cross, mutate=mut, device=cuda_device,
                   mparams=(0.3, 0.05), ablate=("no_mut",))
    geom = prod.geom
    gen = torch.Generator(device=cuda_device).manual_seed(P)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.full((geom.Pp,), -torch.inf, device=cuda_device)
    s[:P] = torch.rand(P, generator=gen, device=cuda_device)
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
    if multigen:
        a = fs.multigen_breed(g, s, geom, 0, 3, None, seed=seed, **prod.kw)
        b = fs.multigen_breed(g, s, geom, 0, 3, None, seed=seed, **ablated.kw)
    else:
        ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        a = fs.deme_breed(g, ranks, geom, 0, seed=seed, **prod.kw)
        b = fs.deme_breed(g, ranks, geom, 0, seed=seed, **ablated.kw)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_hook_ablated_kernels_reject_bad_arguments(cuda_device):
    objective, cross, mut = _hook_case("tsp", 100)
    geom = fs.resolve_geometry(4096, 100, crossover="order")
    g = torch.rand((geom.Pp, 100), device=cuda_device)
    ranks = torch.zeros((geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    mp = torch.tensor([0.01, 0.0], device=cuda_device)
    with pytest.raises(ValueError, match="copy"):  # the copy is deme_breed_kernel's
        kernels.order_breed_cuda(g, ranks, geom, 0, seed=seed, mparams=mp,
                                 obj_id=objective.fused_id, coords=objective.coords.to(cuda_device),
                                 ablate=("copy_only", "no_mut"))
    creep = _hook_case("creep", 100)[2]
    with pytest.raises(ValueError, match="copy"):
        kernels.expr_breed_cuda(g, ranks, fs.resolve_geometry(4096, 100), 0, seed=seed,
                                mparams=mp, mutate=creep, obj_id=onemax.fused_id,
                                ablate=("copy_only",))


# ------------------------------------------------- the sub-block pipeline

# (P, L, gene dtype, B, islands, mutate, gene_atol): JAX's sub-block
# geometries (resolve_geometry(subblock=B)), clusters of 1 (bf16 at L = 100;
# L = 33 at bf16, 2-byte-aligned rows: one gene a lane), 2 (float32 at
# L = 100), 4 (L = 128) and 8 blocks (L = 300, which also crosses 128-gene
# tiles); swap mutation re-sums a child four genes a lane and one; 8,000
# rows pad.
PIPE_VARIANTS = [
    (65_536, 100, torch.float32, 2, None, "point", 0.0),
    (65_536, 100, torch.float32, 4, None, "point", 0.0),
    (65_536, 100, torch.bfloat16, 2, None, "point", 0.0),
    (16_384, 100, torch.float32, 2, 8, "point", 0.0),
    (16_384, 100, torch.bfloat16, 2, 8, "point", 0.0),
    (65_536, 128, torch.float32, 2, None, "point", 0.0),
    (65_536, 300, torch.float32, 2, None, "gaussian", 1e-6),
    (65_536, 33, torch.bfloat16, 2, None, "swap", 0.0),
    (65_536, 100, torch.float32, 2, None, "swap", 0.0),
    (65_536, 100, torch.bfloat16, 4, None, "swap", 0.0),
    (8_000, 100, torch.float32, 2, None, "point", 0.0),
]


def warp_order_scores(genomes, P, obj_id=onemax.fused_id):
    """The breed kernels' scores of ``genomes`` as stored (pad rows -inf):
    each child's terms summed in a warp's lane order."""
    s = fs.rowwise_scores(obj_id, genomes.float(), warp_order=True)
    s[..., P:] = -torch.inf
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("variant", PIPE_VARIANTS,
                         ids=lambda v: f"{v[0]}x{v[1]}-{str(v[2])[6:]}-B{v[3]}-I{v[4]}-{v[5]}")
def test_pipelined_kernel_equals_plain_on_card(cuda_device, variant):
    """deme_pipelined_kernel equals its plain version (and deme_breed_kernel
    at the same geometry) on the same inputs, Philox and injected draws,
    both parities, one population or 8 islands, its scores the warp-order
    sums of the children bit for bit; it launches where the geometry's B is
    above 1 and counts under its own name."""
    P, L, dtype, B, islands, mutate, atol = variant
    geom = fs.resolve_geometry(P, L, gene_dtype=dtype, subblock=B)
    assert geom.layout == "pingpong" and geom.B == B
    assert kernels.pipelined_holds(geom, dtype)
    n = islands or 1
    lead = () if islands is None else (islands,)
    gen = torch.Generator(device=cuda_device).manual_seed(P + L + B)
    g = torch.rand(lead + (geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = g.float().sum(dim=-1)
    s[..., P:] = -torch.inf
    kw = dict(tournament_size=3, mutate=mutate, obj_id=onemax.fused_id,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device))
    key = ("deme_pipelined" if islands is None else "islands_deme_pipelined") + (
        "_bf16" if dtype == torch.bfloat16 else "")
    for parity in range(2):
        tie = fs.draw_tie_words(gen, n * geom.Pp, cuda_device).view(lead + (geom.Pp,))
        ranks = fs.compute_ranks(s, geom, parity, tie)
        seed = torch.randint(0, 2**62, (n,), generator=gen, device=cuda_device)
        draw = fs.philox_draws if islands is None else fs.island_philox_draws
        draws = draw(seed, geom.G, geom.K, L, mutate)
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        before = kernels.LAUNCHES[key]
        for got in (fs.deme_breed(g, ranks, geom, parity, seed=seed, islands=islands, **kw),
                    fs.deme_breed(g, ranks, geom, parity, draws=draws, islands=islands, **kw)):
            torch.cuda.synchronize()
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=atol)
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)
            assert torch.equal(got[1], warp_order_scores(got[0], P))
        assert kernels.LAUNCHES[key] == before + 2
        base = kernels.deme_breed_cuda(g, ranks, geom, parity, seed=seed, islands=islands, **kw)
        got = fs.deme_breed(g, ranks, geom, parity, seed=seed, islands=islands, **kw)
        torch.testing.assert_close(got[0], base[0], rtol=0, atol=atol)
        if atol == 0.0:
            assert torch.equal(got[1], base[1])


# (P, L, gene dtype, islands, mutate, objective, gene_atol): PGA.run's B = 1
# cells at small sizes: the padded riffle (40,000 rows: 192 pad rows, 157
# demes), ping-pong with pad rows, bf16, the Rastrigin islands' L = 30 (one
# gene a lane) with gaussian mutation, a shard launch of L = 128 (C = 4).
B1_VARIANTS = [
    (40_000, 100, torch.float32, None, "point", onemax, 0.0),
    (1000, 20, torch.float32, None, "swap", onemax, 0.0),
    (65_536, 100, torch.bfloat16, None, "point", onemax, 0.0),
    (16_384, 30, torch.float32, 8, "gaussian", rastrigin, 1e-6),
    (16_384, 128, torch.float32, 4, "point", onemax, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", B1_VARIANTS,
                         ids=lambda v: f"{v[0]}x{v[1]}-{str(v[2])[6:]}-I{v[3]}-{v[4]}")
def test_b1_breed_launches_the_pipelined_kernel_on_card(cuda_device, variant):
    """At B = 1 the builtin breed launches deme_pipelined_kernel wherever a
    cluster holds the deme, counted under its own name, and equals
    deme_breed_kernel (pipelined=False) at the same geometry bit for bit,
    children and scores, and its plain version, Philox and injected draws,
    every parity."""
    P, L, dtype, islands, mutate, obj, atol = variant
    geom = fs.resolve_geometry(P, L, gene_dtype=dtype)
    assert geom.B == 1 and kernels.pipelined_holds(geom, dtype)
    n = islands or 1
    lead = () if islands is None else (islands,)
    gen = torch.Generator(device=cuda_device).manual_seed(P + L)
    g = torch.rand(lead + (geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    g[..., P:, :] = 0
    s = g.float().sum(dim=-1)
    s[..., P:] = -torch.inf
    kw = dict(tournament_size=2, mutate=mutate, obj_id=obj.fused_id,
              mparams=torch.tensor([0.3, 0.05], device=cuda_device))
    key = _deme_key(geom, dtype, islands=islands is not None)
    for parity in range(geom.parities):
        tie = fs.draw_tie_words(gen, n * geom.Pp, cuda_device).view(lead + (geom.Pp,))
        ranks = fs.compute_ranks(s, geom, parity, tie)
        seed = torch.randint(0, 2**62, (n,), generator=gen, device=cuda_device)
        draw = fs.philox_draws if islands is None else fs.island_philox_draws
        draws = draw(seed, geom.G, geom.K, L, mutate)
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        for mode in (dict(seed=seed), dict(draws=draws)):
            before = kernels.LAUNCHES[key]
            got = fs.deme_breed(g, ranks, geom, parity, islands=islands, **mode, **kw)
            old = kernels.deme_breed_cuda(g, ranks, geom, parity, islands=islands,
                                          pipelined=False, **mode, **kw)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[key] == before + 1
            assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=atol)
            real = torch.arange(geom.Pp, device=cuda_device) < P
            assert bool(torch.isinf(got[1][..., ~real]).all())
            torch.testing.assert_close(got[1][..., real], want[1][..., real], rtol=1e-5,
                                       atol=1e-3)


@pytest.mark.cuda
def test_deme_no_cluster_holds_breeds_through_deme_breed_kernel_on_card(cuda_device):
    """At 131,072x1,024 float32, B = 2 (K = 256: 1 MB a deme) no cluster
    of at most 8 blocks holds a deme: the breed launches deme_breed_kernel
    at the B-aware geometry, counted under its layout, bit for bit against
    the plain version; the pipelined wrapper refuses the shape."""
    P, L = 131_072, 1024
    geom = fs.resolve_geometry(P, L, subblock=2)
    assert geom.B == 2 and geom.K == 256 and not kernels.pipelined_holds(geom, torch.float32)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    kw = dict(obj_id=onemax.fused_id, mparams=torch.tensor([0.05, 0.0], device=cuda_device))
    for parity in range(2):
        ranks = fs.compute_ranks(g.sum(dim=1), geom, parity,
                                 fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        kernels.reset_launches()
        got = fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), "pingpong": 1}
        want = fs.deme_breed_reference(g, ranks, geom, parity,
                                       fs.philox_draws(seed, geom.G, geom.K, L), **kw)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], warp_order_scores(got[0], P))
    with pytest.raises(ValueError, match="no cluster"):
        kernels.deme_breed_cuda(g, ranks, geom, 0, seed=seed, pipelined=True, **kw)


@pytest.mark.cuda
def test_pipelined_kernel_rejects_bad_arguments(cuda_device):
    geom = fs.resolve_geometry(65_536, 100, subblock=2)
    g = torch.rand((geom.Pp, 100), device=cuda_device)
    ranks = torch.zeros((geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    mp = torch.tensor([0.01, 0.0], device=cuda_device)
    with pytest.raises(ValueError, match="no copy"):
        kernels.deme_breed_cuda(g, ranks.float(), geom, 0, mparams=mp, pipelined=True,
                                ablate=("copy_only", "no_mut"))
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.rand(geom.Pp * 100 + 1, device=cuda_device)
        kernels.deme_breed_cuda(flat[1:].view(geom.Pp, 100), ranks, geom, 0, seed=seed,
                                mparams=mp, pipelined=True)
    with pytest.raises(ValueError, match="alias"):
        kernels.deme_breed_cuda(g, ranks, geom, 0, seed=seed, mparams=mp, pipelined=True, out=g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_on_card_runs_subblock_through_the_pipelined_kernel(cuda_device, dtype):
    """``PGA.run`` and ``run_islands`` at ``subblock=2`` launch the pipelined
    kernel once a generation and nothing else; the best rises."""
    from libpga_tpu_torch import PGAConfig
    from libpga_tpu_torch import pga_create_population, pga_init, pga_run, pga_run_islands
    from libpga_tpu_torch import pga_set_objective_function

    bf = "_bf16" if dtype == torch.bfloat16 else ""
    p = pga_init(0, PGAConfig(subblock=2, gene_dtype=dtype))
    h = pga_create_population(p, 65_536, 100)
    pga_set_objective_function(p, "onemax")
    start = float(p.population(h).genomes.float().sum(dim=1).max())
    kernels.reset_launches()
    assert pga_run(p, 12) == 12
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0), "deme_pipelined" + bf: 12}
    assert p.get_best_with_score(h)[1] > start
    q = pga_init(1, PGAConfig(subblock=2, gene_dtype=dtype))
    for _ in range(4):
        pga_create_population(q, 16_384, 100)
    pga_set_objective_function(q, "onemax")
    kernels.reset_launches()
    assert pga_run_islands(q, 20, 10, 0.05) == 20
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**dict.fromkeys(kernels.LAUNCHES, 0),
                                "islands_deme_pipelined" + bf: 20}


# ------------------- the floor harness at B > 1 and its combinations (B10)

# (flags, P, L, gene dtype, B, mutate): deme_pipelined_kernel's stage cases
# (the harness unit) and a combination (a unit of its own), at JAX's
# sub-block geometries; 8,000 rows pad, L = 300 crosses 128-gene tiles.
PIPE_ABLATE_VARIANTS = [
    (("sel_const",), 65_536, 100, torch.float32, 2, "point"),
    (("no_matmul",), 65_536, 100, torch.float32, 4, "point"),
    (("no_cross",), 65_536, 300, torch.float32, 2, "gaussian"),
    (("no_mut",), 65_536, 33, torch.bfloat16, 2, "swap"),
    (("sel_const", "no_matmul", "no_cross", "no_mut"), 65_536, 100, torch.bfloat16, 2, "point"),
    (("sel_const", "no_matmul", "no_cross", "no_mut"), 8_000, 100, torch.float32, 2, "point"),
    (("sel_const", "no_cross"), 65_536, 100, torch.float32, 2, "point"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", PIPE_ABLATE_VARIANTS,
                         ids=lambda v: f"{'+'.join(v[0])}-{v[1]}x{v[2]}-{str(v[3])[6:]}-B{v[4]}")
def test_pipelined_ablated_breed_equals_plain_on_card(cuda_device, variant):
    """``make_fused_breed(ablate=..., subblock=B)`` launches
    deme_pipelined_kernel's case of the flags, which equals its plain
    version in Philox and injected draws, both parities, and counts as
    "ablate_pipelined" (and under its mask)."""
    ablate, P, L, dtype, B, mutate = variant
    breed = fs.make_fused_breed(P, L, onemax, ablate=ablate, subblock=B, device=cuda_device,
                                gene_dtype=dtype, mutate=mutate, mparams=(0.3, 0.05),
                                tournament_size=3)
    geom, kw = breed.geom, breed.kw
    assert geom.layout == "pingpong" and geom.B == B
    gen = torch.Generator(device=cuda_device).manual_seed(P + L + B)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = g.float().sum(dim=1)
    s[P:] = -torch.inf
    key = "ablate_pipelined" + ("_bf16" if dtype == torch.bfloat16 else "")
    mask = kernels.ablate_mask(ablate)
    for parity in range(2):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        draws = fs.philox_draws(seed, geom.G, geom.K, L, mutate)
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        before = dict(kernels.LAUNCHES)
        masked = kernels.MASK_LAUNCHES.get((key, mask), 0)
        for got in (fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw),
                    fs.deme_breed(g, ranks, geom, parity, draws=draws, **kw)):
            torch.cuda.synchronize()
            torch.testing.assert_close(got[0], want[0], rtol=0,
                                       atol=1e-6 if mutate == "gaussian" else 0.0)
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)
            assert torch.equal(got[1], warp_order_scores(got[0], P))
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        assert launched == {key: 2}
        assert kernels.MASK_LAUNCHES[(key, mask)] == masked + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pipelined_no_mut_is_the_production_child_at_rate_zero_on_card(cuda_device, dtype):
    """The pipelined no_mut case at rate 0.3 breeds the production
    pipelined kernel's children at rate 0, bit for bit, scores included:
    the other stages keep their Philox counters; and ABLATE = 0 is the
    production launch, counted as such."""
    P, L = 65_536, 100
    prod = fs.make_fused_breed(P, L, onemax, subblock=2, device=cuda_device, gene_dtype=dtype,
                               mparams=(0.0, 0.0), ablate=())
    ablated = fs.make_fused_breed(P, L, onemax, subblock=2, device=cuda_device, gene_dtype=dtype,
                                  mparams=(0.3, 0.0), ablate=("no_mut",))
    geom = prod.geom
    assert geom.B == 2 and "ablate" not in prod.kw
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device).to(dtype)
    s = g.float().sum(dim=1)
    ranks = fs.compute_ranks(s, geom, 1, fs.draw_tie_words(gen, geom.Pp, cuda_device))
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
    before = dict(kernels.LAUNCHES)
    a = fs.deme_breed(g, ranks, geom, 1, seed=seed, **prod.kw)
    b = fs.deme_breed(g, ranks, geom, 1, seed=seed, **ablated.kw)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    bf = "_bf16" if dtype == torch.bfloat16 else ""
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {"deme_pipelined" + bf: 1, "ablate_pipelined" + bf: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("ablate", [("no_mut",), ("sel_const", "no_matmul", "no_cross", "no_mut"),
                                    ("no_cross", "no_mut")], ids="+".join)
def test_expression_hook_ablated_at_subblock_equals_plain_on_card(cuda_device, ablate):
    """With the creep hook at B = 2 the factory launches
    expr_pipelined_kernel's case of the flags on the B-aware maps (its
    harness unit, or a unit of its own for a combination), equal to its
    plain version, both parities, Philox and injected draws."""
    objective, cross, mut = _hook_case("creep", 100)
    P, L = 65_536, 100
    breed = fs.make_fused_breed(P, L, objective, crossover=cross, mutate=mut, subblock=2,
                                ablate=ablate, device=cuda_device, mparams=(0.3, 0.1))
    geom, kw = breed.geom, breed.kw
    assert geom.B == 2
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = g.sum(dim=1)
    for parity in range(2):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        draws = fs.philox_draws(seed, geom.G, geom.K, L, mut)
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        before = kernels.LAUNCHES["ablate_expr_pipelined"]
        for got in (fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw),
                    fs.deme_breed(g, ranks, geom, parity, draws=draws, **kw)):
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-3)
        assert kernels.LAUNCHES["ablate_expr_pipelined"] == before + 2


# (kernel, flags, hooks, P, L, steps, elitism): combinations outside the
# production unit's masks, each launched from a unit of its own.
COMBO_VARIANTS = [
    ("deme", ("sel_const", "no_cross"), "point", 8192, 100, 1, 0),
    ("deme", ("no_cross", "no_mut"), "point", 1000, 100, 1, 0),
    ("order", ("no_matmul", "no_mut"), "tsp", 4096, 100, 1, 0),
    ("multigen", ("no_freeze", "no_rank_cube"), "point", 8192, 100, 3, 2),
    ("multigen", ("sel_const", "no_mut"), "point", 8192, 100, 3, 2),
    ("multigen_order", ("no_freeze", "no_cross"), "order_onemax", 4096, 100, 3, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", COMBO_VARIANTS, ids=lambda v: f"{v[0]}-{'+'.join(v[1])}")
def test_combo_ablated_kernels_equal_plain_on_card(cuda_device, variant):
    """A combination of flags outside the production unit's masks builds a
    deme_breed.cu unit of its own (DEME_ABLATE_EXTRA) and equals its plain
    version, Philox and injected draws; copy_only with a stage flag
    launches the copy."""
    kernel, ablate, hooks, P, L, steps, e = variant
    objective, cross, mut = (onemax, "uniform", "point") if hooks == "point" else \
        _hook_case(hooks, L)
    mask = kernels.ablate_mask(ablate, multigen=True)
    unit = "multigen" if kernel.startswith("multigen") else kernel
    assert kernels.deme_macro(unit, mask) == f"#define DEME_ABLATE_EXTRA {mask}u\n"
    gen = torch.Generator(device=cuda_device).manual_seed(P + mask)
    key = "ablate_" + {"deme": "breed", "order": "order"}.get(kernel, kernel)
    if steps > 1:
        launch = fs.make_fused_multigen(P, L, objective, crossover=cross, mutate=mut, elitism=e,
                                        ablate=ablate, device=cuda_device, mparams=(0.3, 0.0))
        geom, kw = launch.geom, launch.kw
        g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
        s = torch.full((geom.Pp,), -torch.inf, device=cuda_device)
        s[:P] = g[:P].sum(dim=1)
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        target = float(s[:P].min()) if "no_freeze" in ablate else None
        before = kernels.MASK_LAUNCHES.get((key, mask), 0)
        got = fs.multigen_breed(g, s, geom, 0, steps, target, seed=seed, **kw)
        want = fs.multigen_breed_reference(g, s, geom, 0, steps,
                                           math.inf if target is None else target, seed=seed, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert kernels.MASK_LAUNCHES[(key, mask)] == before + 1
        return
    breed = fs.make_fused_breed(P, L, objective, crossover=cross, mutate=mut, ablate=ablate,
                                device=cuda_device, mparams=(0.3, 0.0))
    geom, kw = breed.geom, breed.kw
    if kernel == "deme":
        key = _deme_key(geom, ablate=True)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.full((geom.Pp,), -torch.inf, device=cuda_device)
    s[:P] = g[:P].sum(dim=1)
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        draws = fs.philox_draws(seed, geom.G, geom.K, L, mut, cross)
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        before = kernels.MASK_LAUNCHES.get((key, mask), 0)
        for got in (fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw),
                    fs.deme_breed(g, ranks, geom, parity, draws=draws, **kw)):
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            fin = torch.isfinite(want[1])
            torch.testing.assert_close(got[1][fin], want[1][fin], rtol=1e-5, atol=1e-3)
        assert kernels.MASK_LAUNCHES[(key, mask)] == before + 2
    copy = fs.make_fused_breed(P, L, objective, crossover=cross, mutate=mut, device=cuda_device,
                               ablate=("copy_only", "no_rank_sort") + ablate)
    g = torch.rand((copy.geom.Pp, L), generator=gen, device=cuda_device)
    before = dict(kernels.LAUNCHES)
    out, _ = copy(g, g.sum(dim=1), 0, gen)
    torch.cuda.synchronize()
    read, write = copy.geom.row_maps(0, cuda_device)
    assert torch.equal(out[write.reshape(-1)], g[read.reshape(-1)])
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
    assert launched == {"ablate_copy": 1}


# (P, L, S, gene dtype): sharded runs on the kernel route (B9).
SHARD_VARIANTS = [
    (65_536, 128, 4, torch.float32),
    (65_536, 128, 8, torch.float32),
    (65_536, 128, 4, torch.bfloat16),
    (262_144, 256, 8, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", SHARD_VARIANTS,
                         ids=lambda v: f"{v[0]}x{v[1]}-S{v[2]}-{str(v[3])[6:]}")
def test_sharded_launch_equals_plain_island_breed_on_card(cuda_device, variant):
    """The sharded run's step on the kernel route, one launch of the island
    breed over the S shards at elitism 0, equals the plain island breed on
    the draws its generator gives (replayed), both parities; the injected
    draws give the same children; it counts as an island launch."""
    from libpga_tpu_torch import PGA, PGAConfig

    P, L, S, dtype = variant
    pp = PGA(seed=0, config=PGAConfig(pop_shards=S, gene_dtype=dtype, mutation_rate=0.05))
    pp.set_objective("onemax")
    step, _ = pp._sharded_local_step(P // S, L)
    geom, kw = step.breed.geom, step.breed.kw
    assert geom.Pp == P // S and geom.layout == "pingpong"
    g = torch.rand((S, geom.Pp, L), device=cuda_device).to(dtype)
    s = g.float().sum(dim=-1)
    key = _deme_key(geom, dtype, islands=True)
    for gen in (0, 1):
        before = kernels.LAUNCHES[key]
        got = step(g, s, gen, torch.Generator(device=cuda_device).manual_seed(gen))
        replay = torch.Generator(device=cuda_device).manual_seed(gen)
        tie = fs.draw_tie_words(replay, S * geom.Pp, cuda_device).view(S, geom.Pp)
        ranks = fs.compute_ranks(s, geom, gen, tie)
        seeds = torch.randint(0, 2**63 - 1, (S,), generator=replay, device=cuda_device)
        draws = fs.island_philox_draws(seeds, geom.G, geom.K, L)
        want = fs.deme_breed_reference(g, ranks, geom, gen, draws, **kw)
        injected = fs.deme_breed(g, ranks, geom, gen, draws=draws, islands=S, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[key] == before + 2
        for out in (got, injected):
            assert torch.equal(out[0], want[0])
            torch.testing.assert_close(out[1], want[1], rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_engine_on_card_breeds_every_shard_in_one_launch(cuda_device, dtype):
    """``PGA.run`` at ``pop_shards=4``: at 65,536x128 one launch a
    generation for all shards and nothing else, the best rising and the
    scores the genomes' onemax; the creep expression launches the
    expression kernel the same way; at 65,536x64 (no exact fit) nothing
    launches."""
    from libpga_tpu_torch import PGAConfig, mutate_from_expression
    from libpga_tpu_torch import pga_create_population, pga_init, pga_run
    from libpga_tpu_torch import pga_set_mutate_function, pga_set_objective_function

    bf = "_bf16" if dtype == torch.bfloat16 else ""
    shard = fs.resolve_geometry(16_384, 128, gene_dtype=dtype)
    for L, mutate, key in ((128, None, _deme_key(shard, dtype, islands=True)),
                           (128, "creep", "islands_expr_pipelined" + bf),
                           (64, None, None)):
        p = pga_init(0, PGAConfig(pop_shards=4, gene_dtype=dtype))
        h = pga_create_population(p, 65_536, L)
        pga_set_objective_function(p, "onemax")
        if mutate:
            pga_set_mutate_function(p, mutate_from_expression(
                "where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05, sigma=0.1))
        start = float(p.population(h).genomes.float().sum(dim=1).max())
        kernels.reset_launches()
        assert pga_run(p, 12) == 12
        torch.cuda.synchronize()
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        if key:
            want[key] = 12
        assert kernels.LAUNCHES == want and p.launches == (12 if key else 0)
        pop = p.population(h)
        assert pop.genomes.shape == (65_536, L) and pop.genomes.dtype == dtype
        torch.testing.assert_close(pop.scores, pop.genomes.float().sum(dim=1), rtol=0, atol=1e-3)
        assert p.get_best_with_score(h)[1] > start


# The multi-generation cluster schedule: multigen_breed_kernel<false>
# holding each group in a thread-block cluster's shared memory
# (csrc/mg_plan.cuh), against the plain version and against the one-block
# schedule (cluster=False), children and scores bit for bit; and the
# expression kernel, which breeds on the one-block schedule alone, at the
# same shapes. (hooks, P, L, dtype, layout, steps, elitism, scores,
# islands, ablate): scores "objective" are the genomes' own, "freeze" with
# a target some groups reach mid-launch, "nan" with NaN among them.
CLUSTER_VARIANTS = [
    ("onemax", 65_536, 100, torch.float32, None, 3, 0, "objective", None, ()),
    ("onemax", 65_536, 100, torch.float32, "riffle", 8, 2, "objective", None, ()),
    ("onemax", 65_536, 100, torch.float32, None, 0, 0, "objective", None, ()),
    ("onemax", 65_536, 100, torch.float32, None, 1, 2, "objective", None, ()),
    ("onemax", 65_536, 100, torch.float32, None, 2, 0, "freeze", None, ()),
    ("onemax", 65_536, 100, torch.float32, None, 8, 0, "freeze", None, ()),
    ("onemax", 65_536, 100, torch.float32, None, 3, 0, "nan", None, ()),
    ("onemax", 65_000, 100, torch.float32, None, 3, 0, "objective", None, ()),  # riffle tail
    ("onemax", 1000, 20, torch.float32, None, 3, 0, "freeze", None, ()),  # ping-pong pad rows
    ("onemax", 40_000, 100, torch.float32, None, 3, 2, "objective", None, ()),  # C = 1
    ("onemax", 8192, 130, torch.float32, None, 3, 2, "objective", None, ()),  # L % 4, two tiles
    ("swap", 8192, 100, torch.float32, None, 3, 2, "objective", None, ()),
    ("gaussian", 8192, 100, torch.float32, None, 2, 0, "objective", None, ()),
    ("rastrigin", 4096, 30, torch.float32, None, 2, 0, "objective", None, ()),
    ("onemax", 65_536, 100, torch.bfloat16, None, 3, 2, "objective", None, ()),
    ("onemax", 65_536, 100, torch.bfloat16, None, 8, 0, "freeze", None, ()),
    ("onemax", 16_384, 100, torch.float32, None, 3, 0, "freeze", 4, ()),
    ("onemax", 16_384, 100, torch.bfloat16, None, 3, 2, "objective", 3, ()),
    *[("onemax", 65_536, 100, dt, None, 3, 2, sc, None, a)
      for a, dt, sc in ((("no_freeze",), torch.float32, "freeze"),
                        (("no_rank_cube",), torch.float32, "objective"),
                        (("sel_const",), torch.float32, "objective"),
                        (("no_matmul",), torch.bfloat16, "objective"),
                        (("no_cross",), torch.float32, "objective"),
                        (("no_mut",), torch.float32, "objective"),
                        (ABLATE_FLOOR, torch.float32, "objective"),
                        (("no_cross", "no_mut"), torch.float32, "objective"))],
]
EXPR_VARIANTS = [
    ("creep", 65_536, 100, torch.float32, None, 3, 2, "objective", None, ()),
    ("creep", 65_536, 100, torch.bfloat16, None, 8, 0, "freeze", None, ()),
    ("creep", 16_384, 100, torch.float32, None, 3, 0, "objective", 4, ()),
    ("creep", 40_000, 100, torch.float32, None, 8, 2, "freeze", None, ()),  # C = 1, pad rows
    ("creep", 65_536, 100, torch.float32, "riffle", 0, 0, "objective", None, ()),
    ("creep", 65_536, 100, torch.float32, None, 1, 2, "objective", None, ()),
    ("one_point", 65_536, 100, torch.float32, None, 3, 2, "objective", None, ()),
    ("nk", 16_384, 64, torch.float32, None, 3, 0, "objective", None, ()),
    ("nk", 16_384, 64, torch.float32, None, 8, 2, "freeze", None, ()),
    ("trap", 65_536, 60, torch.float32, None, 3, 2, "nan", None, ()),
    ("trap", 16_384, 60, torch.bfloat16, None, 3, 0, "objective", 2, ()),
    ("trap_swap", 16_384, 60, torch.float32, None, 3, 2, "objective", None, ()),  # ROWED
    ("trap_swap", 16_384, 60, torch.bfloat16, None, 3, 2, "objective", None, ()),  # own row
    ("trap_gauss", 16_384, 60, torch.float32, None, 2, 0, "objective", None, ()),
    ("rolled", 16_384, 64, torch.bfloat16, None, 3, 0, "objective", None, ()),
    ("knapsack", 4096, 6, torch.float32, None, 3, 2, "objective", None, ()),  # one block
    ("creep", 65_536, 100, torch.float32, None, 3, 2, "freeze", None, ("no_freeze",)),
    *[(h, 65_536, L, torch.float32, None, 3, 2, "objective", None, a)
      for h, L, a in (("creep", 100, ("sel_const",)), ("one_point", 100, ("no_matmul",)),
                      ("one_point", 100, ("no_cross",)), ("creep", 100, ("no_mut",)),
                      ("trap", 60, ("no_rank_cube",)), ("trap", 60, ABLATE_FLOOR))],
]
_VARIANT_ID = (lambda v: f"{v[0]}-{v[1]}x{v[2]}-{str(v[3])[6:]}-{v[4]}-s{v[5]}-e{v[6]}-{v[7]}"
                         f"-i{v[8]}-{'+'.join(v[9]) or 'prod'}")


def _cluster_case(hooks):
    """``(objective, crossover, mutate, mparams, exact)`` of a hook set;
    ``exact`` False where a transcendental may differ in the last ulp from
    torch's (the two schedules still agree bit for bit)."""
    from libpga_tpu_torch import objectives as po
    from libpga_tpu_torch.ops import breed_expr as bx

    creep = bx.mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)",
                                      rate=0.05, sigma=0.1)
    one_point = bx.crossover_from_expression("where(i < floor(q * L), p1, p2)")
    return {
        "onemax": (onemax, "uniform", "point", (0.3, 0.0), True),
        "swap": (onemax, "uniform", "swap", (0.5, 0.0), True),
        "gaussian": (onemax, "uniform", "gaussian", (0.3, 0.05), False),
        "rastrigin": (rastrigin, "uniform", "point", (0.3, 0.0), False),
        "creep": (onemax, "uniform", creep, (0.05, 0.1), True),
        "one_point": (onemax, one_point, "point", (0.3, 0.0), True),
        "nk": (po.make_nk_landscape(64, 3, seed=0), "uniform", "point", (0.3, 0.0), True),
        "trap": (po.make_deceptive_trap(5), "uniform", "point", (0.3, 0.0), True),
        "trap_swap": (po.make_deceptive_trap(5), "uniform", "swap", (0.5, 0.0), True),
        "trap_gauss": (po.make_deceptive_trap(5), "uniform", "gaussian", (0.3, 0.05), False),
        "rolled": (po.from_expression("sum(roll(g, 1) * g)"), "uniform", "point", (0.3, 0.0),
                   True),
        "knapsack": (po.default_knapsack, "uniform", "point", (0.3, 0.0), True),
    }[hooks]


def _multigen_against_plain(device, variant, cluster: Optional[bool]):
    """Launches ``variant`` through ``fs.multigen_breed`` at every parity,
    Philox and injected draws, and holds it against the plain version:
    genomes and scores bit for bit (within 2 ulp / rtol 1e-5 after a
    transcendental at one step). ``cluster``: each launch takes the
    cluster route, counted under CLUSTER_LAUNCHES, and equals the
    one-block schedule (cluster=False), whose launches are not counted
    there; False: no launch takes the cluster route; None: the expression
    kernel's plan decides which (kernels.expr_multigen_holds)."""
    from libpga_tpu_torch.ops.evaluate import evaluate

    hooks, P, L, dtype, layout, steps, e, scores, islands, ablate = variant
    objective, cross, mut, mparams, exact = _cluster_case(hooks)
    launch = fs.make_fused_multigen(P, L, objective, crossover=cross, mutate=mut, elitism=e,
                                    layout=layout, ablate=ablate, device=device,
                                    gene_dtype=dtype, mparams=mparams)
    geom, kw = launch.geom, launch.kw
    if cluster is None:
        program = expr_cuda.program_for(*(op if fs.is_expression(op) else None
                                          for op in (cross, mut)), kw.get("objective"))
        mut_id = 0 if fs.is_expression(mut) else kernels.MUTATE_IDS[mut]
        cluster = kernels.expr_multigen_holds(program, geom, dtype, mut_id,
                                              ablate=kernels.ablate_mask(ablate, multigen=True))
        assert cluster == (L % 4 == 0)  # every variant's group fits a cluster
    elif cluster:
        assert kernels.multigen_cluster_plan(geom, dtype, cross)
    gen = torch.Generator(device=device).manual_seed(P + L + steps + e)
    lead = () if islands is None else (islands,)
    g = torch.rand(lead + (geom.Pp, L), generator=gen, device=device).to(dtype)
    s = torch.full(lead + (geom.Pp,), -torch.inf, device=device)
    s[..., :P] = evaluate(objective, g[..., :P, :].float().reshape(-1, L)).view(lead + (P,))
    target = None
    if scores == "freeze":  # reached by some groups after a generation or two
        target = float(s[..., :P].max()) + 1.0
    elif scores == "nan":
        s[..., 0:P:7] = float("nan")
        target = float(s[..., :P].nan_to_num(-1.0).max())  # the NaN groups never freeze
    T = max(steps, 1)
    draws = _random_draws(geom, L, kw, device, steps=T)
    if islands is not None:
        draws = fs.stack_draws([_random_draws(geom, L, kw, device, steps=T)
                                for _ in range(islands)])
    key = _hook_key(kw, True, dtype) if ablate else (
        ("expr_" if "objective" in kw or fs.is_expression(cross) or fs.is_expression(mut) else "")
        + "multigen" + ("_bf16" if dtype == torch.bfloat16 else ""))
    if islands is not None and not ablate:
        key = "islands_" + key
    for parity in range(geom.parities):
        seed = torch.randint(0, 2**62, lead or (1,), generator=gen, device=device)
        for mode in (dict(seed=seed), dict(draws=draws)):
            before = kernels.CLUSTER_LAUNCHES.get(key, 0)
            launched = kernels.LAUNCHES[key]
            got = fs.multigen_breed(g, s, geom, parity, steps, target, islands=islands, **mode,
                                    **kw)
            assert kernels.LAUNCHES[key] == launched + 1
            assert kernels.CLUSTER_LAUNCHES.get(key, 0) == before + cluster
            if cluster:
                old = fs.multigen_breed(g, s, geom, parity, steps, target, islands=islands,
                                        cluster=False, **mode, **kw)
                assert kernels.CLUSTER_LAUNCHES[key] == before + 1
            want = fs.multigen_breed_reference(
                g, s, geom, parity, steps, math.inf if target is None else target, **mode, **kw)
            torch.cuda.synchronize()
            if cluster:
                assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
            if exact or steps == 0:
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            elif steps == 1:
                assert int(_ulps(got[0].float(), want[0].float()).max()) <= 2
                torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5 * L)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", CLUSTER_VARIANTS, ids=_VARIANT_ID)
def test_multigen_cluster_schedule_equals_plain_on_card(cuda_device, variant):
    """The cluster schedule equals the plain version and the one-block
    schedule at the same inputs, Philox and injected draws, every parity:
    genomes and scores bit for bit (within 2 ulp / rtol 1e-5 of the plain
    version after a transcendental at one step). Each launch takes the
    cluster route, counted under CLUSTER_LAUNCHES; the one-block launches
    are not."""
    _multigen_against_plain(cuda_device, variant, cluster=True)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", EXPR_VARIANTS, ids=_VARIANT_ID)
def test_expr_multigen_schedules_equal_plain_on_card(cuda_device, variant):
    """The expression kernel (creep, one-point, NK, trap with point, swap
    and gaussian mutation, roll(g), knapsack; bf16, islands, freeze, NaN,
    0 and 1 steps, the harness's flags) takes the cluster schedule with the
    eight-lane child wherever its plan holds the group (the knapsack's
    L = 6 stays on one block), counted under CLUSTER_LAUNCHES, and equals
    the one-block schedule and the plain version bit for bit."""
    _multigen_against_plain(cuda_device, variant, cluster=None)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["genomes", "out"])
def test_multigen_cluster_rejects_misaligned_rows_on_card(cuda_device, which):
    """The cluster schedule stages genomes by TMA bulk copies and stores
    16-byte words: a contiguous view at an offset that is no multiple of
    16 bytes raises ValueError before any launch, and the context stays
    usable (the aligned rows then breed as the plain version does)."""
    geom = fs.resolve_geometry(40_000, 100, multigen=True)
    assert kernels.multigen_cluster_plan(geom, torch.float32)
    n = geom.Pp * 100
    a = torch.rand(n + 1, device=cuda_device)
    b = torch.empty(n + 1, device=cuda_device)
    g, out = a[:n].view(geom.Pp, 100), b[:n].view(geom.Pp, 100)
    if which == "genomes":
        g = a[1:].view(geom.Pp, 100)
    else:
        out = b[1:].view(geom.Pp, 100)
    assert g.is_contiguous() and out.is_contiguous()
    s = g.sum(dim=1)
    kw = dict(seed=torch.tensor([5], dtype=torch.int64, device=cuda_device),
              mparams=torch.tensor([0.3, 0.0], device=cuda_device), obj_id=onemax.fused_id)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fs.multigen_breed(g, s, geom, 0, 3, None, out=out, **kw)
    assert kernels.LAUNCHES["multigen"] == 0
    g, out = a[:n].view(geom.Pp, 100), b[:n].view(geom.Pp, 100)
    s = g.sum(dim=1)
    got = fs.multigen_breed(g, s, geom, 0, 3, None, out=out, **kw)
    assert kernels.CLUSTER_LAUNCHES == {"multigen": 1}
    want = fs.multigen_breed_reference(g, s, geom, 0, 3, math.inf, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_multigen_cluster_route_by_shape_on_card(cuda_device):
    """A group no cluster holds (16,384x300: 1,024 rows of 1,200 bytes a
    group) breeds on the one-block schedule, chosen before the launch; a
    cluster launch of that shape raises and runs nothing in its place."""
    geom = fs.resolve_geometry(16_384, 300, multigen=True)
    assert kernels.multigen_cluster_plan(geom, torch.float32) is None
    g = torch.rand((geom.Pp, 300), device=cuda_device)
    s = g.sum(dim=1)
    kw = dict(seed=torch.tensor([3], dtype=torch.int64, device=cuda_device),
              mparams=torch.tensor([0.3, 0.0], device=cuda_device), obj_id=onemax.fused_id)
    kernels.reset_launches()
    got = fs.multigen_breed(g, s, geom, 0, 3, None, **kw)
    want = fs.multigen_breed_reference(g, s, geom, 0, 3, math.inf, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.LAUNCHES["multigen"] == 1 and not kernels.CLUSTER_LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        fs.multigen_breed(g, s, geom, 0, 3, None, cluster=True, **kw)
    assert kernels.LAUNCHES["multigen"] == 1
    order = fs.resolve_geometry(40_000, 100, multigen=True, crossover="order")
    assert kernels.multigen_cluster_plan(order, torch.float32, "order") is None
