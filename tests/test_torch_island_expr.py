"""Islands with expression hooks (libpga_tpu_torch/ops/fused_step.py:
deme_breed / multigen_breed with ``islands`` and an expression crossover,
mutation or objective, make_island_breed / make_island_multigen, and
PGA.run_islands over them) on the CPU. On the card the same calls launch
the island axis (``blockIdx.y``) of csrc/expr_breed.cu's expr_breed_kernel,
expr_order_kernel and expr_multigen_kernel; on the CPU they run the plain
versions, which tests/test_torch_kernels_cuda.py and chip_smoke.py hold the
kernels against.

JAX's island path vmaps the Pallas breed over the islands
(libpga_tpu/parallel/islands.py: make_stacked_pallas_epoch,
make_multigen_stacked_epoch). Under jax 0.9.0 on the CPU that stacked epoch
fails in interpret mode: ``ValueError: safe_zip() argument 2 is shorter than
argument 1`` in ``interpret_pallas_call._get_randomized_grid_coordinates``
(the vmap adds a grid axis interpret mode does not cover). So the island form
is anchored on the port's single-population expression breeds, which
tests/test_torch_breed_expr.py, test_torch_multigen_expr.py and
test_torch_order_expr.py hold against JAX's interpret-mode kernels: an island
breed must equal I single-population breeds bit for bit, each with its
island's seed or its slice of the injected draws. Migration after an
expression epoch is held against JAX's ``_migrate_local`` on the same rows.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu_torch as port
from libpga_tpu.parallel import islands as jis
from libpga_tpu_torch import objectives as O
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels
from libpga_tpu_torch.ops.breed_expr import crossover_from_expression, mutate_from_expression
from libpga_tpu_torch.parallel import islands as pis

I = 3
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
TOUR = ("c = floor(g * L);"
        "x = gather(X, c); y = gather(Y, c);"
        "dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
        "-sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))")


def _creep():
    return mutate_from_expression(CREEP, rate=0.3, sigma=0.1)


def _tour(L):
    c = O.random_tsp_coords(L, seed=1)
    return O.from_expression(TOUR, X=c[:, 0], Y=c[:, 1])


def _tsp(L):
    return O.make_tsp_coords(O.random_tsp_coords(L, seed=2), duplicate_mode="genes")


# name -> (S, L, objective, breed keywords, layout): every hook set of the
# island path, in both row maps and padded.
HOOKS = {
    "creep": (1024, 16, lambda L: O.onemax, lambda: dict(mutate=_creep()), "pingpong"),
    "creep-riffle": (2100, 16, lambda L: O.onemax, lambda: dict(mutate=_creep()), "riffle"),
    "cross-expr": (1024, 16, lambda L: O.onemax, lambda: dict(crossover=crossover_from_expression(
        "where(r2 < 0.5, min(p1, p2), max(p1, p2)) * 0.5 + r * q")), "pingpong"),
    "nk-pingpong": (1024, 16, lambda L: O.make_nk_landscape(L, 3, seed=0),
                    lambda: dict(layout="pingpong"), "pingpong"),
    "nk-riffle": (1024, 16, lambda L: O.make_nk_landscape(L, 3, seed=0),
                  lambda: dict(layout="riffle"), "riffle"),
    "trap-padded": (600, 20, lambda L: O.make_deceptive_trap(5), dict, "pingpong"),
    "tour-swap": (512, 24, _tour, lambda: dict(crossover="order", mutate="swap"), "riffle"),
    "tsp-creep": (512, 24, _tsp, lambda: dict(crossover="order", mutate=_creep()), "riffle"),
}
MULTIGEN = ["creep", "cross-expr", "nk-pingpong", "nk-riffle", "trap-padded", "tour-swap"]
# Order crossover breeds float32 genes only, as in JAX: bf16 takes the rest.
ONE_GEN = [(n, torch.float32) for n in HOOKS] + [
    (n, torch.bfloat16) for n in HOOKS if "tour" not in n and "tsp" not in n]


def _islands(geom, obj, seed, dtype=torch.float32):
    """Uniform genomes (I, Pp, L) with zero pad rows (random keys for
    order crossover) and their scores (I, Pp) with -inf pad rows."""
    rng = np.random.default_rng(seed)
    P, Pp, L = geom.P, geom.Pp, geom.L
    g = torch.from_numpy(rng.random((I, Pp, L), dtype=np.float32)).to(dtype)
    g[:, P:] = 0.0
    s = torch.full((I, Pp), -torch.inf)
    s[:, :P] = obj(g[:, :P].float().reshape(-1, L)).view(I, P)
    return g, s


def _seeds(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2**62, I))


def _same(got, want):
    assert torch.equal(got[0], want[0])
    assert (got[1] is None and want[1] is None) or torch.equal(got[1], want[1])


def _island_draws(seeds, geom, kw, steps=None):
    """Injected draws with a leading island axis (and, for a
    multi-generation launch, a sub-generation axis after it): each
    island's Philox draws of another seed, expression streams included."""
    mutate, cross = kw.get("mutate", "point"), kw.get("crossover", "uniform")

    def one(i, t=0):
        return fs.philox_draws(seeds[i:i + 1] + 7, geom.G, geom.K, geom.L, mutate, cross,
                               sub_generation=t, tie=steps is not None)

    if steps is None:
        return fs.stack_draws([one(i) for i in range(I)])
    return fs.stack_draws([fs.stack_draws([one(i, t) for t in range(steps)]) for i in range(I)])


@pytest.mark.parametrize("name,dtype", ONE_GEN, ids=lambda v: str(v).replace("torch.", ""))
def test_island_breed_equals_single_breeds(name, dtype):
    """One generation: the island breed (one seed per island, or the
    island's slice of the injected draws) is I single-population breeds,
    children and scores bit for bit, in every parity."""
    S, L, make_obj, make_kw, layout = HOOKS[name]
    obj = make_obj(L)
    breed = fs.make_fused_breed(S, L, obj, device="cpu", gene_dtype=dtype, **make_kw())
    geom, kw = breed.geom, breed.kw
    assert geom.layout == layout
    assert fs._expression_hooked(kw)
    g, s = _islands(geom, obj, S + L, dtype)
    tie = torch.from_numpy(np.random.default_rng(1).integers(0, 2**31, (I, geom.Pp)))
    G = geom.G
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, tie)
        seeds = _seeds(parity)
        draws = _island_draws(seeds, geom, kw)
        got = fs.deme_breed(g, ranks, geom, parity, seed=seeds, islands=I, **kw)
        got_inj = fs.deme_breed(g, ranks, geom, parity, draws=draws, islands=I, **kw)
        assert got[0].dtype == dtype and got[1] is not None
        for i in range(I):
            r = ranks[i * G:(i + 1) * G]
            for res, want in (
                (got, fs.deme_breed(g[i], r, geom, parity, seed=seeds[i:i + 1], **kw)),
                (got_inj, fs.deme_breed(g[i], r, geom, parity, draws=draws.island(i), **kw)),
            ):
                _same((res[0][i], res[1][i]), want)
        assert not torch.equal(got[0][0], got[0][1])  # the islands draw apart
        assert bool(torch.isinf(got[1][:, geom.P:]).all())


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", MULTIGEN + ["trap-bf16"])
def test_island_multigen_equals_single_launches(name, steps):
    """Several generations per launch: the island launch is I single
    launches (Philox seeds and injected (I, T, ...) draws, expression
    planes included), with per-deme elites and a target that freezes
    some groups; a const-carrying objective (NK) scores the flattened
    (I*G, K) rows as each island's (G, K) rows."""
    dtype = torch.bfloat16 if name == "trap-bf16" else torch.float32
    S, L, make_obj, make_kw, layout = HOOKS["trap-padded" if name == "trap-bf16" else name]
    obj = make_obj(L)
    elitism = 1
    launch = fs.make_fused_multigen(S, L, obj, device="cpu", elitism=elitism, gene_dtype=dtype,
                                    **make_kw())
    geom, kw = launch.geom, launch.kw
    assert fs._expression_hooked(kw)
    g, s = _islands(geom, obj, S + steps, dtype)
    target = float(torch.quantile(s[:, :S].amax(dim=1), 0.5)) + 1e-3
    seeds = _seeds(steps + 10)
    draws = _island_draws(seeds, geom, kw, steps=steps)
    for parity in range(geom.parities):
        got = fs.multigen_breed(g, s, geom, parity, steps, target, seed=seeds, islands=I, **kw)
        got_inj = fs.multigen_breed(g, s, geom, parity, steps, target, draws=draws, islands=I,
                                    **kw)
        assert got[0].dtype == dtype
        for i in range(I):
            for res, want in (
                (got, fs.multigen_breed(g[i], s[i], geom, parity, steps, target,
                                        seed=seeds[i:i + 1], **kw)),
                (got_inj, fs.multigen_breed(g[i], s[i], geom, parity, steps, target,
                                            draws=draws.island(i), **kw)),
            ):
                _same((res[0][i], res[1][i]), want)


@pytest.mark.parametrize("name", ["creep", "nk-riffle", "tour-swap"])
def test_one_island_equals_the_single_breed(name):
    S, L, make_obj, make_kw, _ = HOOKS[name]
    obj = make_obj(L)
    breed = fs.make_fused_breed(S, L, obj, device="cpu", **make_kw())
    geom, kw = breed.geom, breed.kw
    g, s = _islands(geom, obj, 5)
    tie = torch.from_numpy(np.random.default_rng(2).integers(0, 2**31, (1, geom.Pp)))
    ranks = fs.compute_ranks(s[:1], geom, 0, tie)
    seed = _seeds(3)[:1]
    got = fs.deme_breed(g[:1], ranks, geom, 0, seed=seed, islands=1, **kw)
    _same((got[0][0], got[1][0]), fs.deme_breed(g[0], ranks, geom, 0, seed=seed, **kw))
    mg = fs.make_fused_multigen(S, L, obj, device="cpu", **make_kw())
    got = fs.multigen_breed(g[:1], s[:1], mg.geom, 0, 2, None, seed=seed, islands=1, **mg.kw)
    _same((got[0][0], got[1][0]),
          fs.multigen_breed(g[0], s[0], mg.geom, 0, 2, None, seed=seed, **mg.kw))


def test_island_breeds_with_a_hook_make_one_launch_per_call():
    """make_island_breed / make_island_multigen with an expression hook
    have no per-island loop: one breed call is one launch for every
    island, and its islands are the single breeds of the island seeds
    the generator draws."""
    S, L = 1024, 16
    for T in (None, 3):
        if T is None:
            breed = fs.make_island_breed(S, L, O.onemax, I, device="cpu", mutate=_creep())
        else:
            breed = fs.make_island_multigen(S, L, O.onemax, I, T, device="cpu", mutate=_creep())
        geom = breed.geom
        g, s = _islands(geom, O.onemax, 9)
        gen = torch.Generator().manual_seed(4)
        for n in (1, 2):
            if T is None:
                g2, s2 = breed(g, s, 0, gen)
            else:
                g2, s2 = breed(g, s, 0, T, math.inf, gen)
            assert breed.launches == n and g2.shape == g.shape and s2.shape == s.shape
        torch.testing.assert_close(s2[:, :S], g2[:, :S].sum(dim=2), rtol=1e-5, atol=1e-4)


def _solver(I_, S, L, seed=0, **config):
    p = port.pga_init(seed, port.PGAConfig(device="cpu", **config))
    for _ in range(I_):
        port.pga_create_population(p, S, L)
    return p


@pytest.mark.parametrize("T", [None, 3])
def test_run_islands_with_a_hook_counts_launches_and_stops_at_a_target(T):
    """run_islands with an expression objective and the creep expression:
    one launch per generation (T = 1) or ceil(m / T) per epoch plus the
    remainder's; no kernel launches on the CPU; the best rises; a target
    run stops at an epoch boundary, an epoch earlier the best was below
    it."""
    before = dict(kernels.LAUNCHES)
    obj = O.from_expression("sum(g * g)")
    p = _solver(I, 512, 20, generations_per_launch=T)
    p.set_objective(obj)
    p.set_mutate(_creep())
    start = max(float(obj(pop.genomes).max()) for pop in p._populations)
    assert p.run_islands(11, 4, 0.05) == 11
    want = 11 if T is None else 2 * math.ceil(4 / T) + math.ceil(3 / T)
    assert p.launches == want and kernels.LAUNCHES == before
    assert max(p.get_best_with_score(h)[1] for h in p._handles()) > start
    for pop in p._populations:
        torch.testing.assert_close(pop.scores, obj(pop.genomes), rtol=1e-5, atol=1e-4)

    m, target = 2, start + 1.0
    q = _solver(I, 512, 20, seed=3, generations_per_launch=T)
    q.set_objective(obj)
    q.set_mutate(_creep())
    gens = q.run_islands(1000, m, 0.05, target=target)
    assert 0 < gens < 1000 and gens % m == 0
    assert max(q.get_best_with_score(h)[1] for h in q._handles()) >= target
    r = _solver(I, 512, 20, seed=3, generations_per_launch=T)
    r.set_objective(obj)
    r.set_mutate(_creep())
    assert r.run_islands(gens - m, m, 0.05, target=target) == gens - m
    assert max(r.get_best_with_score(h)[1] for h in r._handles()) < target


def test_expression_epoch_migrates_jax_rows():
    """An epoch of expression islands (NK, creep) and its ring migration
    through the runner: the migration picks JAX's ``_migrate_local`` rows
    on the epoch's islands."""
    S, L, m = 1024, 16, 2
    nk = O.make_nk_landscape(L, 3, seed=0)
    breed = fs.make_island_breed(S, L, nk, I, device="cpu", mutate=_creep())
    count = int(S * 0.05)
    genomes = torch.from_numpy(np.random.default_rng(6).random((I, S, L), dtype=np.float32))
    runner = pis.build_local_runner(breed, nk, m=m, count=count, topology="ring")
    got_g, got_s, done = runner(genomes, torch.Generator().manual_seed(8), 1)
    assert done == 1 and breed.launches == m
    epoch = pis.make_stacked_deme_epoch(breed, m)
    g, s = epoch(genomes, pis.evaluate_islands(nk, genomes), torch.Generator().manual_seed(8))
    want_g, want_s = jis._migrate_local(jnp.asarray(g.numpy()), jnp.asarray(s.numpy()),
                                        jax.random.key(0), count, "ring")
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert not np.array_equal(np.asarray(want_g), g.numpy())  # rows moved
