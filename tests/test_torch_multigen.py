"""Parity of the port's multi-generation breed (libpga_tpu_torch/ops/
fused_step.py: ``resolve_geometry(multigen=True)``, ``kernel_ranks``,
``multigen_breed_reference``, ``make_multigen_run``; csrc/deme_breed.cu's
``multigen_breed_kernel`` computes the same function) with the JAX
package's (libpga_tpu/ops/pallas_step.py: ``make_pallas_multigen``,
``_kernel_ranks``, ``_multigen_kernel``, ``_multigen_run_loop``).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays. The JAX kernel runs as the JAX package's own tests run it
on the CPU, under ``force_tpu_interpret_mode``, whose PRNG bits are all
zero; the port takes all-zero draws through its injected mode. With zero
draws every child copies its deme's rank-0 row (elites: ranks 0..e-1),
score ties break by the row's index, and point mutation sets gene 0 to
0.0, so the comparison pins ranks, row maps, padding, the freeze, the
elites and the step count.

Tolerances: JAX gathers parents with a bf16 hi/lo one-hot matmul, so its
genes are within 1e-5 of the port's exact gather after every
sub-generation, and its fused score (a sum over L genes) within L * 1e-5.
Geometry, ranks, row maps and generation counts are exact.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu.objectives as jax_objectives
from libpga_tpu.ops import pallas_step as ps
import libpga_tpu_torch as port
import libpga_tpu_torch.objectives as objectives
from libpga_tpu_torch import interop
from libpga_tpu_torch.objectives.classic import ROWWISE_FUSED
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels
from libpga_tpu_torch.ops.crossover import order_preserving_crossover
from libpga_tpu_torch.ops.mutate import make_swap_mutate

GENE_ATOL = 1e-5
MPARAMS = torch.tensor([0.01, 0.0])


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _jax_multigen(P, L, name="onemax", **kw):
    obj = jax_objectives.get(name)
    with _interpret():
        return ps.make_pallas_multigen(
            P, L, fused_obj=obj.kernel_rowwise,
            fused_consts=tuple(getattr(obj, "kernel_rowwise_consts", ())), **kw
        )


def _population(P, L, Pp, seed):
    """Uniform genomes with zero pad rows and their onemax scores, -inf
    on pad rows, as numpy."""
    rng = np.random.default_rng(seed)
    g = np.zeros((Pp, L), np.float32)
    g[:P] = rng.random((P, L), dtype=np.float32)
    s = g.sum(axis=1)
    s[P:] = -np.inf
    return g, s


def _both(P, L, steps, *, K=128, parity=0, target=None, elitism=0, layout=None,
          dps=None, name="onemax", scores=None, seed=0):
    """One launch in both packages on the same population, zero draws.
    Returns (geometry, inputs, JAX outputs, port outputs), each outputs
    pair (genomes (Pp, L), scores (Pp,)) as numpy."""
    bm = _jax_multigen(P, L, name, deme_size=K, elitism=elitism, _layout=layout,
                       _demes_per_step=dps)
    geom = fs.resolve_geometry(P, L, deme_size=K, multigen=True, elitism=elitism,
                               layout=layout, demes_per_step=dps)
    assert (bm.layout, bm.K, bm.D, bm.Pp) == (geom.layout, geom.K, geom.D, geom.Pp)
    g, s = _population(P, L, geom.Pp, seed)
    if scores is not None:
        s = scores(geom.Pp).astype(np.float32)
        s[P:] = -np.inf
    with _interpret():
        gj, sj = bm.padded(
            jnp.asarray(np.pad(g, ((0, 0), (0, bm.Lp - L)))), jnp.asarray(s),
            jax.random.key(0), steps, None, target, parity,
        )
    got = fs.multigen_breed(
        torch.from_numpy(g), torch.from_numpy(s), geom, parity, steps, target,
        draws=fs.zero_draws(geom.G, geom.K, L, steps=max(steps, 1)),
        mparams=MPARAMS, obj_id=objectives.get(name).fused_id, elitism=elitism,
    )
    return geom, (g, s), (np.asarray(gj)[:, :L], np.asarray(sj)), (got[0].numpy(), got[1].numpy())


def _assert_same(geom, jax_out, port_out, rows=None):
    P, L = geom.P, geom.L
    rows = slice(0, P) if rows is None else rows
    np.testing.assert_allclose(port_out[0][rows], jax_out[0][rows], rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(port_out[1][:P], jax_out[1][:P], rtol=0, atol=L * 1e-5)
    assert np.isneginf(port_out[1][P:]).all() and np.isneginf(jax_out[1][P:]).all()


# ---------------------------------------------------------------- geometry

GEOMETRY_SHAPES = [
    (1 << 20, 100), (40_000, 100), (524_288, 100), (65_536, 100), (1000, 100),
    (8192, 100), (1000, 20), (300, 33), (2100, 100), (512, 16), (4096, 1000),
    (40_000, 300),
]


@pytest.mark.parametrize("elitism", [0, 2])
@pytest.mark.parametrize("P,L", GEOMETRY_SHAPES)
def test_multigen_geometry_matches_make_pallas_multigen(P, L, elitism):
    bm = _jax_multigen(P, L, elitism=elitism)
    geom = fs.resolve_geometry(P, L, multigen=True, elitism=elitism)
    assert (bm.layout, bm.K, bm.D, bm.Pp, bm.parities, bm.grid_steps) == (
        geom.layout, geom.K, geom.D, geom.Pp, geom.parities, geom.S
    )


def test_multigen_geometry_of_the_main_shapes():
    """The table the kernel's launch shapes follow from: the multigen
    geometry differs from the one-generation one (1,048,576x100 breeds
    ping-pong D=8 there)."""
    got = {
        P: (g.layout, g.K, g.G, g.D, g.Pp)
        for P in (1 << 20, 40_000, 524_288, 65_536, 1000)
        for g in [fs.resolve_geometry(P, 100, multigen=True)]
    }
    assert got == {
        1 << 20: ("riffle", 512, 2048, 4, 1 << 20),
        40_000: ("riffle", 256, 157, 1, 40_192),
        524_288: ("pingpong", 512, 1024, 4, 524_288),
        65_536: ("pingpong", 512, 128, 4, 65_536),
        1000: ("pingpong", 512, 2, 2, 1024),
    }
    one_gen = fs.resolve_geometry(1 << 20, 100)
    assert (one_gen.layout, one_gen.D) == ("pingpong", 8)


@pytest.mark.parametrize("K,layout,dps", [
    (128, None, None), (128, "riffle", None), (128, "pingpong", None),
    (128, None, 2), (128, "pingpong", 2), (256, None, 1), (None, "riffle", 2),
])
@pytest.mark.parametrize("P,L", [(1024, 12), (1000, 12), (512, 20), (300, 33)])
def test_multigen_geometry_with_knobs(P, L, K, layout, dps):
    kw = dict(deme_size=K, _layout=layout, _demes_per_step=dps)
    pkw = dict(deme_size=K, layout=layout, demes_per_step=dps, multigen=True)
    try:
        bm = _jax_multigen(P, L, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="pingpong"):
            fs.resolve_geometry(P, L, **pkw)
        assert "pingpong" in str(e)
        return
    geom = fs.resolve_geometry(P, L, **pkw)
    if bm is None:
        assert geom is None
    else:
        assert (bm.layout, bm.K, bm.D, bm.Pp) == (geom.layout, geom.K, geom.D, geom.Pp)


def test_multigen_declines_where_jax_declines():
    # no rowwise fused objective
    assert ps.make_pallas_multigen(512, 16, fused_obj=None) is None
    unfused = lambda m: -torch.sum((m - 0.25) ** 2, dim=1)  # noqa: E731
    assert fs.make_fused_multigen(512, 16, unfused, device="cpu") is None
    # per-deme elites would fill the deme: elitism >= K // 4
    for e, declined in ((31, False), (32, True), (40, True)):
        bm = _jax_multigen(512, 16, deme_size=128, elitism=e)
        geom = fs.resolve_geometry(512, 16, deme_size=128, multigen=True, elitism=e)
        assert (bm is None) == (geom is None) == declined
        launch = fs.make_fused_multigen(
            512, 16, objectives.onemax, deme_size=128, elitism=e, device="cpu")
        assert (launch is None) == declined
    # under 128 rows, and a tournament outside 1..16
    assert _jax_multigen(100, 8) is None
    assert fs.resolve_geometry(100, 8, multigen=True) is None
    assert _jax_multigen(512, 8, tournament_size=17) is None
    assert fs.resolve_geometry(512, 8, multigen=True, tournament_size=17) is None


def test_padded_elitism_resolves_to_riffle():
    """A pad row can take a parity-1 cohort's elite slot, so per-deme
    elitism on a padded population stays on the riffle; an explicit
    ping-pong request raises in both packages."""
    bm = _jax_multigen(1000, 12, deme_size=128, elitism=2, _demes_per_step=2)
    geom = fs.resolve_geometry(1000, 12, deme_size=128, multigen=True, elitism=2,
                               demes_per_step=2)
    assert bm.layout == geom.layout == "riffle" and geom.D == bm.D == 2
    assert fs.resolve_geometry(1000, 12, deme_size=128, multigen=True,
                               demes_per_step=2).layout == "pingpong"
    with pytest.raises(ValueError, match="padded"):
        _jax_multigen(1000, 12, deme_size=128, elitism=2, _layout="pingpong")
    with pytest.raises(ValueError, match="padded"):
        fs.resolve_geometry(1000, 12, deme_size=128, multigen=True, elitism=2,
                            layout="pingpong")


def test_multigen_blocks_fit_equals_jax():
    for K in (128, 256, 512, 1024):
        for D in (1, 2, 4, 8, 16):
            for Lp in (128, 384, 1024):
                for extra in (0, 3_000_000):
                    assert fs._multigen_blocks_fit(K, D, Lp, 4, extra) == \
                        ps._multigen_blocks_fit(K, D, Lp, 4, extra)


# ------------------------------------------------------------ in-kernel ranks


def _jax_ranks(s, tie, v, K, padded, alive=None):
    """``_kernel_ranks`` outside a kernel: jitted, because ``pltpu.bitcast``
    has a lowering but no eager rule."""
    fn = jax.jit(lambda s, t, v, a: ps._kernel_ranks(s, t, v, K, padded=padded, alive=a))
    return np.asarray(fn(jnp.asarray(s), jnp.asarray(tie.astype(np.uint32)), v,
                         None if alive is None else jnp.asarray(alive.astype(np.float32))))


def _rank_inputs(seed, K, N=3):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 6, (N, K)).astype(np.float32)  # many ties
    s[0, 5] = np.nan
    s[1, 7] = -np.inf
    s[2, 3] = np.inf
    s[1, 11] = -0.0
    tie = rng.integers(0, 2**32, (N, K), dtype=np.uint64)
    tie[:, ::4] = tie[:, 1::4]  # equal words: only the lane index orders them
    return s, tie


@pytest.mark.parametrize("K,V", [(128, 128), (128, 77), (256, 1), (256, 200)])
def test_kernel_ranks_equals_jax_positional_tail(K, V):
    s, tie = _rank_inputs(K + V, K)
    alive = np.broadcast_to(np.arange(K) < V, s.shape)
    got = fs.kernel_ranks(torch.from_numpy(s), torch.from_numpy(tie.astype(np.int64)),
                          torch.from_numpy(alive.copy()))
    for n in range(s.shape[0]):
        want = _jax_ranks(s[n : n + 1], tie[n : n + 1], jnp.int32(V), K, V < K)
        np.testing.assert_array_equal(got[n].numpy(), want[0].astype(np.int32))
    g = got.numpy()
    assert (np.sort(g, axis=1) == np.arange(K)).all()  # a permutation: the order is strict
    assert (g[:, V:] >= V).all() and (g[:, :V] < V).all()


@pytest.mark.parametrize("K", [128, 256])
def test_kernel_ranks_equals_jax_alive_mask(K):
    s, tie = _rank_inputs(K, K)
    alive = np.random.default_rng(K).random(s.shape) < 0.8
    got = fs.kernel_ranks(torch.from_numpy(s), torch.from_numpy(tie.astype(np.int64)),
                          torch.from_numpy(alive))
    for n in range(s.shape[0]):
        want = _jax_ranks(s[n : n + 1], tie[n : n + 1], None, K, True, alive[n : n + 1])
        np.testing.assert_array_equal(got[n].numpy(), want[0].astype(np.int32))
        V = int(alive[n].sum())
        assert (got[n].numpy()[alive[n]] < V).all() and (got[n].numpy()[~alive[n]] >= V).all()


def test_kernel_ranks_equals_a_compare_cube():
    """rank[j] = the number of rows strictly before row j."""
    s, tie = _rank_inputs(9, 128)
    alive = np.ones(s.shape, bool)
    alive[:, 100:] = False
    got = fs.kernel_ranks(torch.from_numpy(s), torch.from_numpy(tie.astype(np.int64)),
                          torch.from_numpy(alive)).numpy()
    lane = np.arange(128)
    sc = np.where(np.isnan(s) | ~alive, -np.inf, s)
    t = np.where(alive, ((tie >> 2) & ~np.uint64(1023)) | lane.astype(np.uint64),
                 np.uint64(0x7FFFFC00) | lane.astype(np.uint64)).astype(np.int64)
    better = (sc[:, :, None] > sc[:, None, :]) | (
        (sc[:, :, None] == sc[:, None, :]) & (t[:, :, None] < t[:, None, :]))
    np.testing.assert_array_equal(got, better.sum(axis=1))


# ------------------------------------------------- whole launch, zero draws


@pytest.mark.parametrize("layout,parity", [("riffle", 0), ("pingpong", 0), ("pingpong", 1)])
def test_zero_steps_is_the_write_permutation(layout, parity):
    geom, (g, s), jax_out, port_out = _both(512, 20, 0, layout=layout, parity=parity)
    read, write = (m.reshape(-1).numpy() for m in geom.row_maps(parity, "cpu"))
    np.testing.assert_array_equal(port_out[0][write], g[read])
    np.testing.assert_array_equal(port_out[1][write], s[read])
    np.testing.assert_array_equal(port_out[0], jax_out[0])
    np.testing.assert_allclose(port_out[1], jax_out[1], rtol=1e-6)


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("layout,parity,dps", [
    ("riffle", 0, None), ("riffle", 0, 2), ("pingpong", 0, 2), ("pingpong", 1, 2),
])
def test_launch_equals_jax(steps, layout, parity, dps):
    geom, _, jax_out, port_out = _both(1024, 12, steps, layout=layout, parity=parity, dps=dps)
    assert geom.layout == layout and (dps is None or geom.D == dps)
    _assert_same(geom, jax_out, port_out)
    assert (port_out[0][:, 0] == 0.0).all()  # point mutation of gene 0
    np.testing.assert_array_equal(
        port_out[1], fs.rowwise_scores(1, torch.from_numpy(port_out[0]), True).numpy())


@pytest.mark.parametrize("layout", ["riffle", None])
@pytest.mark.parametrize("steps", [1, 3])
def test_launch_padded_300x33_equals_jax(steps, layout):
    """300 rows pad to 384: the riffle's tail deme holds 44 real rows
    (a positional tail); left to itself the shape resolves to ping-pong
    with D = 1."""
    geom, _, jax_out, port_out = _both(300, 33, steps, layout=layout)
    assert (geom.layout, geom.Pp, geom.G) == (layout or "pingpong", 384, 3)
    _assert_same(geom, jax_out, port_out)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("steps", [1, 3])
def test_launch_padded_pingpong_alive_mask_equals_jax(steps, parity):
    """Pad rows scatter through the parity-1 cohorts: the alive mask, not
    a positional tail, keeps them out of ranks and of the freeze."""
    geom, _, jax_out, port_out = _both(1000, 12, steps, parity=parity, dps=2)
    assert (geom.layout, geom.Pp, geom.D) == ("pingpong", 1024, 2)
    _assert_same(geom, jax_out, port_out)
    assert np.isfinite(port_out[1][:1000]).all()


@pytest.mark.parametrize("parity", [0, 1])
def test_frozen_padded_pingpong_moves_rows_as_jax_does(parity):
    """Reference behaviour, held as it is: a frozen (or zero-step)
    padded ping-pong group writes every slot through the interleave, so
    a pad slot's -inf lands on a real row and a real slot written to a
    row >= P is masked to -inf, in both packages."""
    geom, (g, s), jax_out, port_out = _both(1000, 12, 0, parity=parity, dps=2)
    np.testing.assert_array_equal(port_out[0], jax_out[0])
    np.testing.assert_array_equal(np.isneginf(port_out[1]), np.isneginf(jax_out[1]))
    assert np.isneginf(port_out[1][:1000]).sum() == 24 - (port_out[0][1000:] == 0).all(axis=1).sum()


def test_pad_scores_never_freeze_a_group():
    """A stale finite score on a dead slot must not reach the target."""
    P, L, K = 300, 33, 128
    geom = fs.resolve_geometry(P, L, deme_size=K, multigen=True)
    g, s = _population(P, L, geom.Pp, 3)
    s[P:] = 1e9  # what a caller must not pass, and the freeze must ignore
    out = fs.multigen_breed(
        torch.from_numpy(g), torch.from_numpy(s), geom, 0, 1, 100.0,
        draws=fs.zero_draws(geom.G, K, L, steps=1), mparams=MPARAMS, obj_id=1)
    write = geom.row_maps(0, "cpu")[1].numpy()
    assert (out[0].numpy()[write[2]][:, 0] == 0.0).all()  # the tail deme bred


@pytest.mark.parametrize("layout,parity", [("riffle", 0), ("pingpong", 1)])
def test_target_freezes_one_group_and_not_the_other(layout, parity):
    """A frozen group comes back unchanged up to the row permutation,
    whatever the step count, while the other group breeds on."""
    P, L, K, D = 1024, 12, 128, 2
    geom0 = fs.resolve_geometry(P, L, deme_size=K, multigen=True, layout=layout,
                                demes_per_step=D)
    read = geom0.row_maps(parity, "cpu")[0].numpy()  # (G, K)
    hot = read[2 * D, 5]  # a row of group 2

    def scores(Pp):
        s = np.random.default_rng(1).random(Pp).astype(np.float32)
        s[hot] = 50.0
        return s

    geom, (g, s), jax_out, port_out = _both(
        P, L, 3, layout=layout, parity=parity, dps=D, target=40.0, scores=scores)
    _assert_same(geom, jax_out, port_out)
    read, write = (m.numpy() for m in geom.row_maps(parity, "cpu"))
    frozen = slice(2 * D, 3 * D)
    np.testing.assert_array_equal(port_out[0][write[frozen]], g[read[frozen]])
    np.testing.assert_array_equal(port_out[1][write[frozen]], s[read[frozen]])
    assert port_out[1].max() == 50.0
    others = np.delete(np.arange(geom.G), np.arange(2 * D, 3 * D))
    assert (port_out[0][write[others]][..., 0] == 0.0).all()  # they bred


@pytest.mark.parametrize("steps", [1, 3])
def test_per_deme_elitism_keeps_the_global_top(steps):
    e = 2
    geom, (g, s), jax_out, port_out = _both(512, 20, steps, elitism=e, layout="riffle", seed=4)
    _assert_same(geom, jax_out, port_out)
    # each global top-j row (j <= e) is within the top-e of its own deme
    assert (np.sort(port_out[1])[-e:] >= np.sort(s)[-e:]).all()
    best = g[np.argmax(s)]
    assert (port_out[0] == best).all(axis=1).any()  # verbatim, unmutated


def test_nan_scores_rank_last_and_do_not_freeze():
    P, L, K = 512, 12, 128

    def scores(Pp):
        s = np.random.default_rng(2).random(Pp).astype(np.float32)
        s[::7] = np.nan
        return s

    geom, _, jax_out, port_out = _both(P, L, 2, layout="riffle", target=0.5, scores=scores)
    _assert_same(geom, jax_out, port_out)


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "ackley", "onemax_bits"])
def test_launch_with_other_fused_objectives_equals_jax(name):
    geom, _, jax_out, port_out = _both(512, 20, 2, layout="riffle", name=name, seed=6)
    np.testing.assert_allclose(port_out[0], jax_out[0], rtol=0, atol=GENE_ATOL)
    # the objectives' slopes: a gene error of 1e-5 moves a term by up to
    # ~2e-3 (ackley's box is 65.5 wide), so compare relatively
    np.testing.assert_allclose(port_out[1], jax_out[1], rtol=2e-4, atol=20 * 1e-5)


# ------------------------------ against the port's own one-generation breed


@pytest.mark.parametrize("P,L,layout,parity,mutate", [
    (1024, 33, "pingpong", 0, "point"), (1024, 33, "pingpong", 1, "swap"),
    (1000, 20, "riffle", 0, "gaussian"), (300, 33, None, 0, "point"),
])
def test_one_step_equals_the_one_generation_plain_breed(P, L, layout, parity, mutate):
    """steps = 1 with the same ranks and draws breeds the same children."""
    geom = fs.resolve_geometry(P, L, deme_size=128, multigen=True, layout=layout)
    gen = torch.Generator().manual_seed(P + L)
    G, K = geom.G, geom.K
    g = torch.rand((geom.Pp, L), generator=gen)
    s = torch.rand(geom.Pp, generator=gen)
    s[P:] = -torch.inf
    draws = fs.Draws(
        sel_u=torch.rand((1, G, K, 2), generator=gen),
        cross=(torch.rand((1, G, K, L), generator=gen) < 0.5).to(torch.uint8),
        mut_u=torch.rand((1, G, K, 4), generator=gen),
        gauss=torch.rand((1, 3, G, K, L), generator=gen) if mutate == "gaussian" else None,
        tie=torch.randint(0, 2**32, (1, G, K), generator=gen),
    )
    kw = dict(tournament_size=3, selection="linear_rank", selection_param=1.7,
              mutate=mutate, mparams=torch.tensor([0.3, 0.05]), obj_id=1)
    got = fs.multigen_breed(g, s, geom, parity, 1, draws=draws, **kw)
    read, _ = geom.row_maps(parity, "cpu")
    ranks = fs.kernel_ranks(s[read], draws.tie[0], read < P)
    want = fs.deme_breed_reference(g, ranks, geom, parity, draws.at(0), **kw)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-4)


def test_injected_sub_generations_are_consumed_in_order():
    """Two steps equal one step twice through the cohort order."""
    P, L = 512, 16
    geom = fs.resolve_geometry(P, L, deme_size=128, multigen=True, layout="riffle")
    gen = torch.Generator().manual_seed(7)
    G, K = geom.G, geom.K
    g, s = torch.rand((P, L), generator=gen), torch.rand(P, generator=gen)
    draws = fs.Draws(
        sel_u=torch.rand((2, G, K, 2), generator=gen),
        cross=(torch.rand((2, G, K, L), generator=gen) < 0.5).to(torch.uint8),
        mut_u=torch.rand((2, G, K, 4), generator=gen),
        tie=torch.randint(0, 2**32, (2, G, K), generator=gen),
    )
    kw = dict(mparams=torch.tensor([0.3, 0.0]), obj_id=1)
    two = fs.multigen_breed(g, s, geom, 0, 2, draws=draws, **kw)
    read, write = (m.reshape(-1) for m in geom.row_maps(0, "cpu"))
    one = fs.multigen_breed(g, s, geom, 0, 1, draws=draws, **kw)
    # undo the riffle: put the children back in cohort order
    g1, s1 = torch.empty_like(g), torch.empty_like(s)
    g1[read], s1[read] = one[0][write], one[1][write]
    second = fs.Draws(*(None if x is None else x[1:] for x in (
        draws.sel_u, draws.cross, draws.mut_u, draws.gauss, draws.fill, draws.tie)))
    again = fs.multigen_breed(g1, s1, geom, 0, 1, draws=second, **kw)
    assert torch.equal(two[0], again[0]) and torch.equal(two[1], again[1])


# ------------------------------------------------------- scores and Philox


def _warp_sum_numpy(x):
    L = x.shape[-1]
    x = np.pad(x, ((0, 0), (0, -L % 32))).reshape(x.shape[0], -1, 32)
    v = np.zeros((x.shape[0], 32), np.float32)
    for j in range(x.shape[1]):
        v = (v + x[:, j]).astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[:, np.arange(32) ^ o]).astype(np.float32)
    assert (v == v[:, :1]).all()  # every lane ends on the same sum
    return v[:, 0]


@pytest.mark.parametrize("L", [12, 32, 100, 130])
def test_warp_order_sum_is_the_kernels_order(L):
    x = np.random.default_rng(L).random((64, L), dtype=np.float32)
    got = fs.rowwise_scores(1, torch.from_numpy(x), warp_order=True).numpy()
    np.testing.assert_array_equal(got, _warp_sum_numpy(x))
    np.testing.assert_allclose(got, x.sum(axis=1), rtol=1e-6)
    bits = fs.rowwise_scores(2, torch.from_numpy(x), warp_order=True).numpy()
    np.testing.assert_array_equal(bits, (x >= 0.5).sum(axis=1))  # exact in any order


@pytest.mark.parametrize("warp_order", [False, True])
@pytest.mark.parametrize("name", ["onemax", "onemax_bits", "sphere", "rastrigin", "ackley"])
def test_fused_scores_equal_jax_kernel_rowwise(name, warp_order):
    """Fault 1: every builtin with a ``kernel_rowwise`` form in JAX has a
    fused id here, and the score the kernels compute for it equals JAX's
    rowwise form within rtol 1e-5 (sums in another order, cos/exp/sqrt
    of another library)."""
    m = np.random.default_rng(5).random((64, 100), dtype=np.float32)
    want = np.asarray(jax_objectives.get(name).kernel_rowwise(jnp.asarray(m)))
    obj = objectives.get(name)
    assert obj.fused_id in ROWWISE_FUSED
    got = fs.rowwise_scores(obj.fused_id, torch.from_numpy(m), warp_order).numpy()
    if not warp_order:
        np.testing.assert_array_equal(got, fs.fused_scores(obj.fused_id, torch.from_numpy(m)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, obj(torch.from_numpy(m)).numpy(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("P,L", [(65_536, 100), (1 << 20, 100), (40_000, 100), (1000, 30),
                                 (8192, 30)])
@pytest.mark.parametrize("name", ["sphere", "rastrigin", "ackley"])
def test_fused_builtins_resolve_jax_geometry(name, P, L):
    """Fault 1: ``make_fused_breed`` resolves sphere, rastrigin and
    ackley as fused, so they breed the cohorts JAX's ``kernel_plan(
    fused=True)`` gives (65,536x100: ping-pong, not the riffle)."""
    plan = ps.kernel_plan(P, L, fused=True)
    breed = fs.make_fused_breed(P, L, objectives.get(name), device="cpu")
    geom = breed.geom
    assert (plan["layout"], plan["deme_size"], plan["demes_per_step"], plan["Pp"]) == (
        geom.layout, geom.K, geom.D, geom.Pp)
    assert fs.make_fused_multigen(P, L, objectives.get(name), device="cpu") is not None


def test_one_generation_breed_scores_fused_builtins():
    P, L = 512, 20
    breed = fs.make_fused_breed(P, L, objectives.rastrigin, device="cpu")
    gen = torch.Generator().manual_seed(0)
    g = torch.rand((P, L), generator=gen)
    g2, s2 = breed(g, objectives.rastrigin(g), 0, gen)
    torch.testing.assert_close(s2, objectives.rastrigin(g2), rtol=1e-5, atol=0)


def test_philox_sub_generation_zero_is_the_one_generation_stream():
    seed = torch.tensor([0x1234_5678_9ABC_DEF0 >> 1])
    G, K, L = 3, 128, 150
    for mutate in ("point", "gaussian"):
        base = fs.philox_draws(seed, G, K, L, mutate)
        zero = fs.philox_draws(seed, G, K, L, mutate, sub_generation=0, tie=True)
        one = fs.philox_draws(seed, G, K, L, mutate, sub_generation=1, tie=True)
        assert base.tie is None
        for name in ("sel_u", "cross", "mut_u", "gauss"):
            a, b, c = getattr(base, name), getattr(zero, name), getattr(one, name)
            if a is None:
                assert b is None and c is None
                continue
            assert torch.equal(a, b) and not torch.equal(a, c)
    k = torch.arange(K)[None, :].expand(G, K)
    g = torch.arange(G)[:, None].expand(G, K)
    z = torch.zeros((), dtype=torch.int64)
    assert torch.equal(one.tie, fs.philox4x32(seed, k, g, z + 0x60000000, z + 1)[0])
    assert 0 <= int(one.tie.min()) and int(one.tie.max()) < 2**32
    assert not torch.equal(one.tie, zero.tie)


def test_philox_launch_is_reproducible_and_frozen_groups_keep_the_stream():
    """The counter carries the sub-generation, so a group's draws at
    step t do not depend on whether another step was frozen."""
    P, L = 512, 16
    geom = fs.resolve_geometry(P, L, deme_size=128, multigen=True, layout="riffle",
                               demes_per_step=1)
    gen = torch.Generator().manual_seed(1)
    g, s = torch.rand((P, L), generator=gen), torch.rand(P, generator=gen)
    seed = torch.tensor([99])
    kw = dict(mparams=MPARAMS, obj_id=1, seed=seed)
    a = fs.multigen_breed(g, s, geom, 0, 3, **kw)
    b = fs.multigen_breed(g, s, geom, 0, 3, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    s_hot = s.clone()
    s_hot[5] = 100.0  # group 0 frozen from the start
    c = fs.multigen_breed(g, s_hot, geom, 0, 3, 50.0, **kw)
    write = geom.row_maps(0, "cpu")[1]
    assert torch.equal(c[0][write[1:]], a[0][write[1:]])
    assert torch.equal(c[0][write[0]], g[:128])


# ------------------------------------------------------------------ run loop


def _zero_philox(monkeypatch):
    """The port's production draws made all zero, as JAX's are in
    interpret mode."""
    def draws(seed, G, K, L, mutate="point", crossover="uniform", sub_generation=0, tie=False):
        return fs.zero_draws(G, K, L, mutate, steps=1).at(0)

    monkeypatch.setattr(fs, "philox_draws", draws)


def _jax_run(P, L, T, n, target, g, layout=None):
    obj = jax_objectives.get("onemax")
    bm = _jax_multigen(P, L, deme_size=128, _layout=layout)
    with _interpret():
        run = ps._multigen_run_loop(obj, bm, P, L, T, donate=False)
        g2, s2, gens = run(jnp.asarray(g), jax.random.key(0), jnp.int32(n),
                           jnp.float32(target), bm.default_params)
    return np.asarray(g2), np.asarray(s2), int(gens)


@pytest.mark.parametrize("layout", ["riffle", "pingpong"])
def test_run_loop_lands_on_n_with_alternating_parities(layout, monkeypatch):
    P, L, T, n = 512, 20, 3, 10
    run = fs.make_multigen_run(P, L, objectives.onemax, T, deme_size=128, layout=layout,
                               device="cpu")
    calls = []
    real = fs.multigen_breed

    def spy(genomes, scores, geom, parity, steps, target=None, **kw):
        calls.append((parity, steps))
        return real(genomes, scores, geom, parity, steps, target, **kw)

    monkeypatch.setattr(fs, "multigen_breed", spy)
    g = np.random.default_rng(1).random((P, L), dtype=np.float32)
    g2, s2, gens = run(torch.from_numpy(g), n, None, torch.Generator().manual_seed(0))
    assert gens == n
    par = [0, 1, 0, 1] if layout == "pingpong" else [0, 0, 0, 0]
    assert calls == list(zip(par, [3, 3, 3, 1]))
    assert g2.shape == (P, L) and s2.shape == (P,)
    torch.testing.assert_close(s2, g2.sum(dim=1), rtol=1e-5, atol=0)
    assert float(s2.mean()) > float(g.sum(axis=1).mean()) + 1.0


@pytest.mark.parametrize("layout", ["riffle", "pingpong"])
@pytest.mark.parametrize("n,target", [(10, math.inf), (10, 12.4), (7, 12.4), (10, 5.0)])
def test_run_loop_generations_equal_jax(layout, n, target, monkeypatch):
    """Same population, zero draws in both packages: the generation
    count, the population and the scores agree; a target stop is a
    multiple of T with the achiever present."""
    P, L, T = 512, 20, 3
    g = np.random.default_rng(1).random((P, L), dtype=np.float32)
    gj, sj, gens_j = _jax_run(P, L, T, n, target, g, layout)
    _zero_philox(monkeypatch)
    run = fs.make_multigen_run(P, L, objectives.onemax, T, deme_size=128, layout=layout,
                               device="cpu")
    gp, sp, gens_p = run(torch.from_numpy(g), n, None if math.isinf(target) else target,
                         torch.Generator().manual_seed(0))
    assert gens_p == gens_j
    np.testing.assert_allclose(gp.numpy(), gj, rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(sp.numpy(), sj, rtol=0, atol=L * 1e-5)
    if not math.isinf(target) and gens_p < n:
        assert gens_p % T == 0 and float(sp.max()) >= target


def test_run_loop_target_stop_keeps_the_achiever():
    """Philox draws: the run stops at a multiple of T, and the
    individual that reached the target is in the returned population."""
    P, L, T, target = 1024, 32, 4, 26.0
    run = fs.make_multigen_run(P, L, objectives.onemax, T, device="cpu")
    gen = torch.Generator().manual_seed(5)
    g = torch.rand((P, L), generator=gen)
    g2, s2, gens = run(g, 1000, target, gen)
    assert 0 < gens < 1000 and gens % T == 0
    assert float(s2.max()) >= target
    torch.testing.assert_close(s2, g2.sum(dim=1), rtol=1e-5, atol=0)


def test_run_loop_stops_on_a_nan_best():
    P, L = 512, 8
    nan_obj = lambda m: torch.sum(m, dim=1) + torch.where(m[:, 0] > 2.0, 0.0, torch.nan)  # noqa: E731
    nan_obj.fused_id = 1
    run = fs.make_multigen_run(P, L, nan_obj, 3, device="cpu")
    g = torch.rand((P, L), generator=torch.Generator().manual_seed(0))
    _, s2, gens = run(g, 10, None, torch.Generator().manual_seed(0))
    assert gens == 0 and torch.isnan(s2).all()


# -------------------------------------------------------------------- engine


def _solver(P=1024, L=32, **config):
    p = port.PGA(seed=0, config=port.PGAConfig(device="cpu", **config))
    h = p.create_population(P, L)
    p.set_objective("onemax")
    return p, h


def test_engine_counts_launches_not_generations():
    """Fault 2: ``PGA.launches`` counts launches."""
    before = dict(kernels.LAUNCHES)
    p, h = _solver(generations_per_launch=3)
    start = float(p.population(h).genomes.sum(dim=1).max())
    assert p.run(10) == 10
    assert p.launches == 4
    assert p.run(6) == 6 and p.launches == 6
    assert p.get_best_with_score(h)[1] > start
    assert kernels.LAUNCHES == before  # on the CPU the plain version ran
    one, _ = _solver()
    assert one.run(10) == 10 and one.launches == 10
    explicit, _ = _solver(generations_per_launch=1)
    assert explicit.run(4) == 4 and explicit.launches == 4


def test_engine_default_is_one_generation_per_launch(monkeypatch):
    monkeypatch.setattr(fs, "multigen_breed", None)  # must not be reached
    p, _ = _solver()
    assert p.config.generations_per_launch is None and p.config.layout is None
    assert p.run(3) == 3 and p.launches == 3


def test_engine_target_stop_at_launch_granularity():
    p, h = _solver(generations_per_launch=4)
    gens = p.run(1000, target=26.0)
    assert 0 < gens < 1000 and gens % 4 == 0 and p.launches == gens // 4
    assert p.get_best_with_score(h)[1] >= 26.0


def test_engine_elitism_is_per_deme_and_monotone():
    p, h = _solver(generations_per_launch=3, elitism=2)
    p.run(3)
    best = p.get_best_with_score(h)[1]
    p.run(9)
    assert p.get_best_with_score(h)[1] >= best


def test_engine_warns_and_runs_one_generation_where_multigen_declines():
    # an objective without a rowwise fused form
    p = port.PGA(seed=0, config=port.PGAConfig(device="cpu", generations_per_launch=3))
    p.create_population(512, 16)
    p.set_objective(lambda m: -torch.sum((m - 0.25) ** 2, dim=1))
    with pytest.warns(UserWarning, match="generations_per_launch=3"):
        assert p.run(5) == 5
    assert p.launches == 5
    # elitism too large for the deme
    p, _ = _solver(P=512, L=16, generations_per_launch=3, elitism=200)
    with pytest.warns(UserWarning, match="declined"):
        assert p.run(4) == 4
    assert p.launches == 4
    # the fused TSP score is gene-major, not rowwise: JAX warns and runs
    # the one-generation order kernel
    p = port.PGA(seed=0, config=port.PGAConfig(device="cpu", generations_per_launch=2))
    p.create_population(256, 40)
    p.set_objective(objectives.make_tsp_coords(
        objectives.random_tsp_coords(40, seed=2), duplicate_mode="genes"))
    p.set_crossover(order_preserving_crossover)
    p.set_mutate(make_swap_mutate(0.5))
    with pytest.warns(UserWarning, match="declined"):
        assert p.run(3) == 3
    assert p.launches == 3
    # the panmictic path ignores the knob silently, as JAX's XLA path does
    p, _ = _solver(P=100, L=8, generations_per_launch=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert p.run(3) == 3
    assert p.launches == 0


def test_engine_order_crossover_with_a_rowwise_objective_raises():
    """Order crossover with a rowwise-fused objective at T > 1, which
    once raised NotImplementedError, now breeds in the multi-generation
    breed (one riffle deme per group), ceil(gens / T) launches."""
    p, _ = _solver(P=256, L=40, generations_per_launch=2)
    p.set_crossover(order_preserving_crossover)
    p.set_mutate(make_swap_mutate(0.5))
    assert p.run(3) == 3 and p.launches == 2
    geom = p._run_fn(256, 40)[0].geom
    assert (geom.layout, geom.D) == ("riffle", 1)


def test_engine_layout_knob_and_config_validation():
    p, _ = _solver(P=1024, L=16, generations_per_launch=2, layout="riffle")
    assert p.run(4) == 4
    assert p._run_fn(1024, 16)[0].geom.layout == "riffle"
    p, _ = _solver(P=1024, L=16, generations_per_launch=2)
    assert p._run_fn(1024, 16)[0].geom.layout == "pingpong"
    p, _ = _solver(P=2100, L=16, layout="pingpong")  # 17 demes: no D mixes
    with pytest.raises(ValueError, match="mixing gate"):
        p.run(1)
    with pytest.raises(ValueError, match="generations_per_launch"):
        port.PGAConfig(device="cpu", generations_per_launch=0)
    with pytest.raises(ValueError, match="layout"):
        port.PGAConfig(device="cpu", layout="comb")


def test_same_seed_same_multigen_run():
    runs = []
    for _ in range(2):
        p, h = _solver(P=600, L=20, generations_per_launch=4)
        p.run(10)
        runs.append(p.population(h).genomes)
    assert torch.equal(*runs)


def test_interop_maps_the_jax_config_fields():
    import libpga_tpu

    jc = libpga_tpu.PGAConfig(
        tournament_size=3, selection="truncation", selection_param=0.4,
        mutation_rate=0.05, elitism=2, pallas_deme_size=256,
        pallas_generations_per_launch=8, pallas_layout="riffle", use_pallas=False,
    )
    c = interop.pga_config_from_fields(jc, device="cpu")
    assert (c.tournament_size, c.selection, c.selection_param, c.mutation_rate, c.elitism) == (
        3, "truncation", 0.4, 0.05, 2)
    assert (c.deme_size, c.generations_per_launch, c.layout, c.use_deme_kernel, c.device) == (
        256, 8, "riffle", False, "cpu")
    assert interop.pga_config_from_fields(libpga_tpu.PGAConfig(), device="cpu").use_deme_kernel
