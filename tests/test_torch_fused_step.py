"""Parity of the port's breed geometry, row maps, ranks and Philox
draws (libpga_tpu_torch/ops/fused_step.py) with the JAX package's
Pallas breed (libpga_tpu/ops/pallas_step.py). Inputs are made with numpy
from a seed and handed to both packages as numpy arrays. The breeding
itself is compared in tests/test_torch_deme_breed.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.objectives import onemax as jax_onemax
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch.objectives import onemax
from libpga_tpu_torch.ops import fused_step as fs


# (a) geometry -------------------------------------------------------------

GEOMETRY_SHAPES = [
    (40_000, 100), (1 << 20, 100), (8192, 100), (4096, 32), (1000, 20),
    (600, 20), (1100, 10), (40_960, 100), (3000, 300), (200, 2000),
]


@pytest.mark.parametrize("P,L", GEOMETRY_SHAPES)
@pytest.mark.parametrize("fused", [True, False])
def test_geometry_matches_make_pallas_breed(P, L, fused):
    breed = ps.make_pallas_breed(
        P, L, fused_obj=jax_onemax.kernel_rowwise if fused else None
    )
    geom = fs.resolve_geometry(P, L, fused=fused)
    assert (geom.layout, geom.K, geom.D, geom.Pp) == (
        breed.layout, breed.K, breed.D, breed.Pp
    )


def test_main_path_shapes_take_the_documented_kernels():
    big = fs.resolve_geometry(1 << 20, 100)
    assert (big.layout, big.K, big.D, big.S) == ("pingpong", 512, 8, 256)
    ref = fs.resolve_geometry(40_000, 100)
    assert (ref.layout, ref.K, ref.D, ref.Pp) == ("riffle", 256, 1, 40_192)


@pytest.mark.parametrize("P", [100, 1025])
def test_geometry_declines_like_jax(P):
    assert ps.make_pallas_breed(P, 10) is None
    assert fs.resolve_geometry(P, 10) is None


# (b) layout algebra -------------------------------------------------------


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize(
    "Pp,K,D,q", [(4096, 512, 8, 8), (8192, 512, 8, 8), (1024, 512, 2, 8),
                 (1 << 20, 512, 8, 8), (2048, 128, 4, 16)]
)
def test_pingpong_maps_equal_jax_helpers(parity, Pp, K, D, q):
    W = D * K
    np.testing.assert_array_equal(
        fs.pingpong_perm(parity, Pp, W, q), ps.pingpong_perm(parity, Pp, W, q)
    )
    np.testing.assert_array_equal(
        fs.pingpong_child_rows(parity, Pp, K, q, D),
        ps.pingpong_child_rows(parity, Pp, K, q, D),
    )
    assert fs.pingpong_admissible(W, Pp, q) == ps.pingpong_admissible(W, Pp, q)


# (c) ranks ----------------------------------------------------------------


def _lexsort_ranks(scores, read, tie, P):
    """numpy oracle: per cohort, sort by (score descending with NaN as
    -inf, tie word ascending; pads pinned to 0xFFFFFFFF)."""
    G, K = read.shape
    out = np.empty((G, K), np.int64)
    for g in range(G):
        s = scores[read[g]].astype(np.float64)
        s = np.where(np.isnan(s), -np.inf, s)
        t = np.where(read[g] >= P, 0xFFFFFFFF, tie[g * K : (g + 1) * K])
        order = np.lexsort((t, -s))
        out[g, order] = np.arange(K)
    return out


@pytest.mark.parametrize(
    "P,L,layout", [(1000, 20, None), (4096, 32, None), (600, 20, None),
                   (1000, 20, "riffle")]
)
@pytest.mark.parametrize("parity", [0, 1])
def test_compute_ranks_equals_lexsort_oracle(P, L, layout, parity):
    geom = fs.resolve_geometry(P, L, layout=layout)
    rng = np.random.default_rng(P + parity)
    # Coarse scores force ties; NaN, -inf, +-0 exercise the total order.
    s = rng.integers(0, 6, geom.Pp).astype(np.float32)
    s[rng.random(geom.Pp) < 0.05] = np.nan
    s[rng.random(geom.Pp) < 0.05] = -np.inf
    s[rng.random(geom.Pp) < 0.05] = -0.0
    s[P:] = -np.inf
    tie = rng.integers(0, 2**31, geom.Pp)
    tie[:8] = tie[8]  # a colliding tie word resolves by slot order
    ranks = fs.compute_ranks(
        torch.from_numpy(s), geom, parity, torch.from_numpy(tie)
    ).numpy()
    read = geom.row_maps(parity, "cpu")[0].numpy()
    np.testing.assert_array_equal(ranks, _lexsort_ranks(s, read, tie, P))


@pytest.mark.parametrize("P,L", [(8192, 100), (1000, 20), (600, 20)])
@pytest.mark.parametrize("parity", [0, 1])
def test_compute_ranks_equals_jax_on_distinct_scores(P, L, parity):
    breed = ps.make_pallas_breed(P, L, fused_obj=jax_onemax.kernel_rowwise)
    geom = fs.resolve_geometry(P, L)
    rng = np.random.default_rng(7)
    s = rng.permutation(geom.Pp).astype(np.float32)
    s[P:] = -np.inf
    want = np.asarray(
        breed.compute_ranks(jnp.asarray(s), jax.random.key(3), parity)
    ).reshape(geom.G, geom.K)
    tie = torch.randint(0, 2**31, (geom.Pp,), generator=torch.Generator().manual_seed(1))
    got = fs.compute_ranks(torch.from_numpy(s), geom, parity, tie).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("P,L", [(4096, 32), (1000, 20), (600, 20)])
@pytest.mark.parametrize("parity", [0, 1])
def test_island_compute_ranks_equals_jax_flattened_sort(P, L, parity):
    """Scores of three islands (I, Pp) rank in one sort over (I*G, K), as
    JAX's island runner ranks them (``breed.compute_ranks`` on (I, Pp)),
    for both row maps (4096 and 600 rows: ping-pong, 1000: riffle)."""
    breed = ps.make_pallas_breed(P, L, fused_obj=jax_onemax.kernel_rowwise)
    geom = fs.resolve_geometry(P, L)
    rng = np.random.default_rng(8)
    s = np.stack([rng.permutation(geom.Pp) for _ in range(3)]).astype(np.float32)
    s[:, P:] = -np.inf
    want = np.asarray(breed.compute_ranks(jnp.asarray(s), jax.random.key(3), parity))
    tie = torch.randint(0, 2**31, (3, geom.Pp), generator=torch.Generator().manual_seed(1))
    got = fs.compute_ranks(torch.from_numpy(s), geom, parity, tie).numpy()
    np.testing.assert_array_equal(got, want.reshape(3 * geom.G, geom.K).astype(np.int64))


# the plain Philox draws ---------------------------------------------------


def test_philox_matches_known_answer():
    """Random123's published Philox4x32-10 known-answer vectors."""
    def run(key, ctr):
        seed = torch.tensor([key[0] | (key[1] << 32)], dtype=torch.int64)
        c = [torch.tensor(v, dtype=torch.int64) for v in ctr]
        return [int(w) for w in fs.philox4x32(seed, *c)]

    assert run((0, 0), (0, 0, 0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_draws_statistics():
    seed = torch.tensor([12345], dtype=torch.int64)
    d = fs.philox_draws(seed, 64, 256, 300)
    assert d.cross.shape == (64, 256, 300)
    assert abs(d.cross.float().mean().item() - 0.5) < 0.005
    for u in (d.sel_u, d.mut_u):
        assert 0.0 <= u.min().item() and u.max().item() < 1.0
        assert abs(u.mean().item() - 0.5) < 0.01
    other = fs.philox_draws(torch.tensor([12346], dtype=torch.int64), 64, 256, 300)
    assert not torch.equal(d.sel_u, other.sel_u)


# the CPU wrapper ----------------------------------------------------------


def test_wrapper_on_cpu_runs_the_plain_version_with_philox_draws():
    geom = fs.resolve_geometry(1000, 20)
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.random((geom.Pp, 20), dtype=np.float32))
    s = torch.from_numpy(rng.random(geom.Pp, dtype=np.float32))
    ranks = fs.compute_ranks(s, geom, 1, torch.zeros(geom.Pp, dtype=torch.int64))
    seed = torch.tensor([99], dtype=torch.int64)
    kw = dict(mparams=torch.tensor([0.2, 0.0]), obj_id=onemax.fused_id)
    got = fs.deme_breed(g, ranks, geom, 1, seed=seed, **kw)
    want = fs.deme_breed_reference(
        g, ranks, geom, 1, fs.philox_draws(seed, geom.G, geom.K, 20), **kw
    )
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fs.deme_breed(g, ranks, geom, 1, **kw)
