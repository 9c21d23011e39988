"""Parity of the port's deme breed (libpga_tpu_torch/ops/fused_step.py
and csrc/deme_breed.cu) with the JAX package's Pallas breed
(libpga_tpu/ops/pallas_step.py).

Inputs and noise are made with numpy from a seed and handed to both
packages as numpy arrays. The breeding core is compared draw for draw by
calling ``_deme_child`` directly with an injected ``uniform``. The whole
breed runs the JAX kernels as the JAX package's own tests run them on the
CPU: under ``force_tpu_interpret_mode``, whose PRNG bits are all zero
(every child copies its cohort's rank-0 row, and point mutation sets
gene 0 to 0.0), so the comparison pins the row maps and padding exactly.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.objectives import onemax as jax_onemax
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch.objectives import onemax
from libpga_tpu_torch.ops import fused_step as fs


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


# (d) the breeding core ----------------------------------------------------

CORE_K, CORE_L = 256, 100
GENE_ATOL = 2e-5  # JAX gathers parents with a bf16 hi/lo one-hot matmul


def _core_inputs(seed, mutate):
    rng = np.random.default_rng(seed)
    K, L = CORE_K, CORE_L
    return dict(
        g=rng.random((K, L), dtype=np.float32),
        ranks=rng.permutation(K).astype(np.int32),
        sel_u=rng.random((K, 2), dtype=np.float32),
        cross=(rng.random((K, L)) < 0.5).astype(np.uint8),
        mut_u=rng.random((K, 4), dtype=np.float32),
        gauss=rng.random((3, K, L), dtype=np.float32) if mutate == "gaussian" else None,
    )


def _jax_child(x, *, V, sel, sel_param, tk, mutate, rate, sigma, elite_rows):
    """``_deme_child`` with an injected ``uniform`` serving the numpy
    draws in JAX's draw order: (2, K) selection, then the crossover
    mask word (deme d=0 reads bit 0), then the mutation draws."""
    K, L = x["g"].shape
    Lp = 128 * -(-L // 128)
    pad = ((0, 0), (0, Lp - L))
    queue = [x["sel_u"].T]
    if mutate in ("point", "swap"):
        queue.append(x["mut_u"].T)
    elif mutate == "gaussian":
        queue += [np.pad(p, pad) for p in x["gauss"]]

    def uniform(shape):
        a = queue.pop(0)
        assert a.shape == shape
        return jnp.asarray(a)

    lane_ok = None
    if mutate == "gaussian":
        lane_ok = jax.lax.broadcasted_iota(jnp.int32, (K, Lp), 1) < L
    child = ps._deme_child(
        jnp.asarray(np.pad(x["g"], pad)),
        jnp.asarray(x["ranks"], jnp.float32)[None, :],
        jnp.float32(V), uniform,
        jnp.asarray(np.pad(x["cross"], pad).astype(np.uint32)), 0,
        K=K, L=L, Lp=Lp, tk=tk, sel=sel, sel_param=sel_param,
        crossover="uniform", mutate=mutate, rate=jnp.float32(rate),
        sigma=jnp.float32(sigma), lane_ok=lane_ok, bf16_genes=False,
        elite_rows=elite_rows,
    )
    assert not queue
    return np.asarray(child)[:, :L]


def _port_child(x, *, V, sel, sel_param, tk, mutate, rate, sigma, elite_rows):
    draws = fs.Draws(
        sel_u=torch.from_numpy(x["sel_u"])[None],
        cross=torch.from_numpy(x["cross"])[None],
        mut_u=torch.from_numpy(x["mut_u"])[None],
        gauss=None if x["gauss"] is None else torch.from_numpy(x["gauss"])[:, None],
    )
    child = fs.breed_children(
        torch.from_numpy(x["g"])[None], torch.from_numpy(x["ranks"])[None],
        torch.tensor([float(V)]), draws, tournament_size=tk, selection=sel,
        selection_param=sel_param, mutate=mutate,
        mparams=torch.tensor([rate, sigma], dtype=torch.float32),
        elite_rows=elite_rows,
    )
    return child[0].numpy()


CORE_CASES = [
    # (selection, param, k, mutate, elite_rows, V)
    ("tournament", None, 2, "point", 0, CORE_K),
    ("tournament", None, 3, "point", 0, CORE_K),
    ("tournament", None, 16, "swap", 0, 200),
    ("truncation", 0.3, 2, "point", 0, CORE_K),
    ("linear_rank", 1.7, 2, "gaussian", 0, 137),
    ("tournament", None, 2, "point", 5, CORE_K),
    ("linear_rank", None, 2, "swap", 3, 3),
]


@pytest.mark.parametrize("sel,param,tk,mutate,elite,V", CORE_CASES)
def test_breeding_core_equals_deme_child(sel, param, tk, mutate, elite, V):
    x = _core_inputs(zlib.crc32(repr((sel, tk, mutate, elite, V)).encode()), mutate)
    kw = dict(V=V, sel=sel, sel_param=ps_select_param(sel, param), tk=tk,
              mutate=mutate, rate=0.3, sigma=0.1, elite_rows=elite)
    np.testing.assert_allclose(
        _port_child(x, **kw), _jax_child(x, **kw), rtol=0, atol=GENE_ATOL
    )


def ps_select_param(sel, param):
    from libpga_tpu.ops.select import resolve_selection

    return resolve_selection(sel, param)


@pytest.mark.parametrize("sel,param,tk,mutate,elite,V", CORE_CASES)
def test_breeding_core_selects_identical_parents(sel, param, tk, mutate, elite, V):
    """With no mutation and a constant crossover mask the child IS a
    parent row; both packages must pick the same row for every child."""
    x = _core_inputs(1 + zlib.crc32(repr((sel, tk, elite, V)).encode()), mutate)
    kw = dict(V=V, sel=sel, sel_param=ps_select_param(sel, param), tk=tk,
              mutate=mutate, rate=0.0, sigma=0.0, elite_rows=elite)
    for bit in (0, 1):
        x["cross"][:] = bit
        picked = []
        for child in (_port_child(x, **kw), _jax_child(x, **kw)):
            dist = np.abs(child[:, None, :] - x["g"][None, :, :]).max(-1)
            assert dist.min(1).max() <= GENE_ATOL
            picked.append(dist.argmin(1))
        np.testing.assert_array_equal(picked[0], picked[1])
        assert (x["ranks"][picked[0]] < V).all(), "selected a rank >= V"


# (e) whole-breed structure ------------------------------------------------


def _jax_vs_port_breed(P, L, parity, layout=None):
    with _interpret():  # the pallas_call must be built under the context
        breed = ps.make_pallas_breed(
            P, L, fused_obj=jax_onemax.kernel_rowwise, _layout=layout
        )
    geom = fs.resolve_geometry(P, L, layout=layout)
    assert (breed.layout, breed.K, breed.D, breed.Pp) == (
        geom.layout, geom.K, geom.D, geom.Pp
    )
    Pp, Lp = breed.Pp, breed.Lp
    rng = np.random.default_rng(P + L + parity)
    genomes = np.zeros((Pp, L), np.float32)
    genomes[:P] = rng.random((P, L), dtype=np.float32)
    # Strictly decreasing in physical row: every cohort's rank 0 is its
    # minimal real row, with no score ties.
    scores = -np.arange(Pp, dtype=np.float32)
    scores[P:] = -np.inf
    with _interpret():
        g_jax, s_jax = breed.padded(
            jnp.asarray(np.pad(genomes, ((0, 0), (0, Lp - L)))),
            jnp.asarray(scores), jax.random.key(0), None, parity,
        )
    g_jax, s_jax = np.asarray(g_jax)[:, :L], np.asarray(s_jax)
    tie = torch.zeros(Pp, dtype=torch.int64)
    ranks = fs.compute_ranks(torch.from_numpy(scores), geom, parity, tie)
    g_port, s_port = fs.deme_breed_reference(
        torch.from_numpy(genomes), ranks, geom, parity,
        fs.zero_draws(geom.G, geom.K, L),
        mparams=torch.tensor([0.01, 0.0]), obj_id=onemax.fused_id,
    )
    # JAX's hi/lo one-hot gather is accurate to ~1e-5 per gene, so its
    # fused score (a sum over L genes) is within L * 1e-5.
    np.testing.assert_allclose(g_port.numpy(), g_jax, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_port.numpy(), s_jax, rtol=0, atol=L * 1e-5)
    assert (g_port.numpy()[:, 0] == 0.0).all()  # point mutation of gene 0
    return geom


@pytest.mark.parametrize("parity", [0, 1])
def test_whole_breed_pingpong_8192x100(parity):
    geom = _jax_vs_port_breed(8192, 100, parity)
    assert (geom.layout, geom.Pp) == ("pingpong", 8192)


@pytest.mark.parametrize("parity", [0, 1])
def test_whole_breed_pingpong_padded(parity):
    geom = _jax_vs_port_breed(1000, 20, parity)
    assert (geom.layout, geom.Pp) == ("pingpong", 1024)


def test_whole_breed_riffle_padded():
    geom = _jax_vs_port_breed(1000, 20, 0, "riffle")
    assert (geom.layout, geom.G, geom.Pp) == ("riffle", 2, 1024)
