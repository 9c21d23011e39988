"""The port's GP encoding (libpga_tpu_torch/gp/encoding.py) against the
JAX package's (libpga_tpu/gp/encoding.py): the same numpy gene matrices
and uniform blocks give exactly the same opcodes, structure, canonical
forms and random programs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.gp import encoding as jenc
from libpga_tpu_torch import interop
from libpga_tpu_torch.gp import encoding as enc

CONFIGS = [
    dict(max_nodes=10, n_vars=2),
    dict(max_nodes=8, n_vars=2, consts=(1.0, 2.0), unary=("neg",), binary=("add", "sub", "mul")),
    dict(max_nodes=12, n_vars=3, unary=(), binary=("add", "mul")),
    dict(max_nodes=6, n_vars=1, consts=()),
    dict(max_nodes=32, n_vars=2),
]
IDS = ["default10", "small", "no_unary", "no_consts", "main32"]


def _pair(kw):
    return jenc.GPConfig(**kw), enc.GPConfig(**kw)


def _genes(gp, n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.uniform(0, 1, (n, gp.genome_len)).astype(np.float32)
    rand = rng.uniform(0, 1, (n, jenc.grow_rand_cols(gp))).astype(np.float32)
    return np.array(jenc.random_program_genes(jnp.asarray(rand), gp))


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_config_tables_and_keys_match(kw):
    jgp, pgp = _pair(kw)
    assert pgp.op_names() == jgp.op_names()
    assert pgp.op_arities() == jgp.op_arities()
    assert pgp.n_ops == jgp.n_ops and pgp.genome_len == jgp.genome_len
    assert pgp.cache_key() == jgp.cache_key()
    assert pgp.pad_gene == jgp.pad_gene
    assert interop.gp_config_from_fields(jgp) == pgp


def test_config_validation_matches():
    for bad in (dict(max_nodes=1), dict(unary=("nope",)), dict(binary=("pow",)),
                dict(max_nodes=10, opcode_block=3), dict(min_nodes=0),
                dict(stack_depth=0), dict(dispatch="sparse")):
        with pytest.raises(ValueError):
            jenc.GPConfig(**bad)
        with pytest.raises(ValueError):
            enc.GPConfig(**bad)


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
def test_random_program_genes_equal_jax(kw):
    jgp, pgp = _pair(kw)
    rand = np.random.default_rng(1).uniform(
        0, 1, (300, jenc.grow_rand_cols(jgp))
    ).astype(np.float32)
    want = np.asarray(jenc.random_program_genes(jnp.asarray(rand), jgp))
    got = enc.random_program_genes(torch.from_numpy(rand), pgp).numpy()
    np.testing.assert_array_equal(got, want)
    assert all(enc.is_well_formed(r, pgp) for r in got)


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
@pytest.mark.parametrize("kind", ["programs", "noise"])
def test_decode_structure_canonicalize_equal_jax(kw, kind):
    jgp, pgp = _pair(kw)
    g = _genes(jgp, 200, kind, seed=2)
    gj, gt = jnp.asarray(g), torch.from_numpy(g)
    np.testing.assert_array_equal(enc.decode_ops(gt, pgp).numpy(), np.asarray(jenc.decode_ops(gj, jgp)))
    np.testing.assert_array_equal(enc.decode_args(gt, pgp).numpy(), np.asarray(jenc.decode_args(gj, jgp)))
    sj, sp = jenc.program_structure(gj, jgp), enc.program_structure(gt, pgp)
    for field in ("live", "start", "span", "length", "final_depth"):
        np.testing.assert_array_equal(getattr(sp, field).numpy(), np.asarray(getattr(sj, field)), err_msg=field)
    canon = enc.canonicalize(gt, pgp).numpy()
    np.testing.assert_array_equal(canon, np.asarray(jenc.canonicalize(gj, jgp)))
    np.testing.assert_array_equal(enc.canonicalize(torch.from_numpy(canon), pgp).numpy(), canon)


@pytest.mark.parametrize("kw", CONFIGS[:3], ids=IDS[:3])
def test_host_helpers_equal_jax(kw):
    jgp, pgp = _pair(kw)
    for row in np.concatenate([_genes(jgp, 40, "programs", 3), _genes(jgp, 40, "noise", 4)]):
        assert enc.is_well_formed(row, pgp) == jenc.is_well_formed(row, jgp)
        assert enc.program_length(row, pgp) == jenc.program_length(row, jgp)
        assert enc.decode_expression(row, pgp) == jenc.decode_expression(row, jgp)
    toks = [("var", 0), ("var", 1), "mul", ("var", 0), "add"]
    np.testing.assert_array_equal(enc.encode_program(toks, pgp), jenc.encode_program(toks, jgp))
    assert enc.decode_expression(enc.encode_program(toks, pgp), pgp) == "((x0 * x1) + x0)"
    with pytest.raises(ValueError):
        enc.encode_program([("var", 9)], pgp)


def test_random_population_from_a_generator():
    gp = enc.GPConfig(max_nodes=16, n_vars=2)
    a = enc.random_population(torch.Generator().manual_seed(5), 128, gp)
    b = enc.random_population(torch.Generator().manual_seed(5), 128, gp)
    assert a.shape == (128, 32) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert all(enc.is_well_formed(r, gp) for r in a.numpy())
