"""The port's eval-time optimizer (libpga_tpu_torch/gp/optimize.py)
against the JAX package's (libpga_tpu/gp/optimize.py) on the same numpy
gene matrices: opcodes and live lengths exactly equal, every operand
that is not a folded literal exactly equal.

Folded LIT values agree within rtol = atol = 1e-6, and most of them bit
for bit. XLA's CPU sin and cos differ from torch's by 1 ulp on about 5%
of inputs (measured), a fold chains up to max_nodes such calls, and
cancellation (log(log(exp(1.0))) is 0.0 in one library and -6e-8 in the
other) turns a 1-ulp step into a large relative difference, so a bound
in ulps does not hold for chains."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.gp import encoding as jenc
from libpga_tpu.gp import optimize as jopt
from libpga_tpu_torch.gp import encoding as enc
from libpga_tpu_torch.gp import optimize as opt
from libpga_tpu_torch.gp.reference import reference_predict

CONFIGS = [
    dict(max_nodes=16, n_vars=2),
    dict(max_nodes=8, n_vars=2, consts=(1.0, 2.0), unary=("neg",), binary=("add", "sub", "mul")),
    dict(max_nodes=12, n_vars=1, unary=("exp", "log", "sqrt", "abs"), binary=("div", "min", "max")),
    dict(max_nodes=32, n_vars=2),
]
IDS = ["default16", "small", "all_functions", "main32"]


def _genes(gp, kind, n=256, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.uniform(0, 1, (n, gp.genome_len)).astype(np.float32)
    rand = rng.uniform(0, 1, (n, jenc.grow_rand_cols(gp))).astype(np.float32)
    return np.array(jenc.random_program_genes(jnp.asarray(rand), gp))


@pytest.mark.parametrize("kw", CONFIGS, ids=IDS)
@pytest.mark.parametrize("kind", ["programs", "noise"])
def test_optimize_for_eval_equals_jax(kw, kind):
    jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
    g = _genes(jgp, kind)
    want = jopt.optimize_for_eval(jnp.asarray(g), jgp)
    got = opt.optimize_for_eval(torch.from_numpy(g), pgp)
    ops, wops = got.ops.numpy(), np.asarray(want.ops)
    np.testing.assert_array_equal(ops, wops)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    assert got.ops.dtype == torch.int32 and got.length.dtype == torch.int32
    lit = ops == opt.lit_op(pgp)
    args, wargs = got.args.numpy(), np.asarray(want.args)
    np.testing.assert_array_equal(args[~lit], wargs[~lit])
    np.testing.assert_allclose(args[lit], wargs[lit], rtol=1e-6, atol=1e-6)
    assert (args[lit] == wargs[lit]).mean() >= 0.9


@pytest.mark.parametrize("kw", CONFIGS[:2], ids=IDS[:2])
def test_compaction_stats_and_live_lengths_equal_jax(kw):
    jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
    g = _genes(jgp, "programs", n=512, seed=1)
    assert opt.compaction_stats(torch.from_numpy(g), pgp) == jopt.compaction_stats(jnp.asarray(g), jgp)
    assert opt.mean_live_length(torch.from_numpy(g), pgp) == pytest.approx(
        jopt.mean_live_length(jnp.asarray(g), jgp), rel=1e-12
    )


def test_compacted_programs_keep_their_values():
    """The compacted program computes what the genome computes (numpy
    oracle on the genome; the port's plain B2 on the program)."""
    from libpga_tpu_torch.gp.interpreter import stack_predict_program

    pgp = enc.GPConfig(**CONFIGS[2])
    g = _genes(jenc.GPConfig(**CONFIGS[2]), "noise", n=128, seed=2)
    X = np.random.default_rng(3).uniform(-2, 2, (30, 1)).astype(np.float32)
    want = reference_predict(g, X, pgp)
    got = stack_predict_program(
        opt.optimize_for_eval(torch.from_numpy(g), pgp), torch.from_numpy(X.T.copy()), pgp
    ).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
