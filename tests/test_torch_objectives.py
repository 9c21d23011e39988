"""The port's rowwise objectives and evaluation against the JAX
package's (libpga_tpu/objectives/classic.py, libpga_tpu/ops/evaluate.py)
on the same numpy genomes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpga_tpu.objectives as jax_objectives
from libpga_tpu.ops.evaluate import evaluate as jax_evaluate
import libpga_tpu_torch.objectives as objectives
from libpga_tpu_torch.ops.evaluate import evaluate

# float32 sums over L genes in another order, and cos/exp/sqrt from
# another math library: a few ulps of the result.
RTOL = 1e-6

NAMES = ["onemax", "onemax_bits", "sphere", "rastrigin", "ackley"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("L", [4, 100])
def test_rowwise_objective_matches_jax(name, L):
    rng = np.random.default_rng(L)
    m = rng.random((64, L), dtype=np.float32)
    m[0] = 0.5  # onemax_bits threshold exactly
    want = np.asarray(jax_objectives.get(name).kernel_rowwise(jnp.asarray(m)))
    got = objectives.get(name)(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_evaluate_matches_jax(name):
    m = np.random.default_rng(1).random((32, 20), dtype=np.float32)
    want = np.asarray(jax_evaluate(jax_objectives.get(name), jnp.asarray(m)))
    got = evaluate(objectives.get(name), torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == (32,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_registry():
    assert set(NAMES) <= set(objectives.names())
    assert objectives.onemax.fused_id and objectives.onemax_bits.fused_id
    # every builtin with a kernel_rowwise form in JAX is fused here too
    for name in NAMES:
        assert hasattr(jax_objectives.get(name), "kernel_rowwise")
        assert objectives.get(name).fused_id in objectives.classic.ROWWISE_FUSED
    with pytest.raises(KeyError, match="registered"):
        objectives.get("no_such_objective")
