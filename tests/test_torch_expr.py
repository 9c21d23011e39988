"""Parity of the port's expression objectives
(libpga_tpu_torch/objectives/expr.py) with the JAX package's
(libpga_tpu/objectives/expr.py).

The same numpy genomes, made from a seed, go through both packages'
``from_expression(...).kernel_rowwise``. Tolerance: rtol = atol = 1e-6
(float32 sums in another order, one-ulp differences of the two
libraries' transcendentals); results that are integers compare exactly.
Every expression the JAX package rejects is rejected by the port with
``ExpressionError`` too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.objectives import ExpressionError as JaxExpressionError
from libpga_tpu.objectives import from_expression as jax_from_expression
from libpga_tpu_torch.interop import expression_objective_from_jax
from libpga_tpu_torch.objectives import ExpressionError, from_expression

RTOL = ATOL = 1e-6

_RNG = np.random.default_rng(20)
W12 = np.linspace(-1.0, 2.0, 12).astype(np.float32)
T7 = _RNG.random(7).astype(np.float32)
T2D = _RNG.random((5, 12)).astype(np.float32)

# (expression, constants, genome length, integer valued)
CASES = [
    # the module docstring's examples
    ("sum(g)", {}, 12, False),
    ("-sum((g*10.24-5.12)**2)", {}, 12, False),
    ("dot(v, g >= 0.5)", {"v": W12}, 12, False),
    ("where(dot(w, floor(g*2)) <= cap, dot(v, floor(g*2)), cap - dot(w, floor(g*2)))",
     {"w": np.arange(12, dtype=np.float32), "v": W12, "cap": 30.0}, 12, False),
    ("b = g >= 0.5; codes = b + 2*roll(b, 1) + 4*roll(b, 2) + 8*roll(b, 3);"
     " mean(gather(T, codes))", {"T": _RNG.random((16, 12)).astype(np.float32)}, 12, False),
    ("c = floor(g * L); x = gather(X, c); y = gather(Y, c);"
     " dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
     " -sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))",
     {"X": _RNG.random(12).astype(np.float32) * 100, "Y": _RNG.random(12).astype(np.float32) * 100},
     12, False),
    # % with negative operands: the sign of the divisor
    ("sum((g - 0.5) * 7 % 2.5) + sum((g * 3) % -0.7)", {}, 12, False),
    ("sum(floor((g - 0.5) * 20) % -3)", {}, 12, True),
    # round at .5: half to even
    ("sum(round(floor(g * 8) + 0.5))", {}, 12, True),
    ("sum(round(g * 6 - 3))", {}, 12, True),
    # NaN through min / max / clip-like forms
    ("sum(min(log(g - 0.3), 0.5))", {}, 12, False),
    ("max(sqrt(g - 0.2)) + min(g)", {}, 12, False),
    ("sum(max(log(g - 0.5), -1) * 0 + g)", {}, 12, False),
    # roll with negative and > L shifts
    ("sum(roll(g, -3) * g) + sum(roll(g, 25) * i)", {}, 12, False),
    ("a = roll(roll(g, 2), -13); sum(a * a) - max(roll(g, 12))", {}, 12, False),
    # 1-D and 2-D gather with out-of-range indices
    ("sum(gather(t, g * 12 - 3))", {"t": T7}, 12, False),
    ("sum(gather(T, (g - 0.3) * 9))", {"T": T2D}, 12, False),
    ("sum(gather(t, sum(g))) + sum(gather(T, 2))", {"t": T7, "T": T2D}, 12, False),
    # locals, comparisons, where, transcendentals
    ("x = g * 2 - 1; y = x * x; s = sum(y); s / (1 + mean(abs(x))) - max(tanh(x))", {}, 12, False),
    ("sum(where(g > 0.5, sin(g * pi), cos(g * e))) + sum(exp(g) * (g == g))", {}, 12, False),
    ("sum(tan(g) * (i < 4)) + sum(g <= 0.25) + c", {"c": 2.5}, 12, False),
    ("-(2**3) + sum(g)*0", {}, 12, True),
    ("sum(g ** 1.5) + sum(floor(g * 4) ** 2)", {}, 12, False),
]


def _genomes(L, seed=0):
    g = np.random.default_rng(seed).random((9, L)).astype(np.float32)
    g[0, :4] = [0.5, 0.25, 0.0, 0.75]  # exact halves and quarters
    return g


def _both(expr, consts, L):
    g = _genomes(L, len(expr))
    want = np.asarray(jax_from_expression(expr, **consts).kernel_rowwise(jnp.asarray(g)))
    got = from_expression(expr, **consts).kernel_rowwise(torch.from_numpy(g)).numpy()
    return got, want


@pytest.mark.parametrize("expr,consts,L,integer", CASES, ids=[c[0][:40] for c in CASES])
def test_kernel_rowwise_equals_jax(expr, consts, L, integer):
    got, want = _both(expr, consts, L)
    assert got.shape == want.shape == (9,)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


def test_nan_propagates_as_in_jax():
    got, want = _both("sum(min(log(g - 0.3), 0.5))", {}, 12)
    assert np.isnan(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_attributes_match_jax():
    T = _RNG.random((4, 10)).astype(np.float32)
    w = np.ones(10, np.float32)
    for expr, consts in (("sum(gather(T, g * 4)) + dot(w, g) + c", {"T": T, "w": w, "c": 1.0, "unused": 3.0}),
                         ("sum(gather(t, g * 7))", {"t": T7})):
        j = jax_from_expression(expr, **consts)
        p = from_expression(expr, **consts)
        assert p.expression == j.expression == expr
        assert p.pinned_genome_len == j.pinned_genome_len
        assert len(p.kernel_rowwise_consts) == len(j.kernel_rowwise_consts)
        for a, b in zip(p.kernel_rowwise_consts, j.kernel_rowwise_consts):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert p.expr_fused is p


BAD_OBJECTIVES = [
    # tests/test_objectives.py::test_errors
    ("sum(", {}), ("sum(q)", {}), ("g * 2", {}), ("frobnicate(g)", {}),
    ("sum(g,)", {}), ("where(g)", {}), ("1 ++", {}), ("sum(g) @ 2", {}),
    ("dot(v, g)", {"v": np.ones((2, 2))}),
    ("sum(g) + sum", {}),
    ("dot(a, g) + dot(b, g)", {"a": np.ones(3), "b": np.ones(5)}),
    ("sum(g)", {"where": np.ones(3)}),
    # tests/test_objectives.py::test_v2_errors
    ("x = g; x = g; sum(x)", {}),
    ("g = sum(g); g", {}),
    ("sum(roll(g, L))", {}),
    ("sum(gather(g, g))", {}),
    ("sum(T * g)", {"T": np.ones((3, 4))}),
    ("sum(gather(t, g))", {"t": np.ones(600)}),
]


@pytest.mark.parametrize("expr,consts", BAD_OBJECTIVES, ids=[b[0] for b in BAD_OBJECTIVES])
def test_bad_expressions_raise_in_both(expr, consts):
    with pytest.raises(JaxExpressionError) as jax_err:
        jax_from_expression(expr, **consts)
    with pytest.raises(ExpressionError) as port_err:
        from_expression(expr, **consts)
    # The parser's messages are the JAX module's; shape errors that the
    # JAX package finds while tracing are rewrapped there, and here.
    if "invalid expression" not in str(jax_err.value):
        assert str(port_err.value) == str(jax_err.value)


def test_per_locus_width_mismatch_raises():
    f = from_expression("sum(gather(T2, g * 5))", T2=np.arange(5, dtype=np.float32).reshape(5, 1))
    with pytest.raises(ExpressionError, match="width"):
        f.kernel_rowwise(torch.zeros((2, 8)))


def test_folded_roll_shift_is_accepted():
    from_expression("sum(roll(g, 2 + 1))")


@pytest.mark.parametrize("expr,consts", [
    ("b = g >= 0.5; codes = b + 2*roll(b, 1) + 4*roll(b, 2); mean(gather(T, codes))",
     {"T": _RNG.random((8, 12)).astype(np.float32)}),
    ("dot(w, g) + c", {"w": W12, "c": 2.0}),
    ("sum(gather(t, g * 7)) + sum(gather(P, 0) * g)",
     {"t": T7, "P": np.arange(12, dtype=np.float32).reshape(1, 12)}),
])
def test_expression_objective_from_jax(expr, consts):
    """The interop rebuild carries the source and the constants across,
    a (1, L) per-locus table included."""
    j = jax_from_expression(expr, **consts)
    p = expression_objective_from_jax(j)
    g = _genomes(12, 3)
    np.testing.assert_allclose(
        p(torch.from_numpy(g)).numpy(), np.asarray(j.kernel_rowwise(jnp.asarray(g))),
        rtol=RTOL, atol=ATOL,
    )
    assert p.table_kinds == from_expression(expr, **consts).table_kinds
