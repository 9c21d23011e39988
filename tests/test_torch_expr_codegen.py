"""The CUDA lowering of expressions (libpga_tpu_torch/ops/expr_cuda.py)
checked on the host, without ``nvcc`` or a card.

The generated hooks compile as plain C++ when ``__CUDACC__`` is
undefined (a warp of one lane). Each program here is built with the
host ``g++`` (``-ffp-contract=off``, so nothing is fused into a
multiply-add, as ``--fmad=false`` does on the card), loaded with ctypes
and held against the port's torch plain versions on seeded inputs:
breeding hooks exactly for ``+ - * / %``, comparisons, ``where``,
``floor``, ``round``, ``min`` / ``max``, and within 2 ulp where they call
a transcendental, ``sqrt`` or ``**``; objectives within a float32 rounding of
their sums' order (rtol 1e-6), exactly where every value is an integer.
"""

import ctypes
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from libpga_tpu_torch import objectives as po
from libpga_tpu_torch.objectives import from_expression
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import expr_cuda

T = torch.from_numpy
PTR = ctypes.c_void_p
L = 24


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("expr_codegen")

    def make(program, name):
        src, lib = out / f"{name}.cpp", out / f"lib{name}.so"
        src.write_text(expr_cuda.host_source(program))
        res = subprocess.run(
            [cxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib), str(src)],
            capture_output=True, text=True,
        )
        assert res.returncode == 0, res.stderr
        so = ctypes.CDLL(str(lib))
        if program.has_crossover:
            so.host_crossover.argtypes = [PTR] * 6 + [ctypes.c_int] * 2 + [PTR] * 2
        if program.has_mutate:
            so.host_mutate.argtypes = [PTR] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [PTR] * 2
        if program.has_objective:
            so.host_objective.argtypes = [PTR, ctypes.c_int, ctypes.c_int, PTR, PTR]
        return so

    return make


def _p(a):
    return a.ctypes.data_as(PTR)


def _ulps(a, b):
    """Distance in float32 units in the last place (NaN to NaN: 0)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(2**31) - ia, ia)
    ib = np.where(ib < 0, -(2**31) - ib, ib)
    d = np.abs(ia - ib)
    return np.where(np.isnan(a) & np.isnan(b), 0, d)


W = np.linspace(-1.0, 1.0, L).astype(np.float32)

BREEDING = [
    # (role, expression, constants, transcendental)
    ("crossover", "where(i < floor(q * L), p1, p2)", {}, False),
    ("crossover", "r * p1 + (1 - r) * p2", {}, False),
    ("crossover", "where(r2 <= 0.5, min(p1, p2), max(p1, p2)) + (p1 - p2) % -0.3 * w", {"w": W}, False),
    ("crossover", "round((p1 + p2) * 4.5) / 9 + (p1 == p2) - abs(q2 - p1) * (i >= L / 2)", {}, False),
    ("crossover", "sqrt(p1 * p2) + 0 * q", {}, True),
    ("crossover", "tanh(p1 - q + r)", {}, True),
    ("crossover", "p2 ** (1 + r)", {}, True),
    ("mutate", "where(r < rate, g + sigma * (2*r2 - 1), g)", {}, False),
    ("mutate", "where(r < rate, r2, g)", {}, False),
    ("mutate", "g % (0.25 + q) + floor(g * 7) / 7 * c - (g > q2)", {"c": 0.5}, False),
    ("mutate", "exp(-g * r)", {}, True),
    ("mutate", "log(1 + r2 + g)", {}, True),
    ("mutate", "cos(g * pi * 0.5) + sin(q - 1) * 0", {}, True),
    ("mutate", "max(log(g - 0.4), -2) + 3", {}, True),
]


@pytest.mark.parametrize("role,expr,consts,trans", BREEDING, ids=[b[1][:36] for b in BREEDING])
def test_breeding_hook_equals_torch(build, role, expr, consts, trans):
    rng = np.random.default_rng(len(expr))
    P = 37
    p1, p2, r, r2 = (rng.random((P, L), dtype=np.float32) for _ in range(4))
    q, q2 = (rng.random(P, dtype=np.float32) for _ in range(2))
    p1[0, :5] = p2[0, :5] = [0.5, 0.25, 0.0, 0.75, 0.125]
    out = np.zeros((P, L), np.float32)
    if role == "crossover":
        op = pbx.crossover_from_expression(expr, **consts)
        prog = expr_cuda.generate(crossover=op)
        so = build(prog, f"cx{zlib.crc32(expr.encode())}")
        so.host_crossover(_p(p1), _p(p2), _p(r), _p(r2), _p(q), _p(q2), P, L, _p(prog.consts), _p(out))
        want = op.kernel_rows(T(p1), T(p2), T(r), T(r2), T(q)[:, None], T(q2)[:, None]).numpy()
    else:
        op = pbx.mutate_from_expression(expr, rate=0.3, sigma=0.1, **consts)
        prog = expr_cuda.generate(mutate=op)
        so = build(prog, f"mx{zlib.crc32(expr.encode())}")
        so.host_mutate(_p(p1), _p(r), _p(r2), _p(q), _p(q2), P, L, 0.3, 0.1, _p(prog.consts), _p(out))
        want = op.kernel_rows(T(p1), T(r), T(r2), T(q)[:, None], T(q2)[:, None], 0.3, 0.1).numpy()
    assert prog.transcendental == trans
    if trans:
        assert int(_ulps(out, want).max()) <= 2
    else:
        np.testing.assert_array_equal(out, want)
    assert (np.isnan(out) == np.isnan(want)).all()


NK_T = np.random.default_rng(9).random((16, L)).astype(np.float32)
OBJECTIVES = [
    # (name, objective, integer valued)
    ("nk", po.make_nk_landscape(L, 3, seed=1).expr_fused, False),
    ("trap", po.make_deceptive_trap(5).expr_fused, True),
    ("knapsack", po.make_knapsack(np.arange(1, L + 1), np.arange(L, 0, -1), 60.0).expr_fused, True),
    ("reductions", from_expression(
        "a = roll(g, -3); x = max(a) - min(g); sum(where(g < 0.3, a % 0.25, round(g*4.5)))"
        " + mean(g*g) * x + dot(i, g) / L"), False),
    ("nested-roll-gather", from_expression(
        "c = floor(g * 7); x = gather(t, c) + gather(T, g * 16); y = roll(x, 2);"
        " z = roll(y * g, -25); sum(z) + max(y) + sum(gather(t, sum(g)))",
        t=np.random.default_rng(2).random(7).astype(np.float32), T=NK_T), False),
    ("nan", from_expression("sum(min(log(g - 0.3), 0.5)) + max(sqrt(g - 0.2)) + min(g)"), False),
]


@pytest.mark.parametrize("name,obj,integer", OBJECTIVES, ids=[o[0] for o in OBJECTIVES])
def test_objective_hook_equals_torch(build, name, obj, integer):
    g = np.random.default_rng(len(name)).random((41, L), dtype=np.float32)
    g[1] = 0.9
    prog = expr_cuda.generate(objective=obj)
    so = build(prog, f"obj_{name.replace('-', '_')}")
    out = np.zeros(41, np.float32)
    so.host_objective(_p(g), 41, L, _p(prog.consts), _p(out))
    want = obj(T(g)).numpy()
    if integer:
        np.testing.assert_array_equal(out, want)
    else:
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6, equal_nan=True)


def test_generated_text_is_deterministic_and_value_free():
    """The text, whose hash keys the build, depends on the expressions
    and the constants' shapes, never on their values."""
    a = expr_cuda.generate(objective=po.make_nk_landscape(64, 3, seed=0).expr_fused)
    b = expr_cuda.generate(objective=po.make_nk_landscape(64, 3, seed=5).expr_fused)
    assert a.source == b.source and not np.array_equal(a.consts, b.consts)
    assert a.obj_rows == 1 and a.consts.size == 16 * 64
    cx = pbx.crossover_from_expression("r * p1 + (1 - r) * p2")
    mx = pbx.mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)")
    p = expr_cuda.generate(crossover=cx, mutate=mx)
    assert (p.gene_planes, p.row_words) == ((0, 2, 3), ())
    assert expr_cuda.program_for(cx, mx) is expr_cuda.program_for(cx, mx)
    assert expr_cuda.flit(0.1) == "0x1.99999a0000000p-4f" and expr_cuda.flit(-2.0) == "(-0x1.0000000000000p+1f)"
