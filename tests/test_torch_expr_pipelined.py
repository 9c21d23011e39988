"""The expression breed on the pipelined schedule (``expr_pipelined_kernel``
of libpga_tpu_torch/csrc/expr_breed.cu), checked on the host, without
``nvcc`` or a card.

The kernel breeds a child with 8 lanes, sub-lane ``jl`` holding genes
``4*jl + 32*m + 0..3``. Two things it needs from the generated code and
the draws are checked here:

- the objective's eight-lane form (``ops/expr_cuda.py``:
  ``expr_obj8_genes``, ``expr_objective8``), built with the host ``g++``
  through ``expr_cuda.host_source``, where ``host_objective8`` runs the
  group's eight lanes one after the other between its syncs, so its sums
  combine in the kernel's order. Each reduction keeps a partial a
  warp-lane position and combines them in ``warp_sum``'s butterfly, so the
  score equals the warp form's order: ``objective.kernel_rowwise(child,
  warp_order=True)``, the plain version the card holds
  ``expr_breed_kernel`` to, bit for bit; and torch's own score within a
  float32 rounding of the sums' order (exactly where every value is an
  integer). Both of the kernel's paths: the first stage fused into the
  breed (no child row), and every stage over the child's row.
- the expression planes: sub-lane ``jl``'s Philox call ``32*t + 8*it +
  jl`` of tile ``t`` and word ``it`` gives exactly the uniforms that
  ``fused_step.philox_draws`` (the torch twin) and ``expr_breed_kernel``'s
  shuffled calls (``gene_draws``) give each gene.
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
from libpga_tpu_torch.ops import fused_step as fs

PTR = ctypes.c_void_p
L = 24

NK_T = np.random.default_rng(9).random((16, L)).astype(np.float32)
# The objectives of tests/test_torch_expr_codegen.py: (name, objective,
# integer valued, reads the child back from its row).
OBJECTIVES = [
    ("nk", po.make_nk_landscape(L, 3, seed=1).expr_fused, False, False),
    ("trap", po.make_deceptive_trap(5).expr_fused, True, False),
    ("knapsack", po.make_knapsack(np.arange(1, L + 1), np.arange(L, 0, -1), 60.0).expr_fused,
     True, False),
    ("reductions", from_expression(
        "a = roll(g, -3); x = max(a) - min(g); sum(where(g < 0.3, a % 0.25, round(g*4.5)))"
        " + mean(g*g) * x + dot(i, g) / L"), False, True),
    ("nested-roll-gather", from_expression(
        "c = floor(g * 7); x = gather(t, c) + gather(T, g * 16); y = roll(x, 2);"
        " z = roll(y * g, -25); sum(z) + max(y) + sum(gather(t, sum(g)))",
        t=np.random.default_rng(2).random(7).astype(np.float32), T=NK_T), False, True),
    ("nan", from_expression("sum(min(log(g - 0.3), 0.5)) + max(sqrt(g - 0.2)) + min(g)"),
     False, False),
    ("later-stage", from_expression("m = mean(g); sum((g - m) * (g - m)) + max(g - m)"),
     False, True),
]


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("expr_pipelined")

    def make(program, name):
        src, lib = out / f"{name}.cpp", out / f"lib{name}.so"
        src.write_text(expr_cuda.host_source(program))
        res = subprocess.run(
            [cxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib), str(src)],
            capture_output=True, text=True,
        )
        assert res.returncode == 0, res.stderr
        so = ctypes.CDLL(str(lib))
        so.host_objective8.argtypes = [PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int, PTR, PTR]
        so.host_objective.argtypes = [PTR, ctypes.c_int, ctypes.c_int, PTR, PTR]
        return so

    return make


def _p(a):
    return a.ctypes.data_as(PTR)


@pytest.mark.parametrize("name,obj,integer,child", OBJECTIVES, ids=[o[0] for o in OBJECTIVES])
def test_eight_lane_objective_equals_the_warp_order(build, name, obj, integer, child):
    """The eight-lane objective, fused and over the child's row, scores
    every genome bit for bit as the warp form's order does (the plain
    version in warp order, NaN where it is NaN) and within a rounding of
    torch's own score; the generated text says whether it needs the
    child's row (EXPR_OBJ_CHILD), which only the unfused path may serve."""
    P = 41
    g = np.random.default_rng(zlib.crc32(name.encode())).random((P, L), dtype=np.float32)
    g[1] = 0.9
    g[2, ::3] = 0.5  # the comparisons' edge
    prog = expr_cuda.generate(objective=obj)
    assert prog.obj_child == child
    assert f"#define EXPR_OBJ_CHILD {int(child)}" in prog.source
    so = build(prog, f"obj8_{name.replace('-', '_')}")
    want = obj.kernel_rowwise(torch.from_numpy(g), warp_order=True).numpy()
    for fused in (0,) if child else (0, 1):
        out = np.zeros(P, np.float32)
        so.host_objective8(_p(g), P, L, fused, _p(prog.consts), _p(out))
        np.testing.assert_array_equal(out, want)  # bit for bit, NaN where NaN
        torch_score = obj(torch.from_numpy(g)).numpy()
        if integer:
            np.testing.assert_array_equal(out, torch_score)
        else:
            np.testing.assert_allclose(out, torch_score, rtol=1e-6, atol=1e-6, equal_nan=True)
        warp = np.zeros(P, np.float32)  # the warp form, one lane on the host
        so.host_objective(_p(g), P, L, _p(prog.consts), _p(warp))
        np.testing.assert_allclose(out, warp, rtol=1e-6, atol=1e-6, equal_nan=True)


def test_the_eight_lane_form_sits_beside_the_warp_form():
    """One unit holds both forms of the objective (the warp form for
    expr_breed_kernel, expr_order_kernel and expr_multigen_kernel, the
    eight-lane form for expr_pipelined_kernel), and the warp form's text
    is what it was: the breeding hooks and the warp objective keep their
    text, so those kernels' code does not change. A unit without an
    objective hook says it keeps no child row."""
    obj = po.make_deceptive_trap(5).expr_fused
    prog = expr_cuda.generate(objective=obj)
    src = prog.source
    warp = src[src.index("// objective: "):src.index("// objective, eight lanes a child")]
    assert "__device__ __forceinline__ float expr_objective(const float* __restrict__ grow," in warp
    assert "expr_lanes_sum" in warp and "EXPR_LANES" in warp
    for fn in ("struct ExprAcc8", "expr_obj8_begin", "expr_obj8_genes", "float expr_objective8("):
        assert fn in src
    mx = pbx.mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)")
    no_obj = expr_cuda.generate(mutate=mx)
    assert "#define EXPR_OBJ_CHILD 0" in no_obj.source and not no_obj.obj_child
    assert "expr_objective8" not in no_obj.source


def _words(seed, k, g, calls):
    """The four Philox words of calls ``calls`` (int64) of child (k, g),
    sub-generation 0, each shaped as ``calls``."""
    z = torch.zeros((), dtype=torch.int64)
    return fs.philox4x32(seed, z + k, z + g, calls, z)


@pytest.mark.parametrize("L", [100, 64, 60, 256])
def test_each_sub_lane_makes_its_own_plane_calls(L):
    """Gene ``128*t + 32*it + 4*jl + i`` of plane j is word i of call
    ``32*t + 8*it + jl``: sub-lane jl's call at tile t and word it, no
    shuffle. Over every tile, word and sub-lane that mapping gives each
    gene the uniform ``philox_draws`` gives it, and so does
    expr_breed_kernel's mapping (lane ``c`` of a tile makes call ``32*t +
    c``; gene ``128*t + lane + 32*m`` takes word ``lane & 3`` of lane
    ``(lane >> 2) + 8*m``'s call)."""
    seed = torch.tensor([0x5DEECE66D12345], dtype=torch.int64)
    G, K = 2, 3
    mut = pbx.mutate_from_expression("where(r < rate, r2, g)")
    cross = pbx.crossover_from_expression("r * p1 + (1 - r) * p2")
    want = fs.philox_draws(seed, G, K, L, mut, cross).expr_gene
    planes, _ = expr_cuda.streams(cross, mut)
    assert planes == (0, 2, 3)
    tiles = -(-L // 128)
    for j in planes:
        stream = fs.STREAM_EXPR_GENE + (j << 22)
        for k in range(K):
            for g in range(G):
                eight = torch.full((L,), float("nan"))
                warp = torch.full((L,), float("nan"))
                for t in range(tiles):
                    # expr_pipelined_kernel: sub-lane jl, word it.
                    it, jl = torch.meshgrid(torch.arange(4), torch.arange(8), indexing="ij")
                    calls = stream + 32 * t + 8 * it + jl
                    words = torch.stack(_words(seed, k, g, calls), dim=-1)  # (4, 8, 4)
                    for i in range(4):
                        gene = 128 * t + 32 * it + 4 * jl + i
                        ok = gene < L
                        eight[gene[ok]] = fs._to_uniform(words[..., i][ok])
                    # expr_breed_kernel: lane c's call, shuffled.
                    lane_words = torch.stack(_words(seed, k, g, stream + 32 * t + torch.arange(32)),
                                             dim=-1)  # (32, 4)
                    for lane in range(32):
                        for m in range(4):
                            gene = 128 * t + lane + 32 * m
                            if gene < L:
                                src = (lane >> 2) + 8 * m
                                warp[gene] = fs._to_uniform(lane_words[src, lane & 3])
                assert torch.equal(eight, want[j, g, k])
                assert torch.equal(warp, want[j, g, k])
