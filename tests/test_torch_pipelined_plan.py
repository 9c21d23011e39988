"""The sub-block pipeline's launch plan and its route, on the CPU.

``deme_pipelined_kernel`` (csrc/deme_breed.cu) shares each deme among a
cluster of C blocks; csrc/pipe_plan.cuh picks C and lays out a block's
shared memory, and ``kernels.pipelined_plan`` mirrors it. Here the mirror
is pinned at the shapes the card runs, at B > 1 and at B = 1 (where
``PGA.run`` breeds OneMax, the islands and the shards), and at the edges
of the plan, held against the header itself (built with the host
compiler), and ``fused_step.breed_launcher`` is shown to send every shape
a cluster holds to the pipelined kernel and a deme no cluster holds, and
the floor harness's copy, to ``deme_breed_kernel``, from the shape and
before any launch.
"""

import functools
import shutil
import subprocess
import types

import pytest
import torch

from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels
from libpga_tpu_torch.ops.breed_expr import mutate_from_expression

F32, BF16 = torch.float32, torch.bfloat16

# (rows, genes, gene dtype, B) -> (C, rows a block, chunks a block at
# parity 1, shared bytes a block), or None where no cluster holds a deme.
PINNED = [
    ((1 << 20, 100, F32, 2), (2, 256, 32, 213_120)),
    ((1 << 20, 100, F32, 4), (2, 256, 32, 213_120)),
    ((1 << 20, 100, BF16, 2), (1, 512, 32, 213_120)),
    ((131_072, 100, F32, 2), (2, 256, 32, 213_120)),
    ((1 << 20, 128, F32, 2), (4, 128, 16, 139_392)),
    ((65_536, 300, F32, 2), (8, 64, 8, 161_920)),
    ((65_536, 33, BF16, 2), (1, 512, 32, 75_904)),
    ((131_072, 1024, F32, 2), None),
]

# The B = 1 cells of PGA.run (rows, genes, gene dtype) -> (layout, C, rows a
# block, chunks a block at parity 1, shared bytes a block): OneMax at
# 1,048,576x100 (float32 and bf16), the reference driver's padded riffle, the
# Rastrigin islands' 16,384x30 and a shard of 1,048,576x128 at S = 4.
PINNED_B1 = [
    ((1 << 20, 100, F32), ("pingpong", 2, 256, 32, 213_120)),
    ((40_000, 100, F32), ("riffle", 1, 256, 32, 209_024)),
    ((1 << 20, 100, BF16), ("pingpong", 1, 512, 32, 213_120)),
    ((16_384, 30, F32), ("pingpong", 1, 512, 64, 131_200)),
    ((262_144, 128, F32), ("pingpong", 4, 128, 16, 139_392)),
]

# The plan's edges, (K, L, gene bytes, q) -> C (None: no cluster): where
# one block stops holding a deme, where eight stop, and shapes whose rows
# or slots the kernel could not map by shifts.
EDGES = [
    ((512, 54, 4, 8), 1), ((512, 55, 4, 8), 2),
    ((512, 435, 4, 8), 8), ((512, 436, 4, 8), None),
    ((256, 887, 4, 8), 8), ((256, 888, 4, 8), None),
    ((512, 871, 2, 16), 8), ((512, 872, 2, 16), None),
    ((128, 100, 4, 32), 1), ((128, 1024, 2, 64), None),
    ((384, 16, 4, 8), None), ((512, 16, 4, 12), None),  # K / C, q: powers of two only
]


def _plan(P, L, dtype, B):
    geom = fs.resolve_geometry(P, L, gene_dtype=dtype, subblock=B)
    assert geom.layout == "pingpong" and geom.B == B
    return geom, kernels.pipelined_plan(geom.K, geom.L, 2 if dtype == BF16 else 4, geom.q)


@pytest.mark.parametrize("shape, want", PINNED, ids=lambda v: str(v))
def test_plan_at_the_card_shapes(shape, want):
    geom, plan = _plan(*shape)
    if want is None:
        assert plan is None
        return
    C, rows, chunks, smem = want
    assert (plan.C, plan.rows, plan.chunks, plan.smem) == want
    gene_bytes = 2 if shape[2] == BF16 else 4
    assert plan.staged == rows * geom.L * gene_bytes + 4 * geom.K
    # A run of q rows is 32*L bytes at both gene types: every bulk copy is
    # a multiple of 16 bytes.
    assert (geom.q * geom.L * gene_bytes) % 16 == 0 and plan.rows % geom.q == 0
    assert plan.smem <= kernels.PIPE_SMEM_LIMIT and C * rows == geom.K


@pytest.mark.parametrize("shape, want", PINNED_B1, ids=lambda v: str(v))
def test_plan_at_the_b1_cells(shape, want):
    P, L, dtype = shape
    geom = fs.resolve_geometry(P, L, gene_dtype=dtype)
    assert geom.B == 1
    gene_bytes = 2 if dtype == BF16 else 4
    plan = kernels.pipelined_plan(geom.K, L, gene_bytes, geom.q)
    assert (geom.layout, plan.C, plan.rows, plan.chunks, plan.smem) == want
    assert plan.C * plan.rows == geom.K and kernels.pipelined_holds(geom, dtype)


@pytest.mark.parametrize("args, C", EDGES, ids=lambda v: str(v))
def test_plan_edges(args, C):
    plan = kernels.pipelined_plan(*args)
    assert (plan and plan.C) == C


@pytest.fixture(scope="module")
def header_plan(tmp_path_factory):
    """pipe_plan() of csrc/pipe_plan.cuh, built with the host compiler:
    (K, L, gene bytes, q) -> (C, rows, shared bytes)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("pipe_plan")
    src, exe = out / "plan.cpp", out / "plan"
    src.write_text(
        '#include <cstdio>\n#include <cstdlib>\n#include "pipe_plan.cuh"\n'
        "int main(int argc, char** argv) {\n"
        "  for (int i = 1; i + 3 < argc; i += 4) {\n"
        "    const PipePlan p = pipe_plan(atoi(argv[i]), atoi(argv[i + 1]), atoi(argv[i + 2]),\n"
        "                                 atoi(argv[i + 3]));\n"
        '    printf("%d %d %zu\\n", p.C, p.rows, p.smem);\n'
        "  }\n}\n")
    res = subprocess.run([cxx, "-std=c++17", "-I", str(kernels.CSRC), "-o", str(exe), str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr

    def plan(cases):
        argv = [str(x) for case in cases for x in case]
        res = subprocess.run([str(exe), *argv], capture_output=True, text=True, check=True)
        return [tuple(int(x) for x in line.split()) for line in res.stdout.splitlines()]

    return plan


@pytest.mark.parametrize("gene_bytes, q", [(4, 8), (2, 16)], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [128, 256, 384, 512, 1024])
def test_mirror_agrees_with_the_header(header_plan, K, gene_bytes, q):
    cases = [(K, L, gene_bytes, q) for L in (4, 16, 33, 54, 55, 100, 128, 200, 300, 435, 436,
                                             871, 872, 887, 888, 1024, 3968)]
    for case, got in zip(cases, header_plan(cases), strict=True):
        plan = kernels.pipelined_plan(*case)
        assert got == ((plan.C, plan.rows, plan.smem) if plan else (0, 0, 0)), case


def test_mirror_constants_are_the_headers():
    text = (kernels.CSRC / "pipe_plan.cuh").read_text()
    assert "constexpr int PIPE_MAX_CLUSTER = %d;" % kernels.PIPE_MAX_CLUSTER in text
    assert "constexpr size_t PIPE_SMEM_LIMIT = %d - 1024;" % kernels.SMEM_BLOCK_BYTES in text
    assert "constexpr size_t PIPE_ALIGN = %d;" % kernels.PIPE_ALIGN in text


@pytest.mark.parametrize("shape, pipelined", [
    ((1 << 20, 100, F32, 2), True),
    ((1 << 20, 100, BF16, 2), True),
    ((1 << 20, 128, F32, 2), True),
    ((65_536, 300, F32, 2), True),
    ((131_072, 1024, F32, 2), False),  # K = 256 of 4 KB rows: 1 MB a deme
    ((1 << 20, 100, F32, None), True),  # B = 1: PGA.run's OneMax
    ((40_000, 100, F32, None), True),  # B = 1, the padded riffle
    ((1 << 20, 100, BF16, None), True),
    ((16_384, 30, F32, None), True),  # L % 4 != 0: one gene a lane
    ((262_144, 128, F32, None), True),  # a shard of 4
    ((131_072, 1024, F32, None), False),  # B = 1, riffle K = 256: 1 MB a deme
], ids=lambda v: str(v))
def test_breed_launcher_routes_by_shape(shape, pipelined):
    P, L, dtype, B = shape
    geom = fs.resolve_geometry(P, L, gene_dtype=dtype, subblock=B)
    launch = fs.breed_launcher(geom, dtype, {"mutate": "point"})
    assert launch.func is kernels.deme_breed_cuda and launch.keywords == {"pipelined": pipelined}
    assert kernels.pipelined_holds(geom, dtype) == pipelined


@pytest.mark.parametrize("ablate, pipelined", [
    (("copy_only",), False),
    (("copy_only", "no_rank_sort"), False),
    (("copy_only", "no_mut"), False),  # the copy whatever the stage flags
    (("no_mut",), True),
    (("sel_const", "no_matmul", "no_cross", "no_mut"), True),
], ids=lambda v: str(v))
def test_the_floor_harness_follows_the_route(ablate, pipelined):
    """At B = 1 the floor harness's stage cases take the pipelined kernel
    where a cluster holds the deme, as at B > 1; its copy stays on
    deme_breed_kernel, which alone has one."""
    for P, B in ((40_000, None), (1 << 20, None), (1 << 20, 2)):
        geom = fs.resolve_geometry(P, 100, subblock=B)
        launch = fs.breed_launcher(geom, F32, {"mutate": "point", "ablate": ablate})
        assert launch.keywords == {"pipelined": pipelined}


def test_breed_launcher_keeps_the_hook_kernels():
    geom = fs.resolve_geometry(1 << 20, 100, subblock=2)
    creep = mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05,
                                   sigma=0.1)
    assert fs.breed_launcher(geom, F32, {"mutate": creep}) is kernels.expr_breed_cuda
    assert fs.breed_launcher(geom, F32, {"crossover": "order"}) is kernels.order_breed_cuda


def test_a_deme_no_cluster_holds_launches_deme_breed_kernel_once(monkeypatch):
    """fused_step.deme_breed on CUDA genomes at 131,072x1,024, B = 2 calls
    the deme-breed wrapper once, unpipelined: the shape decides, and no
    launch is tried first."""
    geom = fs.resolve_geometry(131_072, 1024, subblock=2)
    calls = []

    def wrapper(genomes, ranks, g, parity, **kw):
        calls.append(kw["pipelined"])
        return "children", "scores"

    monkeypatch.setattr(kernels, "deme_breed_cuda", wrapper)
    genomes = types.SimpleNamespace(is_cuda=True, dtype=F32)
    got = fs.deme_breed(genomes, None, geom, 1, seed=torch.zeros(1, dtype=torch.int64),
                        mparams=None)
    assert got == ("children", "scores") and calls == [False]
    calls.clear()
    fs.deme_breed(genomes, None, fs.resolve_geometry(1 << 20, 100, subblock=2), 1,
                  seed=torch.zeros(1, dtype=torch.int64), mparams=None)
    assert calls == [True]
    assert isinstance(fs.breed_launcher(geom, F32, {}), functools.partial)
