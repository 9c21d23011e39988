"""The multi-generation kernel's cluster plan and its route, on the CPU.

``multigen_breed_kernel<false>`` (csrc/deme_breed.cu) keeps a group of D
demes in the shared memory of a cluster of C blocks for a whole launch;
csrc/mg_plan.cuh picks C and lays out a block, and Python reads it only
through the built unit's ``multigen_cluster_plan``. Here the header is
built with the host compiler and pinned at every multi-generation geometry
the card runs and at the plan's edges; ``kernels.multigen_cluster_plan``
is held against it through ctypes; and the factories are shown to hand
every builtin launch to ``multigen_breed_cuda`` to route from the shape,
which sends a group no cluster holds, and every order case, to the
one-block schedule before any launch, and every expression launch to
``expr_multigen_cuda``, which routes from the shape in the same way
(its own plan: tests/test_torch_expr_multigen_plan.py).
"""

import ctypes
import shutil
import subprocess
import types

import pytest
import torch

from libpga_tpu_torch import objectives as po
from libpga_tpu_torch.ops import expr_cuda
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels
from libpga_tpu_torch.ops.breed_expr import mutate_from_expression

F32, BF16 = torch.float32, torch.bfloat16
CREEP = mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05, sigma=0.1)

def _hooks(name):
    """(factory keywords, objective) of a multigen cell's hook set."""
    if name == "creep":
        return {"mutate": CREEP}, po.onemax
    objective = {"onemax": po.onemax, "nk": po.make_nk_landscape(64, 3, seed=0),
                 "trap": po.make_deceptive_trap(5), "knapsack": po.default_knapsack}[name]
    return {}, objective


def _geometry(P, L, dtype, hooks):
    _, objective = _hooks(hooks)
    expr = getattr(objective, "expr_fused", None)
    return fs.resolve_geometry(P, L, multigen=True, gene_dtype=dtype,
                               const_carrying=bool(getattr(expr, "kernel_rowwise_consts", ())))


# The multi-generation cells of PERF.md section 4 (islands: one island's
# rows), (P, L, dtype, hooks) -> (layout, K, D) and the plan's (C, rows a
# block, keys it sorts, shared bytes a block) at that geometry. For the
# expression cells (nk, trap, creep, knapsack) this is the builtin kernel's
# plan at their geometry; the expression kernel's adds its children's
# objective rows (tests/test_torch_expr_multigen_plan.py).
PINNED = [
    ((1 << 20, 100, F32, "onemax"), ("riffle", 512, 4), (8, 256, 512, 216_448)),
    ((40_000, 100, F32, "onemax"), ("riffle", 256, 1), (1, 256, 256, 211_328)),
    ((524_288, 100, F32, "onemax"), ("pingpong", 512, 4), (8, 256, 512, 216_448)),
    ((131_072, 100, F32, "onemax"), ("pingpong", 512, 4), (8, 256, 512, 216_448)),
    ((1 << 20, 100, BF16, "onemax"), ("pingpong", 512, 8), (8, 512, 512, 217_728)),
    ((40_000, 100, BF16, "onemax"), ("riffle", 256, 1), (1, 256, 256, 108_928)),
    ((4_194_304, 64, F32, "nk"), ("riffle", 256, 8), (8, 256, 256, 137_600)),
    ((524_288, 64, F32, "nk"), ("pingpong", 256, 8), (8, 256, 256, 137_600)),
    ((1 << 20, 60, F32, "trap"), ("riffle", 512, 4), (8, 256, 512, 134_528)),
    ((40_000, 60, F32, "trap"), ("riffle", 256, 1), (1, 256, 256, 129_408)),
    ((1 << 20, 60, BF16, "trap"), ("pingpong", 512, 8), (8, 512, 512, 135_808)),
    ((131_072, 60, F32, "trap"), ("pingpong", 512, 4), (8, 256, 512, 134_528)),
    ((131_072, 60, BF16, "trap"), ("pingpong", 512, 4), (4, 512, 512, 135_808)),
    ((1 << 20, 100, F32, "creep"), ("riffle", 512, 4), (8, 256, 512, 216_448)),
    ((40_000, 100, F32, "creep"), ("riffle", 256, 1), (1, 256, 256, 211_328)),
    ((4_096, 6, F32, "knapsack"), ("pingpong", 256, 8), (1, 2048, 2048, 149_632)),
]

# The plan's edges, (D, K, L, gene bytes, q) -> C (0: no cluster holds the
# group): where one block stops holding a group, where eight stop, a genome
# length that is no multiple of 4, bf16.
EDGES = [
    ((4, 512, 10, 4, 8), 1), ((4, 512, 11, 4, 8), 2),
    ((4, 512, 53, 4, 8), 4), ((4, 512, 54, 4, 8), 8),
    ((4, 512, 107, 4, 8), 8), ((4, 512, 108, 4, 8), 0),
    ((4, 512, 101, 4, 8), 8), ((4, 512, 99, 4, 8), 8),
    ((1, 256, 109, 4, 8), 1), ((1, 256, 110, 4, 8), 2),
    ((1, 256, 882, 4, 8), 8), ((1, 256, 883, 4, 8), 0),
    ((8, 512, 7, 2, 16), 1), ((8, 512, 8, 2, 16), 2),
    ((8, 512, 106, 2, 16), 8), ((8, 512, 107, 2, 16), 0),
    ((8, 512, 101, 2, 16), 8), ((4, 512, 100, 2, 16), 4),
    ((16, 1024, 4, 4, 8), 8),  # 16,384 rows, 2,048 a block
    ((3, 512, 100, 4, 8), 0), ((4, 384, 100, 4, 8), 0),  # W, K: powers of two only
]


@pytest.fixture(scope="module")
def header(tmp_path_factory):
    """``(plan(cases) -> [(C, rows, sort, smem)], path of the header built
    as a library, which exports multigen_cluster_plan)``: mg_plan() of
    csrc/mg_plan.cuh, built with the host compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("mg_plan")
    src, exe, lib = out / "plan.cpp", out / "plan", out / "libplan.so"
    src.write_text(
        '#include <cstdio>\n#include <cstdlib>\n#include "mg_plan.cuh"\n'
        "int main(int argc, char** argv) {\n"
        "  for (int i = 1; i + 4 < argc; i += 5) {\n"
        "    const MgPlan p = mg_plan(atoi(argv[i]), atoi(argv[i + 1]), atoi(argv[i + 2]),\n"
        "                             atoi(argv[i + 3]), atoi(argv[i + 4]));\n"
        '    printf("%d %d %d %zu\\n", p.C, p.rows, p.sort, p.smem);\n'
        "  }\n}\n")
    header = kernels.CSRC / "mg_plan.cuh"
    for cmd in ([cxx, "-std=c++17", "-Wall", "-I", str(kernels.CSRC), "-o", str(exe), str(src)],
                [cxx, "-std=c++17", "-x", "c++", "-shared", "-fPIC", "-o", str(lib), str(header)]):
        res = subprocess.run(cmd, capture_output=True, text=True)
        assert res.returncode == 0, res.stderr

    def plan(cases):
        argv = [str(x) for case in cases for x in case]
        res = subprocess.run([str(exe), *argv], capture_output=True, text=True, check=True)
        return [tuple(int(x) for x in line.split()) for line in res.stdout.splitlines()]

    return plan, lib


@pytest.fixture
def built_query(header, monkeypatch):
    """``kernels._library("deme_breed")`` answered by the header's
    query, built with the host compiler and bound as the unit binds it."""
    _, path = header
    lib = ctypes.CDLL(str(path))
    argtypes, restype = kernels._bindings()["deme_breed"]["multigen_cluster_plan"]
    lib.multigen_cluster_plan.argtypes = argtypes
    lib.multigen_cluster_plan.restype = restype
    monkeypatch.setattr(kernels, "_library", lambda name, path=None: lib)
    kernels._multigen_plan.cache_clear()
    yield
    kernels._multigen_plan.cache_clear()


@pytest.mark.parametrize("cell, shape, want", PINNED, ids=lambda v: str(v))
def test_plan_at_the_card_shapes(header, cell, shape, want):
    P, L, dtype, hooks = cell
    geom = _geometry(P, L, dtype, hooks)
    assert (geom.layout, geom.K, geom.D) == shape
    gene_bytes = 2 if dtype == BF16 else 4
    (got,) = header[0]([(geom.D, geom.K, L, gene_bytes, geom.q)])
    assert got == want
    C, R, N, smem = got
    # Every block holds R slots of the group, a whole number of q-row runs,
    # and the demes it breeds; both copies fit beside the rest.
    assert C * R == geom.D * geom.K and R % geom.q == 0 and N == max(R, geom.K)
    assert 2 * R * L * gene_bytes < smem <= kernels.SMEM_BLOCK_BYTES - 1024


@pytest.mark.parametrize("args, C", EDGES, ids=lambda v: str(v))
def test_plan_edges(header, args, C):
    (got,) = header[0]([args])
    assert got[0] == C
    if C:
        D, K = args[0], args[1]
        assert got[1] * C == D * K and got[2] == max(got[1], K)


def test_plan_constants_are_the_kernels():
    text = (kernels.CSRC / "mg_plan.cuh").read_text()
    assert "constexpr size_t MG_SMEM_LIMIT = %d - 1024;" % kernels.SMEM_BLOCK_BYTES in text


@pytest.mark.parametrize("cell, shape, want", PINNED[:8], ids=lambda v: str(v))
def test_multigen_plan_reads_the_built_query(built_query, cell, shape, want):
    P, L, dtype, hooks = cell
    plan = kernels.multigen_cluster_plan(_geometry(P, L, dtype, hooks), dtype)
    assert (plan.C, plan.rows, plan.sort, plan.smem) == want


def test_the_route_holds_order_and_long_genomes_on_one_block(built_query):
    geom = fs.resolve_geometry(1 << 20, 300, multigen=True)  # 1,024 rows of 1,200 bytes
    assert kernels.multigen_cluster_plan(geom, F32) is None
    order = fs.resolve_geometry(40_000, 100, multigen=True, crossover="order")
    assert kernels.multigen_cluster_plan(order, F32) is not None  # the shape alone fits
    assert kernels.multigen_cluster_plan(order, F32, crossover="order") is None


class _Recorder:
    """A kernel wrapper stand-in: records the genome length, crossover,
    named schedule (None: the wrapper routes from the shape) and work
    buffers of each launch, and launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, genomes, scores, geom, parity, steps, target, **kw):
        self.calls.append((geom.L, kw.get("crossover"), kw.get("cluster"), kw.get("work")))
        return "children", "scores"


@pytest.fixture
def fake_plan(monkeypatch):
    """A fake plan of each kernel (a cluster holds every group of at most
    100 genes) and recorders in place of both multigen wrappers."""
    def plan(D, K, L, gene_bytes, q):
        return kernels.MultigenPlan(8, 256, 512, 216_448) if L <= 100 else None

    def expr_plan(program, geom, gene_dtype, mutate_id, ablate=0):
        return kernels.ExprMultigenPlan(8, 256, 512, 0, 216_448) if geom.L <= 100 else None

    monkeypatch.setattr(kernels, "_multigen_plan", plan)
    monkeypatch.setattr(kernels, "expr_multigen_plan", expr_plan)
    rec = {"builtin": _Recorder(), "expr": _Recorder()}
    monkeypatch.setattr(kernels, "multigen_breed_cuda", rec["builtin"])
    monkeypatch.setattr(kernels, "expr_multigen_cuda", rec["expr"])
    return rec


def _cuda_like(dtype=F32):
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, device="cpu")


@pytest.mark.parametrize("L, crossover, mutate, cluster", [
    (100, "uniform", "point", True),
    (128, "uniform", "point", False),  # no cluster holds the group
    (100, "order", "swap", False),     # order crossover walks on one block
    (100, "uniform", CREEP, True),     # the expression kernel's eight-lane cluster schedule
    (128, "uniform", CREEP, False),
], ids=["f32", "long", "order", "creep", "creep-long"])
def test_make_fused_multigen_routes_by_shape(fake_plan, L, crossover, mutate, cluster):
    launch = fs.make_fused_multigen(40_000, L, po.onemax, crossover=crossover, mutate=mutate,
                                    device="cpu")
    gen = torch.Generator().manual_seed(0)
    got = launch(_cuda_like(), None, 0, 8, None, gen, out="out", work=None)
    assert got == ("children", "scores")
    expr = callable(mutate)
    assert fake_plan["expr" if expr else "builtin"].calls == [(L, crossover, None, None)]
    assert not fake_plan["builtin" if expr else "expr"].calls
    if expr:  # the expression wrapper's route at this shape
        program = expr_cuda.program_for(None, mutate, None)
        assert kernels.expr_multigen_holds(program, launch.geom, F32, 0) == cluster
    else:  # the builtin wrapper's route at this shape
        assert (kernels.multigen_cluster_plan(launch.geom, F32, crossover) is not None) == cluster


@pytest.mark.parametrize("L, crossover, cluster", [
    (100, "uniform", True), (128, "uniform", False), (100, "order", False),
])
def test_make_island_multigen_routes_by_shape(fake_plan, L, crossover, cluster):
    launch = fs.make_island_multigen(16_384, L, po.onemax, 4, 8, crossover=crossover,
                                     mutate="swap", device="cpu")
    gen = torch.Generator().manual_seed(0)
    launch(_cuda_like(), None, 0, 8, None, gen, out="out")
    assert fake_plan["builtin"].calls == [(L, crossover, None, None)]
    assert (kernels.multigen_cluster_plan(launch.geom, F32, crossover) is not None) == cluster


def test_a_named_schedule_is_launched_as_named(fake_plan):
    """``cluster=`` in the keywords (tests and chip_smoke.py comparing the
    two schedules) reaches the wrapper unchanged, and no plan is read."""
    geom = fs.resolve_geometry(1 << 20, 100, multigen=True)
    for cluster in (False, True):
        fs.multigen_breed(_cuda_like(), None, geom, 0, 8, seed=None, mparams=None,
                          cluster=cluster)
    assert [c[2] for c in fake_plan["builtin"].calls] == [False, True]


@pytest.mark.parametrize("cluster, steps, n_work", [(True, 8, 0), (False, 8, 2), (False, 2, 1)])
def test_work_buffers_only_on_the_one_block_schedule(cluster, steps, n_work):
    genomes = torch.zeros(2, 256, 16)
    out, work = kernels._multigen_buffers(genomes, None, None, steps, cluster)
    assert out.shape == genomes.shape
    made = [w for w in work if w is not None]
    assert len(made) == n_work
    assert all(w.shape == genomes.shape and w.data_ptr() != genomes.data_ptr() for w in made)
