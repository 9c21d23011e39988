"""The cluster plan of the expression multigen kernel and its route, on the
CPU.

``expr_multigen_kernel<false>`` (csrc/expr_breed.cu) breeds on the
builtin multigen kernel's cluster schedule (a group held in a
thread-block cluster's shared memory for the launch, csrc/mg_plan.cuh)
with the eight-lane expression child, and keeps beside the group the
objective's materialised rows of L floats for every child in flight
(``expr_mg_plan`` in csrc/expr_plan.cuh). Python reads the plan only from
a built unit (``kernels.expr_multigen_plan``, ctypes). Here each unit's
hooks are built with the host compiler together with expr_plan.cuh, so
the plan read is the header's own: pinned at every expression cell bred
at T = 8 (PERF.md section 4), and at the shapes that stay on the one-block
schedule (the knapsack's L = 6, order crossover, a group no cluster
holds, an objective row beside the creep cell's group). Then the route:
the factories hand every expression launch to ``expr_multigen_cuda``,
which takes the cluster schedule from the shape alone
(``kernels.expr_multigen_holds``).
"""

import ctypes
import shutil
import subprocess
import types

import pytest
import torch

from libpga_tpu_torch import objectives as po
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import expr_cuda
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels

F32, BF16 = torch.float32, torch.bfloat16
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
ONE_POINT = "where(i < floor(q * L), p1, p2)"


def _programs():
    """name -> (crossover, mutate, objective) of each hook set."""
    creep = pbx.mutate_from_expression(CREEP, rate=0.05, sigma=0.1)
    return {
        "nk": (None, None, po.make_nk_landscape(64, 3, seed=0)),
        "trap": (None, None, po.make_deceptive_trap(5)),
        "knapsack": (None, None, po.default_knapsack),
        "creep": (None, creep, po.onemax),
        "one_point": (pbx.crossover_from_expression(ONE_POINT), None, po.onemax),
        "rolled": (None, None, po.from_expression("sum(roll(g, 1) * g)")),
    }


def _ops(name):
    cross, mut, objective = _programs()[name]
    return cross, mut, getattr(objective, "expr_fused", None)


# (hooks, rows, genes, gene dtype, builtin mutate id) -> ((layout, K, D) of
# the T = 8 geometry, and (C, rows a block, keys sorted, rows of L floats a
# child, shared bytes a block)), or None where the one-block schedule
# breeds the group. Islands: one island's rows.
PINNED = [
    (("nk", 1 << 22, 64, F32, 0), ("riffle", 256, 8), (8, 256, 256, 1, 154_240)),
    (("trap", 1 << 20, 60, F32, 0), ("riffle", 512, 4), (8, 256, 512, 1, 150_144)),
    (("trap", 40_000, 60, F32, 0), ("riffle", 256, 1), (1, 256, 256, 1, 145_024)),
    (("trap", 1 << 20, 60, BF16, 0), ("pingpong", 512, 8), (8, 512, 512, 1, 151_424)),
    (("trap", 131_072, 60, F32, 0), ("pingpong", 512, 4), (8, 256, 512, 1, 150_144)),
    (("trap", 131_072, 60, BF16, 0), ("pingpong", 512, 4), (4, 512, 512, 1, 151_424)),
    (("creep", 1 << 20, 100, F32, 0), ("riffle", 512, 4), (8, 256, 512, 0, 216_448)),
    (("creep", 40_000, 100, F32, 0), ("riffle", 256, 1), (1, 256, 256, 0, 211_328)),
    (("creep", 131_072, 100, F32, 0), ("pingpong", 512, 4), (8, 256, 512, 0, 216_448)),
    (("one_point", 1 << 20, 100, F32, 0), ("riffle", 512, 4), (8, 256, 512, 0, 216_448)),
    (("one_point", 40_000, 100, F32, 0), ("riffle", 256, 1), (1, 256, 256, 0, 211_328)),
    # roll(g): a float child is read back from the group's copy, a bf16 one
    # from a float row of its own; a builtin swap re-scores from one too.
    (("rolled", 4096, 64, F32, 0), ("pingpong", 512, 4), (8, 256, 512, 0, 142_720)),
    (("rolled", 4096, 64, BF16, 0), ("pingpong", 512, 4), (4, 512, 512, 1, 160_640)),
    (("trap", 4096, 60, BF16, 2), ("pingpong", 512, 4), (4, 512, 512, 2, 166_784)),
    # The one-block schedule: L % 4 != 0; the creep cell's group with an
    # objective row beside it; 1,024 rows of 1,200 bytes a group.
    (("knapsack", 4096, 6, F32, 0), ("pingpong", 256, 8), None),
    (("trap", 1 << 20, 100, F32, 0), ("riffle", 512, 4), None),
    (("creep", 1 << 20, 300, F32, 0), ("riffle", 512, 2), None),
]


def _geometry(name, P, L, dtype):
    expr = _ops(name)[2]
    return fs.resolve_geometry(P, L, multigen=True, gene_dtype=dtype,
                               const_carrying=bool(getattr(expr, "kernel_rowwise_consts", ())))


@pytest.fixture(scope="module")
def host_units(tmp_path_factory):
    """``{hooks: (program, ctypes library)}``: each program's generated
    hooks with csrc/expr_plan.cuh after them, built with the host compiler
    (the header reads the hooks' macros, as it does in a unit)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("expr_mg_plan")
    bindings = kernels._bindings()
    libs = {}
    for name in _programs():
        program = expr_cuda.program_for(*_ops(name))
        src, lib = out / f"{name}.cpp", out / f"lib{name}.so"
        src.write_text(program.source + '\n#include "expr_plan.cuh"\n')
        res = subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-I", str(kernels.CSRC), "-o",
                              str(lib), str(src)], capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        so = ctypes.CDLL(str(lib))
        for fn, unit in (("expr_multigen_cluster_plan", "expr_breed"),
                         ("multigen_cluster_plan", "deme_breed")):
            getattr(so, fn).argtypes, getattr(so, fn).restype = bindings[unit][fn]
        libs[name] = (program, so)
    return libs


@pytest.fixture
def read_from_host(monkeypatch, host_units):
    """``kernels.expr_multigen_plan`` reading each program's host-built
    unit where it would read the built CUDA unit."""
    by_source = {program.source: so for program, so in host_units.values()}
    monkeypatch.setattr(kernels, "_expr_library",
                        lambda program, ablate=0: by_source[program.source])
    monkeypatch.setattr(kernels, "_expr_plans", {})
    return host_units


@pytest.mark.parametrize("cell, shape, want", PINNED, ids=lambda v: str(v))
def test_plan_at_the_expression_cells(read_from_host, cell, shape, want):
    name, P, L, dtype, mutate = cell
    program, so = read_from_host[name]
    geom = _geometry(name, P, L, dtype)
    assert (geom.layout, geom.K, geom.D) == shape
    plan = kernels.expr_multigen_plan(program, geom, dtype, mutate)
    held = kernels.expr_multigen_holds(program, geom, dtype, mutate)
    if want is None:
        assert plan is None and not held
        return
    assert held and (plan.C, plan.rows, plan.sort, plan.child_rows, plan.smem) == want
    assert plan.smem <= kernels.SMEM_BLOCK_BYTES - 1024 and plan.C * plan.rows == geom.D * geom.K
    # The group's layout is the builtin kernel's (mg_plan.cuh); the children's
    # rows come after it, 64 children at an odd stride, and may take a
    # larger cluster, never a smaller one.
    base = (ctypes.c_longlong * 4)()
    gene_bytes = 2 if dtype == BF16 else 4
    assert so.multigen_cluster_plan(geom.D, geom.K, L, gene_bytes, geom.q, base)
    if plan.child_rows == 0:
        assert (plan.C, plan.rows, plan.sort, plan.smem) == tuple(base)
    else:
        assert plan.C >= base[0]
        extra = -(-64 * (plan.child_rows * L + 1) * 4 // 128) * 128
        if plan.C == base[0]:
            assert plan.smem == base[3] + extra


def test_only_order_crossover_stays_on_one_block_at_a_cluster_shape(read_from_host):
    """Order crossover walks on the one-block schedule whatever the shape."""
    program = read_from_host["creep"][0]
    geom = _geometry("creep", 40_000, 100, F32)
    assert kernels.expr_multigen_holds(program, geom, F32, 0)
    assert not kernels.expr_multigen_holds(program, geom, F32, 0, order=True)


def test_the_child_rows_follow_the_hooks_and_the_gene_type(read_from_host):
    """A float child is read back from the group's copy: only the
    objective's materialised rows are extra. A bf16 child the objective
    reads back (roll(g), or a builtin swap re-scored) keeps a float row."""
    geom = _geometry("trap", 4096, 64, F32)
    rows = {(name, dt, mut): kernels.expr_multigen_plan(read_from_host[name][0], geom, dt,
                                                        kernels.MUTATE_IDS[mut]).child_rows
            for name in ("nk", "trap", "rolled", "creep") for dt in (F32, BF16)
            for mut in ("point", "swap")}
    for dt in (F32, BF16):
        assert rows[("creep", dt, "point")] == rows[("creep", dt, "swap")] == 0
    assert rows[("nk", F32, "swap")] == rows[("trap", F32, "swap")] == 1
    assert rows[("nk", BF16, "point")] == 1 and rows[("nk", BF16, "swap")] == 2
    assert rows[("rolled", F32, "point")] == 0 and rows[("rolled", BF16, "swap")] == 1


class _Recorder:
    """A kernel wrapper stand-in: records the genome length, crossover and
    named schedule (None: the wrapper routes from the shape) of each
    launch, and launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, genomes, scores, geom, parity, steps, target, **kw):
        self.calls.append((geom.L, kw.get("crossover"), kw.get("cluster")))
        return "children", "scores"


@pytest.fixture
def recorders(monkeypatch, read_from_host):
    rec = {"builtin": _Recorder(), "expr": _Recorder()}
    monkeypatch.setattr(kernels, "multigen_breed_cuda", rec["builtin"])
    monkeypatch.setattr(kernels, "expr_multigen_cuda", rec["expr"])
    return rec


def _cuda_like(dtype=F32):
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, device="cpu")


@pytest.mark.parametrize("cell, shape, want", PINNED, ids=lambda v: str(v))
def test_make_fused_multigen_routes_by_shape(recorders, cell, shape, want):
    """Each cell's factory hands its launch to ``expr_multigen_cuda`` with no
    schedule named, and that wrapper's route at the factory's geometry is
    the plan's: the cluster schedule exactly where the pinned plan holds."""
    name, P, L, dtype, mutate = cell
    cross, mut, objective = _programs()[name]
    if mutate:
        mut = "swap"
    launch = fs.make_fused_multigen(P, L, objective, crossover=cross or "uniform",
                                    mutate=mut or "point", device="cpu", gene_dtype=dtype)
    got = launch(_cuda_like(dtype), None, 0, 8, None, torch.Generator().manual_seed(0),
                 out="out", work=None)
    assert got == ("children", "scores")
    assert recorders["expr"].calls == [(L, cross or "uniform", None)]
    assert not recorders["builtin"].calls
    program = expr_cuda.program_for(*_ops(name))
    assert kernels.expr_multigen_holds(program, launch.geom, dtype, mutate) == (want is not None)


@pytest.mark.parametrize("L, held", [(100, True), (300, False)])
def test_make_island_multigen_routes_by_shape(recorders, L, held):
    creep = _programs()["creep"][1]
    launch = fs.make_island_multigen(16_384, L, po.onemax, 4, 8, mutate=creep, device="cpu")
    launch(_cuda_like(), None, 0, 8, None, torch.Generator().manual_seed(0), out="out")
    assert recorders["expr"].calls == [(L, "uniform", None)]
    program = expr_cuda.program_for(None, creep, None)
    assert kernels.expr_multigen_holds(program, launch.geom, F32, 0) == held


def test_a_named_schedule_is_launched_as_named(recorders):
    """``cluster=`` in the keywords (tests and chip_smoke.py comparing the
    two schedules) reaches the expression wrapper unchanged."""
    creep = _programs()["creep"][1]
    geom = fs.resolve_geometry(1 << 20, 100, multigen=True)
    for cluster in (False, True, None):
        fs.multigen_breed(_cuda_like(), None, geom, 0, 8, seed=None, mparams=None,
                          mutate=creep, cluster=cluster)
    assert [c[2] for c in recorders["expr"].calls] == [False, True, None]


def test_the_wrapper_refuses_cpu_tensors():
    """The wrapper launches only on CUDA tensors (a named schedule too);
    the plain version runs for CPU tensors through
    fused_step.multigen_breed."""
    creep = _programs()["creep"][1]
    geom = fs.resolve_geometry(4096, 16, multigen=True)
    g = torch.zeros(geom.Pp, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.expr_multigen_cuda(g, torch.zeros(geom.Pp), geom, 0, 2, 0.0, mutate=creep,
                                   mparams=torch.zeros(2), obj_id=1, cluster=True)
