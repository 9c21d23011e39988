"""The launch plan of the expression breed's pipelined kernel and its route,
on the CPU.

``expr_pipelined_kernel`` (csrc/expr_breed.cu) breeds on
``deme_pipelined_kernel``'s schedule with, beside the staged deme, rows of
L floats for every child in flight (csrc/expr_plan.cuh over
csrc/pipe_plan.cuh). Python reads the plan only from a built unit
(``kernels.expr_pipelined_plan``, ctypes). Here each unit's hooks are
built with the host compiler together with expr_plan.cuh, so the plan
read is the header's own: pinned at every expression cell of PERF.md
section 4, and at the shapes that stay on ``expr_breed_kernel`` (the
knapsack's L = 6; a deme no cluster holds). Then the route:
``fused_step.breed_launcher`` hands every expression breed to
``kernels.expr_breed_cuda``, which picks the pipelined kernel from the
shape alone (``kernels.expr_pipelined_holds``), and never for order
crossover.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from libpga_tpu_torch import objectives as po
from libpga_tpu_torch.ops import breed_expr as pbx
from libpga_tpu_torch.ops import expr_cuda
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels

F32, BF16 = torch.float32, torch.bfloat16
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"


def _programs():
    creep = pbx.mutate_from_expression(CREEP, rate=0.05, sigma=0.1)
    return {
        "nk": (None, None, po.make_nk_landscape(64, 3, seed=0).expr_fused),
        "trap": (None, None, po.make_deceptive_trap(5).expr_fused),
        "knapsack": (None, None, po.default_knapsack.expr_fused),
        "creep": (None, creep, None),
        "one_point": (pbx.crossover_from_expression("where(i < floor(q * L), p1, p2)"), None, None),
        "arithmetic": (pbx.crossover_from_expression("r * p1 + (1 - r) * p2"), None, None),
        "rolled": (None, None, po.from_expression("sum(roll(g, 1) * g)")),
    }


# (hooks, rows, genes, gene dtype, B, constant-carrying, builtin mutate id)
# -> (C, parent rows a block, rows of L floats a child, shared bytes a
# block), or None where expr_breed_kernel breeds the shape.
PINNED = [
    (("nk", 1 << 22, 64, F32, None, True, 0), (1, 256, 1, 151_936)),
    (("nk", 524_288, 64, F32, None, True, 0), (1, 256, 1, 151_936)),  # an island of 8
    (("trap", 1 << 20, 60, F32, None, False, 0), (2, 256, 1, 146_816)),
    (("trap", 1 << 20, 60, BF16, None, False, 0), (1, 512, 1, 146_816)),
    (("trap", 131_072, 60, F32, None, False, 0), (2, 256, 1, 146_816)),
    (("one_point", 1 << 20, 100, F32, None, False, 0), (2, 256, 0, 213_120)),
    (("one_point", 1 << 20, 100, BF16, None, False, 0), (1, 512, 0, 213_120)),
    (("arithmetic", 1 << 20, 100, F32, None, False, 0), (2, 256, 0, 213_120)),
    (("creep", 1 << 20, 100, F32, None, False, 0), (2, 256, 0, 213_120)),
    (("creep", 131_072, 100, F32, None, False, 0), (2, 256, 0, 213_120)),
    (("creep", 1 << 20, 100, F32, 2, False, 0), (2, 256, 0, 213_120)),
    (("creep", 262_144, 128, F32, None, False, 0), (4, 128, 0, 139_392)),  # a shard of 4
    (("nk", 4096, 64, F32, None, True, 2), (1, 256, 2, 168_320)),  # swap re-scores: a child row
    (("rolled", 4096, 64, F32, None, False, 0), (2, 256, 1, 156_032)),  # roll(g): a child row
    (("knapsack", 4096, 6, F32, None, True, 0), None),  # L % 4 != 0
    (("trap", 131_072, 1024, F32, None, False, 0), None),  # no cluster holds the deme
]


@pytest.fixture(scope="module")
def host_units(tmp_path_factory):
    """``{hooks: ctypes library}``: each program's generated hooks with
    csrc/expr_plan.cuh after them, built with the host compiler (the
    header reads the hooks' macros, as it does at the end of a unit)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("expr_plan")
    libs = {}
    for name, ops in _programs().items():
        program = expr_cuda.program_for(*ops)
        src, lib = out / f"{name}.cpp", out / f"lib{name}.so"
        src.write_text(program.source + '\n#include "expr_plan.cuh"\n')
        res = subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-I", str(kernels.CSRC), "-o",
                              str(lib), str(src)], capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        so = ctypes.CDLL(str(lib))
        so.expr_pipelined_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        so.expr_pipelined_plan.restype = ctypes.c_int
        libs[name] = (program, so)
    return libs


@pytest.fixture
def read_from_host(monkeypatch, host_units):
    """``kernels.expr_pipelined_plan`` reading each program's host-built
    unit where it would read the built CUDA unit."""
    by_source = {program.source: so for program, so in host_units.values()}
    monkeypatch.setattr(kernels, "_expr_library", lambda program, ablate=0: by_source[program.source])
    monkeypatch.setattr(kernels, "_expr_plans", {})
    return host_units


def _geom(P, L, dtype, B, const):
    return fs.resolve_geometry(P, L, gene_dtype=dtype, subblock=B, const_carrying=const)


@pytest.mark.parametrize("cell, want", PINNED, ids=lambda v: str(v))
def test_plan_at_the_expression_cells(read_from_host, cell, want):
    name, P, L, dtype, B, const, mutate = cell
    program = read_from_host[name][0]
    geom = _geom(P, L, dtype, B, const)
    plan = kernels.expr_pipelined_plan(program, geom, dtype, mutate)
    if want is None:
        assert plan is None
        assert not kernels.expr_pipelined_holds(program, geom, dtype, mutate)
        return
    assert (plan.C, plan.rows, plan.child_rows, plan.smem) == want
    assert plan.smem <= kernels.PIPE_SMEM_LIMIT
    assert kernels.expr_pipelined_holds(program, geom, dtype, mutate)
    # Without the children's rows the layout is B8's (kernels.pipelined_plan).
    gene_bytes = 2 if dtype == BF16 else 4
    base = kernels.pipelined_plan(geom.K, L, gene_bytes, geom.q)
    if plan.child_rows == 0:
        assert (plan.C, plan.rows, plan.smem) == (base.C, base.rows, base.smem)
    else:  # the children's rows may take a larger cluster, never a smaller one
        assert plan.C >= base.C and plan.rows == geom.K // plan.C


def test_the_child_row_follows_the_hooks(read_from_host):
    """A child keeps its own row where the objective reads it back or a
    builtin swap mutation re-scores it, then the objective's materialised
    rows; a builtin objective keeps none whatever the mutation."""
    geom = _geom(4096, 64, F32, None, False)
    rows = {name: {mut: kernels.expr_pipelined_plan(read_from_host[name][0], geom, F32,
                                                    kernels.MUTATE_IDS[mut]).child_rows
                   for mut in ("point", "gaussian", "swap")}
            for name in ("nk", "trap", "rolled", "creep", "one_point")}
    assert rows["nk"] == rows["trap"] == {"point": 1, "gaussian": 1, "swap": 2}
    assert rows["rolled"] == {"point": 1, "gaussian": 1, "swap": 1}  # its row serves both
    assert rows["creep"] == rows["one_point"] == {"point": 0, "gaussian": 0, "swap": 0}


def test_breed_launcher_hands_expressions_to_expr_breed_cuda():
    geom = fs.resolve_geometry(1 << 20, 100)
    creep = pbx.mutate_from_expression(CREEP, rate=0.05, sigma=0.1)
    for kw in ({"mutate": creep}, {"crossover": pbx.crossover_from_expression("r * p1 + (1 - r) * p2")},
               {"objective": po.make_deceptive_trap(5).expr_fused}):
        assert fs.breed_launcher(geom, F32, kw) is kernels.expr_breed_cuda
    assert fs.breed_launcher(geom, F32, {"crossover": "order"}) is kernels.order_breed_cuda


class _FakeLibrary:
    """A unit whose plan holds every shape with C = 2 (records calls)."""

    def __init__(self):
        self.calls = []

    def expr_pipelined_plan(self, K, L, gene_bytes, q, mutate, out):
        self.calls.append((K, L, gene_bytes, q, mutate))
        out[0], out[1], out[2], out[3] = 2, K // 2, 0, 1000
        return 2


def test_the_route_on_a_fake_plan(monkeypatch):
    """The choice is the plan's, from the shape alone: the plan's C
    decides, order crossover never takes the pipelined kernel, and the
    shape and the builtin mutate id are what the unit is asked."""
    fake = _FakeLibrary()
    monkeypatch.setattr(kernels, "_expr_library", lambda program, ablate=0: fake)
    monkeypatch.setattr(kernels, "_expr_plans", {})
    program = expr_cuda.program_for(None, None, po.make_deceptive_trap(5).expr_fused)
    geom = fs.resolve_geometry(1 << 20, 60)
    assert kernels.expr_pipelined_holds(program, geom, F32, kernels.MUTATE_IDS["swap"])
    assert not kernels.expr_pipelined_holds(program, geom, F32, 0, order=True)
    assert fake.calls == [(geom.K, 60, 4, geom.q, 2)]
    kernels.expr_pipelined_holds(program, geom, F32, kernels.MUTATE_IDS["swap"])
    assert len(fake.calls) == 1  # read once a shape
    monkeypatch.setattr(fake, "expr_pipelined_plan", lambda *a: 0)
    monkeypatch.setattr(kernels, "_expr_plans", {})
    assert not kernels.expr_pipelined_holds(program, geom, F32, 0)


@pytest.mark.parametrize("cell", [c for c, _ in PINNED], ids=str)
def test_the_route_at_each_cell(read_from_host, cell):
    """Every expression cell of PERF.md section 4 takes the pipelined
    kernel, as a single population, an island launch or a shard launch of
    the same rows; the knapsack and a deme no cluster holds stay on
    expr_breed_kernel; order crossover always does."""
    name, P, L, dtype, B, const, mutate = cell
    program = read_from_host[name][0]
    geom = _geom(P, L, dtype, B, const)
    held = kernels.expr_pipelined_holds(program, geom, dtype, mutate)
    assert held == (L % 4 == 0 and L <= 512)
    assert not kernels.expr_pipelined_holds(program, geom, dtype, mutate, order=True)
