"""The order walk's shared-memory layouts, on the CPU.

``order_breed_kernel`` (csrc/deme_breed.cu) and ``expr_order_kernel``
(csrc/expr_breed.cu) walk a block's children in step on shared-memory
tiles; csrc/order_plan.cuh lays out a block, and ``kernels.order_plan``
mirrors it. Here the header is built with the host compiler and held
against the mirror at every order shape the card runs and at the edges of
the deme geometry; the layout is shown to fit a block at every shape the
deme path admits with order crossover, and ``kernels.expr_warps`` to
refuse, from the shape and before any launch, the one kind of shape it
does not hold (expression objectives whose rows leave no room).

The multi-generation kernels' order case (``multigen_group<true>``) walks
a group's children on the same tiles, in the layout of the header's
``mg_order_plan``, which Python reads only through the built units
(``kernels.multigen_order_plan``): here it is built with the host compiler
and pinned at the cells, shown to hold every group the launchers admit
(K 32-1,024, L up to 2,304) without warp rows and with the expression
kernel's, to walk a group of 1,024 rows in more than one pass, and to
refuse, from the shape, a group where not even one warp's rows fit.
"""

import shutil
import subprocess

import pytest

from libpga_tpu_torch import objectives as po
from libpga_tpu_torch.objectives import make_tsp_coords, random_tsp_coords
from libpga_tpu_torch.ops import expr_cuda
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels

TOUR = ("c = floor(g * L);"
        "x = gather(X, c); y = gather(Y, c);"
        "dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
        "-sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))")


def _tour_rows(L):
    """The objective rows of the tour expression at genome length L."""
    c = random_tsp_coords(L, seed=2)
    tour = po.from_expression(TOUR, X=c[:, 0], Y=c[:, 1])
    return expr_cuda.program_for(None, None, tour).obj_rows


def _warp_bytes(L, obj_rows, warps=kernels.ORDER_THREADS // 32):
    """expr_order_kernel's rows: each of its warps' child and objective rows."""
    return warps * (1 + obj_rows) * L * 4


# The order shapes of chip_smoke.py and the card tests: (case, rows, genes,
# cities, seen bitmasks, warp rows: None for order_breed_kernel, else the
# objective rows of expr_order_kernel's hooks, "tour" for the tour
# expression's) -> the block's shared bytes.
SHAPES = [
    ("tsp main", 8192, 1000, 1000, True, None, 46_400),
    ("tsp reference", 1000, 100, 0, False, None, 24_064),
    ("tsp islands", 8192, 200, 200, True, None, 28_224),
    ("onemax order", 40_000, 100, 0, False, None, 23_040),
    ("card C > L", 256, 130, 200, True, None, 25_616),
    ("card C < L", 1000, 100, 60, True, None, 25_568),
    ("tour", 65_536, 200, 0, False, "tour", 23_808),
    ("tour islands", 16_384, 200, 0, False, "tour", 23_808),
    ("coordinate tsp + creep", 8192, 1000, 1000, False, 0, 38_208),
    ("coordinate tsp islands", 8192, 1000, 1000, False, 0, 38_208),
]


@pytest.fixture(scope="module")
def header(tmp_path_factory):
    """``plan(cases) -> [(xy, vis, seen, ror, srow, smem)]``:
    order_plan() of csrc/order_plan.cuh, built with the host compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("order_plan")
    src, exe = out / "plan.cpp", out / "plan"
    src.write_text(
        '#include <cstdio>\n#include <cstdlib>\n#include "order_plan.cuh"\n'
        "int main(int argc, char** argv) {\n"
        "  for (int i = 1; i + 4 < argc; i += 5) {\n"
        "    const OrderPlan p = order_plan(atoi(argv[i]), atoi(argv[i + 1]), atoi(argv[i + 2]),\n"
        "                                   atoi(argv[i + 3]) != 0, (size_t)atol(argv[i + 4]));\n"
        '    printf("%zu %zu %zu %zu %zu %zu\\n", p.xy, p.vis, p.seen, p.ror, p.srow,\n'
        "           p.smem);\n"
        "  }\n}\n")
    res = subprocess.run([cxx, "-std=c++17", "-Wall", "-I", str(kernels.CSRC), "-o", str(exe),
                          str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr

    def plan(cases):
        argv = [str(int(x)) for case in cases for x in case]
        res = subprocess.run([str(exe), *argv], capture_output=True, text=True, check=True)
        return [tuple(int(x) for x in line.split()) for line in res.stdout.splitlines()]

    return plan


def _plan_args(P, L, cities, seen, rows):
    """(K, L, staged cities, seen, warp bytes) of a shape, K as PGA.run picks it."""
    geom = fs.resolve_geometry(P, L, crossover="order", fused=bool(cities or rows is not None),
                               const_carrying=rows == "tour")
    warp = 0
    if rows is not None:
        rows = _tour_rows(L) if rows == "tour" else rows
        warps = kernels.expr_warps(geom.K, L, rows, order=True, cities=cities)
        warp = _warp_bytes(L, rows, warps)
    return geom.K, L, min(cities, L), seen, warp


@pytest.mark.parametrize("shape", SHAPES, ids=lambda v: v[0])
def test_plan_at_the_card_shapes(header, shape):
    _, P, L, cities, seen, rows, want = shape
    args = _plan_args(P, L, cities, seen, rows)
    (got,) = header([args])
    plan = kernels.order_plan(*args)
    assert got == (plan.xy, plan.vis, plan.seen, plan.ror, plan.srow, plan.smem)
    assert plan.smem == want
    assert kernels.order_holds(*args)
    # The two tile buffers come first, the warps' rows in their bytes where
    # they fit, every region 16-byte aligned.
    tiles = kernels.ORDER_STAGES * kernels.ORDER_ROWS * kernels.ORDER_STRIDE * 4
    assert plan.xy == max(tiles, -(-args[4] // 16) * 16)
    assert all(x % 16 == 0 for x in (plan.xy, plan.vis, plan.seen, plan.ror, plan.srow))


# Where the deme geometry stops admitting order crossover (the walk's scratch
# in JAX's VMEM model): the longest genome at the least deme, the shortest,
# a genome that is no multiple of 4 or of the tile.
EDGES = [(128, 2304, 2304, True, 0), (1024, 4, 4, True, 0), (128, 2303, 1, True, 0),
         (512, 33, 33, True, 0), (256, 2304, 2304, False, _warp_bytes(2304, 9))]


@pytest.mark.parametrize("args", EDGES, ids=lambda v: str(v[:2]))
def test_plan_edges_against_the_header(header, args):
    (got,) = header([args])
    plan = kernels.order_plan(*args)
    assert got == (plan.xy, plan.vis, plan.seen, plan.ror, plan.srow, plan.smem)
    assert got[-1] <= kernels.ORDER_SMEM_LIMIT


def test_every_admitted_order_shape_fits_a_block():
    """Without warp rows the layout fits at every genome length the deme
    path admits with order crossover, at the deme size it picks, the TSP
    score's coordinates and bitmasks included; one gene more is no longer
    admitted."""
    for P in (1024, 8192, 1 << 20):
        for L in (4, 100, 1000, 1537, 2048, 2304):
            geom = fs.resolve_geometry(P, L, crossover="order", fused=True)
            assert geom is not None and geom.K % kernels.ORDER_THREADS == 0
            assert kernels.order_holds(geom.K, L, L, True)
            assert kernels.order_holds(1024, L, L, True)  # the largest deme
        assert fs.resolve_geometry(P, 2305, crossover="order", fused=True) is None


def test_expr_warps_routes_from_the_plan():
    """expr_order_kernel's warps, from the shape before any launch: four
    (the walk's two and two more for the hooks) wherever the plan holds
    their rows, else the walk's two, else a ValueError."""
    for L, rows in ((200, 0), (1000, 0), (2000, 1), (200, _tour_rows(200))):
        assert kernels.order_holds(128, L, L, warp_bytes=_warp_bytes(L, rows, 4))
        assert kernels.expr_warps(128, L, rows, order=True, cities=L) == 4
    assert not kernels.order_holds(128, 2304, 2304, warp_bytes=_warp_bytes(2304, 9, 4))
    assert kernels.order_holds(128, 2304, 2304, warp_bytes=_warp_bytes(2304, 9))
    assert kernels.expr_warps(128, 2304, 9, order=True, cities=2304) == 2
    assert not kernels.order_holds(128, 2304, 2304, warp_bytes=_warp_bytes(2304, 10))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.expr_warps(128, 2304, 10, order=True, cities=2304)


def _one_thread_smem(K, L, cities, warp_bytes):
    """The shared memory of the one-thread order kernels that the tiles
    replaced: row_of_rank, the visited bitmasks, the coordinates and the
    warps' rows, end to end."""
    return (K + -(-L // 32) * kernels.ORDER_THREADS) * 4 + min(cities, L) * 8 + warp_bytes


@pytest.mark.parametrize("L", [4, 33, 100, 130, 200, 640, 1000, 1537, 2048, 2304])
def test_the_tiles_hold_every_shape_the_one_thread_kernels_held(L):
    """No shape moves off the order kernels: at every deme size the deme
    path admits at this genome length and every number of objective rows
    where the one-thread kernels' shared memory fit a block, the tiles'
    layout fits too (the TSP score's seen bitmasks included)."""
    Ks = {fs.resolve_geometry(1 << 20, L, crossover="order", deme_size=k, fused=True).K
          for k in (64, 128, 256, 512, 1024)}
    for K in Ks:
        for rows in range(0, 24):
            warp = _warp_bytes(L, rows)
            if _one_thread_smem(K, L, L, warp) <= kernels.ORDER_SMEM_LIMIT:
                assert kernels.order_holds(K, L, L, warp_bytes=warp), (K, L, rows)
        assert kernels.order_holds(K, L, L, seen=True)


def test_plan_constants_are_the_kernels():
    text = (kernels.CSRC / "order_plan.cuh").read_text()
    for line in (f"constexpr int ORDER_THREADS = {kernels.ORDER_THREADS};",
                 f"constexpr int ORDER_TILE = {kernels.ORDER_TILE};",
                 "constexpr int ORDER_STRIDE = ORDER_TILE + 4;",
                 "constexpr int ORDER_ROWS = 2 * ORDER_THREADS;",
                 f"constexpr int ORDER_STAGES = {kernels.ORDER_STAGES};",
                 f"constexpr size_t ORDER_SMEM_LIMIT = {kernels.SMEM_BLOCK_BYTES} - 1024;"):
        assert line in text
    assert kernels.ORDER_STRIDE == kernels.ORDER_TILE + 4
    assert kernels.ORDER_ROWS == 2 * kernels.ORDER_THREADS


def test_tsp_coordinates_beyond_the_genome_are_not_staged():
    """A decode in [0, L) reaches only the first L cities: C > L stages L."""
    tsp = make_tsp_coords(random_tsp_coords(200, seed=2), duplicate_mode="genes")
    assert tsp.coords.shape[0] == 200
    small, large = kernels.order_plan(256, 130, 130, True), kernels.order_plan(256, 130, 200, True)
    assert small == large


# ------------------------------------------- the multi-generation walk

MG_THREADS = kernels.EXPR_MULTIGEN_MAX_WARPS * 32  # a block of the order case


def _mg_base(W):
    """multigen_group's arrays before the walk's layout (mg_rows_bytes)."""
    return -(-W * kernels.MULTIGEN_ROW_BYTES // 16) * 16


@pytest.fixture(scope="module")
def walk_plan(tmp_path_factory):
    """``plan(cases) -> [(P, warps, ring, vis, srow, smem)]`` for cases
    (W, L, warp bytes): mg_order_plan() of csrc/order_plan.cuh as the
    kernels call it (mg_walk_plan: after multigen_group's arrays, in a
    block of MG_THREADS), built with the host compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("mg_order_plan")
    src, exe = out / "walk.cpp", out / "walk"
    src.write_text(
        '#include <cstdio>\n#include <cstdlib>\n#include "order_plan.cuh"\n'
        "int main(int argc, char** argv) {\n"
        "  for (int i = 1; i + 3 < argc; i += 4) {\n"
        "    const MgOrderPlan p = mg_order_plan(atoi(argv[i]), atoi(argv[i + 1]),\n"
        "                                        (size_t)atol(argv[i + 2]), %d,\n"
        "                                        (size_t)atol(argv[i + 3]));\n"
        '    printf("%%d %%d %%zu %%zu %%zu %%zu\\n", p.P, p.warps, p.ring, p.vis, p.srow,\n'
        "           p.smem);\n"
        "  }\n}\n" % MG_THREADS)
    res = subprocess.run([cxx, "-std=c++17", "-Wall", "-I", str(kernels.CSRC), "-o", str(exe),
                          str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr

    def plan(cases):
        argv = [str(int(x)) for W, L, warp in cases for x in (W, L, _mg_base(W), warp)]
        res = subprocess.run([str(exe), *argv], capture_output=True, text=True, check=True)
        return [tuple(int(x) for x in line.split()) for line in res.stdout.splitlines()]

    return plan


def _walk_rows(L, obj_rows):
    """One warp's rows in expr_multigen_kernel: its child and objective rows."""
    return (1 + obj_rows) * L * 4


def _check_walk(plan, W, L, warp):
    """The layout's rules: P a multiple of 64, as many as cover the group
    where that fits, else the most that fit; the ring first (the warps' rows
    in its bytes), every region 16-byte aligned, the whole within a block;
    as many warps as fit."""
    P, warps, ring, vis, srow, smem = plan
    words = -(-L // 32)
    tiles = kernels.ORDER_STAGES * 2 * P * kernels.ORDER_STRIDE * 4
    assert P % 64 == 0 and 64 <= P <= min(-(-W // 64) * 64, MG_THREADS)
    assert ring == _mg_base(W) and all(x % 16 == 0 for x in (ring, vis, srow, smem))
    assert vis - ring == max(tiles, -(-warps * warp // 16) * 16)
    assert srow - vis == -(-words * P * 4 // 16) * 16 and smem - srow == -(-12 * P // 16) * 16
    assert smem <= kernels.ORDER_SMEM_LIMIT
    assert 1 <= warps <= 32 and (warps == 32 or warp == 0 or
                                 smem - (vis - ring) + max(tiles, (warps + 1) * warp)
                                 > kernels.ORDER_SMEM_LIMIT)


# (case, W, L, warp rows: None for multigen_breed_kernel<true>, "tour" for
# the tour expression's) -> (P, warps, smem)
WALK_CELLS = [
    ("tour 65,536x200 and its islands", 256, 200, "tour", (256, 32, 96_512)),
    ("onemax 40,000x100 order + swap", 256, 100, None, (256, 32, 93_440)),
    ("two passes", 1024, 200, None, (576, 32, 224_768)),
    ("four passes", 1024, 2304, None, (320, 32, 215_808)),
]


@pytest.mark.parametrize("cell", WALK_CELLS, ids=lambda v: v[0])
def test_walk_plan_at_the_cells(walk_plan, cell):
    _, W, L, rows, want = cell
    warp = 0 if rows is None else _walk_rows(L, _tour_rows(L))
    (got,) = walk_plan([(W, L, warp)])
    _check_walk(got, W, L, warp)
    assert (got[0], got[1], got[5]) == want


@pytest.mark.parametrize("W", [32, 64, 128, 256, 512, 1024])
def test_walk_plan_holds_every_group_the_launchers_admit(walk_plan, W):
    """Every group of K rows (D = 1) and L <= 2,304 genes: without warp
    rows (the builtin kernel, every warp breeding), and with up to 19
    objective rows a warp (the expression kernel, one warp at least)."""
    Ls = (4, 37, 100, 200, 500, 1000, 1537, 2048, 2304)
    cases = [(W, L, _walk_rows(L, rows) if rows >= 0 else 0)
             for L in Ls for rows in (-1, 0, 3, 9, 19)]
    for case, got in zip(cases, walk_plan(cases)):
        _check_walk(got, *case)
        assert case[2] or got[1] == 32
        if W <= 512 and case[1] <= 500:  # every admitted cell walks its group in one pass
            assert got[0] >= W


def test_walk_plan_refuses_a_group_no_layout_holds(walk_plan):
    """One warp's rows that do not fit beside the least pass: refused (P =
    0), which the wrappers turn into a ValueError before the launch."""
    cases = [(W, 2304, _walk_rows(2304, 22)) for W in (32, 256, 1024)]
    assert [got[0] for got in walk_plan(cases)] == [0, 0, 0]
    assert walk_plan([(0, 100, 0), (256, 0, 0)]) == [(0, 0, 0, 0, 0, 0)] * 2


def test_walk_plan_is_the_kernels():
    """The kernels and launchers read mg_order_plan as this file builds it:
    after multigen_group's 17 bytes a row, in a block of MG_THREADS."""
    core = (kernels.CSRC / "breed_core.cuh").read_text()
    for line in ("constexpr int MG_THREADS = %d;" % MG_THREADS,
                 "constexpr int MG_ROW_BYTES = 8 + 4 + 4 + 1;",
                 "return ((size_t)W * MG_ROW_BYTES + 15) & ~(size_t)15;",
                 "return mg_order_plan(W, L, mg_rows_bytes(W), MG_THREADS, warp_bytes);"):
        assert line in core
    assert kernels.MULTIGEN_ROW_BYTES == 17
    assert "constexpr int MG_WALK_GRAIN = 64;" in (kernels.CSRC / "order_plan.cuh").read_text()
