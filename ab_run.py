#!/usr/bin/env python3
"""Time ``PGA.run`` of two checkouts of the port on one card, in turns
(A, B, B, A), each in its own process:

    python3 ab_run.py PARENT_DIR [CHANGE_DIR] [--generations-per-launch T] [--subblock B]
                      [--tsp | --order-expr | --onemax-order | --creep | --nk]
                      [--shape PxL] [--bf16]
                      [--rounds N]
    python3 ab_run.py PARENT_DIR [CHANGE_DIR] --gp [--rounds N]
    python3 ab_run.py PARENT_DIR [CHANGE_DIR] --sass [--creep]

CHANGE_DIR defaults to the checkout holding this script. Prints one JSON
line per turn: wall milliseconds per generation of three 200-generation
runs (after a warm-up of 5 generations, or of one launch) and, under
``kernel_ms``, the breed kernel's device milliseconds per launch over 48
more generations under torch.profiler. The workload is OneMax at
1,048,576x100 and 40,000x100; with ``--tsp`` the TSP at 8,192x1,000
(``make_tsp_coords(random_tsp_coords(1000, seed=2), duplicate_mode=
"genes")``, order crossover, swap mutation at 0.5: the order-breed
kernel with the fused tour score); with ``--order-expr`` the order
crossover's expression kernel at its two cells: the tour written as an
expression over ``random_tsp_coords(200, seed=2)`` at 65,536x200 with
swap mutation at 0.5, and the coordinate TSP of ``--tsp`` at 8,192x1,000
with the creep expression (rate 0.05, sigma 0.1) as its mutation (no
``--shape``; at ``--generations-per-launch`` T > 1 the tour alone, on
``expr_multigen_kernel<true>``: the coordinate TSP declines T > 1); with
``--onemax-order`` OneMax at 40,000x100 with order crossover, swap
mutation at 0.5 and elitism 2 (at T > 1 ``multigen_breed_kernel<true>``;
no ``--shape``); with ``--creep`` OneMax with the
creep mutation expression (``where(r < rate, g + sigma * (2*r2 - 1),
g)``, rate 0.05, sigma 0.1: the expression breed kernel); with ``--nk``
the NK landscape (n = 64, k = 3, seed 0) at 4,194,304x64, an expression
objective with builtin crossover and mutation. With
``--generations-per-launch T`` both checkouts run
``PGAConfig(generations_per_launch=T)``, the multi-generation kernel;
with ``--subblock B`` ``PGAConfig(subblock=B)``, the sub-block pipeline's
``deme_pipelined_kernel`` (with ``--creep`` the expression breed on the
B-aware row maps). ``--shape PxL`` (repeatable) runs those shapes in
place of the workload's; ``--bf16`` stores the genomes in bfloat16
(``PGAConfig(gene_dtype=torch.bfloat16)``); ``--rounds N`` runs the
four turns N times over (N A B B A rounds in a row, 2N pairs).
Each turn also prints ``digest``, a hash of every shape's final genomes
and scores: from the same seed the runs of two checkouts whose kernels
compute the same function end on the same digest, and the last line
says whether all four turns did.

With ``--gp`` each turn runs GP symbolic regression of Nguyen-12 at
65,536 programs x 32 tokens x 1,024 samples as ``chip_smoke.py``'s
gp_run sets it up (seed 3, truncation selection, elitism 2), with
``GPConfig.optimize`` on (the evaluator's compacted mode) and off (its
static mode): wall milliseconds per generation over 10 generations after
one, and, under ``kernel_ms``, the evaluator kernel's device
milliseconds per launch over 2 more generations under torch.profiler.
Its ``digest`` hashes each run's final genomes and scores and the scores
of one evaluator call on each of ``chip_smoke.gp_populations``' three
populations in both modes (``chip_smoke.py`` of the checkout under
test). Under ``eval_ms`` it times that evaluator on the well-formed
population (compacted first in its compacted mode) by CUDA events: the
median of 5 windows of 20 launches.

With ``--sass`` it runs no turn: it builds each checkout's production
``csrc/deme_breed.cu`` unit (with ``--creep``: the expression unit of the
creep mutation's hooks, ``csrc/expr_breed.cu`` with the hooks each
checkout generates) and compares ``cuobjdump -sass`` of the two, kernel
by kernel (names with the unit's hash digits masked), and prints which
kernels' code is the same, which differs and which one checkout alone
has.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

SHAPES = ((1 << 20, 100), (40_000, 100))
TSP_SHAPES = ((8192, 1000),)
ORDER_EXPR_SHAPES = ((65_536, 200, "tour"), (8192, 1000, "tsp_creep"))
ONEMAX_ORDER_SHAPES = ((40_000, 100, "onemax_order"),)
NK_SHAPES = ((1 << 22, 64),)

CHILD = r"""
import hashlib, json, re, sys, time
sys.path.insert(0, sys.argv[1])
T, tsp, creep, nk = (int(sys.argv[2]), sys.argv[3] == "tsp", sys.argv[3] == "creep",
                    sys.argv[3] == "nk")
TOUR = ("c = floor(g * L); x = gather(X, c); y = gather(Y, c);"
        " dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
        " -sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))")
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
B = int(sys.argv[4])
shapes = [tuple(x) for x in json.loads(sys.argv[5])]
import torch
bf16 = sys.argv[6] == "bf16"
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import libpga_tpu_torch as port
out, kernel_ms, digest = {}, {}, hashlib.sha256()
for P, L, *case in shapes:
    knobs = dict(generations_per_launch=T) if T > 1 else {}
    if case == ["onemax_order"]:
        knobs["elitism"] = 2
    if B > 1:
        knobs["subblock"] = B
    if bf16:
        knobs["gene_dtype"] = torch.bfloat16
    config = port.PGAConfig(**knobs) if knobs else None
    pga = port.pga_init(seed=1, config=config)
    h = port.pga_create_population(pga, P, L)
    if case:  # the order kernels' cells
        from libpga_tpu_torch.objectives import (from_expression, make_tsp_coords,
                                                 random_tsp_coords)
        from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
        from libpga_tpu_torch.ops.crossover import order_preserving_crossover
        from libpga_tpu_torch.ops.mutate import make_swap_mutate
        xy = random_tsp_coords(L, seed=2)
        if case[0] == "onemax_order":
            port.pga_set_objective_function(pga, "onemax")
            port.pga_set_mutate_function(pga, make_swap_mutate(0.5))
        elif case[0] == "tour":
            port.pga_set_objective_function(pga, from_expression(TOUR, X=xy[:, 0], Y=xy[:, 1]))
            port.pga_set_mutate_function(pga, make_swap_mutate(0.5))
        else:
            port.pga_set_objective_function(pga, make_tsp_coords(xy, duplicate_mode="genes"))
            port.pga_set_mutate_function(pga, mutate_from_expression(CREEP, rate=0.05, sigma=0.1))
        port.pga_set_crossover_function(pga, order_preserving_crossover)
    elif tsp:
        from libpga_tpu_torch.objectives import make_tsp_coords, random_tsp_coords
        from libpga_tpu_torch.ops.crossover import order_preserving_crossover
        from libpga_tpu_torch.ops.mutate import make_swap_mutate
        port.pga_set_objective_function(
            pga, make_tsp_coords(random_tsp_coords(L, seed=2), duplicate_mode="genes"))
        port.pga_set_crossover_function(pga, order_preserving_crossover)
        port.pga_set_mutate_function(pga, make_swap_mutate(0.5))
    elif nk:
        from libpga_tpu_torch.objectives import make_nk_landscape
        port.pga_set_objective_function(pga, make_nk_landscape(64, 3, seed=0))
    else:
        port.pga_set_objective_function(pga, "onemax")
    if creep:
        from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
        port.pga_set_mutate_function(pga, mutate_from_expression(
            "where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05, sigma=0.1))
    port.pga_run(pga, max(5, T))
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        port.pga_run(pga, 200)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / 200)
    out["%dx%d" % (P, L)] = ms
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        port.pga_run(pga, 48)
        torch.cuda.synchronize()
    kernel_ms["%dx%d" % (P, L)] = {
        re.search(r"\w*(breed|pipelined|multigen|order)_kernel", e.key).group():
            e.self_device_time_total / 1e3 / e.count
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and re.search(r"(breed|pipelined|multigen|order)_kernel", e.key)}
    pop = pga.population(h)
    digest.update(pop.genomes.cpu().float().numpy().tobytes() + pop.scores.cpu().numpy().tobytes())
print(json.dumps({"ms_per_gen": out, "kernel_ms": kernel_ms, "digest": digest.hexdigest()[:16]}))
"""

CHILD_GP = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import libpga_tpu_torch as port
from libpga_tpu_torch import gp as gpmod
from libpga_tpu_torch.ops import gp_eval as ge
from chip_smoke import GP_SHAPES, gp_populations, gp_solver, nguyen12
GENS = 10
P, T, B = GP_SHAPES["main"]
X, y = gpmod.make_dataset(nguyen12, n_samples=B, n_vars=2, seed=0)
out, kernel_ms, eval_ms, digest = {}, {}, {}, hashlib.sha256()
for mode, optimize in (("opt", True), ("static", False)):
    gp = gpmod.GPConfig(max_nodes=T, n_vars=2, optimize=optimize)
    pga, h = gp_solver(port, gpmod, gp, P, X, y, seed=3, selection="truncation", elitism=2)
    pga.run(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pga.run(GENS)
    torch.cuda.synchronize()
    out[mode] = 1e3 * (time.perf_counter() - t0) / GENS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pga.run(2)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "gp_eval_kernel" in e.key]
    kernel_ms[mode] = sum(e.self_device_time_total for e in ev) / 1e3 / max(1, sum(e.count for e in ev))
    pop = pga.population(h)
    digest.update(pop.genomes.cpu().numpy().tobytes() + pop.scores.cpu().numpy().tobytes())
    port.pga_deinit(pga)
    gen = torch.Generator(device="cuda").manual_seed(P + T)
    for name, pgp, g in gp_populations(gpmod, P, T, gen, torch.device("cuda")):
        fn = ge.make_gp_eval(pgp, X, y, optimize=optimize)
        digest.update(fn(g).cpu().numpy().tobytes())
        if name == "well_formed":
            arg = gpmod.optimize_for_eval(g, pgp) if optimize else g
            fn(arg)
            windows = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fn(arg)
                end.record()
                torch.cuda.synchronize()
                windows.append(start.elapsed_time(end) / 20)
            eval_ms[mode] = sorted(windows)[2]
print(json.dumps({"ms_per_gen": out, "kernel_ms": kernel_ms, "eval_ms": eval_ms,
                  "digest": digest.hexdigest()[:16]}))
"""


BUILD_UNIT = r"""
import sys
sys.path.insert(0, sys.argv[1])
from libpga_tpu_torch.ops import kernels
if sys.argv[2] == "creep":
    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
    creep = mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)", rate=0.05,
                                   sigma=0.1)
    print(kernels.build_expr(expr_cuda.program_for(None, creep, None)))
else:
    print(kernels.build("deme_breed"))
"""


def sass_by_kernel(root: Path, unit: str = "deme_breed") -> dict:
    """{kernel name: its SASS} of ``root``'s production deme_breed.cu unit
    (``unit`` "creep": its expression unit of the creep mutation)."""
    lib = subprocess.run([sys.executable, "-c", BUILD_UNIT, str(root), unit], capture_output=True,
                         text=True, check=True, timeout=900).stdout.strip().splitlines()[-1]
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    # The unit's hashes in internal names: the anonymous namespace's, the
    # one after the file name, which moves with the unit's first external
    # definition, and a generated unit's file name's own.
    mask = re.compile(r"(?<=_)[0-9a-f]{8}(?=_)|(?<=_cu_)[0-9a-f]{8}|(?<=_)[0-9a-f]{16}(?=_cu)")
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        # cuobjdump pads its comment column to the unit's longest line: compare
        # each line's words, not its spacing.
        lines = mask.sub("H", body.split(".........")[0]).splitlines()
        out[mask.sub("H", name.strip())] = "\n".join(" ".join(x.split()) for x in lines)
    return out


def main() -> int:
    args = sys.argv[1:]
    if "--sass" in args:
        unit = "creep" if "--creep" in args else "deme_breed"
        dirs = [a for a in args if a not in ("--sass", "--creep")]
        parent = sass_by_kernel(Path(dirs[0]).resolve(), unit)
        change = sass_by_kernel(Path(dirs[1]).resolve() if len(dirs) > 1
                                else Path(__file__).resolve().parent, unit)
        both = sorted(parent.keys() & change.keys())
        differ = {}
        for k in both:
            a, b = parent[k].splitlines(), change[k].splitlines()
            pairs = [(x, y) for x, y in zip(a, b) if x != y]
            if pairs or len(a) != len(b):
                differ[k] = {"lines": [len(a), len(b)], "differing": len(pairs),
                             "first": pairs[:4]}
        print(json.dumps({"sass": {
            "unit": unit, "same": [k for k in both if k not in differ], "differ": differ,
            "parent_only": sorted(parent.keys() - change.keys()),
            "change_only": sorted(change.keys() - parent.keys())}}), flush=True)
        return 0
    knobs = {"--generations-per-launch": 1, "--subblock": 1, "--rounds": 1}
    workload = ("tsp" if "--tsp" in args else "order_expr" if "--order-expr" in args
                else "onemax_order" if "--onemax-order" in args
                else "creep" if "--creep" in args else "nk" if "--nk" in args
                else "gp" if "--gp" in args else "onemax")
    dtype = "bf16" if "--bf16" in args else "f32"
    args = [a for a in args if a not in (
        "--tsp", "--order-expr", "--onemax-order", "--creep", "--nk", "--gp", "--bf16")]
    for flag in knobs:
        if flag in args:
            at = args.index(flag)
            knobs[flag] = int(args[at + 1])
            del args[at : at + 2]
    shapes = []
    while "--shape" in args:
        at = args.index("--shape")
        shapes.append([int(x) for x in args[at + 1].split("x")])
        del args[at : at + 2]
    if workload == "order_expr":
        # The coordinate TSP breeds one generation a launch at any T.
        shapes = ORDER_EXPR_SHAPES[:1] if knobs["--generations-per-launch"] > 1 else ORDER_EXPR_SHAPES
    elif workload == "onemax_order":
        shapes = ONEMAX_ORDER_SHAPES
    shapes = shapes or {"tsp": TSP_SHAPES, "nk": NK_SHAPES}.get(workload, SHAPES)
    per_launch, subblock = knobs["--generations-per-launch"], knobs["--subblock"]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(args[0]).resolve(),
             "B": Path(args[1]).resolve() if len(args) > 1
             else Path(__file__).resolve().parent}
    digests = []
    for turn in "ABBA" * knobs["--rounds"]:
        cmd = ([sys.executable, "-c", CHILD_GP, str(roots[turn])] if workload == "gp" else
               [sys.executable, "-c", CHILD, str(roots[turn]), str(per_launch), workload,
                str(subblock), json.dumps(shapes), dtype])
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stderr[-2000:], file=sys.stderr)
            return 1
        line = json.loads(res.stdout)
        digests.append(line["digest"])
        print(json.dumps({"turn": turn, "root": roots[turn].name, "workload": workload,
                          "generations_per_launch": per_launch, "subblock": subblock,
                          "genes": dtype, **line}), flush=True)
    print(json.dumps({"workload": workload, "generations_per_launch": per_launch,
                      "subblock": subblock, "genes": dtype,
                      "same_digest": len(set(digests)) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
