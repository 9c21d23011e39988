#!/usr/bin/env python3
"""Time ``PGA.run`` of two checkouts of the port on one card, in turns
(A, B, B, A), each in its own process:

    python3 ab_run.py PARENT_DIR [CHANGE_DIR] [--generations-per-launch T] [--tsp | --creep]

CHANGE_DIR defaults to the checkout holding this script. Prints one JSON
line per turn: wall milliseconds per generation of three 200-generation
runs (after a warm-up of 5 generations, or of one launch) and, under
``kernel_ms``, the breed kernel's device milliseconds per launch over 48
more generations under torch.profiler. The workload is OneMax at
1,048,576x100 and 40,000x100; with ``--tsp`` the TSP at 8,192x1,000
(``make_tsp_coords(random_tsp_coords(1000, seed=2), duplicate_mode=
"genes")``, order crossover, swap mutation at 0.5: the order-breed
kernel with the fused tour score); with ``--creep`` OneMax with the
creep mutation expression (``where(r < rate, g + sigma * (2*r2 - 1),
g)``, rate 0.05, sigma 0.1: the expression breed kernel). With
``--generations-per-launch T`` both checkouts run
``PGAConfig(generations_per_launch=T)``, the multi-generation kernel.
Each turn also prints ``digest``, a hash of every shape's final genomes
and scores: from the same seed the runs of two checkouts whose kernels
compute the same function end on the same digest, and the last line
says whether all four turns did.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((1 << 20, 100), (40_000, 100))
TSP_SHAPES = ((8192, 1000),)

CHILD = r"""
import hashlib, json, re, sys, time
sys.path.insert(0, sys.argv[1])
T, tsp, creep = int(sys.argv[2]), sys.argv[3] == "tsp", sys.argv[3] == "creep"
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import libpga_tpu_torch as port
out, kernel_ms, digest = {}, {}, hashlib.sha256()
for P, L in %r if tsp else %r:
    config = port.PGAConfig(generations_per_launch=T) if T > 1 else None
    pga = port.pga_init(seed=1, config=config)
    h = port.pga_create_population(pga, P, L)
    if tsp:
        from libpga_tpu_torch.objectives import make_tsp_coords, random_tsp_coords
        from libpga_tpu_torch.ops.crossover import order_preserving_crossover
        from libpga_tpu_torch.ops.mutate import make_swap_mutate
        port.pga_set_objective_function(
            pga, make_tsp_coords(random_tsp_coords(L, seed=2), duplicate_mode="genes"))
        port.pga_set_crossover_function(pga, order_preserving_crossover)
        port.pga_set_mutate_function(pga, make_swap_mutate(0.5))
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
    out["%%dx%%d" %% (P, L)] = ms
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        port.pga_run(pga, 48)
        torch.cuda.synchronize()
    kernel_ms["%%dx%%d" %% (P, L)] = {
        re.search(r"\w*breed_kernel", e.key).group(): e.self_device_time_total / 1e3 / e.count
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "breed_kernel" in e.key}
    pop = pga.population(h)
    digest.update(pop.genomes.cpu().numpy().tobytes() + pop.scores.cpu().numpy().tobytes())
print(json.dumps({"ms_per_gen": out, "kernel_ms": kernel_ms, "digest": digest.hexdigest()[:16]}))
""" % (TSP_SHAPES, SHAPES)


def main() -> int:
    args = sys.argv[1:]
    per_launch = 1
    workload = "tsp" if "--tsp" in args else "creep" if "--creep" in args else "onemax"
    args = [a for a in args if a not in ("--tsp", "--creep")]
    if "--generations-per-launch" in args:
        at = args.index("--generations-per-launch")
        per_launch = int(args[at + 1])
        del args[at : at + 2]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(args[0]).resolve(),
             "B": Path(args[1]).resolve() if len(args) > 1
             else Path(__file__).resolve().parent}
    digests = []
    for turn in "ABBA":
        res = subprocess.run(
            [sys.executable, "-c", CHILD, str(roots[turn]), str(per_launch), workload],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stderr[-2000:], file=sys.stderr)
            return 1
        line = json.loads(res.stdout)
        digests.append(line["digest"])
        print(json.dumps({"turn": turn, "root": roots[turn].name, "workload": workload,
                          "generations_per_launch": per_launch, **line}), flush=True)
    print(json.dumps({"workload": workload, "generations_per_launch": per_launch,
                      "same_digest": len(set(digests)) == 1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
