#!/usr/bin/env python3
"""Time ``PGA.run`` of two checkouts of the port on one card, in turns
(A, B, B, A), each in its own process:

    python3 ab_run.py PARENT_DIR [CHANGE_DIR] [--generations-per-launch T] [--tsp]

CHANGE_DIR defaults to the checkout holding this script. Prints one JSON
line per turn: wall milliseconds per generation of three 200-generation
runs (after a warm-up of 5 generations, or of one launch) and, under
``kernel_ms``, the breed kernel's device milliseconds per launch over 48
more generations under torch.profiler. The workload is OneMax at
1,048,576x100 and 40,000x100; with ``--tsp`` the TSP at 8,192x1,000
(``make_tsp_coords(random_tsp_coords(1000, seed=2), duplicate_mode=
"genes")``, order crossover, swap mutation at 0.5: the order-breed
kernel with the fused tour score). With ``--generations-per-launch T``
both checkouts run ``PGAConfig(generations_per_launch=T)``, the
multi-generation kernel.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((1 << 20, 100), (40_000, 100))
TSP_SHAPES = ((8192, 1000),)

CHILD = r"""
import json, re, sys, time
sys.path.insert(0, sys.argv[1])
T, tsp = int(sys.argv[2]), sys.argv[3] == "tsp"
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import libpga_tpu_torch as port
out, kernel_ms = {}, {}
for P, L in %r if tsp else %r:
    config = port.PGAConfig(generations_per_launch=T) if T > 1 else None
    pga = port.pga_init(seed=1, config=config)
    port.pga_create_population(pga, P, L)
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
print(json.dumps({"ms_per_gen": out, "kernel_ms": kernel_ms}))
""" % (TSP_SHAPES, SHAPES)


def main() -> int:
    args = sys.argv[1:]
    per_launch = 1
    workload = "tsp" if "--tsp" in args else "onemax"
    args = [a for a in args if a != "--tsp"]
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
    for turn in "ABBA":
        res = subprocess.run(
            [sys.executable, "-c", CHILD, str(roots[turn]), str(per_launch), workload],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stderr[-2000:], file=sys.stderr)
            return 1
        print(json.dumps({"turn": turn, "root": roots[turn].name, "workload": workload,
                          "generations_per_launch": per_launch,
                          **json.loads(res.stdout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
