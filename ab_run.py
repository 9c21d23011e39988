#!/usr/bin/env python3
"""Time ``PGA.run`` OneMax of two checkouts of the port on one card, in
turns (A, B, B, A), each in its own process:

    python3 ab_run.py PARENT_DIR [CHANGE_DIR]

CHANGE_DIR defaults to the checkout holding this script. Prints one JSON
line per turn: wall milliseconds per generation of three 200-generation
runs (after a 5-generation warm-up) at 1,048,576x100 and 40,000x100.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((1 << 20, 100), (40_000, 100))

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import libpga_tpu_torch as port
out = {}
for P, L in %r:
    pga = port.pga_init(seed=1)
    port.pga_create_population(pga, P, L)
    port.pga_set_objective_function(pga, "onemax")
    port.pga_run(pga, 5)
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        port.pga_run(pga, 200)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / 200)
    out["%%dx%%d" %% (P, L)] = ms
print(json.dumps(out))
""" % (SHAPES,)


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(sys.argv[1]).resolve(),
             "B": Path(sys.argv[2]).resolve() if len(sys.argv) > 2
             else Path(__file__).resolve().parent}
    for turn in "ABBA":
        res = subprocess.run([sys.executable, "-c", CHILD, str(roots[turn])],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stderr[-2000:], file=sys.stderr)
            return 1
        print(json.dumps({"turn": turn, "root": roots[turn].name,
                          "ms_per_gen": json.loads(res.stdout)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
