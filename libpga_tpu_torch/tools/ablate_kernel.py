"""Stage ablation of the port's one-generation breed kernel on one CUDA card.

Usage: python -m libpga_tpu_torch.tools.ablate_kernel [f32|bf16] [K]
           [--pop 1048576] [--len 100] [--rounds 3]

The port's counterpart of ``tools/ablate_kernel.py``: the generation of
``PGA.run`` (rank sort + ``deme_breed_kernel``) with the kernel's stages
removed one at a time (``make_fused_breed(ablate=...)``), so each stage's
cost falls out by subtraction. Every variant is on the riffle row map, so
the differences share one layout:

  full       the production kernel, scoring in the kernel
  no_eval    unscored                          -> the score's cost
  no_mut     mutation off                      -> mutation's cost
  no_cross   crossover off (no bits drawn)     -> crossover's cost
  sel_const  no selection draws: p1 = p2 = slot k's row -> selection's cost
  no_matmul  no rank-space gather: p1 = p2 = slot k's row (draws made)
  floor      all of the above off              -> memory, blocks, ranks

Timed as ``ablate_floor`` times (interleaved rounds of a two-length
subtraction by CUDA events, medians). Needs a CUDA card.
"""

from __future__ import annotations

import argparse

import torch

from libpga_tpu_torch.tools.ablate_floor import (
    FLOOR_ABLATE,
    GENE_DTYPES,
    build_variant,
    measure_interleaved,
)

STAGES = [
    ("full", (), True),
    ("no_eval", (), False),
    ("no_mut", ("no_mut",), True),
    ("no_cross", ("no_cross",), True),
    ("sel_const", ("sel_const",), True),
    ("no_matmul", ("no_matmul",), True),
    ("floor", FLOOR_ABLATE, False),
]


def main(argv=None) -> dict:
    """Time every stage variant; print each median and its difference to
    ``full``; return ``{variant: median ms/gen}``."""
    ap = argparse.ArgumentParser(prog="python -m libpga_tpu_torch.tools.ablate_kernel")
    ap.add_argument("dtype", nargs="?", default="f32", choices=sorted(GENE_DTYPES))
    ap.add_argument("k", nargs="?", type=int, default=512)
    ap.add_argument("--pop", type=int, default=1 << 20)
    ap.add_argument("--len", type=int, default=100, dest="length")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage costs are a card's quantity: run this where CUDA is available")
    dtype = GENE_DTYPES[args.dtype]
    runners = {
        label: build_variant(label, dtype, args.k, args.pop, args.length, ablate=ablate,
                             fused=fused, layout="riffle")
        for label, ablate, fused in STAGES
    }
    for run in runners.values():
        run(3)
    med = measure_interleaved(runners, args.rounds)
    base = med["full"]
    for label in runners:
        delta = "" if label == "full" else f"  (stage ~ {base - med[label]:+.4f} ms)"
        print(f"{args.dtype} K={args.k} {label:10s} {med[label]:8.4f} ms/gen{delta}", flush=True)
    return dict(med)


if __name__ == "__main__":
    main()
