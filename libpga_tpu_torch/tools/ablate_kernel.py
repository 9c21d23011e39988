"""Stage ablation of the port's breed kernels on one CUDA card.

Usage: python -m libpga_tpu_torch.tools.ablate_kernel [f32|bf16] [K]
           [--pop 1048576] [--len 100] [--rounds 3]
           [--hooks builtin|creep|trap|nk|tour|tsp|order] [--steps T]
           [--subblock B] [--combo FLAG,FLAG ...]

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

``--hooks`` breeds another hook set through the same flags, on the
geometry ``PGA.run`` gives it: ``creep`` (OneMax with the creep mutation
expression, ``expr_breed_kernel``), ``trap`` (the trap(5) objective
expression), ``nk`` (the NK landscape of ``examples/nk_landscape.py``,
n = L, k = 3, seed 0), ``tour`` (the tour expression over
``random_tsp_coords(L, seed=2)`` with order crossover and swap,
``expr_order_kernel``), ``tsp``
(the coordinate TSP scored gene-major with order crossover and swap,
``order_breed_kernel``) and ``order`` (OneMax with order crossover and
swap). Every variant is then scored (an objective hook always runs, as in
JAX): ``full``, each stage flag alone, ``floor`` (the four stages off)
and ``copy`` (the builtin copy at the hooks' geometry, each row handed
its score). With ``--steps T`` above 1 the variants are the
multi-generation kernel's at T steps a launch (``expr_multigen_kernel``,
``multigen_breed_kernel<true>`` for ``order``): ``full``, ``no_freeze``,
``no_rank_cube``, each stage flag alone and ``floor``; the times are per
generation.

``--subblock B`` breeds every one-generation variant on ping-pong with B
sub-blocks a group (``PGAConfig(subblock=B)``'s geometry, the unscored
variants included): the builtin hooks through
``deme_pipelined_kernel``'s cases, an expression hook through
``expr_breed_kernel``'s on the B-aware row maps (the copy stays the
riffle's). Each ``--combo`` adds a variant of that set of flags (any
combination JAX's harness takes, e.g. ``sel_const,no_cross``), scored.

Timed as ``ablate_floor`` times (interleaved rounds of a two-length
subtraction by CUDA events, medians). Needs a CUDA card.
"""

from __future__ import annotations

import argparse

import torch

from libpga_tpu_torch.tools.ablate_floor import (
    COPY,
    FLOOR_ABLATE,
    GENE_DTYPES,
    TSWEEP_ABLATE,
    build_tsweep_variant,
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
HOOK_SETS = ("builtin", "creep", "trap", "nk", "tour", "tsp", "order")
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
TOUR = ("c = floor(g * L);"
        "x = gather(X, c); y = gather(Y, c);"
        "dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
        "-sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))")


def hook_kinds(hooks: str, L: int) -> dict:
    """The factory keywords of a hook set at genome length ``L``:
    ``objective``, ``crossover``, ``mutate`` and ``mparams``."""
    from libpga_tpu_torch import objectives as po
    from libpga_tpu_torch.ops.breed_expr import mutate_from_expression

    kw = dict(objective=po.onemax, crossover="uniform", mutate="point", mparams=(0.01, 0.0))
    if hooks == "creep":
        kw.update(mutate=mutate_from_expression(CREEP, rate=0.05, sigma=0.1), mparams=(0.05, 0.1))
    elif hooks == "trap":
        kw.update(objective=po.make_deceptive_trap(5))
    elif hooks == "nk":
        kw.update(objective=po.make_nk_landscape(L, 3, seed=0))
    elif hooks in ("tour", "tsp", "order"):
        kw.update(crossover="order", mutate="swap", mparams=(0.5, 0.0))
        c = po.random_tsp_coords(L, seed=2)
        if hooks == "tour":
            kw.update(objective=po.from_expression(TOUR, X=c[:, 0], Y=c[:, 1]))
        elif hooks == "tsp":
            kw.update(objective=po.make_tsp_coords(c, duplicate_mode="genes"))
    elif hooks != "builtin":
        raise ValueError(f"unknown hook set {hooks!r}; one of {HOOK_SETS}")
    return kw


def variants(hooks: str, steps: int = 1, combos=()) -> list:
    """(label, ablate, scored) of every variant timed: ``STAGES`` for the
    builtin hooks at one generation a launch; else each of them scored
    (an objective hook always runs, as in JAX) but ``no_eval``, and the
    copy at one generation a launch, or no_freeze and no_rank_cube after
    ``full`` at several; then one scored variant a flag set of
    ``combos``, labelled by its flags joined with "+"."""
    extra = [("+".join(flags), tuple(flags), True) for flags in combos]
    if hooks == "builtin" and steps == 1:
        return STAGES + extra
    scored = [(label, ablate, True) for label, ablate, _ in STAGES if label != "no_eval"]
    if steps == 1:
        return scored + [("copy", COPY, True)] + extra
    return scored[:1] + [(flag, (flag,), True) for flag in TSWEEP_ABLATE] + scored[1:] + extra


def build_runners(hooks, dtype, K, pop, L, steps=1, device="cuda", subblock=None,
                  combos=()) -> dict:
    """``{label: run}`` of every variant of ``variants(hooks, steps,
    combos)``: ``ablate_floor``'s runners, one generation a launch (the
    builtin hooks on the riffle, a hook set on the geometry ``PGA.run``
    gives it; at ``subblock`` B both on ``PGA.run``'s geometry at that
    depth) or the multi-generation kernel at ``steps``."""
    kinds = None if hooks == "builtin" and steps == 1 else hook_kinds(hooks, L)
    runners = {}
    for label, ablate, scored in variants(hooks, steps, combos):
        if steps > 1:
            runners[label] = build_tsweep_variant(dtype, K, pop, L, steps, ablate=ablate,
                                                  device=device, kinds=kinds)
        else:
            # An unscored breed takes the riffle unless a layout is named;
            # a copy is a riffle instrument at any depth.
            layout = "riffle" if kinds is None else None
            if subblock is not None:
                layout = "riffle" if "copy_only" in ablate else "pingpong"
            runners[label] = build_variant(label, dtype, K, pop, L, ablate=ablate, fused=scored,
                                           layout=layout, device=device, kinds=kinds,
                                           subblock=subblock)
    return runners


def main(argv=None) -> dict:
    """Time every stage variant; print each median and its difference to
    ``full``; return ``{variant: median ms/gen}``."""
    ap = argparse.ArgumentParser(prog="python -m libpga_tpu_torch.tools.ablate_kernel")
    ap.add_argument("dtype", nargs="?", default="f32", choices=sorted(GENE_DTYPES))
    ap.add_argument("k", nargs="?", type=int, default=512)
    ap.add_argument("--pop", type=int, default=1 << 20)
    ap.add_argument("--len", type=int, default=100, dest="length")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--hooks", default="builtin", choices=HOOK_SETS)
    ap.add_argument("--steps", type=int, default=1, help="generations a launch (multigen)")
    ap.add_argument("--subblock", type=int, default=None,
                    help="ping-pong sub-block depth of the one-generation variants")
    ap.add_argument("--combo", action="append", default=[],
                    help="one more variant: a comma-separated set of flags")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage costs are a card's quantity: run this where CUDA is available")
    dtype = GENE_DTYPES[args.dtype]
    lo, hi = (30, 90) if args.steps == 1 else (10, 30)
    combos = [tuple(c.split(",")) for c in args.combo]
    runners = build_runners(args.hooks, dtype, args.k, args.pop, args.length, args.steps,
                            subblock=args.subblock, combos=combos)
    for run in runners.values():
        run(3)
    med = measure_interleaved(runners, args.rounds, lo=lo, hi=hi)
    base = med["full"]
    tag = f"{args.dtype} {args.hooks} K={args.k} T={args.steps}"
    for label, run in runners.items():
        delta = "" if label == "full" else f"  (stage ~ {base - med[label]:+.4f} ms)"
        print(f"{tag} B={run.geom.B} {label:12s} {med[label]:8.4f} ms/gen{delta}", flush=True)
    return dict(med)


if __name__ == "__main__":
    main()
