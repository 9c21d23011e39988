"""Floor attribution of the port's one-generation breed on one CUDA card.

Usage: python -m libpga_tpu_torch.tools.ablate_floor [f32|bf16] [--k 512]
           [--d 1] [--pop 1048576] [--len 100] [--rounds 5] [--dsweep]
           [--tsweep] [--subblock-b 2] [--json PATH]

The port's counterpart of ``tools/ablate_floor.py``. A generation of
``PGA.run`` is a rank sort (torch, outside the kernel) and one launch of
``deme_breed_kernel`` (``csrc/deme_breed.cu``). This tool times the
production generation beside the kernel's ablated cases (the
``ablate=`` of ``ops/fused_step.make_fused_breed``) and partitions the
"floor" (every breeding stage off) into named components:

  floor            rank sort + the kernel with sel_const, no_matmul,
                   no_cross and no_mut, unscored: the quantity partitioned
  copy_riffle      the copy case (copy_only + no_rank_sort), riffle row
                   map: device-memory reads and writes, the blocks and the
                   riffle's strided writes, nothing else
  copy_contig      the same copy with the contiguous row map (no_riffle):
                   the riffle stride's cost by difference
  copy_alias       the contiguous copy in place (alias_io): the
                   output buffer's cost by difference
  copy_riffle_score  the copy with the handed scores stored: the score
                   stores' cost by difference (part of full, not floor)
  rank_sort        ``fused_step.compute_ranks`` and its tie words alone, on
                   the floor's cohorts (the riffle's)
  rank_sort_full   the same on the production generation's cohorts
                   (ping-pong where ``full`` breeds ping-pong)
  full / full_riffle  the production generation (ping-pong where its
                   mixing gate admits, as PGA.run breeds it) and the same
                   pinned to the riffle
  subblock         the production generation on ping-pong at sub-block
                   depth --subblock-b (default 2): groups of B*D demes,
                   bred by the pipelined deme kernel (B8); left out, with
                   the reason printed, where no D admits that depth
  --dsweep         copy_riffle at Dc = 1, 2, 4, 8 demes per block (those
                   dividing G) with Dc warps per block, so the running
                   warps stay G at every point and only the block count
                   changes: fits t(Dc) = a + b * (G / Dc), b being the cost
                   of one block at fixed bytes and fixed parallelism (the
                   partition's grid_steps). Beside it, the same copy at 1,
                   2, ..., 32 demes per block with the breed's 8 warps per
                   block, as JAX's sweep varies _demes_per_step: there
                   fewer blocks also means fewer running warps, so its
                   slope mixes lost parallelism into the block's cost
  --tsweep         the multi-generation kernel at T in {1, 2, 4, 8} steps
                   per launch: the per-launch cost amortised over T; and
                   at T = 8 with no_freeze and with no_rank_cube: the
                   freeze check's and the in-kernel ranks' cost by
                   difference

``--d`` sets the copy variants' demes per block (the kernel's default is
one deme per block, as the production breed launches). JAX's
``full_serial`` and ``full_nodonate`` variants print their reason and no
number (``NOT_PORTED``).

Every variant is timed interleaved over ``--rounds`` rounds in a fixed
order; each sample is a two-length subtraction (30 and 90 generations)
of per-length minima of CUDA-event times, and the median of each
variant's samples is reported. The partition (``partition_floor``) and
the slope fit (``fit_dispatch_slope``) are pure arithmetic, copies of
JAX's, and are tested on the CPU (``tests/test_torch_ablate.py``). The
tool needs a CUDA card; nothing runs on the CPU in its place.
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Dict

import torch

# The floor variant: every removable breeding stage off, unscored.
FLOOR_ABLATE = ("sel_const", "no_matmul", "no_cross", "no_mut")
# Copy variants skip the rank sort too: the copy ignores ranks, so sorting
# would time the sort into the copy.
COPY = ("copy_only", "no_rank_sort")
DSWEEP = (1, 2, 4, 8, 16, 32)  # demes per block at the breed's 8 warps per block
DSWEEP_FIXED_WARPS = (1, 2, 4, 8)  # demes per block, one warp per deme
TSWEEP = (1, 2, 4, 8)
TSWEEP_ABLATE = ("no_freeze", "no_rank_cube")  # at the sweep's last T
# JAX's variants without a counterpart on the card, and why.
NOT_PORTED = {
    "full_serial": "serial_grid has no meaning on the card: CUDA blocks have no grid"
                   " dimension semantics to choose",
    "full_nodonate": "buffer donation is a jit notion: the port always breeds into the"
                     " other of two buffers",
}
GENE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def _population(geom, dtype, device, objective=None, seed=1):
    """Uniform genomes of ``dtype`` and their scores (-inf on pad rows),
    as the run loop keeps them: onemax's, or ``objective``'s."""
    from libpga_tpu_torch.ops.evaluate import evaluate

    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.rand((geom.Pp, geom.L), generator=gen, device=device).to(dtype)
    s = g.float().sum(dim=1) if objective is None else evaluate(objective, g)
    s[geom.P:] = -torch.inf
    return g, s


def _kinds(kinds):
    """(objective, factory keywords) of a hook set (``ablate_kernel``'s
    ``hook_kinds``); None is onemax with the factory's builtin hooks."""
    from libpga_tpu_torch.objectives import onemax

    kw = dict(kinds or {"objective": onemax})
    return kw.pop("objective"), kw


def build_variant(name, dtype, K, pop, L, ablate=(), fused=True, layout=None,
                  demes_per_block=1, warps_per_block=0, subblock=None,
                  device="cuda", kinds=None) -> Callable[[int], None]:
    """``run(n)``: n generations of one variant, as ``PGA.run``'s loop
    breeds them (the parity alternating by generation, the children into
    the other buffer, in place under ``alias_io``); ``run.breed`` is the
    breed, ``run.geom`` its geometry. ``fused`` False breeds unscored
    (the scores stay those of generation 0); ``subblock`` is the
    ping-pong sub-block depth (JAX's ``_subblock``); ``kinds`` the
    objective, crossover, mutation and mparams of a hook set (None:
    onemax with the builtin hooks)."""
    from libpga_tpu_torch.ops import fused_step as fs

    objective, kw = _kinds(kinds)
    breed = fs.make_fused_breed(
        pop, L, objective if fused else None, deme_size=K, layout=layout, device=device,
        gene_dtype=dtype, ablate=ablate, demes_per_block=demes_per_block,
        warps_per_block=warps_per_block, subblock=subblock, **kw,
    )
    geom = breed.geom
    g0, s0 = _population(geom, dtype, device, None if kinds is None else objective)
    gen = torch.Generator(device=device).manual_seed(0)
    state = {"g": g0, "s": s0, "spare": torch.empty_like(g0), "gen": 0}

    def run(n):
        for _ in range(n):
            g = state["g"]
            g2, s2 = breed(g, state["s"], state["gen"] % geom.parities, gen, out=state["spare"])
            if g2 is not g:
                state["spare"] = g
            state["g"], state["gen"] = g2, state["gen"] + 1
            if s2 is not None:
                state["s"] = s2

    run.name, run.breed, run.geom, run.gens_per_call = name, breed, geom, 1
    run.blocks = geom.G // demes_per_block
    return run


def build_rank_sort(dtype, K, pop, L, layout=None, device="cuda") -> Callable[[int], None]:
    """``compute_ranks`` with its tie words, alone, n times: the rank
    sort of the cohorts of ``layout`` (None: the production geometry's,
    as ``PGA.run`` picks it)."""
    from libpga_tpu_torch.ops import fused_step as fs

    geom = fs.resolve_geometry(pop, L, deme_size=K, gene_dtype=dtype, layout=layout)
    gen = torch.Generator(device=device).manual_seed(2)
    s = torch.rand(geom.Pp, generator=gen, device=device)

    def run(n):
        for i in range(n):
            fs.compute_ranks(s, geom, i % geom.parities,
                             fs.draw_tie_words(gen, geom.Pp, device))

    run.name, run.geom = "rank_sort", geom
    return run


def build_tsweep_variant(dtype, K, pop, L, T, ablate=(), device="cuda",
                         kinds=None) -> Callable[[int], None]:
    """n launches of the multi-generation kernel at T steps each
    (``run.gens_per_call`` = T), with the multigen ``ablate`` flags and
    the hook set ``kinds`` (as :func:`build_variant`'s)."""
    from libpga_tpu_torch.ops import fused_step as fs

    objective, kw = _kinds(kinds)
    launch = fs.make_fused_multigen(pop, L, objective, deme_size=K, gene_dtype=dtype, device=device,
                                    ablate=ablate, **kw)
    if launch is None:
        raise ValueError(f"no multi-generation geometry at {pop}x{L} for these hooks")
    geom = launch.geom
    g0, s0 = _population(geom, dtype, device, None if kinds is None else objective)
    gen = torch.Generator(device=device).manual_seed(0)
    state = {"g": g0, "s": s0, "spare": torch.empty_like(g0), "launch": 0}

    def run(n):
        for _ in range(n):
            g = state["g"]
            g2, s2 = launch(g, state["s"], state["launch"] % geom.parities, T, None, gen,
                            out=state["spare"])
            state.update(g=g2, s=s2, spare=g, launch=state["launch"] + 1)

    run.name, run.geom, run.gens_per_call = "_".join((f"t{T}",) + tuple(ablate)), geom, T
    return run


def elapsed_ms(run, n: int) -> float:
    """CUDA-event milliseconds of ``run(n)`` on the current stream."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run(n)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def best_ms_per_unit(run, lo: int = 30, hi: int = 90, tries: int = 2) -> float:
    """ms per generation by the two-length subtraction of per-length
    minima: ``(min t(hi) - min t(lo)) / ((hi - lo) * gens per call)``
    (the constant costs cancel); NaN where the difference is not
    positive."""
    t_lo, t_hi = [], []
    for _ in range(tries):
        t_lo.append(elapsed_ms(run, lo))
        t_hi.append(elapsed_ms(run, hi))
    delta = min(t_hi) - min(t_lo)
    units = (hi - lo) * getattr(run, "gens_per_call", 1)
    return delta / units if delta > 0 else float("nan")


def measure_interleaved(runners: Dict[str, Callable], rounds: int, lo: int = 30,
                        hi: int = 90) -> dict:
    """``{name: median ms/gen}`` over ``rounds`` rounds, each taking one
    sample of every runner in a fixed order; NaN samples are left out of
    the median and counted in ``.dropped``."""
    samples = {name: [] for name in runners}
    for _ in range(rounds):
        for name, run in runners.items():
            samples[name].append(best_ms_per_unit(run, lo, hi))
    med = _Medians()
    for name, xs in samples.items():
        kept = [x for x in xs if x == x]
        med[name] = statistics.median(kept) if kept else float("nan")
        med.dropped[name] = len(xs) - len(kept)
    return med


class _Medians(dict):
    def __init__(self):
        super().__init__()
        self.dropped = {}


def fit_dispatch_slope(dsweep_ms: dict, G: int):
    """Least-squares fit t(D) = a + b·(G/D) over the copy's sweep of D
    demes per block (JAX's per grid step). Returns (a_ms, b_ms_per_step):
    ``b`` is the marginal cost of one block at fixed total bytes; (None,
    None) under two points. The arithmetic is JAX's, unchanged."""
    pts = [(G / d, ms) for d, ms in sorted(dsweep_ms.items()) if ms == ms]
    if len(pts) < 2:
        return None, None
    n = len(pts)
    sx = sum(x for x, _ in pts); sy = sum(y for _, y in pts)
    sxx = sum(x * x for x, _ in pts); sxy = sum(x * y for x, y in pts)
    denom = n * sxx - sx * sx
    if denom == 0:
        return None, None
    b = (n * sxy - sx * sy) / denom
    a = (sy - b * sx) / n
    return a, b


def partition_floor(ms: dict, *, steps_bench=None, dispatch_per_step=None):
    """Partition the measured floor into named components: JAX's
    arithmetic and method strings, unchanged (tests hold the two equal).
    ``ms`` carries the medians for ``floor``, ``copy_riffle``,
    ``copy_contig``, ``copy_alias`` and ``rank_sort`` (a missing key folds
    its delta into its parent component). Returns ``(components,
    coverage)``: an ordered list of ``(name, ms, method)`` that sums to
    ``floor`` exactly, and the share of the floor measured directly
    (everything but the scaffold residual)."""
    floor = ms["floor"]
    copy_riffle = ms.get("copy_riffle")
    copy_contig = ms.get("copy_contig", copy_riffle)
    copy_alias = ms.get("copy_alias", copy_contig)
    rank_sort = ms.get("rank_sort", 0.0)

    comps = []
    base = copy_alias
    if steps_bench and dispatch_per_step and dispatch_per_step > 0:
        grid = min(dispatch_per_step * steps_bench, base)
        comps.append((
            "grid_steps", grid,
            f"D-sweep slope: {dispatch_per_step*1000:.2f} us/step x "
            f"{steps_bench} steps",
        ))
        base = base - grid
    comps.append((
        "hbm_copy", base,
        "aliased contiguous pure-copy kernel at the identical grid"
        + (" (minus grid_steps)" if len(comps) else ""),
    ))
    if copy_contig is not None and copy_alias is not None:
        comps.append((
            "alias_headroom", copy_contig - copy_alias,
            "contiguous copy minus in-place (input_output_aliases) copy",
        ))
    if copy_riffle is not None and copy_contig is not None:
        comps.append((
            "riffle_stride", copy_riffle - copy_contig,
            "riffle-layout copy minus contiguous copy",
        ))
    comps.append((
        "rank_sort", rank_sort, "compute_ranks looped in isolation",
    ))
    attributed = sum(c[1] for c in comps)
    comps.append((
        "kernel_scaffold", floor - attributed,
        "subtraction: floor minus all directly measured components "
        "(PRNG seeding, sel_const scaffolding, casts, unmodeled "
        "per-step overhead)",
    ))
    coverage = attributed / floor if floor else float("nan")
    return comps, coverage


def copy_bound_ms(geom, gene_bytes: int, scored: bool = False) -> float:
    """The copy's least time on an H100 (ms): every row read once and
    written once and, ``scored``, each handed score read and each score
    written, over the card's memory rate; the copy does no operations."""
    nbytes = 2 * geom.Pp * geom.L * gene_bytes + (2 * geom.Pp * 4 if scored else 0)
    return 1e3 * nbytes / H100_BYTES_PER_S


def main(argv=None) -> dict:
    """Run the harness; print each median, the partition and, with the
    sweeps, the slope and the T sweep; return the JSON record it prints
    last (``--json PATH`` also writes it there)."""
    ap = argparse.ArgumentParser(prog="python -m libpga_tpu_torch.tools.ablate_floor")
    ap.add_argument("dtype", nargs="?", default="f32", choices=sorted(GENE_DTYPES))
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--d", type=int, default=1, help="demes per block of the copy variants")
    ap.add_argument("--pop", type=int, default=1 << 20)
    ap.add_argument("--len", type=int, default=100, dest="length")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--dsweep", action="store_true")
    ap.add_argument("--tsweep", action="store_true")
    ap.add_argument("--subblock-b", type=int, default=2, dest="subblock_b",
                    help="sub-block depth of the 'subblock' variant")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the floor is a card's quantity: run this where CUDA is available"
                         " (the partition arithmetic is tested on the CPU)")
    dtype, K, pop, L, Dc = GENE_DTYPES[args.dtype], args.k, args.pop, args.length, args.d

    def mk(name, **kw):
        return build_variant(name, dtype, K, pop, L, **kw)

    def mk_pp(name, **kw):
        # The sub-block depth can be inadmissible at a swept shape (the
        # mixing gate, G % (B*D)): leave the variant out, as JAX's tool does.
        try:
            return mk(name, **kw)
        except ValueError as exc:
            print(f"# {name}: skipped ({exc})", flush=True)
            return None

    for name, reason in NOT_PORTED.items():
        print(f"# {name}: not measured ({reason})", flush=True)
    copy_kw = dict(fused=False, demes_per_block=Dc)
    runners = {
        "full": mk("full"),
        "full_riffle": mk("full_riffle", layout="riffle"),
        "subblock": mk_pp("subblock", layout="pingpong", subblock=args.subblock_b),
        "floor": mk("floor", ablate=FLOOR_ABLATE, fused=False),
        "copy_riffle_score": mk("copy_riffle_score", ablate=COPY, demes_per_block=Dc),
        "copy_riffle": mk("copy_riffle", ablate=COPY, **copy_kw),
        "copy_contig": mk("copy_contig", ablate=COPY + ("no_riffle",), **copy_kw),
        "copy_alias": mk("copy_alias", ablate=COPY + ("no_riffle", "alias_io"), **copy_kw),
        "rank_sort": build_rank_sort(dtype, K, pop, L, layout="riffle"),
        "rank_sort_full": build_rank_sort(dtype, K, pop, L),
    }
    runners = {name: run for name, run in runners.items() if run is not None}
    for run in runners.values():
        run(3)  # builds and first launches before the interleave
    med = measure_interleaved(runners, args.rounds)
    geom = runners["copy_riffle"].geom
    G = geom.G

    dsweep_ms, fixed_ms, a_ms, b_ms, b8_ms = {}, {}, None, None, None
    if args.dsweep:
        sweep = {f"w{d}": mk(f"copy_riffle_d{d}_w{d}", ablate=COPY, fused=False,
                             demes_per_block=d, warps_per_block=d)
                 for d in DSWEEP_FIXED_WARPS if G % d == 0}
        sweep.update({f"d{d}": mk(f"copy_riffle_d{d}", ablate=COPY, fused=False,
                                  demes_per_block=d)
                      for d in DSWEEP if G % d == 0})
        for run in sweep.values():
            run(3)
        sw = measure_interleaved(sweep, args.rounds)
        fixed_ms = {d: sw[f"w{d}"] for d in DSWEEP_FIXED_WARPS if f"w{d}" in sw}
        dsweep_ms = {d: sw[f"d{d}"] for d in DSWEEP if f"d{d}" in sw}
        a_ms, b_ms = fit_dispatch_slope(fixed_ms, G)
        b8_ms = fit_dispatch_slope(dsweep_ms, G)[1]
        del sweep

    tsweep_ms = {}
    if args.tsweep:
        sweep = [build_tsweep_variant(dtype, K, pop, L, t) for t in TSWEEP]
        sweep += [build_tsweep_variant(dtype, K, pop, L, TSWEEP[-1], ablate=(flag,))
                  for flag in TSWEEP_ABLATE]
        for run in sweep:
            run(2)
        tsweep_ms = dict(measure_interleaved({r.name[1:]: r for r in sweep}, args.rounds,
                                             lo=10, hi=30))
        del sweep

    comps, coverage = partition_floor(med, steps_bench=G // Dc, dispatch_per_step=b_ms)
    # The same from the out-of-place copy: on the card an in-place copy need
    # not be the cheapest, and the partition's base is then the other one.
    oop = {k: v for k, v in med.items() if k != "copy_alias"}
    comps_oop, coverage_oop = partition_floor(oop, steps_bench=G // Dc, dispatch_per_step=b_ms)
    head = (f"# floor attribution — {args.dtype} K={K} demes/block={Dc} pop={pop} L={L}"
            f" ({args.rounds} interleaved rounds, median ms/gen)")
    print(head, flush=True)
    for label in runners:
        print(f"{args.dtype} {label:18s} {med[label]:8.4f} ms/gen", flush=True)
    score_store = med["copy_riffle_score"] - med["copy_riffle"]
    print(f"{args.dtype} {'score_store':18s} {score_store:8.4f} ms "
          "(copy_riffle_score - copy_riffle; part of full, not floor)")
    print(f"\n# partition of floor = {med['floor']:.4f} ms "
          f"(coverage {coverage:.1%} directly measured)")
    for comp, v, method in comps:
        print(f"  {comp:16s} {v:8.4f} ms  [{method}]")
    print(f"\n# the same from the out-of-place copy (coverage {coverage_oop:.1%})")
    for comp, v, method in comps_oop:
        print(f"  {comp:16s} {v:8.4f} ms  [{method}]")
    if dsweep_ms:
        print(f"\n# demes-per-block sweep (copy_riffle, K={K}), Dc warps a block: "
              + ", ".join(f"Dc={d}: {v:.4f}" for d, v in fixed_ms.items()))
        if b_ms is not None:
            print(f"  fit t = {a_ms:.4f} + {b_ms * 1000:.4f} us * (G/Dc)")
        print("# the same at 8 warps a block (running warps fall with Dc): "
              + ", ".join(f"Dc={d}: {v:.4f}" for d, v in dsweep_ms.items()))
        if b8_ms is not None:
            print(f"  slope {b8_ms * 1000:.4f} us a block")
    if tsweep_ms:
        print("\n# T sweep (multigen): "
              + ", ".join(f"T={t}: {v:.4f} ms/gen" for t, v in tsweep_ms.items()))

    gene_bytes = 2 if dtype == torch.bfloat16 else 4
    out = {
        "device": torch.cuda.get_device_name(0), "dtype": args.dtype, "K": K,
        "demes_per_block": Dc, "pop": pop, "genome_len": L, "rounds": args.rounds,
        "variants": {n: {"layout": r.geom.layout, "K": r.geom.K, "D": r.geom.D,
                         "B": r.geom.B, "blocks": getattr(r, "blocks", None)}
                     for n, r in runners.items()},
        "medians_ms_per_gen": med, "dropped_samples": med.dropped,
        "copy_bound_ms": copy_bound_ms(geom, gene_bytes),
        "floor_partition": [{"component": c, "ms": v, "method": m} for c, v, m in comps],
        "coverage": coverage,
        "floor_partition_out_of_place": [{"component": c, "ms": v} for c, v, _ in comps_oop],
        "coverage_out_of_place": coverage_oop,
        "dsweep_fixed_warps_ms": {str(d): v for d, v in fixed_ms.items()},
        "dispatch_us_per_block": None if b_ms is None else b_ms * 1000,
        "dsweep_intercept_ms": a_ms,
        "dsweep_ms": {str(d): v for d, v in dsweep_ms.items()},
        "dsweep_8_warps_us_per_block": None if b8_ms is None else b8_ms * 1000,
        "tsweep_ms": tsweep_ms,
        "not_ported": NOT_PORTED,
    }
    line = json.dumps(out)
    print("\n" + line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
