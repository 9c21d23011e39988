"""Partition cases of the sub-block pipeline's kernel on one CUDA card.

Usage: python -m libpga_tpu_torch.tools.pipelined_variants [--rounds 3]
           [--reps 20] [--json PATH] [--b1 | --b1-run]

Times ``deme_pipelined_kernel`` built with each partition case of its
source (``PIPE_PART`` in ``csrc/deme_breed.cu``), beside the production
build, at the sub-block cells' 1,048,576x100 geometries (float32 at B = 2
and 4, bf16 at B = 2; and 1,048,576x128 float32 at B = 2, a cluster of
four): Philox draws, onemax scored, point mutation at rate 0.05, at
parity 0 and at parity 1 (``ms`` holds both), the launch of
``kernels.deme_breed_cuda(pipelined=True)`` with each case's library in
the production one's place. Interleaved rounds, each a mean of
``--reps`` launches by CUDA events; medians. In the same call it times
``deme_breed_kernel`` at the same geometry and ``torch.index_select`` of
the row permutation (the pipelined kernel's unscored floor).

  production      as built for ``PGA.run``
  no_breed        the staging, the rank inversion and the cluster barrier
                  of every deme; no child bred (PIPE_PART 1)
  local_parents   every parent read from the block's own buffer (no
                  distributed shared memory; the children are not the
                  function) (PIPE_PART 2)
  dummy_stores    every child written to row ``blockIdx.x`` (PIPE_PART 3)

so the staging, the distributed reads and the child stores fall out by
subtraction. Needs a CUDA card and nvcc.

With ``--b1-run`` it times ``PGA.run`` of OneMax at 40,000x100 (float32
and bf16) with the B = 1 breed routed to ``deme_pipelined_kernel``
(production) and to ``deme_breed_kernel`` in turn, in one process
(:func:`b1_run`).

With ``--b1`` it times instead the production ``deme_pipelined_kernel`` at
the B = 1 geometries of the expression breed's cells (``B1_SHAPES``: the
floor its expression form starts from), beside ``deme_breed_kernel`` at
the same geometry, ``torch.index_select`` of the rows and the bound, after
holding its children and scores bit for bit against
``deme_breed_kernel``'s (:func:`b1_floor`).

"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from libpga_tpu_torch.objectives import onemax
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels

SHAPES = [("f32-B2", 1 << 20, 100, torch.float32, 2), ("f32-B4", 1 << 20, 100, torch.float32, 4),
          ("bf16-B2", 1 << 20, 100, torch.bfloat16, 2),
          ("f32-L128-B2", 1 << 20, 128, torch.float32, 2)]
# The B = 1 geometries of the expression breed's cells (PERF.md section 4),
# the reference driver's padded riffle and a shard of 1,048,576x128 at S = 4:
# (name, rows, genes, gene dtype, constant-carrying objective, parities).
B1_SHAPES = [("pingpong-1Mx100", 1 << 20, 100, torch.float32, False, (0, 1)),
             ("riffle-4Mx64", 1 << 22, 64, torch.float32, True, (0,)),
             ("pingpong-1Mx60", 1 << 20, 60, torch.float32, False, (0,)),
             ("pingpong-1Mx100-bf16", 1 << 20, 100, torch.bfloat16, False, (0,)),
             ("riffle-40000x100", 40_000, 100, torch.float32, False, (0,)),
             ("riffle-40000x100-bf16", 40_000, 100, torch.bfloat16, False, (0,)),
             ("pingpong-262144x128", 262_144, 128, torch.float32, False, (0, 1))]
# The host-bound B = 1 shapes whose PGA.run b1_run times on both routes:
# (name, rows, genes, gene dtype).
B1_RUN_SHAPES = [("40000x100", 40_000, 100, torch.float32),
                 ("40000x100-bf16", 40_000, 100, torch.bfloat16)]
# name: the PIPE_PART case (0 is production).
VARIANTS = {"production": 0, "no_breed": 1, "local_parents": 2, "dummy_stores": 3}


def nvcc_units(units: dict) -> tuple:
    """Build each ``{name: unit text}`` against the headers in ``csrc/``,
    one nvcc each, all at once, into _build/variants/. Returns ``({name:
    library path}, {name: ptxas's registers, stack and spills of each
    production case of deme_pipelined_kernel})``."""
    out = kernels.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)

    def build(name):
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        src.write_text(units[name])
        cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, *kernels.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(kernels.CSRC), "-o", str(lib), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{res.stderr}")
        return lib, ptxas_summary(res.stderr)

    with ThreadPoolExecutor(max_workers=len(units)) as pool:
        built = dict(zip(units, pool.map(build, units)))
    return ({n: lib for n, (lib, _) in built.items()},
            {n: info for n, (_, info) in built.items()})


def ptxas_summary(log: str) -> dict:
    """``{gene type: ptxas's lines}`` of deme_pipelined_kernel<Gene, 0>."""
    out = {}
    for block in log.split("Compiling entry function")[1:]:
        name = block.split("'")[1]
        if "deme_pipelined_kernel" in name and "Lj0E" in name:
            kind = "bf16" if "bfloat16" in name else "f32"
            out[kind] = " | ".join(line.strip() for line in block.splitlines()[1:4]
                                   if "stack" in line or "registers" in line)
    return out


def build_variants() -> tuple:
    """This checkout's deme_breed.cu at each VARIANTS case."""
    source = (kernels.CSRC / "deme_breed.cu").read_text()
    units = {name: (f"#define PIPE_PART {case}\n" if case else "") + source
             for name, case in VARIANTS.items()}
    return nvcc_units(units)


def launcher(lib_path: Path, geom, parity, g, ranks, seed, out, kw):
    """A launch of kernels.deme_breed_cuda(pipelined=True) at ``parity``
    through the library at ``lib_path``."""
    lib = kernels._library("deme_breed", lib_path)

    def run():
        real = kernels._deme_library
        kernels._deme_library = lambda kernel, mask: lib
        try:
            kernels.deme_breed_cuda(g, ranks, geom, parity, seed=seed, out=out, pipelined=True,
                                    **kw)
        finally:
            kernels._deme_library = real
    return run


def b1_floor(rounds: int = 3, reps: int = 20) -> dict:
    """``{shape: {parity: medians}}`` of ``deme_pipelined_kernel`` at each
    ``B1_SHAPES`` geometry (OneMax scored, point mutation at 0.05, Philox
    draws), ``deme_breed_kernel`` at the same geometry, ``index_select`` of
    the row permutation and the bound (the rows read and written once, the
    ranks read and the scores written, at the H100's 3.35 TB/s), in
    interleaved rounds of ``reps`` launches each (the host's launch gaps
    included), each kernel's device time a launch from a torch.profiler
    window of ``reps`` launches (``device_ms``) and the host's time a call
    of its wrapper (``host_us``). The two kernels' children and scores are
    first held equal bit for bit."""
    from libpga_tpu_torch.tools.ablate_floor import H100_BYTES_PER_S

    device = torch.device("cuda")
    mparams = torch.tensor([0.05, 0.0], device=device)
    out = {}
    for name, P, L, dtype, const, parities in B1_SHAPES:
        geom = fs.resolve_geometry(P, L, gene_dtype=dtype, const_carrying=const)
        gb = 2 if dtype == torch.bfloat16 else 4
        plan = kernels.pipelined_plan(geom.K, L, gb, geom.q)
        gen = torch.Generator(device=device).manual_seed(P + L)
        g = torch.rand((geom.Pp, L), generator=gen, device=device).to(dtype)
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        child = torch.empty_like(g)
        nbytes = 2 * geom.Pp * L * gb + geom.Pp * 4 + geom.G * geom.K * 4
        rec = {"P": P, "L": L, "layout": geom.layout, "K": geom.K, "D": geom.D, "B": geom.B,
               "C": plan.C if plan else None, "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S}
        for parity in parities:
            ranks = fs.compute_ranks(g.float().sum(dim=1), geom, parity,
                                     fs.draw_tie_words(gen, geom.Pp, device))
            kw = dict(seed=seed, mparams=mparams, obj_id=onemax.fused_id)
            want = kernels.deme_breed_cuda(g, ranks, geom, parity, **kw)
            got = kernels.deme_breed_cuda(g, ranks, geom, parity, pipelined=True, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{name} parity {parity}: deme_pipelined_kernel at B = 1"
                                   " differs from deme_breed_kernel")
            read, write = geom.row_maps(parity, device)
            rows = torch.empty(geom.Pp, dtype=torch.long, device=device)
            rows[write.reshape(-1)] = read.reshape(-1)
            runners = {
                "pipelined_b1": functools.partial(kernels.deme_breed_cuda, g, ranks, geom, parity,
                                                  out=child, pipelined=True, **kw),
                "deme_breed_kernel": functools.partial(kernels.deme_breed_cuda, g, ranks, geom,
                                                       parity, out=child, **kw),
                "index_select": functools.partial(torch.index_select, g, 0, rows, out=child),
            }
            samples = {k: [] for k in runners}
            for _ in range(rounds):
                for k, run in runners.items():
                    samples[k].append(mean_ms(run, reps))
            rec[f"parity{parity}"] = {k: statistics.median(v) for k, v in samples.items()}
            for what, clock in (("device_ms", device_ms), ("host_us", host_us)):
                rec[f"parity{parity}"][what] = {
                    k: clock(runners[k], reps) for k in ("pipelined_b1", "deme_breed_kernel")}
            del want, got, ranks, rows, runners
        out[name] = rec
        del g, child
        torch.cuda.empty_cache()
    return out


def b1_run(rounds: int = 10, gens: int = 200) -> dict:
    """``{shape: {route: [wall ms a generation, ...]}}`` of ``PGA.run``
    (OneMax through the pga_* API, seed 1) at each ``B1_RUN_SHAPES``
    shape, the B = 1 breed routed to ``deme_pipelined_kernel`` (the
    production route) and to ``deme_breed_kernel``, each route on a
    population of its own, in ``rounds`` A B B A rounds of ``gens``
    generations a run, all in one process, so that the drift of the
    host's pace between processes stays out of the comparison. Each run's
    launches are checked to be the route's kernel's alone. Beside the
    medians: the pairs' differences (production minus deme_breed_kernel),
    their median, mean and a 95% interval of the mean (normal, 1.96
    standard errors)."""
    import libpga_tpu_torch as port

    holds = kernels.pipelined_holds
    out = {}
    for name, P, L, dtype in B1_RUN_SHAPES:
        tail = "_bf16" if dtype == torch.bfloat16 else ""
        routes = {"deme_pipelined_kernel": ("deme_pipelined" + tail, holds),
                  "deme_breed_kernel": ("riffle" + tail, lambda geom, gene_dtype: False)}
        runs, ms = {}, {k: [] for k in routes}
        for route in routes:
            runs[route] = port.pga_init(seed=1, config=port.PGAConfig(gene_dtype=dtype))
            port.pga_create_population(runs[route], P, L)
            port.pga_set_objective_function(runs[route], "onemax")
        try:
            for route, (_, rule) in routes.items():  # warm-up
                kernels.pipelined_holds = rule
                port.pga_run(runs[route], 5)
            for _ in range(rounds):
                for route in ("deme_pipelined_kernel", "deme_breed_kernel", "deme_breed_kernel",
                              "deme_pipelined_kernel"):
                    counter, kernels.pipelined_holds = routes[route]
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    t0 = time.perf_counter()
                    port.pga_run(runs[route], gens)
                    torch.cuda.synchronize()
                    ms[route].append(1e3 * (time.perf_counter() - t0) / gens)
                    if kernels.LAUNCHES[counter] != gens:
                        raise RuntimeError(f"{name}: the {route} route launched"
                                           f" {dict(kernels.LAUNCHES)}")
        finally:
            kernels.pipelined_holds = holds
        # Pair i: the i-th run of each route, side by side in one round.
        diff = [a - b for a, b in zip(ms["deme_pipelined_kernel"], ms["deme_breed_kernel"])]
        half = 1.96 * statistics.stdev(diff) / len(diff) ** 0.5
        mean = statistics.mean(diff)
        out[name] = {"P": P, "L": L, "gens": gens, "ms_per_gen": ms,
                     "median": {k: statistics.median(v) for k, v in ms.items()},
                     "pipelined_minus_deme_breed": {
                         "median": statistics.median(diff), "mean": mean,
                         "ci95": [mean - half, mean + half],
                         "pipelined_faster": sum(d < 0 for d in diff), "pairs": len(diff)}}
        print(json.dumps({name: out[name]}), flush=True)
    return out


def device_ms(fn, reps: int) -> float:
    """Device milliseconds a call of ``fn`` spends in kernels whose name
    holds "_kernel", over ``reps`` calls under torch.profiler (the host's
    gaps between launches excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "_kernel" in e.key) / 1e3 / reps


def host_us(fn, reps: int) -> float:
    """Host microseconds a call of ``fn`` takes to return, over ``reps``
    calls issued back to back (the card not awaited between them: the
    launch's cost to the host, the wrapper's checks included)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / reps


def mean_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m libpga_tpu_torch.tools.pipelined_variants")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--b1", action="store_true",
                      help="time the production kernel at the B = 1 geometries (b1_floor)")
    mode.add_argument("--b1-run", action="store_true",
                      help="time PGA.run at 40k on both B = 1 routes (b1_run)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel times are a card's quantity: run this where CUDA is available")
    if args.b1 or args.b1_run:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        record = {"tool": "pipelined_variants " + ("--b1" if args.b1 else "--b1-run"),
                  "nvidia_smi": smi.strip(),
                  "shapes": b1_floor(args.rounds, args.reps) if args.b1 else b1_run(args.rounds)}
        print(json.dumps(record), flush=True)
        return record
    libs, ptxas = build_variants()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    device = torch.device("cuda")
    record = {"tool": "pipelined_variants", "nvidia_smi": smi, "ptxas": ptxas, "shapes": {}}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    for name, P, L, dtype, B in SHAPES:
        geom = fs.resolve_geometry(P, L, gene_dtype=dtype, subblock=B)
        gen = torch.Generator(device=device).manual_seed(P + L + B)
        g = torch.rand((geom.Pp, L), generator=gen, device=device).to(dtype)
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        out = torch.empty_like(g)
        kw = dict(mparams=torch.tensor([0.05, 0.0], device=device), obj_id=onemax.fused_id)
        runners = {}
        for parity in (0, 1):
            ranks = fs.compute_ranks(g.float().sum(dim=1), geom, parity,
                                     fs.draw_tie_words(gen, geom.Pp, device))
            for v, path in libs.items():
                runners[(v, parity)] = launcher(path, geom, parity, g, ranks, seed, out, kw)
            runners[("deme_breed_kernel", parity)] = functools.partial(
                kernels.deme_breed_cuda, g, ranks, geom, parity, seed=seed, out=out, **kw)
            read, write = geom.row_maps(parity, device)
            rows = torch.empty(geom.Pp, dtype=torch.long, device=device)
            rows[write.reshape(-1)] = read.reshape(-1)
            runners[("index_select", parity)] = functools.partial(
                torch.index_select, g, 0, rows, out=out)
        samples = {key: [] for key in runners}
        for _ in range(args.rounds):
            for key, run in runners.items():
                samples[key].append(mean_ms(run, args.reps))
        med = {}
        for (v, parity), xs in samples.items():
            med.setdefault(v, [None, None])[parity] = statistics.median(xs)
        samples = {f"{v}@{parity}": xs for (v, parity), xs in samples.items()}
        plan = kernels.pipelined_plan(geom.K, L, g.element_size(), geom.q)
        line = {"shape": name, "P": P, "L": L, "K": geom.K, "D": geom.D, "B": B,
                "C": plan.C if plan else None, "ms": med, "samples": samples}
        print(json.dumps(line), flush=True)
        record["shapes"][name] = line
        del g, out, runners
        torch.cuda.empty_cache()
    print(json.dumps({k: v for k, v in record.items() if k != "shapes"}), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
