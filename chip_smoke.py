#!/usr/bin/env python3
"""Build and drive the PyTorch port (libpga_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel source under libpga_tpu_torch/csrc/, with nvcc;
  3. kernel vs plain: the deme-breed kernel against its plain torch
     version on the same inputs, for the ping-pong parities at
     1,048,576x100, the riffle at 40,000x100 (padded to 40,192 rows) and a
     padded ping-pong population, with injected draws and with Philox
     draws; genomes must be equal element for element, scores within
     SCORE_ATOL (float32 sums in another order). Times the kernel and the
     plain version with CUDA events;
  4. Philox statistics at 1,048,576x100, tournament k=2, read from the
     kernel's own output on a tracer population;
  5. PGA.run through the public pga_* API at 1,048,576x100 and
     40,000x100 OneMax: launches must equal generations and the best
     score must rise; a target run must stop at the exact generation.
     Then a torch.profiler window: device time per generation by kernel.
Then one JSON line of per-kernel numbers, the card's name and power
limit, and last the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SCORE_ATOL = 1e-3  # onemax of 100 genes in [0, 1): float32 sums reordered
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
MAIN_SHAPES = {"pingpong": (1 << 20, 100), "riffle": (40_000, 100)}
REPLACES = {
    "pingpong": "libpga_tpu/ops/pallas_step.py:1173",  # _pp_breed_kernel
    "riffle": "libpga_tpu/ops/pallas_step.py:946",  # _breed_kernel
}
RUN_GENS = 200
WARMUP_GENS = 5
PROFILE_GENS = 20
# Philox statistics bands (n ~ 1e6 children, 1e8 genes): the standard
# errors are ~2e-4 or smaller, so these bands are > 5 sigma wide.
MEAN_RANK_BAND = (1 / 3 - 0.004, 1 / 3 + 0.002)  # E = 1/3 - O(1/K)
CROSS_BAND = (0.495, 0.505)
MUTATION_RATE = 0.01
MUTATION_BAND = (0.0095, 0.0105)


class SmokeError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def breed_bound(geom) -> tuple:
    """Least time (ms) for one breed on the card and what sets it: the
    larger of the bytes it must move (genomes and ranks read once,
    children and scores written once) over the memory rate, and its
    float32 operations (a crossover select and a score add per gene)
    over the float32 rate."""
    nbytes = geom.Pp * geom.L * 4 * 2 + geom.G * geom.K * 4 + geom.Pp * 4
    ops = 2 * geom.Pp * geom.L
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def population(geom, gen, device):
    """Uniform genomes with zero pad rows, onemax scores with -inf pads."""
    import torch

    g = torch.rand((geom.Pp, geom.L), generator=gen, device=device)
    g[geom.P:] = 0.0
    s = g.sum(dim=1)
    s[geom.P:] = -torch.inf
    return g, s


def phase_compare(fs, onemax, device, results):
    """Kernel vs plain on the same inputs; times both at the main shapes."""
    import torch

    cases = [
        ("pingpong0", *MAIN_SHAPES["pingpong"], 0),
        ("pingpong1", *MAIN_SHAPES["pingpong"], 1),
        ("riffle", *MAIN_SHAPES["riffle"], 0),
        ("pingpong1-padded", 1000, 100, 1),
    ]
    for name, P, L, parity in cases:
        geom = fs.resolve_geometry(P, L)
        check(geom.layout == name.split("-")[0].rstrip("01"), f"{name}: layout {geom.layout}")
        gen = torch.Generator(device=device).manual_seed(P + parity)
        g, s = population(geom, gen, device)
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, device))
        kw = dict(mparams=torch.tensor([0.05, 0.0], device=device), obj_id=onemax.fused_id)
        injected = fs.Draws(
            sel_u=torch.rand((geom.G, geom.K, 2), generator=gen, device=device),
            cross=(torch.rand((geom.G, geom.K, L), generator=gen, device=device) < 0.5).to(torch.uint8),
            mut_u=torch.rand((geom.G, geom.K, 4), generator=gen, device=device),
        )
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        errs = []
        for mode, draws in (("injected", injected), ("philox", None)):
            if draws is None:
                got = fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw)
                draws = fs.philox_draws(seed, geom.G, geom.K, L)
            else:
                got = fs.deme_breed(g, ranks, geom, parity, draws=draws, **kw)
            want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]), f"{name} {mode}: genomes differ")
            real = torch.arange(geom.Pp, device=device) < P
            check(bool(torch.isinf(got[1][~real]).all()), f"{name} {mode}: pad scores not -inf")
            err = float((got[1][real] - want[1][real]).abs().max())
            check(err <= SCORE_ATOL, f"{name} {mode}: score error {err}")
            errs.append(err)
        line = {"phase": "compare", "case": name, "shape": [P, L], "layout": geom.layout,
                "K": geom.K, "D": geom.D, "Pp": geom.Pp, "genomes_equal": True,
                "max_abs_err": max(errs), "score_atol": SCORE_ATOL}
        if (P, L) == MAIN_SHAPES[geom.layout] and parity == 0:
            out = torch.empty_like(g)
            ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, parity, seed=seed, out=out, **kw), 50)
            plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
                g, ranks, geom, parity, fs.philox_draws(seed, geom.G, geom.K, L), **kw), 5)
            tie = fs.draw_tie_words(gen, geom.Pp, device)
            rank_ms = cuda_ms(lambda: fs.compute_ranks(s, geom, parity, tie), 50)
            bound_ms, bound_by = breed_bound(geom)
            line.update(kernel_ms=ms, plain_ms=plain_ms, rank_ms=rank_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            results[geom.layout].update(ms=ms, plain_ms=plain_ms, rank_ms=rank_ms,
                                        bound_ms=bound_ms, bound_by=bound_by)
        results[geom.layout]["max_abs_err"] = max(
            results[geom.layout].get("max_abs_err", 0.0), max(errs))
        print(json.dumps(line), flush=True)


def phase_philox_stats(fs, device):
    """Selection pressure, crossover balance and mutation rate, read from
    the kernel's output in production (Philox) mode. Every row of a deme
    holds the constant gene value (rank + 0.5) / K, so a child gene tells
    which rank it came from; a mutated gene is off that grid."""
    import torch

    P, L = MAIN_SHAPES["pingpong"]
    geom = fs.resolve_geometry(P, L)
    gen = torch.Generator(device=device).manual_seed(11)
    scores = torch.rand(geom.Pp, generator=gen, device=device)
    ranks = fs.compute_ranks(scores, geom, 0, fs.draw_tie_words(gen, geom.Pp, device))
    read, _ = geom.row_maps(0, device)
    g = torch.empty((geom.Pp, L), device=device)
    g[read.reshape(-1)] = ((ranks.to(torch.float32) + 0.5) / geom.K).reshape(-1, 1).expand(-1, L)
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
    child, _ = fs.deme_breed(
        g, ranks, geom, 0, seed=seed, tournament_size=2,
        mparams=torch.tensor([MUTATION_RATE, 0.0], device=device), obj_id=0,
    )
    scaled = child * geom.K - 0.5
    on_grid = scaled == torch.round(scaled)
    mean_rank = float((scaled[on_grid] / geom.K).mean())
    mutated = float((~on_grid).any(dim=1).float().mean())
    hi = torch.where(on_grid, child, -1.0).max(dim=1, keepdim=True).values
    lo = torch.where(on_grid, child, 2.0).min(dim=1, keepdim=True).values
    two = (hi > lo).squeeze(1)
    cross = float(((child == hi) & on_grid)[two].float().sum() / on_grid[two].float().sum())
    line = {"phase": "philox_stats", "shape": [P, L], "tournament_size": 2,
            "mean_rank_over_V": mean_rank, "mean_rank_band": MEAN_RANK_BAND,
            "crossover_bit_mean": cross, "crossover_band": CROSS_BAND,
            "mutation_fire_rate": mutated, "mutation_rate": MUTATION_RATE,
            "mutation_band": MUTATION_BAND}
    print(json.dumps(line), flush=True)
    check(MEAN_RANK_BAND[0] <= mean_rank <= MEAN_RANK_BAND[1], f"mean rank {mean_rank}")
    check(CROSS_BAND[0] <= cross <= CROSS_BAND[1], f"crossover bit mean {cross}")
    check(MUTATION_BAND[0] <= mutated <= MUTATION_BAND[1], f"mutation rate {mutated}")


def profile_generations(port, pga, wall_ms_per_gen: float) -> dict:
    """Device time per generation, by kernel, over PROFILE_GENS more
    generations under torch.profiler, and the device's busy share: that
    time over the unprofiled wall time per generation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        port.pga_run(pga, PROFILE_GENS)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): the host-side aten op
    # that launched a kernel carries the same device time again.
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3 / PROFILE_GENS)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    device_ms = sum(ms for _, ms in rows)
    return {
        "profiled_gens": PROFILE_GENS,
        "device_ms_per_gen": device_ms if rows else "not measured",
        "device_busy_share": device_ms / wall_ms_per_gen if rows else "not measured",
        "top_device_ms_per_gen": [[name[:70], ms] for name, ms in rows[:8]],
    }


def phase_run(port, kernels, results):
    """PGA.run through the pga_* API at both main shapes."""
    import torch

    for layout, (P, L) in MAIN_SHAPES.items():
        pga = port.pga_init(seed=1)
        h = port.pga_create_population(pga, P, L)
        port.pga_set_objective_function(pga, "onemax")
        start_best = float(pga.population(h).genomes.sum(dim=1).max())
        check(port.pga_run(pga, WARMUP_GENS) == WARMUP_GENS, "warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        gens = port.pga_run(pga, RUN_GENS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        _, best = pga.get_best_with_score(h)
        line = {"phase": "run", "layout": layout, "shape": [P, L], "gens": gens,
                "launches": launches, "gens_per_s": gens / seconds,
                "ms_per_gen": 1e3 * seconds / gens,
                "kernel_ms_per_gen": results[layout].get("ms"),
                "rank_ms_per_gen": results[layout].get("rank_ms"),
                "bound_ms_per_gen": results[layout].get("bound_ms"),
                "start_best": start_best, "best": best}
        print(json.dumps(line), flush=True)
        results[layout]["launches"] = launches[layout]
        check(gens == RUN_GENS, f"{layout}: ran {gens} generations")
        check(launches[layout] == gens and sum(launches.values()) == gens,
              f"{layout}: launches {launches} for {gens} generations")
        check(best > start_best + 10.0 and best < L, f"{layout}: best {start_best} -> {best}")
        print(json.dumps({"phase": "profile", "layout": layout, "shape": [P, L],
                          **profile_generations(port, pga, 1e3 * seconds / gens)}), flush=True)
        port.pga_deinit(pga)

    # Target: the run stops at the first generation whose best reaches it.
    P, L = MAIN_SHAPES["riffle"]

    def fresh():
        pga = port.pga_init(seed=2)
        port.pga_create_population(pga, P, L)
        port.pga_set_objective_function(pga, "onemax")
        return pga

    target = 70.0
    pga = fresh()
    gens = port.pga_run(pga, 10_000, target=target)
    best = pga.get_best_with_score(port.PopulationHandle(0))[1]
    before = fresh()
    port.pga_run(before, gens - 1)
    prev = before.get_best_with_score(port.PopulationHandle(0))[1]
    print(json.dumps({"phase": "target", "shape": [P, L], "target": target,
                      "gens": gens, "best": best, "best_one_gen_earlier": prev}), flush=True)
    check(0 < gens < 10_000 and best >= target > prev, "target early stop")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import libpga_tpu_torch as port
        from libpga_tpu_torch.objectives import onemax
        from libpga_tpu_torch.ops import fused_step as fs
        from libpga_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(json.dumps({"phase": "device", "name": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)

    t0 = time.perf_counter()
    kernels.build_all(verbose=True)
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "sources": sorted(p.name for p in kernels.CSRC.glob("*.cu"))}), flush=True)

    results = {"pingpong": {}, "riffle": {}}
    phase_compare(fs, onemax, device, results)
    phase_philox_stats(fs, device)
    phase_run(port, kernels, results)

    entries = []
    for layout, r in results.items():
        entries.append({
            "name": f"deme_breed[{layout}]", "route": "cuda",
            "source": "libpga_tpu_torch/csrc/deme_breed.cu",
            "replaces": REPLACES[layout], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
