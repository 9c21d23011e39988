#!/usr/bin/env python3
"""Build and drive the PyTorch port (libpga_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--log FILE]

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
     Then a torch.profiler window: device time per generation by kernel;
  6. gp_compare: the GP evaluator kernel (csrc/gp_eval.cu) against its
     plain torch version on the same inputs, in both modes (compacted
     programs, B2; raw genomes with static trips, B2'), at the main
     shape (65,536 programs x 32 tokens x 1,024 samples; the plain
     version on a fixed 8,192-row slice that holds the longest programs)
     and the bench shape (1,024 x 16 x 64), for two knob settings and
     both dispatch modes of the plain version, on well-formed, noise and
     overflow populations: within GP_TOL, -inf where the plain version
     has -inf. Times both with CUDA events beside the bound and per
     executed token-sample, with the SM clock read under the kernel's
     load; prints each population's share of programs at each
     samples-a-pass V, as the kernel reports it; then gp_bit_exact: on
     programs of the IEEE-exact function set (no libm call) the kernel
     equals the plain predictions summed in the kernel's order
     (ops/gp_eval.py::kernel_order_scores) bit for bit, timed as above,
     and gp_ptxas: ptxas's registers and spills of the kernel;
  7. gp_run: PGA.run symbolic regression of Nguyen-12 at the main shape
     through the public API (symbolic_regression, subtree crossover,
     gp_mutate, install_population of random programs): evaluator
     launches must equal evaluations, the deme kernel must not launch,
     and the best and the median -RMSE must rise; then a
     torch.profiler window; then the same path with
     GPConfig(optimize=False), which scores through B2'; then the
     exact-recovery target run of tools/gp_smoke.py's configuration,
     which must stop at score 0.0;
  8. tsp_compare: the order-breed kernel (csrc/deme_breed.cu's
     order_breed_kernel: order crossover, swap mutation, fused TSP score)
     against its plain torch version at 8,192x1,000 (fused TSP over
     random_tsp_coords(1000, seed=2)) and 1,000x100 (unfused, padded to
     1,024 rows), with injected and with Philox draws: genomes equal,
     scores within TSP_RTOL and -inf on the same rows. Times both with
     CUDA events beside the byte bound and the walk's dependent chain,
     in steps and in ms at a walk step the card measures
     (kernels.walk_step_probe: walk_step_ns, chain_ms);
  9. tsp_run: PGA.run through pga_init, pga_create_population,
     pga_set_objective_function, pga_set_crossover_function
     (order_preserving_crossover) and pga_set_mutate_function
     (make_swap_mutate(0.5)): 200 generations at 8,192x1,000 (launches
     of the order kernel equal generations and nothing else launches,
     the best score rises strictly, the best tour's duplicate count
     falls), then a torch.profiler window (tsp_profile); and 1,000
     generations of the reference driver's 1,000x100 over
     random_tsp_matrix(100, seed=7), whose best tour must visit all 100
     cities;
 10. fused_objectives: the deme-breed kernel's in-kernel sphere,
     rastrigin and ackley scores against the plain version at 65,536x100
     (ping-pong) and 40,000x100 (riffle): genomes equal, scores within
     FUSED_RTOL;
 11. multigen_compare: the multi-generation kernel (csrc/deme_breed.cu's
     multigen_breed_kernel) against its plain torch version on the same
     inputs, with injected and with Philox draws: 1,048,576x100 (riffle,
     D=4, 3 steps), 40,000x100 (padded riffle; 0, 1, 3 and 8 steps,
     per-deme elitism 2, a target that freezes some groups, onemax_bits),
     524,288x100 (ping-pong, both parities, 3 steps, a target) and
     1,000x100 (padded ping-pong, both parities): genomes and scores
     equal element for element (the plain version sums scores in the
     kernel's order); rastrigin at 1 step within FUSED_RTOL, and what 3
     steps give, printed. Times by CUDA events: the kernel at 1, 4, 8, 16
     and 32 steps at the shapes of multigen_run, the plain version at 3
     and 8, beside the bound;
 12. multigen_run: PGA.run through pga_init(config=PGAConfig(
     generations_per_launch=8)), pga_create_population,
     pga_set_objective_function and pga_run: 200 generations at
     1,048,576x100, 40,000x100 and 524,288x100 (25 launches of the
     multigen kernel and of nothing else; the best score rises) beside
     the same run at one generation per launch; 203 generations land on
     203 in 26 launches; a target run stops at a multiple of 8 with the
     best at or above the target; a sweep of 1, 4, 8, 16 and 32
     generations per launch at 40,000x100 and 1,048,576x100, up and down;
     then a torch.profiler window;
 13. expr_compare: the expression breed (csrc/expr_breed.cu with hooks
     generated from expressions) against its plain torch version on the
     same inputs, with injected and with Philox draws, in every row map:
     NK (n=64, k=3) at 4,194,304x64 and padded at 1,000x64, the deceptive
     trap(5) at 1,048,576x60 (both parities), the reference knapsack at
     4,096x6, and OneMax 1,048,576x100 with one-point and arithmetic
     crossover (their expression equivalents) and the creep mutation
     expression (and at 40,000x100, riffle): genomes equal (within 2 ulp
     where a breeding hook calls a transcendental or **), scores within
     EXPR_RTOL and EXPR_ATOL_PER_GENE * L, -inf on pad rows. Times both
     with CUDA events beside the byte bound;
 14. nk_run, trap_run, knapsack_run, expr_ops_run: PGA.run through the
     pga_* API: NK at 4,194,304x64 and the trap at 1,048,576x60 for 50
     generations after a warm-up (the best must rise), the knapsack at
     4,096x6 for 30 (its best beside the optimum 285), OneMax
     1,048,576x100 with one-point, arithmetic and creep for 50 each beside
     the builtin uniform/point run: launches of the expression breed equal
     generations and nothing else launches; gens/s and, from a
     torch.profiler window of as many generations, the device's busy
     share;
 15. expr_multigen_compare: the expression multi-generation kernel
     (csrc/expr_breed.cu's expr_multigen_kernel) against its plain torch
     version on the same inputs, with injected and with Philox draws, in
     every row map (riffle, ping-pong parity 0 and 1, padded), at 0, 1, 3
     and 8 steps, with per-deme elites and a target that freezes half the
     groups: NK at 4,194,304x64, the trap at 1,048,576x60 and 40,000x60,
     the knapsack at 4,096x6, OneMax with creep mutation and with one-point
     crossover at 40,000x100 and 1,048,576x100 (and smaller shapes for the
     other row maps): genomes and scores equal element for element, or
     within 2 ulp after a transcendental hook at one step. Times the
     kernel at 1 and 8 steps and the plain version at 8, beside the bound;
 16. expr_multigen_run, expr_multigen_profile: PGA.run of those eight
     workloads through the pga_* API at generations_per_launch=8 (launches
     of expr_multigen_kernel equal ceil(gens / 8) and nothing else
     launches; scores are the genomes' objective; the knapsack reaches
     285) beside the same run at one generation per launch, then a
     torch.profiler window over as many generations;
 17. order_expr_compare: order crossover in the expression breed
     (csrc/expr_breed.cu's expr_order_kernel) against its plain version on
     the same inputs, injected and Philox draws: the Euclidean tour
     written as an expression (TOUR_EXPR over random_tsp_coords(200,
     seed=2)) with swap and with the creep expression at 65,536x200 (and
     padded at 1,000x200), the coordinate TSP with the creep expression
     on its random keys at 8,192x1,000: genomes equal, scores within
     EXPR_RTOL / EXPR_ATOL_PER_GENE * L (the tour) or TSP_RTOL, -inf on
     pad rows. Times both beside the bound and the walk's chain;
 18. order_multigen_compare: the multi-generation kernels' order case
     (expr_multigen_kernel<true> with the tour at 65,536x200,
     multigen_breed_kernel<true> with OneMax at 40,000x100) against the
     plain version, injected and Philox draws, at 0, 1, 3 and 8 steps,
     elites and half the groups frozen: genomes and scores equal. Times
     the kernel at 1 and 8 steps and the plain version at 8;
 19. order_runs: PGA.run through pga_init, pga_create_population,
     pga_set_objective_function, pga_set_crossover_function
     (order_preserving_crossover) and pga_set_mutate_function: the tour
     with make_swap_mutate(0.5) at 65,536x200 for 200 generations at T = 1
     and at T = 8, the coordinate TSP with the creep expression at
     8,192x1,000 for 200 at T = 1 (the best must rise), OneMax with
     elitism 2 at 40,000x100 at T = 8 beside T = 1 (the best must not
     fall): launches equal ceil(gens / T) and nothing else launches;
     gens/s, the best tour's distinct cities (reported: the tour
     expression has no duplicate penalty) and a torch.profiler window.
 20. island_compare: the island launch of the deme, order and multigen
     kernels (csrc/deme_breed.cu, the islands a second grid axis) against
     its plain version on the card, against I single-population launches
     (each with its island's seed or slice of the injected draws: bit for
     bit) and, with one island, against the single launch, with injected
     and with Philox draws: bench.py's 8 x 131,072x100 (ping-pong, both
     parities), tools/bench_rastrigin.py's 8 x 16,384x30 (gaussian),
     4 x 40,000x100 (riffle), TSP islands 4 x 8,192x200 (order, swap, the
     fused tour score) and 8 x 131,072x100 at 8 steps (multigen). Times
     the island launch, the loop of I single launches and the plain
     version with CUDA events beside the bound;
 21. island_run: pga_run_islands at 8 x 131,072x100 OneMax, m = 10, pct =
     0.05, 200 generations after a warm-up, at one and at 8 generations
     per launch: launches equal 200 (one island launch per generation) or
     20 * ceil(10 / 8), nothing else launches, the best rises, scores are
     the genomes' onemax; gens/s, a torch.profiler window's busy share,
     the migration's ms per epoch and the ratio to the single
     1,048,576x100 run of phase 5 (12 at T = 8); a target run that stops at
     an epoch boundary (an epoch earlier the best was below it); TSP
     islands 4 x 8,192x200 for 50 generations through the order kernel;
 22. rastrigin_islands: the five annealing phases of
     tools/bench_rastrigin.py (8 x 16,384x30, elitism 2, gaussian mutation,
     migration of 5% every 20 generations, 400 generations each): the
     best must not fall within a phase and must rise over the run; prints
     the best Rastrigin value;
 23. bf16_compare: the bfloat16 cases of the kernels (gene_dtype=bfloat16)
     against their plain versions, with injected and with Philox draws,
     bit for bit (genomes; scores within the gates above), and against the
     float32 kernel's children on the widened genomes, rounded to bf16
     (one step): deme_breed at 1,048,576x100 (ping-pong K=512 D=8, both
     parities), 40,000x100 (riffle) and with gaussian mutation at
     65,536x100; multigen_breed at 1,048,576x100 (ping-pong D=8) and
     40,000x100 (3 steps with elitism 2, 8 and 1 step); the expression
     breed with the trap at 1,048,576x60 (both parities) and one-point
     crossover at 1,048,576x100, and the trap at T = 8; the island launch
     at 8 x 131,072x100 (each island also against its single launch).
     Times each by CUDA events beside its 2-byte bound, the float32
     kernel on the same shape and the plain version;
 24. bf16_run: PGA.run at gene_dtype=bfloat16 through the pga_* API,
     each the main-path run of a bf16 kernel: OneMax 1,048,576x100 (200
     generations, then a torch.profiler window) and 40,000x100, both also
     at T = 8, the trap at 1,048,576x60 at T = 1 and T = 8, one-point at
     1,048,576x100, and pga_run_islands at 8 x 131,072x100 (m = 10), 100
     generations each after a warm-up: launches of the bf16 kernel equal
     generations (ceil(gens / 8) at T = 8) and nothing else launches, the
     genomes stay bf16, the best rises, the scores are the stored
     genomes' objective; gens/s beside the same configuration at float32
     over as many generations, run just before it.
     Order crossover at bf16 runs on the panmictic path, launching
     nothing.
 25. island_expr_compare: the island launch of the expression kernels
     (csrc/expr_breed.cu's expr_breed_kernel, expr_order_kernel and
     expr_multigen_kernel<false/true>, the islands a second grid axis)
     against its plain version (genomes bit for bit, scores within
     EXPR_RTOL / EXPR_ATOL_PER_GENE * L, the coordinate TSP's within
     TSP_RTOL), against I single-population launches bit for bit and, with
     one island, against the single launch, injected and Philox draws,
     every parity: the creep mutation at 8 x 131,072x100, NK (n=64, k=3)
     at 8 x 524,288x64, the trap at 8 x 131,072x60, the tour expression
     with swap at 4 x 16,384x200, the coordinate TSP with creep at
     4 x 8,192x1,000, at T = 8 the trap, the creep and the tour, and the
     trap at bf16 (T = 1 and 8). Times the island launch beside the loop
     of I single launches, I times the island's bound and the plain
     version;
 26. island_expr_runs: pga_run_islands of those ten cases (m = 10,
     pct = 0.05, after a warm-up epoch): launches of the island expression
     kernel equal the generations (T = 1) or ceil(10 / 8) per epoch and
     nothing else launches, the best rises, the scores are the genomes'
     objective; gens/s, ms/gen, the migration's ms per epoch and a
     torch.profiler window's busy share beside the same configuration's
     single-population run of this script; then a target run of the creep
     islands that stops at an epoch boundary (an epoch earlier the best
     was below it).
 27. floor_compare: the floor harness's cases (B7) of deme_breed_kernel
     (the copies: riffle, contiguous, in place, scored; the floor, every
     stage off; sel_const, no_matmul, no_cross and no_mut alone) at
     1,048,576x100 and 40,000x100 float32 (the copies and the floor at
     1,048,576x100 bf16 too) and of multigen_breed_kernel (no_freeze,
     no_rank_cube) at T = 8 at 1,048,576x100, against their plain versions
     with injected and Philox draws: genomes bit for bit, scores within
     SCORE_ATOL, the copies equal to their row permutation (and to one
     torch.index_select). Times each by CUDA events beside the production
     kernel of the same call, the bound and the plain version;
 28. floor_partition: this slice's path, the port's harness
     (libpga_tpu_torch/tools/ablate_floor.py with --dsweep and --tsweep) at
     1,048,576x100 and 40,000x100 float32 and 1,048,576x100 bf16, then
     tools/ablate_kernel.py at 1,048,576x100: every median, the partition of
     the floor with its coverage, the demes-per-block sweeps (the running
     warps held fixed, and at the breed's 8 warps a block) with their
     slopes, and the T sweep;
     every ablated kernel case must have launched in it (the harness's
     subblock variant included);
 28a. hook_floor_compare: the floor harness with hooks (B7's hook cases):
     each ablated case of expr_breed_kernel (creep 1,048,576x100, trap
     1,048,576x60), expr_order_kernel (the tour 65,536x200 + swap),
     order_breed_kernel (the coordinate TSP 8,192x1,000),
     expr_multigen_kernel<false/true> (creep 1M, the tour, T = 8) and
     multigen_breed_kernel<true> (OneMax 40,000x100 order + swap, T = 8),
     and the builtin copy with the creep hook (HOOK_FLOOR_ROWS), against
     its plain version, injected and Philox draws, each launch the
     kernel's case of that mask, once: genomes bit for bit,
     scores within the objective's tolerance (multigen at T = 8, the T it
     is timed at); timed by CUDA events beside the production launch of
     the same call, the bound (breed_bound: every breed kernel's, the
     hooks' operations counted from their lowering) and the plain
     version;
 28b. hook_floor_partition: this slice's path, tools/ablate_kernel.py
     --hooks over every row of HOOK_FLOOR_ROWS (--steps 8 for the T = 8
     rows), the launch counts set to 0 just before and read just after:
     every hook kernel's ablated cases and production launches must have
     launched;
 29. subblock_compare: the sub-block pipeline (B8): deme_pipelined_kernel
     (csrc/deme_breed.cu) at subblock=2 and 4 (1,048,576x100 float32), 2
     (bf16), 8 x 131,072x100 islands at 2 and 1,048,576x128 at 2: clusters
     of 1 (bf16), 2 and 4 blocks a deme; against its plain version and
     against deme_breed_kernel at the same B-aware geometry, injected and
     Philox draws, both parities: genomes bit for bit, scores equal to the
     children's warp-order sums; timed beside deme_breed_kernel at the
     same geometry, B1 (subblock None), its floor (every stage off,
     unscored) and one torch.index_select of the floor's rows, with C,
     the bytes a block stages and the bound; a sweep of genome lengths
     that take clusters of 1, 2, 4 and 8 blocks (beside
     deme_breed_kernel); 131,072x1,024 at 2, which no cluster holds and
     which must breed through deme_breed_kernel, bit for bit; and the
     creep expression at B = 2 through expr_breed_kernel on the B-aware
     row maps;
 30. subblock_run: PGA.run of OneMax 1,048,576x100 at subblock=2 (200
     generations float32, 100 bf16) and pga_run_islands at 8 x
     131,072x100 (200 generations): launches of the pipelined kernel equal
     generations and nothing else launches, the best rises; gens/s beside
     the subblock=None runs of this call and a torch.profiler busy share.
 31. shard_compare: population sharding (B9), the sharded run's launch of
     the island breed over S shards at elitism 0 (deme_breed_kernel, or
     expr_breed_kernel with the creep expression) at 1,048,576x128, S = 4
     and 8 float32, 4 bf16 and 4 with creep, against its plain version on
     Philox draws replayed from the solver's step and the same draws
     injected, both parities: genomes bit for bit, scores within
     SCORE_ATOL. Times the launch, the whole step, the plain version and
     the unsharded deme_breed_kernel at 1,048,576x128 beside the bound;
 32. shard_run: PGA.run at pop_shards = S through the pga_* API: those four
     cases and pop_shards=1 at 1,048,576x128 (100 generations; launches of
     the sharded counter, or of the unsharded kernel, equal generations and
     nothing else launches; the best rises; the scores are the onemax;
     gens/s, a torch.profiler busy share at S = 1 and 4), the giant
     16,777,216x128 at S = 8 (one step of its solver first, 32,768 blocks
     in one launch and offsets past 2^31 bytes, shards 0 and 7 held
     against the plain version on both parities; then 10 generations,
     the best rises) and the panmictic route at 65,536x64, S = 4, which
     launches nothing. The sharded launch counts as an island launch.
 33. subblock_floor_compare: the floor harness at B > 1 (B10):
     deme_pipelined_kernel's stage cases (each flag alone and the floor,
     scored and unscored) at subblock_compare's 1,048,576x100 geometries
     (float32 B = 2 and 4, bf16 B = 2) against the plain version at the
     same geometry, injected and Philox draws, both parities: genomes bit
     for bit, scores equal to the warp-order sums. Timed beside the
     production launch of the same call, the bound and the plain version,
     with C and the bytes a block stages; the unscored floor, a row
     permutation, also beside one torch.index_select;
 34. ablate_combo_compare, hook_floor_compare's checks over
     B10_HOOK_ROWS: the creep hook's no_mut and floor through
     expr_breed_kernel at B = 2 (both parities), and flag combinations
     outside the production unit's masks (deme_breed_kernel,
     order_breed_kernel, multigen_breed_kernel<false/true> and
     deme_pipelined_kernel, each from a deme_breed.cu unit of its own,
     built in parallel after the production build and reported apart),
     and copy_only with no_mut, which must launch the copy;
 35. subblock_floor_partition: this slice's path, the stage harness
     (tools/ablate_kernel.py) at --subblock 2 (float32 with a combination,
     bf16, the creep hook) and with the other kernels' combinations, the
     launch counts set to 0 just before and read just after: every case of
     those kernels must have launched.
Every phase that launches multigen_breed_kernel<false>
(multigen_compare and multigen_times, multigen_run, island_compare,
bf16_compare, floor_compare) also prints each launch's schedule (the
cluster of csrc/mg_plan.cuh: C and the rows a block holds, or the
one-block schedule), holds the cluster schedule's children and scores
against the one-block schedule's (cluster=False) bit for bit, times the
one-block schedule at the same geometry beside it, and checks that every
builtin multi-generation cell of the main path takes the cluster route
(kernels.CLUSTER_LAUNCHES). The phases of expr_multigen_kernel
(expr_multigen_compare and expr_multigen_run, island_expr_compare,
bf16_compare's expression case, hook_floor_compare) do the same for its
cluster schedule (csrc/expr_plan.cuh's expr_mg_plan, with the eight-lane
expression child): every uniform or expression crossover case but the
knapsack's L = 6 takes it, held bit for bit against the one-block
schedule; order crossover stays on one block.
PGA.run at B = 1 launches deme_pipelined_kernel wherever a cluster holds
the deme (every OneMax, island, bf16 and shard cell): compare,
island_compare, bf16_compare, shard_compare and floor_compare hold each
such launch bit for bit against deme_breed_kernel (pipelined=False) of
the same inputs, which meets every check against the plain version that
the production launch meets, and time deme_breed_kernel beside it; the
run phases count the launches under "deme_pipelined" (and
"islands_deme_pipelined", "ablate_pipelined", "_bf16"); the floor
harness's copy stays on deme_breed_kernel.
The earlier OneMax, GP and TSP runs keep their depths; the whole script
takes about seven and a half minutes on the card (its build 70-130 s, the
B10 units 10-30 s more).
Then one JSON line of per-kernel numbers, the card's name and power
limit, and last the result line. With --log FILE every line printed
also goes to that file (a tool that shows only the end of a long output
can bring the file back whole).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SCORE_ATOL = 1e-3  # onemax of 100 genes in [0, 1): float32 sums reordered
H100_BYTES_PER_S = None  # the card's memory rate: ablate_floor.H100_BYTES_PER_S, set by main()
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
MAIN_SHAPES = {"pingpong": (1 << 20, 100), "riffle": (40_000, 100)}
REPLACES = {
    "pingpong": "libpga_tpu/ops/pallas_step.py:1173",  # _pp_breed_kernel
    "riffle": "libpga_tpu/ops/pallas_step.py:946",  # _breed_kernel
}
RUN_GENS = 200
WARMUP_GENS = 5
PROFILE_GENS = 20
GP_TOL = 1e-5  # rtol = atol: the sums over samples run in another order
GP_SHAPES = {"main": (65_536, 32, 1024), "bench": (1024, 16, 64)}  # P, T, B
GP_PLAIN_ROWS = 8192
GP_REPLACES = {
    "opt": "libpga_tpu/ops/gp_eval.py:334",  # kernel_opt
    "static": "libpga_tpu/ops/gp_eval.py:309",  # kernel
}
GP_RUN_GENS = 20
TSP_SHAPES = {"main": (8192, 1000), "reference": (1000, 100)}
TSP_RTOL = 1e-5  # both sum the edges in l order; the gate allows reordering
TSP_RUN_GENS = {"main": 200, "reference": 1000}
TSP_REPLACES = "libpga_tpu/ops/pallas_step.py:653"  # _deme_child, order branch
TSP_ALSO_REPLACES = "libpga_tpu/ops/pallas_step.py:819"  # _tsp_eval_gene_major
GP_STATIC_RUN_GENS = 5
GP_PROFILE_GENS = 3
FUSED_RTOL = 1e-5  # sphere/rastrigin/ackley: sums reordered, cosf/expf/sqrtf of two libraries
FUSED_SHAPES = {"pingpong": (65_536, 100), "riffle": (40_000, 100)}
MULTIGEN_T = 8
MULTIGEN_SWEEP = (1, 4, 8, 16, 32)
# layout of the multigen geometry -> the shapes PGA.run drives it at
MULTIGEN_RUN_SHAPES = {"riffle": [(1 << 20, 100), (40_000, 100)], "pingpong": [(524_288, 100)]}
MULTIGEN_REPLACES = "libpga_tpu/ops/pallas_step.py:1460"  # _multigen_kernel
MULTIGEN_PROFILE_GENS = 40
EXPR_RTOL = 1e-5  # fused expression scores: float32 sums in another order
EXPR_ATOL_PER_GENE = 1e-5
EXPR_REPLACES = "libpga_tpu/ops/pallas_step.py:946"  # _breed_kernel, expression branches
EXPR_ALSO_REPLACES = "libpga_tpu/ops/pallas_step.py:1173"  # _pp_breed_kernel, same branches
EXPR_GENS = {"nk": 50, "trap": 50, "knapsack": 30, "ops": 50}
# The kernels-line name of each one-generation expression counter, with or
# without "islands_" / "_bf16" (the island and bf16 entries keep theirs).
EXPR_ENTRY = {"expr": "expr_breed", "expr_pipelined": "expr_pipelined",
              "islands_expr": "expr_breed", "islands_expr_pipelined": "expr_pipelined",
              "expr_bf16": "expr_breed", "expr_pipelined_bf16": "expr_pipelined",
              "islands_expr_bf16": "expr_breed", "islands_expr_pipelined_bf16": "expr_pipelined"}
CREEP = "where(r < rate, g + sigma * (2*r2 - 1), g)"
EXPR_MG_T = 8
EXPR_MG_REPLACES = "libpga_tpu/ops/pallas_step.py:1460"  # _multigen_kernel, expression cases
# workload -> (layout, K, D, S) of make_pallas_multigen at its shape
EXPR_MG_GEOMETRY = {
    "nk-4M": ("riffle", 256, 8, 2048), "trap-1M": ("riffle", 512, 4, 512),
    "trap-40k": ("riffle", 256, 1, 157), "knapsack": ("pingpong", 256, 8, 2),
    "creep-40k": ("riffle", 256, 1, 157), "creep-1M": ("riffle", 512, 4, 512),
    "one_point-40k": ("riffle", 256, 1, 157), "one_point-1M": ("riffle", 512, 4, 512),
}
EXPR_MG_GENS = {"nk-4M": 50, "trap-1M": 50, "trap-40k": 200, "knapsack": 30,
                "creep-40k": 200, "creep-1M": 200, "one_point-40k": 200, "one_point-1M": 200}
# A breeding hook with transcendentals (sqrt, log, cos): genes within 2 ulp.
GAUSS_EXPR = "where(r < rate, g + sigma * sqrt(-2 * log(r2 + 1e-7)) * cos(6.2831855 * q), g)"
# Order crossover with expression hooks and at several generations per
# launch. The Euclidean tour cost of libpga_tpu/objectives/expr.py's
# docstring, over random_tsp_coords(200, seed=2): kroA200's city count.
TOUR_EXPR = ("c = floor(g * L);"
             "x = gather(X, c); y = gather(Y, c);"
             "dx = roll(x, 1) - x; dy = roll(y, 1) - y;"
             "-sum(where(i < L - 1, sqrt(dx*dx + dy*dy + 1e-12), 0))")
ORDER_T = 8
ORDER_GENS = 200
# workload -> (P, L, geometry (layout, K, D, S) at T = 1 and at T = 8)
ORDER_GEOMETRY = {
    "tour": ((65_536, 200), ("riffle", 256, 1, 256), ("riffle", 256, 1, 256)),
    "tsp_creep": ((8192, 1000), ("riffle", 256, 1, 32), None),
    "onemax": ((40_000, 100), ("riffle", 256, 1, 157), ("riffle", 256, 1, 157)),
}
ORDER_REPLACES = {
    # _breed_kernel with _deme_child's order branch (:653) then a callable
    # mutation (:750) or a fused kernel_rowwise / gene-major TSP score
    "expr_order": "libpga_tpu/ops/pallas_step.py:946",
    # _multigen_kernel with order_refs (:1548) handed to _deme_child (:1659)
    "expr_multigen_order": "libpga_tpu/ops/pallas_step.py:1460",
    "multigen_order": "libpga_tpu/ops/pallas_step.py:1460",
}
# Philox statistics bands (n ~ 1e6 children, 1e8 genes): the standard
# errors are ~2e-4 or smaller, so these bands are > 5 sigma wide.
# The island kernels: the Pallas kernel each one's island launch replaces,
# and the island epoch that vmaps it over the islands on the TPU.
ISLAND_REPLACES = {
    "deme_breed": ("libpga_tpu/ops/pallas_step.py:1173", "libpga_tpu/parallel/islands.py:110"),
    "order_breed": ("libpga_tpu/ops/pallas_step.py:653", "libpga_tpu/parallel/islands.py:110"),
    "multigen_breed": ("libpga_tpu/ops/pallas_step.py:1460", "libpga_tpu/parallel/islands.py:192"),
}
# (case, kernel, islands, island rows, genes, crossover, mutation, objective,
# steps): bench.py's island config (8 x 131,072 x 100, BASELINE.json),
# tools/bench_rastrigin.py's 8 x 16,384 x 30, islands of the reference's
# OneMax shape, 40,000 rows (riffle), TSP islands with order crossover, and the
# bench islands at T = 8. A kernel's first case is its kernels-line entry.
ISLAND_CASES = [
    ("onemax-8x131072", "deme_breed", 8, 131_072, 100, "uniform", "point", "onemax", 1),
    ("rastrigin-8x16384", "deme_breed", 8, 16_384, 30, "uniform", "gaussian", "rastrigin", 1),
    ("onemax-4x40000", "deme_breed", 4, 40_000, 100, "uniform", "point", "onemax", 1),
    ("tsp-4x8192x200", "order_breed", 4, 8_192, 200, "order", "swap", "tsp", 1),
    ("onemax-8x131072-T8", "multigen_breed", 8, 131_072, 100, "uniform", "point", "onemax", 8),
]
GAUSS_ATOL = 1e-6  # gaussian genes: logf/cosf on the card against torch's, last ulp
ISLAND_RUN = (8, 131_072, 100)  # bench.py:341-351: islands, rows, genes
ISLAND_M, ISLAND_PCT, ISLAND_GENS, ISLAND_T = 10, 0.05, 200, 8
ISLAND_PROFILE_GENS = 20
ISLAND_TSP, ISLAND_TSP_GENS = (4, 8_192, 200), 50
RASTRIGIN_ISLANDS = (8, 16_384, 30)  # tools/bench_rastrigin.py
RASTRIGIN_PHASES = [(0.15, 0.05), (0.15, 0.02), (0.15, 0.008), (0.15, 0.003), (0.15, 0.001)]
RASTRIGIN_GENS, RASTRIGIN_M, RASTRIGIN_PCT, RASTRIGIN_CHUNK = 400, 20, 0.05, 100
# bfloat16 genomes: the kernels-line entry, the Pallas kernel it replaces
# (at gene_dtype=bfloat16) and that kernel's pallas_call site.
BF16_REPLACES = {
    "deme_breed[pingpong,bf16]": ("libpga_tpu/ops/pallas_step.py:1173",
                                  "libpga_tpu/ops/pallas_step.py:2526"),
    "deme_breed[riffle,bf16]": ("libpga_tpu/ops/pallas_step.py:946",
                                "libpga_tpu/ops/pallas_step.py:2257"),
    "multigen_breed[pingpong,bf16]": ("libpga_tpu/ops/pallas_step.py:1460",
                                      "libpga_tpu/ops/pallas_step.py:2872"),
    "multigen_breed[riffle,bf16]": ("libpga_tpu/ops/pallas_step.py:1460",
                                    "libpga_tpu/ops/pallas_step.py:2872"),
    "expr_breed[trap,bf16]": ("libpga_tpu/ops/pallas_step.py:1173",
                              "libpga_tpu/ops/pallas_step.py:2526"),
    "expr_breed[one_point,bf16]": ("libpga_tpu/ops/pallas_step.py:1173",
                                   "libpga_tpu/ops/pallas_step.py:2526"),
    "expr_multigen[trap,bf16]": ("libpga_tpu/ops/pallas_step.py:1460",
                                 "libpga_tpu/ops/pallas_step.py:2872"),
    "deme_breed[islands,bf16]": ("libpga_tpu/ops/pallas_step.py:1173",
                                 "libpga_tpu/parallel/islands.py:110"),
}
BF16_GENS = 100
# (kernels-line entry, workload, rows, genes, generations per launch,
# islands, launch counter, generations): the bf16 runs of PGA.run and
# PGA.run_islands, each the main-path run of its entry.
BF16_RUNS = [
    ("deme_breed[pingpong,bf16]", "onemax", 1 << 20, 100, None, None, "pingpong_bf16", RUN_GENS),
    ("deme_breed[riffle,bf16]", "onemax", 40_000, 100, None, None, "riffle_bf16", BF16_GENS),
    ("multigen_breed[pingpong,bf16]", "onemax", 1 << 20, 100, 8, None, "multigen_bf16", BF16_GENS),
    ("multigen_breed[riffle,bf16]", "onemax", 40_000, 100, 8, None, "multigen_bf16", BF16_GENS),
    ("expr_breed[trap,bf16]", "trap", 1 << 20, 60, None, None, "expr_bf16", BF16_GENS),
    ("expr_breed[one_point,bf16]", "one_point", 1 << 20, 100, None, None, "expr_bf16", BF16_GENS),
    ("expr_multigen[trap,bf16]", "trap", 1 << 20, 60, 8, None, "expr_multigen_bf16", BF16_GENS),
    ("deme_breed[islands,bf16]", "onemax", 131_072, 100, None, 8, "islands_bf16", BF16_GENS),
]
# Islands with expression hooks: (case, launch counter, islands, island
# rows, genes, workload, steps, bf16). bench.py's 8 x 131,072 islands
# (bench.py:341-351) with the creep mutation and the trap; NK at
# examples/nk_landscape.py's 4,194,304 rows over 8 islands; the tour
# expression at the order tour shape's 65,536 rows over 4 islands; the
# coordinate TSP arm's 8,192 x 1,000 per island; T = 8 and bf16 cases of
# the same islands. Each case is one kernels-line entry.
ISLAND_EXPR_CASES = [
    ("creep-8x131072", "expr", 8, 131_072, 100, "creep", 1, False),
    ("nk-8x524288", "expr", 8, 524_288, 64, "nk", 1, False),
    ("trap-8x131072", "expr", 8, 131_072, 60, "trap", 1, False),
    ("tour-4x16384", "expr_order", 4, 16_384, 200, "tour", 1, False),
    ("tsp_creep-4x8192", "expr_order", 4, 8_192, 1000, "tsp_creep", 1, False),
    ("trap-8x131072-T8", "expr_multigen", 8, 131_072, 60, "trap", 8, False),
    ("creep-8x131072-T8", "expr_multigen", 8, 131_072, 100, "creep", 8, False),
    ("tour-4x16384-T8", "expr_multigen_order", 4, 16_384, 200, "tour", 8, False),
    ("trap-8x131072-bf16", "expr", 8, 131_072, 60, "trap", 1, True),
    ("trap-8x131072-T8-bf16", "expr_multigen", 8, 131_072, 60, "trap", 8, True),
]
# The kernels-line name of each launch counter, and the Pallas kernel the
# island launch replaces (by layout) with the island epoch that vmaps it.
ISLAND_EXPR_ENTRY = {"expr": "expr_breed", "expr_pipelined": "expr_pipelined",
                     "expr_order": "expr_order",
                     "expr_multigen": "expr_multigen",
                     "expr_multigen_order": "expr_multigen_order"}
ISLAND_EXPR_REPLACES = {"pingpong": "libpga_tpu/ops/pallas_step.py:1173",
                        "riffle": "libpga_tpu/ops/pallas_step.py:946",
                        "multigen": "libpga_tpu/ops/pallas_step.py:1460"}
# The island runs (pga_run_islands, m = ISLAND_M, pct = ISLAND_PCT), each
# the main-path run of its case: (case, generations, the single-population
# run beside it: results dict and key).
ISLAND_EXPR_RUNS = [
    ("creep-8x131072", 200, "expr", "creep"),
    ("creep-8x131072-T8", 200, "expr_mg", "creep-1M"),
    ("nk-8x524288", 50, "expr", "nk"),
    ("trap-8x131072", 100, "expr", "trap"),
    ("trap-8x131072-T8", 100, "expr_mg", "trap-1M"),
    ("tour-4x16384", 100, "order", "expr_order[tour]"),
    ("tour-4x16384-T8", 100, "order", "expr_multigen_order[tour]"),
    ("tsp_creep-4x8192", 50, "order", "expr_order[tsp_creep]"),
    ("trap-8x131072-bf16", 100, "bf16", "expr_breed[trap,bf16]"),
    ("trap-8x131072-T8-bf16", 100, "bf16", "expr_multigen[trap,bf16]"),
]
ISLAND_EXPR_TARGET = 70.0  # the creep islands' target run
# The floor harness (B7): (P, L, K) of each shape; the copy and stage cases
# (name, ablate, scored); the multigen cases at T = 8; the harness's runs.
FLOOR_SHAPES = {"1M": (1 << 20, 100, 512), "40k": (40_000, 100, 256)}
FLOOR_COPY = ("copy_only", "no_rank_sort")
FLOOR_STAGES = ("sel_const", "no_matmul", "no_cross", "no_mut")
FLOOR_CASES = [
    ("copy_riffle", FLOOR_COPY, False),
    ("copy_contig", FLOOR_COPY + ("no_riffle",), False),
    ("copy_alias", FLOOR_COPY + ("no_riffle", "alias_io"), False),
    ("copy_riffle_score", FLOOR_COPY, True),
    ("floor", FLOOR_STAGES, False),
] + [(flag, (flag,), True) for flag in FLOOR_STAGES]
FLOOR_BF16_CASES = ("copy_riffle", "copy_contig", "copy_alias", "floor")
FLOOR_MULTIGEN_CASES = [("no_freeze", 58.0), ("no_rank_cube", None)]  # (flag, compare target)
FLOOR_T = 8
FLOOR_ROUNDS = 3
FLOOR_RUNS = [["f32", "--pop", str(1 << 20), "--k", "512"], ["f32", "--pop", "40000", "--k", "256"],
              ["bf16", "--pop", str(1 << 20), "--k", "512"]]
FLOOR_REPLACES = {
    "ablate_copy": ("libpga_tpu/ops/pallas_step.py:1009",  # _breed_kernel, copy_only
                    "libpga_tpu/ops/pallas_step.py:2224"),  # no_riffle, alias_io
    "ablate_stages": ("libpga_tpu/ops/pallas_step.py:514",   # _deme_child, sel_const
                      "libpga_tpu/ops/pallas_step.py:592"),  # no_matmul; no_cross :634, no_mut :748
    "ablate_multigen": ("libpga_tpu/ops/pallas_step.py:1617",  # _multigen_kernel, no_freeze
                        "libpga_tpu/ops/pallas_step.py:1638"),  # no_rank_cube
}
# The sub-block pipeline (B8): (name, rows, genes, gene dtype, B, islands).
SUBBLOCK_CASES = [
    ("f32-B2", 1 << 20, 100, "float32", 2, None),
    ("f32-B4", 1 << 20, 100, "float32", 4, None),
    ("bf16-B2", 1 << 20, 100, "bfloat16", 2, None),
    ("islands-B2", 131_072, 100, "float32", 2, 8),
    ("f32-L128-B2", 1 << 20, 128, "float32", 2, None),  # a cluster of four blocks
]
SUBBLOCK_ENTRIES = {"f32-B2": "deme_pipelined[f32]", "bf16-B2": "deme_pipelined[bf16]",
                    "islands-B2": "deme_pipelined[islands]"}
SUBBLOCK_REPLACES = "libpga_tpu/ops/pallas_step.py:1287"  # _pp_breed_kernel, B > 1
SUBBLOCK_RUN_GENS = 200
# Genes -> the blocks a cluster of the pipelined kernel shares a K = 512
# float32 deme among (csrc/pipe_plan.cuh).
SUBBLOCK_CLUSTER_SWEEP = {32: 1, 64: 2, 100: 2, 128: 4, 256: 8}
SUBBLOCK_NO_CLUSTER = (131_072, 1024)  # B = 2: K = 256 rows of 4 KB, 1 MB a deme
# What the sub-block phases print of subblock_compare's line beside their own.
SUBBLOCK_PLAN_KEYS = ("C", "staged_bytes_per_block", "ms", "floor_ms", "library_ms")
# Population sharding (B9): OneMax at the kernel route's exact fit (L a
# multiple of 128, no pad rows a shard). (case, shards, gene dtype,
# mutation: None = point, or the creep expression), each also a run.
SHARD_SHAPE = (1 << 20, 128)
SHARD_CASES = [("S4-f32", 4, "float32", None), ("S8-f32", 8, "float32", None),
               ("S4-bf16", 4, "bfloat16", None), ("S4-creep", 4, "float32", "creep")]
SHARD_REPLACES = ("libpga_tpu/ops/pallas_step.py:1173",  # _pp_breed_kernel, at the shard shape
                  "libpga_tpu/engine.py:1381")  # _sharded_local_step, which builds it
SHARD_RUN_GENS = 100
SHARD_GIANT, SHARD_GIANT_GENS = (1 << 24, 128, 8), 10  # P, L, S: 8.6 GB a buffer
SHARD_PANMICTIC = (65_536, 64, 4)  # bench.py:88-91, the JAX bench's sharded arm
# The floor harness with hooks (B7 with B6, B5 and B4): (row, hook set of
# tools/ablate_kernel.hook_kinds, rows, genes, deme size PGA.run picks,
# generations a launch, sub-block depth, the LAUNCHES name and kernels-line
# entry of its kernel, cases); a case is a stage flag, "floor" (the four
# stage flags: the objective still runs), "copy" (deme_breed_kernel's copy
# at the hooks' geometry) or a tuple of flags. Each entry: what it
# replaces, what else, and the row-case whose numbers it carries.
HOOK_FLOOR_ROWS = [
    ("creep", "creep", 1 << 20, 100, 512, 1, 1, "ablate_expr_pipelined",
     ("sel_const", "no_matmul", "no_cross", "no_mut", "floor", "copy")),
    ("trap", "trap", 1 << 20, 60, 512, 1, 1, "ablate_expr_pipelined",
     ("no_mut", "no_cross", "floor")),
    ("tour", "tour", 65_536, 200, 256, 1, 1, "ablate_expr_order", ("no_cross", "no_mut", "floor")),
    ("tsp", "tsp", 8192, 1000, 256, 1, 1, "ablate_order",
     ("sel_const", "no_matmul", "no_cross", "no_mut", "floor")),
    ("creep-T8", "creep", 1 << 20, 100, 512, 8, 1, "ablate_expr_multigen",
     ("no_freeze", "no_rank_cube", "floor")),
    ("tour-T8", "tour", 65_536, 200, 256, 8, 1, "ablate_expr_multigen_order",
     ("no_cross", "no_rank_cube")),
    ("order-T8", "order", 40_000, 100, 256, 8, 1, "ablate_multigen_order",
     ("no_cross", "no_freeze")),
]
HOOK_FLOOR_ROUNDS = 2
HOOK_FLOOR_ENTRIES = {
    "ablate_expr_pipelined": ("libpga_tpu/ops/pallas_step.py:750",  # callable mutation
                              "libpga_tpu/ops/pallas_step.py:634", "creep-floor"),  # no_cross
    "ablate_expr_order": ("libpga_tpu/ops/pallas_step.py:653",  # the order walk
                          "libpga_tpu/ops/pallas_step.py:1143", "tour-floor"),  # const objective
    "ablate_order": ("libpga_tpu/ops/pallas_step.py:653",
                     "libpga_tpu/ops/pallas_step.py:819", "tsp-floor"),  # _tsp_eval_gene_major
    "ablate_expr_multigen": ("libpga_tpu/ops/pallas_step.py:1617",  # no_freeze
                             "libpga_tpu/ops/pallas_step.py:1638", "creep-T8-floor"),  # ranks
    "ablate_expr_multigen_order": ("libpga_tpu/ops/pallas_step.py:1548",  # order_refs
                                   "libpga_tpu/ops/pallas_step.py:1661", "tour-T8-no_cross"),
    "ablate_multigen_order": ("libpga_tpu/ops/pallas_step.py:1548",
                              "libpga_tpu/ops/pallas_step.py:1661", "order-T8-no_cross"),
}
# The floor harness at B > 1 (B10): subblock_compare's single-population
# geometries (case, rows, genes, gene dtype, B); each stage flag alone and
# the floor, scored and unscored.
SUBBLOCK_FLOOR_CASES = [c[:5] for c in SUBBLOCK_CASES if c[5] is None and c[2] == 100]
SUBBLOCK_FLOOR_FLAGS = [(flag, (flag,)) for flag in FLOOR_STAGES] + [("floor", FLOOR_STAGES)]
SUBBLOCK_FLOOR_REPLACES = ("libpga_tpu/ops/pallas_step.py:1359",  # B > 1 hands ablate on
                           "libpga_tpu/ops/pallas_step.py:1331")  # no_cross: no mask words
# B10's rows of HOOK_FLOOR_ROWS' form: the creep hook at B = 2, and the
# flag combinations outside the production unit's masks, each launched
# from a unit of its own (copy_only with a stage flag is the copy).
B10_HOOK_ROWS = [
    ("creep-B2", "creep", 1 << 20, 100, 512, 1, 2, "ablate_expr_pipelined", ("no_mut", "floor")),
    ("deme", "builtin", 40_000, 100, 256, 1, 1, "ablate_pipelined",
     (("sel_const", "no_cross"), ("no_cross", "no_mut"), ("copy_only", "no_mut"))),
    ("order", "tsp", 8192, 1000, 256, 1, 1, "ablate_order", (("no_matmul", "no_mut"),)),
    ("multigen", "builtin", 40_000, 100, 256, 8, 1, "ablate_multigen",
     (("no_freeze", "no_rank_cube"),)),
    ("multigen_order", "order", 40_000, 100, 256, 8, 1, "ablate_multigen_order",
     (("no_freeze", "no_cross"),)),
    ("pipelined", "builtin", 1 << 20, 100, 512, 1, 2, "ablate_pipelined",
     (("sel_const", "no_cross"),)),
]
# Each combination: (row-case, LAUNCHES name, flags).
ABLATE_COMBOS = [(f"{row}-{'+'.join(c)}", "ablate_copy" if "copy_only" in c else entry, c)
                 for row, *_, entry, cases in B10_HOOK_ROWS for c in cases if isinstance(c, tuple)]
COMBO_UNITS = {"ablate_breed": "deme", "ablate_order": "order", "ablate_multigen": "multigen",
               "ablate_multigen_order": "multigen",
               "ablate_pipelined": "pipelined"}  # kernels.deme_macro's kernel of a counter
ABLATE_COMBO_REPLACES = {  # each combination's kernel: what it replaces, what else
    "ablate_breed": ("libpga_tpu/ops/pallas_step.py:514",  # _deme_child, sel_const
                     "libpga_tpu/ops/pallas_step.py:634"),  # no_cross (no_mut :748)
    "ablate_order": ("libpga_tpu/ops/pallas_step.py:592",  # no_matmul
                     "libpga_tpu/ops/pallas_step.py:653"),  # the order branch
    "ablate_multigen": ("libpga_tpu/ops/pallas_step.py:1617",  # _multigen_kernel, no_freeze
                        "libpga_tpu/ops/pallas_step.py:1638"),  # no_rank_cube
    "ablate_multigen_order": ("libpga_tpu/ops/pallas_step.py:1617",
                              "libpga_tpu/ops/pallas_step.py:1548"),  # order_refs
    "ablate_pipelined": SUBBLOCK_FLOOR_REPLACES,
    "ablate_copy": ("libpga_tpu/ops/pallas_step.py:1009",  # copy_only returns first
                    "libpga_tpu/ops/pallas_step.py:106"),  # _validate_ablate: any set
}
# The harness runs of this slice's path (ablate_kernel's arguments).
SUBBLOCK_FLOOR_RUNS = [
    ["f32", "512", "--subblock", "2", "--combo", "sel_const,no_cross"],
    ["bf16", "512", "--subblock", "2"],
    ["f32", "512", "--subblock", "2", "--hooks", "creep"],
    ["f32", "256", "--pop", "40000", "--combo", "sel_const,no_cross", "--combo", "no_cross,no_mut",
     "--combo", "copy_only,no_mut"],
    ["f32", "256", "--pop", "8192", "--len", "1000", "--hooks", "tsp", "--combo",
     "no_matmul,no_mut"],
    ["f32", "256", "--pop", "40000", "--steps", "8", "--combo", "no_freeze,no_rank_cube"],
    ["f32", "256", "--pop", "40000", "--steps", "8", "--hooks", "order", "--combo",
     "no_freeze,no_cross"],
]
SUBBLOCK_FLOOR_ROUNDS = 2
MEAN_RANK_BAND = (1 / 3 - 0.004, 1 / 3 + 0.002)  # E = 1/3 - O(1/K)
CROSS_BAND = (0.495, 0.505)
MUTATION_RATE = 0.01
MUTATION_BAND = (0.0095, 0.0105)


def nguyen12(a, b):
    """Nguyen-12 (Uy et al., 2011), the gp_run target: no random program
    of 32 tokens over the default function set holds it, so the best
    score must climb."""
    return a**4 - a**3 + 0.5 * b**2 - b


class SmokeError(RuntimeError):
    pass


class Tee:
    """A text stream that writes to two streams."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


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


def cuda_run(fn) -> tuple:
    """(``fn()``, its milliseconds by CUDA events): one run, kept."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    got = fn()
    end.record()
    torch.cuda.synchronize()
    return got, start.elapsed_time(end)


def breed_bound(geom, *, ablate=(), program=None, order: bool = False, n_cities: int = 0,
                steps: int = 1, gene_bytes: int = 4, scored: bool = True) -> tuple:
    """Least time (ms) of one breed launch on the card, what sets it and
    each walker's dependent chain: the bound of every breed kernel, in
    production (``ablate`` ()) and in the floor harness's stage cases.
    The larger of the bytes it must move over the memory rate and its
    float32 operations over the float32 rate. Bytes: the rows read and
    written once (``gene_bytes`` a gene), where it is ``scored`` the
    scores written (at ``steps`` > 1 read too), at one generation the
    ranks where selection reads them (not under sel_const or no_matmul),
    the constant buffer of the expression ``program`` and the
    coordinates of the coordinate TSP (``n_cities``) read once.
    Operations a gene and sub-generation, loads being none: scored, the
    score's add and the objective hook's (``program.gene_ops``; the
    coordinate TSP's ten in their place: a decode, two differences, two
    squares, two adds, a sqrt and the sum); where crossover runs, a
    select (``order``: the walk's two decodes and two tests) and the
    crossover hook's; where mutation runs, the mutation hook's; at
    ``steps`` > 1 K*log2(K) compares a deme to rank it, unless
    no_rank_cube. The chain: L walk steps where the walk runs, plus L
    scoring steps for the coordinate TSP."""
    flags = set(ablate)
    hook_ops = program.gene_ops if program is not None else {}
    L, Pp, G, K = geom.L, geom.Pp, geom.G, geom.K
    nbytes = 2 * Pp * L * gene_bytes + min(n_cities, L) * 8
    nbytes += Pp * 4 * (2 if steps > 1 else 1) * scored
    if steps == 1 and not flags & {"sel_const", "no_matmul"}:
        nbytes += G * K * 4
    if program is not None:
        nbytes += program.consts.nbytes
    crosses = "no_cross" not in flags
    per_gene = (10 if n_cities else 1 + hook_ops.get("objective", 0)) if scored else 0
    if crosses:
        per_gene += (4 if order else 1) + hook_ops.get("crossover", 0)
    if "no_mut" not in flags:
        per_gene += hook_ops.get("mutate", 0)
    ops = steps * Pp * L * per_gene
    if steps > 1 and "no_rank_cube" not in flags:
        ops += steps * K * math.log2(K) * G
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    chain = (L if order and crosses else 0) + (L if n_cities else 0)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", chain


WALK_PROBE_STEPS = 1 << 20  # the walk-step probe's dependent steps a thread
_walk_step_ms: dict = {}


def walk_step_ms(L: int) -> float:
    """Milliseconds one walk step costs on the card at genome length L:
    ``kernels.walk_step_probe`` (the order walk's step alone on shared
    memory, one block, ``WALK_PROBE_STEPS`` dependent steps a thread)
    by CUDA events over its steps, measured once a length."""
    from libpga_tpu_torch.ops import kernels

    if L not in _walk_step_ms:
        _walk_step_ms[L] = cuda_ms(
            lambda: kernels.walk_step_probe(L, WALK_PROBE_STEPS, "cuda"), 3) / WALK_PROBE_STEPS
    return _walk_step_ms[L]


def chain_ms(chain, L: int):
    """A walker's chain of ``chain`` steps priced at the measured walk
    step (None where no walk runs)."""
    return chain * walk_step_ms(L) if chain else None


def population(geom, gen, device):
    """Uniform genomes with zero pad rows, onemax scores with -inf pads."""
    import torch

    g = torch.rand((geom.Pp, geom.L), generator=gen, device=device)
    g[geom.P:] = 0.0
    s = g.sum(dim=1)
    s[geom.P:] = -torch.inf
    return g, s


def deme_key(kernels, geom, dtype=None, islands=False) -> str:
    """The LAUNCHES name of a builtin one-generation launch at ``geom``:
    deme_pipelined_kernel's wherever a cluster holds the deme
    (kernels.pipelined_holds, B = 1 included), else deme_breed_kernel's."""
    import torch

    dtype = dtype or torch.float32
    if kernels.pipelined_holds(geom, dtype):
        key = "islands_deme_pipelined" if islands else "deme_pipelined"
    else:
        key = "islands" if islands else geom.layout
    return key + ("_bf16" if dtype == torch.bfloat16 else "")


def same_deme_kernels(fs, got, g, ranks, geom, parity, tag, **kw):
    """deme_breed_kernel's launch of the same inputs (pipelined=False),
    held against ``got``, the production launch (deme_pipelined_kernel
    where a cluster holds the deme): children and scores bit for bit, so
    deme_breed_kernel meets every check ``got`` meets against the plain
    version."""
    import torch

    check(fs.kernels.pipelined_holds(geom, g.dtype), f"{tag}: no cluster holds the deme")
    old = fs.kernels.deme_breed_cuda(g, ranks, geom, parity, pipelined=False, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got[0], old[0]) and (
        got[1] is old[1] is None or torch.equal(got[1], old[1]))
    check(same, f"{tag}: deme_pipelined_kernel and deme_breed_kernel differ")


def phase_compare(fs, onemax, device, results):
    """The production B = 1 launch (deme_pipelined_kernel) and
    deme_breed_kernel against their plain version on the same inputs, and
    against each other bit for bit; times all three at the main shapes."""
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
            same_deme_kernels(fs, got, g, ranks, geom, parity, f"{name} {mode}",
                              **({"seed": seed} if mode == "philox" else {"draws": draws}), **kw)
            real = torch.arange(geom.Pp, device=device) < P
            check(bool(torch.isinf(got[1][~real]).all()), f"{name} {mode}: pad scores not -inf")
            err = float((got[1][real] - want[1][real]).abs().max())
            check(err <= SCORE_ATOL, f"{name} {mode}: score error {err}")
            errs.append(err)
        plan = fs.kernels.pipelined_plan(geom.K, L, 4, geom.q)
        line = {"phase": "compare", "case": name, "shape": [P, L], "layout": geom.layout,
                "K": geom.K, "D": geom.D, "Pp": geom.Pp, "kernel": deme_key(fs.kernels, geom),
                "C": plan.C, "genomes_equal": True, "deme_breed_kernel_equal": True,
                "max_abs_err": max(errs), "score_atol": SCORE_ATOL}
        if (P, L) == MAIN_SHAPES[geom.layout] and parity == 0:
            out = torch.empty_like(g)
            ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, parity, seed=seed, out=out, **kw), 50)
            deme_ms = cuda_ms(lambda: fs.kernels.deme_breed_cuda(
                g, ranks, geom, parity, seed=seed, out=out, pipelined=False, **kw), 50)
            plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
                g, ranks, geom, parity, fs.philox_draws(seed, geom.G, geom.K, L), **kw), 5)
            tie = fs.draw_tie_words(gen, geom.Pp, device)
            rank_ms = cuda_ms(lambda: fs.compute_ranks(s, geom, parity, tie), 50)
            bound_ms, bound_by, _ = breed_bound(geom)
            line.update(kernel_ms=ms, deme_breed_ms=deme_ms, plain_ms=plain_ms, rank_ms=rank_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
            results[geom.layout].update(ms=ms, deme_breed_ms=deme_ms, plain_ms=plain_ms,
                                        rank_ms=rank_ms, bound_ms=bound_ms, bound_by=bound_by,
                                        C=plan.C)
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


def profile_generations(port, pga, wall_ms_per_gen: float, gens: int = PROFILE_GENS,
                        run=None) -> dict:
    """Device time per generation, by kernel, over ``gens`` more
    generations (``run(gens)``, by default ``pga_run``) under
    torch.profiler, and the device's busy share: that time over the
    unprofiled wall time per generation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (run or (lambda n: port.pga_run(pga, n)))(gens)
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies): the host-side aten op
    # that launched a kernel carries the same device time again.
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3 / gens, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    device_ms = sum(ms for _, ms, _ in rows)
    return {
        "profiled_gens": gens,
        "device_ms_per_gen": device_ms if rows else "not measured",
        "device_busy_share": device_ms / wall_ms_per_gen if rows else "not measured",
        "top_device_ms_per_gen": [[name[:70], ms, count] for name, ms, count in rows[:8]],
    }


def phase_run(port, kernels, results):
    """PGA.run through the pga_* API at both main shapes: every launch is
    deme_pipelined_kernel's."""
    import torch

    from libpga_tpu_torch.ops import fused_step as fs

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
        key = deme_key(kernels, fs.resolve_geometry(P, L))
        check(key == "deme_pipelined", f"{layout}: PGA.run launches {key}")
        results[layout]["launches"] = launches[key]
        results[layout]["gens_per_s"] = gens / seconds
        check(gens == RUN_GENS, f"{layout}: ran {gens} generations")
        check(launches[key] == gens and sum(launches.values()) == gens,
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

def gp_populations(gpmod, P, T, gen, device):
    """(name, GPConfig, genomes) on the card: random well-formed programs
    of the default function set, uniform-noise genes (the skip rule), and
    programs of the full function set with exp chains planted in every
    eighth row (the -inf path)."""
    import torch

    gp = gpmod.GPConfig(max_nodes=T, n_vars=2)
    full = gpmod.GPConfig(
        max_nodes=T, n_vars=2, unary=("neg", "sin", "cos", "sqrt", "abs", "exp", "log"),
        binary=("add", "sub", "mul", "div", "min", "max"),
    )
    over = gpmod.random_population(gen, P, full)
    chain = torch.from_numpy(gpmod.encode_program([("var", 0)] + ["exp"] * 5, full)).to(device)
    over[::8] = chain
    return [
        ("well_formed", gp, gpmod.random_population(gen, P, gp)),
        ("noise", gp, torch.rand((P, 2 * T), generator=gen, device=device)),
        ("overflow", full, over),
    ]


def phase_gp_compare(device, results):
    """The GP evaluator kernel against its plain version, both modes, at
    the main and bench shapes; times at the default knobs."""
    import torch

    from libpga_tpu_torch import gp as gpmod
    from libpga_tpu_torch.gp.encoding import program_structure
    from libpga_tpu_torch.ops import gp_eval as ge

    ptxas = gp_ptxas_start()
    for shape, (P, T, B) in GP_SHAPES.items():
        X, y = gpmod.make_dataset(lambda a, b: a * b + a, n_samples=B, n_vars=2, seed=0)
        xt = torch.from_numpy(X.T.copy()).to(device)
        yt = torch.from_numpy(y).to(device)
        gen = torch.Generator(device=device).manual_seed(P + T)
        for pop_name, gp, g in gp_populations(gpmod, P, T, gen, device):
            prog = gpmod.optimize_for_eval(g, gp)
            live = program_structure(g, gp).length
            # The plain version covers every row at the bench shape, and
            # at the main shape a fixed slice: the 4,096 longest programs
            # and the first rows.
            if P > GP_PLAIN_ROWS:
                key = prog.length * (T + 1) + live
                longest = torch.topk(key, GP_PLAIN_ROWS // 2).indices
                rest = torch.ones(P, dtype=torch.bool, device=device)
                rest[longest] = False
                idx = torch.cat([longest, torch.nonzero(rest)[: GP_PLAIN_ROWS // 2, 0]])
            else:
                idx = torch.arange(P, device=device)
            sub_prog = gpmod.EvalProgram(prog.ops[idx], prog.args[idx], prog.length[idx])
            for mode in ("opt", "static"):
                errs, neg_inf = [], 0
                for knobs in ({}, {"stack_depth": 2 * T, "opcode_block": 4}):
                    fn = ge.make_gp_eval(gp, X, y, optimize=mode == "opt", **knobs)
                    got = fn(prog if mode == "opt" else g)[idx]
                    for dispatch in ("dense", "blocked"):
                        want = ge.gp_eval_reference(
                            sub_prog if mode == "opt" else g[idx], xt, yt, gp,
                            dispatch=dispatch, **knobs,
                            **({"seg_rows": 1024} if mode == "opt" else {}),
                        )
                        torch.cuda.synchronize()
                        check(torch.equal(torch.isinf(got), torch.isinf(want)),
                              f"gp {shape} {pop_name} {mode} {knobs} {dispatch}: -inf rows differ")
                        check(not bool(torch.isnan(got).any()), f"gp {shape} {pop_name} {mode}: NaN score")
                        fin = torch.isfinite(want)
                        close = torch.isclose(got[fin], want[fin], rtol=GP_TOL, atol=GP_TOL)
                        err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
                        check(bool(close.all()), f"gp {shape} {pop_name} {mode} {knobs} {dispatch}: error {err}")
                        errs.append(err)
                        neg_inf = int(torch.isinf(want).sum())
                line = {"phase": "gp_compare", "shape": shape, "P": P, "T": T, "B": B,
                        "population": pop_name, "mode": mode, "compared_rows": int(idx.numel()),
                        "max_abs_err": max(errs), "tol": GP_TOL, "neg_inf_rows": neg_inf,
                        "mean_live_length": float(
                            (prog.length if mode == "opt" else live).float().mean())}
                r = results.setdefault(mode, {})
                r["max_abs_err"] = max(r.get("max_abs_err", 0.0), max(errs))
                arg = prog if mode == "opt" else g
                plan = ge.gp_eval_plan(P, gp, B)
                line.update(v_share=gp_v_share(gp, xt, yt, arg, plan, mode))
                if pop_name == "well_formed":
                    fn = ge.make_gp_eval(gp, X, y, optimize=mode == "opt")
                    ms = cuda_ms(lambda: fn(arg), 20)
                    if mode == "opt":
                        plain = lambda: ge.gp_eval_reference(prog, xt, yt, gp, seg_rows=8192)  # noqa: E731
                    else:
                        plain = lambda: ge.gp_eval_reference(g, xt, yt, gp)  # noqa: E731
                    plain_ms = cuda_ms(plain, 2)
                    n = ge.token_counts(arg, gp)
                    cost = ge.gp_plan_cost(plan, P, gp, B, live_tokens=n["live"],
                                           function_tokens=n["functions"],
                                           optimize=mode == "opt")
                    ns = 1e6 * ms / (n["live"] * B)
                    issue = gp_issue(fn, arg, ms, n["live"] * B) if shape == "main" else {}
                    line.update(kernel_ms=ms, plain_ms=plain_ms, bound_ms=1e3 * cost["bound_s"],
                                bound_by=cost["bound_by"], bound_bytes=cost["bytes"],
                                bound_operations=cost["operations"],
                                mean_function_tokens=n["functions"] / P,
                                ns_per_token_sample=ns, **issue, plan=plan)
                    r[shape] = dict(ms=ms, plain_ms=plain_ms, bound_ms=1e3 * cost["bound_s"],
                                    bound_by=cost["bound_by"],
                                    mean_live_length=line["mean_live_length"],
                                    mean_function_tokens=n["functions"] / P,
                                    ns_per_token_sample=ns, **issue, v_share=line["v_share"])
                print(json.dumps(line), flush=True)
    summary = gp_ptxas(ptxas)
    for mode in ("opt", "static"):
        results[mode].update(bit_exact=gp_bit_exact(gpmod, ge, device, mode), ptxas=summary)


def gp_v_share(gp, xt, yt, arg, plan, mode) -> dict:
    """The share of programs at each samples-a-pass V (4, 2, 1), as the
    kernel reports it through its v_out."""
    import torch

    from libpga_tpu_torch.ops import gp_eval as ge
    from libpga_tpu_torch.ops import kernels

    v = torch.zeros(plan["pop"], dtype=torch.int32, device=yt.device)
    kernels.gp_eval_cuda(
        xt=xt, y=yt, consts=yt.new_tensor(gp.consts),
        fids=yt.new_tensor(ge.function_ids(gp), dtype=torch.int32), plan=plan,
        max_nodes=gp.max_nodes, n_ops=gp.n_ops, v_out=v,
        **({"prog": arg} if mode == "opt" else {"genomes": arg}))
    return {str(w): float((v == w).float().mean()) for w in (4, 2, 1)}


def gp_issue(fn, arg, ms: float, token_samples: int) -> dict:
    """The SM clock nvidia-smi reads while ``fn(arg)`` runs back to back
    (the median of its readings every 50 ms while launches are queued
    for 2.5 s of wall time, the card's highest clock beside it), and the thread
    instructions a token-sample that ``ms`` a launch allows if issue set
    the pace: ms x clock x 4 schedulers an SM x SMs x 32 lanes over the
    token-samples."""
    import statistics

    import torch

    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"]
    fn(arg)
    torch.cuda.synchronize()
    smi = subprocess.Popen([*query, "--loop-ms=50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 2.5:
            fn(arg)
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    rows = [[float(x) for x in r.split(",")] for r in out.strip().splitlines() if r.strip()]
    check(len(rows) > 0, "nvidia-smi read no SM clock")
    mhz = statistics.median(r[0] for r in rows)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sm_clock_mhz": mhz, "sm_clock_max_mhz": rows[0][1], "sm_clock_readings": len(rows),
            "thread_instructions_per_token_sample":
                1e-3 * ms * 1e6 * mhz * 4 * sms * 32 / token_samples}


def gp_bit_exact(gpmod, ge, device, mode):
    """The kernel against the plain predictions reduced in the kernel's
    order (ops/gp_eval.py::kernel_order_scores), bit for bit, on programs
    of the arithmetic set (add, sub, mul, div, min, max, neg, abs: exact
    in both, and no libm call) at the main shape; the plain version on
    the GP_PLAIN_ROWS first rows. Times the kernel there as gp_compare
    does at the default set. Returns the rows compared, the rows that
    differ and the times."""
    import torch

    from libpga_tpu_torch.gp.interpreter import stack_predict, stack_predict_program

    P, T, B = GP_SHAPES["main"]
    gp = gpmod.GPConfig(max_nodes=T, n_vars=2, unary=("neg", "abs"),
                        binary=("add", "sub", "mul", "div", "min", "max"))
    X, y = gpmod.make_dataset(lambda a, b: a * b - a, n_samples=B, n_vars=2, seed=1)
    xt = torch.from_numpy(X.T.copy()).to(device)
    yt = torch.from_numpy(y).to(device)
    g = gpmod.random_population(torch.Generator(device=device).manual_seed(11), P, gp)
    fn = ge.make_gp_eval(gp, X, y, optimize=mode == "opt")
    arg = gpmod.optimize_for_eval(g, gp) if mode == "opt" else g
    got = fn(arg)[:GP_PLAIN_ROWS]
    if mode == "opt":
        sub = gpmod.EvalProgram(*(x[:GP_PLAIN_ROWS] for x in arg))
        preds = stack_predict_program(sub, xt, gp)
    else:
        preds = stack_predict(g[:GP_PLAIN_ROWS], xt, gp)
    want = ge.kernel_order_scores(preds, yt, fn.plan(P)["threads_per_program"])
    torch.cuda.synchronize()
    differ = int((got != want).sum())
    ms = cuda_ms(lambda: fn(arg), 20)
    n = ge.token_counts(arg, gp)
    line = {"phase": "gp_bit_exact", "mode": mode, "P": P, "T": T, "B": B,
            "compared_rows": GP_PLAIN_ROWS, "rows_differing": differ,
            "neg_inf_rows": int(torch.isinf(want).sum()), "kernel_ms": ms,
            "mean_live_length": n["live"] / P, "mean_function_tokens": n["functions"] / P,
            "ns_per_token_sample": 1e6 * ms / (n["live"] * B),
            **gp_issue(fn, arg, ms, n["live"] * B)}
    print(json.dumps(line), flush=True)
    check(differ == 0, f"gp {mode}: {differ} arithmetic programs' scores differ from the kernel-order sum")
    return line


def gp_ptxas_start():
    """Start nvcc -Xptxas -v on csrc/gp_eval.cu (into _build/, apart from
    the production library); gp_ptxas reads it."""
    from libpga_tpu_torch.ops import kernels

    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, *kernels.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", str(kernels.BUILD / "gp_eval_ptxas.so"), str(kernels.CSRC / "gp_eval.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def gp_ptxas(proc) -> dict:
    """ptxas's registers, stack frame and spill bytes of gp_eval_kernel.
    Every walk<V> is inlined into it, so the count is that of its
    costliest V and the spills those of every V."""
    import re

    out, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"nvcc -Xptxas -v gp_eval.cu failed:\n{out[-2000:]}")
    m = re.search(r"Compiling entry function '\w*gp_eval_kernel\w*'.*?"
                  r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
                  r".*?Used (\d+) registers", out, re.S)
    check(m is not None, f"ptxas -v printed no resources of gp_eval_kernel:\n{out[-2000:]}")
    summary = {"registers": int(m.group(4)), "stack_frame": int(m.group(1)),
               "spill_stores": int(m.group(2)), "spill_loads": int(m.group(3))}
    print(json.dumps({"phase": "gp_ptxas", "gp_eval_kernel": summary}), flush=True)
    return summary


def gp_solver(port, gpmod, gp, P, X, y, seed, **config):
    """A PGA set up for symbolic regression through the public API."""
    import torch

    pga = port.PGA(seed=seed, config=port.PGAConfig(**config))
    pga.set_objective(gpmod.symbolic_regression(X, y, gp=gp))
    pga.set_crossover(gpmod.make_subtree_crossover(gp))
    pga.set_mutate(gpmod.make_gp_mutate(gp))
    gen = torch.Generator(device=pga.device).manual_seed(seed)
    h = pga.install_population(gpmod.random_population(gen, P, gp))
    return pga, h


def phase_gp_run(port, kernels, results):
    """PGA.run symbolic regression of Nguyen-12 at the main shape; then
    with the optimizer off (B2'); then the exact-recovery target run."""
    import torch

    from libpga_tpu_torch import gp as gpmod

    P, T, B = GP_SHAPES["main"]
    X, y = gpmod.make_dataset(nguyen12, n_samples=B, n_vars=2, seed=0)
    for mode, optimize in (("opt", True), ("static", False)):
        gp = gpmod.GPConfig(max_nodes=T, n_vars=2, optimize=optimize)
        pga, h = gp_solver(port, gpmod, gp, P, X, y, seed=3, selection="truncation", elitism=2)
        check(not pga.uses_deme_kernel(P, 2 * T), "GP run would take the deme kernel")
        start = pga._objective.rows(pga.population(h).genomes)
        start_best = float(start.max())
        start_median = float(start.median())
        gens = GP_RUN_GENS if optimize else GP_STATIC_RUN_GENS
        check(pga.run(1) == 1, "gp warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        check(pga.run(gens) == gens, f"gp {mode}: generations")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        _, best = pga.get_best_with_score(h)
        median = float(pga.population(h).scores.median())
        live = gpmod.mean_live_length(pga.population(h).genomes, gp)
        line = {"phase": "gp_run", "mode": mode, "shape": [P, T, B], "gens": gens,
                "launches": launches, "ms_per_gen": 1e3 * seconds / gens,
                "gens_per_s": gens / seconds, "start_best": start_best, "best": best,
                "start_median": start_median, "median": median,
                "mean_live_length_end": live}
        print(json.dumps(line), flush=True)
        key = f"gp_eval_{mode}"
        check(launches[key] == gens + 1, f"gp {mode}: {launches[key]} evaluator launches for {gens + 1} evaluations")
        check(sum(launches.values()) == gens + 1, f"gp {mode}: other kernels launched {launches}")
        check(best > start_best, f"gp {mode}: best {start_best} -> {best}")
        check(median > start_median, f"gp {mode}: median {start_median} -> {median}")
        results.setdefault(mode, {})["launches"] = launches[key]
        if optimize:
            print(json.dumps({"phase": "gp_profile", "shape": [P, T, B], **profile_generations(
                port, pga, 1e3 * seconds / gens, GP_PROFILE_GENS)}), flush=True)
        port.pga_deinit(pga)

    # Exact recovery (tools/gp_smoke.py's configuration) stops at 0.0.
    gp = gpmod.GPConfig(max_nodes=8, n_vars=2, consts=(1.0, 2.0), unary=("neg",),
                        binary=("add", "sub", "mul"))
    X, y = gpmod.make_dataset(lambda a, b: a * a + b, n_samples=32, n_vars=2, seed=0)
    pga, h = gp_solver(port, gpmod, gp, 128, X, y, seed=0, selection="truncation", elitism=2)
    pga.set_mutate(gpmod.make_gp_mutate(gp, 0.4, 0.6))
    gens = pga.run(200, target=0.0)
    best_g, best = pga.get_best_with_score(h)
    print(json.dumps({"phase": "gp_target", "gens": gens, "best": best,
                      "expression": gpmod.decode_expression(best_g, gp)}), flush=True)
    check(gens < 200 and best == 0.0, f"gp exact recovery: {gens} generations, best {best}")


def tsp_objective(shape: str):
    """The objective of a TSP shape: the fused coordinate TSP at the main
    shape, the reference driver's planted-path matrix at the other."""
    from libpga_tpu_torch import objectives as obj

    P, L = TSP_SHAPES[shape]
    if shape == "main":
        return obj.make_tsp_coords(obj.random_tsp_coords(L, seed=2), duplicate_mode="genes")
    return obj.make_tsp(obj.random_tsp_matrix(L, seed=7))


def phase_tsp_compare(fs, device, results):
    """The order kernel against its plain version at both TSP shapes,
    injected and Philox draws; times both."""
    import torch

    from libpga_tpu_torch.objectives.classic import FUSED_TSP

    for shape, (P, L) in TSP_SHAPES.items():
        tsp = tsp_objective(shape)
        fused = getattr(tsp, "fused_id", 0) == FUSED_TSP
        geom = fs.resolve_geometry(P, L, crossover="order", fused=fused)
        check(geom.layout == "riffle" and geom.D == 1, f"tsp {shape}: geometry {geom}")
        gen = torch.Generator(device=device).manual_seed(P + L)
        g = torch.rand((geom.Pp, L), generator=gen, device=device)
        g[P:] = 0.0
        s = torch.full((geom.Pp,), -torch.inf, device=device)
        s[:P] = tsp.rows(g[:P])
        ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(gen, geom.Pp, device))
        kw = dict(mutate="swap", crossover="order",
                  mparams=torch.tensor([0.5, 0.0], device=device))
        if fused:
            kw.update(obj_id=FUSED_TSP, coords=tsp.coords.to(device), penalty=tsp.penalty)
        injected = fs.Draws(
            sel_u=torch.rand((geom.G, geom.K, 2), generator=gen, device=device), cross=None,
            mut_u=torch.rand((geom.G, geom.K, 4), generator=gen, device=device),
            fill=torch.rand((geom.G, geom.K, L), generator=gen, device=device),
        )
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        errs = []
        for mode, draws in (("injected", injected), ("philox", None)):
            if draws is None:
                got = fs.deme_breed(g, ranks, geom, 0, seed=seed, **kw)
                draws = fs.philox_draws(seed, geom.G, geom.K, L, "swap", crossover="order")
            else:
                got = fs.deme_breed(g, ranks, geom, 0, draws=draws, **kw)
            want = fs.deme_breed_reference(g, ranks, geom, 0, draws, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]), f"tsp {shape} {mode}: genomes differ")
            if fused:
                check(torch.equal(torch.isinf(got[1]), torch.isinf(want[1])),
                      f"tsp {shape} {mode}: -inf rows differ")
                check(bool(torch.isinf(got[1][P:]).all()) and bool(torch.isfinite(got[1][:P]).all()),
                      f"tsp {shape} {mode}: pad rows not -inf or real rows not finite")
                a, b = got[1][:P], want[1][:P]
                check(bool(torch.isclose(a, b, rtol=TSP_RTOL, atol=0.0).all()),
                      f"tsp {shape} {mode}: score error {float((a - b).abs().max())}")
                errs.append(float((a - b).abs().max()))
            else:
                check(got[1] is None and want[1] is None, f"tsp {shape} {mode}: unfused scores")
                errs.append(0.0)
        out = torch.empty_like(g)
        ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seed, out=out, **kw), 20)
        plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
            g, ranks, geom, 0, fs.philox_draws(seed, geom.G, geom.K, L, "swap", crossover="order"),
            **kw), 2)
        bound_ms, bound_by, chain = breed_bound(geom, order=True, scored=fused,
                                                n_cities=tsp.coords.shape[0] if fused else 0)
        r = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 chain_steps=chain, chain_ms=chain_ms(chain, L),
                 walk_step_ns=1e6 * walk_step_ms(L), max_abs_err=max(errs), K=geom.K, G=geom.G,
                 Pp=geom.Pp)
        if fused:
            # The walk alone (no score: half the dependent chain), and the
            # fused launch on permutation parents (no fallback draws).
            walk = {k: v for k, v in kw.items() if k not in ("obj_id", "coords", "penalty")}
            r["walk_only_ms"] = cuda_ms(
                lambda: fs.deme_breed(g, ranks, geom, 0, seed=seed, out=out, **walk), 20)
            perm = torch.argsort(torch.rand((geom.Pp, L), generator=gen, device=device), dim=1)
            perm = (perm.to(torch.float32) + 0.5) / L
            r["permutation_parents_ms"] = cuda_ms(
                lambda: fs.deme_breed(perm, ranks, geom, 0, seed=seed, out=out, **kw), 20)
        results[shape] = r
        print(json.dumps({"phase": "tsp_compare", "shape": shape, "P": P, "L": L,
                          "fused": fused, "genomes_equal": True, "score_rtol": TSP_RTOL,
                          "kernel_ms": ms, "ms_over_bound": ms / bound_ms, **r}), flush=True)


def tour(genome):
    """(cities, duplicate genes) of one genome (a tensor or an array)."""
    import torch

    from libpga_tpu_torch.objectives.classic import duplicate_genes, tsp_cities

    cities = tsp_cities(torch.as_tensor(genome)[None])
    return cities[0].cpu().numpy(), int(duplicate_genes(cities)[0])


def phase_tsp_run(port, kernels, results):
    """PGA.run of the TSP path through the pga_* API at both shapes."""
    import torch

    from libpga_tpu_torch.ops.crossover import order_preserving_crossover
    from libpga_tpu_torch.ops.mutate import make_swap_mutate

    for shape, (P, L) in TSP_SHAPES.items():
        tsp = tsp_objective(shape)
        pga = port.pga_init(seed=1)
        h = port.pga_create_population(pga, P, L)
        port.pga_set_objective_function(pga, tsp)
        port.pga_set_crossover_function(pga, order_preserving_crossover)
        port.pga_set_mutate_function(pga, make_swap_mutate(0.5))
        check(pga.uses_deme_kernel(P, L), f"tsp {shape}: not on the deme path")
        start = tsp.rows(pga.population(h).genomes)
        start_best = float(start.max())
        _, start_dups = tour(pga.population(h).genomes[int(torch.argmax(start))])
        gens = TSP_RUN_GENS[shape]
        check(port.pga_run(pga, WARMUP_GENS) == WARMUP_GENS, f"tsp {shape}: warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        ran = port.pga_run(pga, gens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        genome, best = pga.get_best_with_score(h)
        cities, dups = tour(genome)
        line = {"phase": "tsp_run", "shape": shape, "P": P, "L": L, "gens": ran,
                "launches": launches, "gens_per_s": ran / seconds,
                "ms_per_gen": 1e3 * seconds / ran,
                "kernel_ms_per_gen": results[shape]["ms"],
                "start_best": start_best, "best": best,
                "start_best_duplicates": start_dups, "best_duplicates": dups,
                "best_distinct_cities": L - dups}
        if shape == "main":
            line["best_tour_length"] = -(best + tsp.penalty * dups)
        else:
            from libpga_tpu_torch.objectives import random_tsp_matrix

            m = random_tsp_matrix(L, seed=7)
            line.update(best_tour_length=float(m[cities[:-1], cities[1:]].sum()),
                        planted_path_length=10.0 * (L - 1))
        print(json.dumps(line), flush=True)
        check(ran == gens, f"tsp {shape}: ran {ran} generations")
        check(launches["order"] == gens and sum(launches.values()) == gens,
              f"tsp {shape}: launches {launches} for {gens} generations")
        check(best > start_best, f"tsp {shape}: best {start_best} -> {best}")
        if shape == "main":
            check(dups < start_dups, f"tsp main: duplicates {start_dups} -> {dups}")
            results[shape]["launches"] = launches["order"]
            print(json.dumps({"phase": "tsp_profile", "shape": shape, "P": P, "L": L,
                              **profile_generations(port, pga, 1e3 * seconds / ran)}), flush=True)
        else:
            check(dups == 0, f"tsp reference: best tour visits {L - dups} of {L} cities")
            results[shape]["launches"] = launches["order"]
        port.pga_deinit(pga)


def phase_fused_objectives(fs, device, results):
    """The deme-breed kernel's in-kernel sphere, rastrigin and ackley
    scores against the plain version, in both row-map layouts."""
    import torch

    from libpga_tpu_torch import objectives as obj

    for layout, (P, L) in FUSED_SHAPES.items():
        geom = fs.resolve_geometry(P, L)
        check(geom.layout == layout, f"fused {P}x{L}: layout {geom.layout}")
        gen = torch.Generator(device=device).manual_seed(P)
        g, s = population(geom, gen, device)
        ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(gen, geom.Pp, device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        errs = {}
        for name in ("sphere", "rastrigin", "ackley"):
            o = obj.get(name)
            kw = dict(mparams=torch.tensor([0.05, 0.0], device=device), obj_id=o.fused_id)
            got = fs.deme_breed(g, ranks, geom, 0, seed=seed, **kw)
            want = fs.deme_breed_reference(
                g, ranks, geom, 0, fs.philox_draws(seed, geom.G, geom.K, L), **kw)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]), f"fused {name} {layout}: genomes differ")
            check(bool(torch.isinf(got[1][P:]).all()), f"fused {name} {layout}: pad scores")
            a, b = got[1][:P], want[1][:P]
            rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
            check(bool(torch.isclose(a, b, rtol=FUSED_RTOL, atol=0.0).all()),
                  f"fused {name} {layout}: score rel error {rel}")
            rows = o(got[0][:P])
            check(bool(torch.isclose(a, rows, rtol=FUSED_RTOL, atol=0.0).all()),
                  f"fused {name} {layout}: kernel score against the rowwise form")
            errs[name] = rel
        results[layout]["fused_objective_rel_err"] = errs
        print(json.dumps({"phase": "fused_objectives", "layout": layout, "shape": [P, L],
                          "genomes_equal": True, "max_rel_err": errs, "rtol": FUSED_RTOL}),
              flush=True)


def multigen_draws(fs, geom, steps, gen, device):
    """Random injected draws of ``steps`` sub-generations."""
    import torch

    G, K, L, T = geom.G, geom.K, geom.L, max(steps, 1)
    return fs.Draws(
        sel_u=torch.rand((T, G, K, 2), generator=gen, device=device),
        cross=(torch.rand((T, G, K, L), generator=gen, device=device) < 0.5).to(torch.uint8),
        mut_u=torch.rand((T, G, K, 4), generator=gen, device=device),
        tie=torch.randint(0, 2**32, (T, G, K), generator=gen, device=device),
    )


def mg_route(kernels, geom, dtype, kw) -> dict:
    """The schedule a multi-generation launch of these keywords takes at
    ``geom``, read from the built unit as its wrapper reads it: with
    expression hooks expr_multigen_kernel's route (csrc/expr_plan.cuh's
    expr_mg_plan: the cluster's C, rows a block and the rows of L floats a
    child keeps, or the one-block schedule: order crossover, L % 4 != 0,
    a group no cluster holds); else multigen_breed_kernel's (csrc/
    mg_plan.cuh: the cluster's C and rows a block, or the one-block
    schedule)."""
    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.ops import fused_step as fs

    cross, mut = kw.get("crossover", "uniform"), kw.get("mutate", "point")
    expr = fs.is_expression(cross) or fs.is_expression(mut) or kw.get("objective") is not None
    if expr:
        program = expr_cuda.program_for(cross if fs.is_expression(cross) else None,
                                        mut if fs.is_expression(mut) else None,
                                        kw.get("objective"))
        mut_id = 0 if fs.is_expression(mut) else kernels.MUTATE_IDS[mut]
        plan = (None if cross == "order"
                else kernels.expr_multigen_plan(program, geom, dtype, mut_id))
    else:
        plan = kernels.multigen_cluster_plan(geom, dtype, cross)
    kernel = "expr_multigen" if expr else "multigen"
    if plan is None:
        return {"route": "one_block", "kernel": kernel}
    return {"route": "cluster", "kernel": kernel, "C": plan.C, "rows_per_block": plan.rows,
            "smem_per_block": plan.smem,
            **({"child_rows": plan.child_rows} if expr else {})}


def same_schedules(fs, got, g, s, geom, parity, steps, target, tag, **kw):
    """The one-block schedule's launch of the same inputs (cluster=False),
    held against ``got`` (the cluster schedule's): children and scores bit
    for bit."""
    import torch

    old = fs.multigen_breed(g, s, geom, parity, steps, target, cluster=False, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got[0], old[0]) and torch.equal(got[1], old[1]),
          f"{tag}: the cluster and one-block schedules differ")


def phase_multigen_compare(fs, kernels, device, results):
    """The multigen kernel against its plain version; times the kernel
    over a sweep of step counts and the plain version at 3 steps."""
    import torch

    from libpga_tpu_torch import objectives as obj

    # (case, P, L, parity, steps, elitism, target, objective)
    cases = [
        ("riffle-1M", 1 << 20, 100, 0, 3, 0, None, "onemax"),
        ("riffle-40k-steps0", 40_000, 100, 0, 0, 0, None, "onemax"),
        ("riffle-40k-steps1", 40_000, 100, 0, 1, 0, None, "onemax"),
        ("riffle-40k-steps3", 40_000, 100, 0, 3, 0, None, "onemax"),
        ("riffle-40k-steps8", 40_000, 100, 0, 8, 0, None, "onemax"),
        ("riffle-40k-elitism2", 40_000, 100, 0, 3, 2, None, "onemax"),
        ("riffle-40k-target", 40_000, 100, 0, 3, 0, 58.0, "onemax"),
        ("riffle-40k-bits", 40_000, 100, 0, 3, 0, 63.0, "onemax_bits"),
        ("pingpong0-512k", 524_288, 100, 0, 3, 0, None, "onemax"),
        ("pingpong1-512k", 524_288, 100, 1, 3, 0, None, "onemax"),
        ("pingpong1-512k-target-elitism2", 524_288, 100, 1, 3, 2, 67.0, "onemax_bits"),
        ("pingpong0-padded", 1000, 100, 0, 3, 0, None, "onemax"),
        ("pingpong1-padded", 1000, 100, 1, 3, 0, None, "onemax"),
    ]
    mparams = torch.tensor([0.05, 0.0], device=device)
    for name, P, L, parity, steps, e, target, oname in cases:
        o = obj.get(oname)
        geom = fs.resolve_geometry(P, L, multigen=True, elitism=e)
        check(geom.layout == name.split("-")[0].rstrip("01"), f"{name}: layout {geom.layout}")
        gen = torch.Generator(device=device).manual_seed(P + parity + steps)
        g, _ = population(geom, gen, device)
        s = torch.full((geom.Pp,), -torch.inf, device=device)
        s[:P] = o(g[:P])
        kw = dict(mparams=mparams, obj_id=o.fused_id, elitism=e)
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        tgt = float("inf") if target is None else target
        errs, frozen = [], None
        route = mg_route(kernels, geom, torch.float32, kw)
        for mode in (dict(draws=multigen_draws(fs, geom, steps, gen, device)), dict(seed=seed)):
            got = fs.multigen_breed(g, s, geom, parity, steps, target, **mode, **kw)
            want = fs.multigen_breed_reference(g, s, geom, parity, steps, tgt, **mode, **kw)
            torch.cuda.synchronize()
            tag = f"{name} {'injected' if 'draws' in mode else 'philox'}"
            same_schedules(fs, got, g, s, geom, parity, steps, target, tag, **mode, **kw)
            check(torch.equal(got[0], want[0]), f"{tag}: genomes differ")
            check(torch.equal(torch.isinf(got[1]), torch.isinf(want[1]))
                  and bool(torch.isinf(got[1][P:]).all()), f"{tag}: -inf rows differ")
            fin = torch.isfinite(want[1])
            err = float((got[1][fin] - want[1][fin]).abs().max())
            check(err <= SCORE_ATOL, f"{tag}: score error {err}")
            errs.append(err)
            if target is not None:
                read, _ = geom.row_maps(parity, device)
                best = torch.where(read < P, s[read], -torch.inf).reshape(geom.S, -1).amax(dim=1)
                frozen = int((best >= target).sum())
                check(0 < frozen < geom.S, f"{tag}: {frozen} of {geom.S} groups frozen at entry")
            if steps:
                check(not torch.equal(got[0], g), f"{tag}: nothing bred")
        print(json.dumps({"phase": "multigen_compare", "case": name, "shape": [P, L],
                          "layout": geom.layout, "K": geom.K, "D": geom.D, "S": geom.S,
                          **route, "same_as_one_block": True,
                          "Pp": geom.Pp, "steps": steps, "elitism": e, "target": target,
                          "groups_frozen_at_entry": frozen, "objective": oname,
                          "genomes_equal": True, "scores_equal": max(errs) == 0.0,
                          "max_abs_err": max(errs), "score_atol": SCORE_ATOL}), flush=True)
        r = results.setdefault(geom.layout, {})
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), max(errs))

    # Rastrigin: cosf on the card against torch.cos. One step is gated;
    # three steps are reported (a last-bit score difference can swap two
    # ranks, after which the genomes differ).
    P, L = 40_000, 100
    geom = fs.resolve_geometry(P, L, multigen=True)
    gen = torch.Generator(device=device).manual_seed(5)
    g, _ = population(geom, gen, device)
    s = torch.full((geom.Pp,), -torch.inf, device=device)
    s[:P] = obj.rastrigin(g[:P])
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
    kw = dict(seed=seed, mparams=mparams, obj_id=obj.rastrigin.fused_id)
    line = {"phase": "multigen_compare", "case": "riffle-40k-rastrigin", "shape": [P, L]}
    for steps in (1, 3):
        got = fs.multigen_breed(g, s, geom, 0, steps, None, **kw)
        want = fs.multigen_breed_reference(g, s, geom, 0, steps, float("inf"), **kw)
        torch.cuda.synchronize()
        rows_equal = float((got[0] == want[0]).all(dim=1).float().mean())
        a, b = got[1][:P], want[1][:P]
        rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
        line[f"steps{steps}"] = {"rows_equal_share": rows_equal, "score_max_rel_err": rel,
                                 "scores_equal_share": float((a == b).float().mean())}
        if steps == 1:
            check(rows_equal == 1.0, "multigen rastrigin, 1 step: genomes differ")
            check(bool(torch.isclose(a, b, rtol=FUSED_RTOL, atol=0.0).all()),
                  f"multigen rastrigin, 1 step: score rel error {rel}")
    print(json.dumps(line), flush=True)

    # Times, at the shapes multigen_run drives.
    for layout, shapes in MULTIGEN_RUN_SHAPES.items():
        for P, L in shapes:
            geom = fs.resolve_geometry(P, L, multigen=True)
            gen = torch.Generator(device=device).manual_seed(P)
            g, s = population(geom, gen, device)
            seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
            kw = dict(seed=seed, mparams=mparams, obj_id=obj.onemax.fused_id)
            out = torch.empty_like(g)
            work = [torch.empty_like(g), torch.empty_like(g)]
            reps = 10 if P > 100_000 else 50
            route = mg_route(kernels, geom, torch.float32, kw)
            check(route["route"] == "cluster", f"multigen {P}x{L}: {route}")
            sweep = {}
            for T in MULTIGEN_SWEEP:
                ms = cuda_ms(lambda: fs.multigen_breed(
                    g, s, geom, 0, T, None, out=out, **kw), reps)
                bound_ms, bound_by, _ = breed_bound(geom, steps=T)
                sweep[T] = {"ms": ms, "ms_per_gen": ms / T, "bound_ms": bound_ms,
                            "bound_by": bound_by}
            # The one-block schedule at the same geometry (its work buffers).
            one_block = {T: cuda_ms(lambda: fs.multigen_breed(
                g, s, geom, 0, T, None, out=out, work=work, cluster=False, **kw), reps)
                for T in (1, MULTIGEN_T)}
            plain = {T: cuda_ms(lambda: fs.multigen_breed_reference(
                g, s, geom, 0, T, float("inf"), **kw), 2) for T in (3, MULTIGEN_T)}
            print(json.dumps({"phase": "multigen_times", "shape": [P, L], "layout": geom.layout,
                              "K": geom.K, "D": geom.D, "S": geom.S, **route,
                              "kernel_by_steps": sweep, "one_block_ms_by_steps": one_block,
                              "plain_ms_by_steps": plain}),
                  flush=True)
            results[layout].setdefault("shapes", {})[P] = dict(
                ms=sweep[MULTIGEN_T]["ms"], bound_ms=sweep[MULTIGEN_T]["bound_ms"],
                bound_by=sweep[MULTIGEN_T]["bound_by"], plain_ms=plain[MULTIGEN_T],
                plain_ms_at_3_steps=plain[3], one_block_ms=one_block[MULTIGEN_T],
                ms_by_steps={T: v["ms"] for T, v in sweep.items()}, **route)


def multigen_solver(port, P, L, T, seed=1):
    """A OneMax solver through the pga_* API at T generations per launch
    (None: the default, one)."""
    pga = port.pga_init(seed=seed, config=port.PGAConfig(generations_per_launch=T))
    h = port.pga_create_population(pga, P, L)
    port.pga_set_objective_function(pga, "onemax")
    return pga, h


def timed_run(port, pga, gens):
    """(generations run, seconds) of one pga_run, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ran = port.pga_run(pga, gens)
    torch.cuda.synchronize()
    return ran, time.perf_counter() - t0


def phase_multigen_run(port, kernels, results):
    """PGA.run with generations_per_launch=8 through the pga_* API."""
    import torch

    T = MULTIGEN_T
    for layout, shapes in MULTIGEN_RUN_SHAPES.items():
        for P, L in shapes:
            pga, h = multigen_solver(port, P, L, T)
            start_best = float(pga.population(h).genomes.sum(dim=1).max())
            check(port.pga_run(pga, T) == T, "multigen warm-up")
            kernels.reset_launches()
            gens, seconds = timed_run(port, pga, RUN_GENS)
            launches = dict(kernels.LAUNCHES)
            _, best = pga.get_best_with_score(h)
            pop = pga.population(h)
            check(gens == RUN_GENS, f"multigen {P}: ran {gens} generations")
            check(launches["multigen"] == RUN_GENS // T and sum(launches.values()) == RUN_GENS // T,
                  f"multigen {P}: launches {launches} for {gens} generations at T={T}")
            check(kernels.CLUSTER_LAUNCHES == {"multigen": RUN_GENS // T},
                  f"multigen {P}: cluster-schedule launches {kernels.CLUSTER_LAUNCHES}")
            check(best > start_best + 10.0 and best < L, f"multigen {P}: best {start_best} -> {best}")
            check(bool(torch.isclose(pop.scores, pop.genomes.sum(dim=1), rtol=0, atol=SCORE_ATOL).all()),
                  f"multigen {P}: scores are not the genomes' onemax")
            # The same run at one generation per launch, in the same call.
            one, _ = multigen_solver(port, P, L, None)
            port.pga_run(one, WARMUP_GENS)
            gens1, seconds1 = timed_run(port, one, RUN_GENS)
            port.pga_deinit(one)
            shape_r = results[layout]["shapes"][P]
            line = {"phase": "multigen_run", "layout": layout, "shape": [P, L],
                    "generations_per_launch": T, "gens": gens, "launches": launches,
                    "gens_per_s": gens / seconds, "ms_per_gen": 1e3 * seconds / gens,
                    "one_per_launch_gens_per_s": gens1 / seconds1,
                    "one_per_launch_ms_per_gen": 1e3 * seconds1 / gens1,
                    "kernel_ms_per_launch": shape_r["ms"],
                    "bound_ms_per_launch": shape_r["bound_ms"],
                    "start_best": start_best, "best": best}
            print(json.dumps(line), flush=True)
            shape_r.update(launches=launches["multigen"], ms_per_gen=line["ms_per_gen"],
                           one_per_launch_ms_per_gen=line["one_per_launch_ms_per_gen"])
            print(json.dumps({"phase": "multigen_profile", "layout": layout, "shape": [P, L],
                              "generations_per_launch": T, **profile_generations(
                                  port, pga, 1e3 * seconds / gens, MULTIGEN_PROFILE_GENS)}),
                  flush=True)
            port.pga_deinit(pga)

    # 203 generations land on 203: 25 launches of 8 and one of 3.
    P, L = MAIN_SHAPES["riffle"]
    pga, _ = multigen_solver(port, P, L, T)
    kernels.reset_launches()
    gens = port.pga_run(pga, 203)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(json.dumps({"phase": "multigen_remainder", "shape": [P, L], "gens": gens,
                      "launches": launches, "solver_launches": pga.launches}), flush=True)
    check(gens == 203 and launches["multigen"] == 26 and pga.launches == 26
          and sum(launches.values()) == 26, f"multigen remainder: {gens} generations, {launches}")
    port.pga_deinit(pga)

    # Target: the stop is seen once per launch; the achiever is kept.
    target = 70.0
    pga, h = multigen_solver(port, P, L, T, seed=2)
    gens = port.pga_run(pga, 10_000, target=target)
    best = pga.get_best_with_score(h)[1]
    earlier, h2 = multigen_solver(port, P, L, T, seed=2)
    port.pga_run(earlier, gens - T)
    prev = earlier.get_best_with_score(h2)[1]
    print(json.dumps({"phase": "multigen_target", "shape": [P, L], "target": target,
                      "generations_per_launch": T, "gens": gens, "best": best,
                      "best_one_launch_earlier": prev}), flush=True)
    check(0 < gens < 10_000 and gens % T == 0 and best >= target > prev,
          f"multigen target: {gens} generations, best {best}, a launch earlier {prev}")
    port.pga_deinit(pga)
    port.pga_deinit(earlier)

    # Generations per launch, up and then down the sweep, in one process.
    for P, L in (MAIN_SHAPES["riffle"], MAIN_SHAPES["pingpong"]):
        readings = {T: [] for T in MULTIGEN_SWEEP}
        for T in MULTIGEN_SWEEP + MULTIGEN_SWEEP[::-1]:
            pga, _ = multigen_solver(port, P, L, T)
            port.pga_run(pga, max(T, WARMUP_GENS))
            gens, seconds = timed_run(port, pga, RUN_GENS)
            check(gens == RUN_GENS, f"multigen sweep T={T}: ran {gens}")
            readings[T].append(1e3 * seconds / gens)
            port.pga_deinit(pga)
        print(json.dumps({"phase": "multigen_sweep", "shape": [P, L], "gens": RUN_GENS,
                          "ms_per_gen_by_generations_per_launch": readings,
                          "gens_per_s": {T: [1e3 / v for v in r] for T, r in readings.items()}}),
              flush=True)


def expr_workloads():
    """name -> (P, L, objective, crossover, mutate) of the expression
    slice, as PGA.run gets them; crossover / mutate None are the
    defaults (uniform, point at the config's rate)."""
    from libpga_tpu_torch import objectives as obj
    from libpga_tpu_torch.ops import crossover as cx
    from libpga_tpu_torch.ops.breed_expr import mutate_from_expression

    return {
        "nk": (1 << 22, 64, obj.make_nk_landscape(64, 3, seed=0), None, None),
        "trap": (1 << 20, 60, obj.make_deceptive_trap(5), None, None),
        "knapsack": (4096, 6, obj.default_knapsack, None, None),
        "one_point": (1 << 20, 100, obj.onemax, cx.one_point_crossover, None),
        "arithmetic": (1 << 20, 100, obj.onemax, cx.arithmetic_crossover, None),
        "creep": (1 << 20, 100, obj.onemax, None,
                  mutate_from_expression(CREEP, rate=0.05, sigma=0.1)),
    }


def expr_kinds(port, objective, crossover, mutate):
    """The deme kernel's kinds for these operators, as the solver routes
    them: (crossover kind, mutate kind, mparams, expression objective,
    builtin objective id)."""
    pga = port.PGA(seed=0, config=port.PGAConfig(device="cpu"))
    pga.set_objective(objective)
    pga.set_crossover(crossover)
    pga.set_mutate(mutate)
    expr_obj = getattr(objective, "expr_fused", None)
    return (pga._crossover_kind(), pga._mutate_kind(), pga._mutate_params(), expr_obj,
            0 if expr_obj is not None else getattr(objective, "fused_id", 0))


def expr_programs(port):
    """The generated units of every workload with an expression hook (and
    of the tour with the creep mutation, which order_expr_compare runs),
    for the build."""
    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
    from libpga_tpu_torch.ops.fused_step import is_expression

    progs = []
    order = order_workloads()
    tour_creep = (order["tour"][0], order["tour"][1],
                  mutate_from_expression(CREEP, rate=0.05, sigma=0.1))
    loads = [*expr_workloads().values(), *expr_multigen_workloads().values(),
             *((None, None, *w) for w in (*order.values(), tour_creep))]
    for P, L, objective, crossover, mutate in loads:
        c, m, _, o, _ = expr_kinds(port, objective, crossover, mutate)
        if not (is_expression(c) or is_expression(m) or o is not None):
            continue
        prog = expr_cuda.program_for(
            c if is_expression(c) else None, m if is_expression(m) else None, o)
        if all(prog is not q for q in progs):
            progs.append(prog)
    return progs


def _ulps(a, b):
    import torch

    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(2**31) - i, i)

    return (key(a) - key(b)).abs()


def expr_counter(kernels, counter, program, geom, dtype, mutate) -> str:
    """The launch counter of a one-generation expression breed
    (``counter``: an ``expr_breed_kernel`` counter, "expr", "islands_expr"
    or "ablate_expr", with "_bf16"): its "expr_pipelined" twin where
    ``kernels.expr_breed_cuda`` routes the shape to
    ``expr_pipelined_kernel`` (``kernels.expr_pipelined_holds``, from the
    shape alone), else ``counter``."""
    mut_id = 0 if callable(mutate) else kernels.MUTATE_IDS[mutate]
    if kernels.expr_pipelined_holds(program, geom, dtype, mut_id):
        return counter.replace("expr", "expr_pipelined", 1)
    return counter


def against_expr_breed(got, old, transcendental: bool, tag: str) -> int:
    """``expr_pipelined_kernel``'s (children, scores) ``got`` against
    ``expr_breed_kernel``'s ``old`` on the same inputs: children bit for
    bit (within 2 ulp where a hook calls a transcendental, whose code nvcc
    may inline differently), scores bit for bit (where the children are).
    Returns the children's largest distance in ulp."""
    import torch

    torch.cuda.synchronize()
    if got[0].dtype == torch.float32:
        ulps = int(_ulps(got[0], old[0]).max())
    else:
        ulps = 0 if torch.equal(got[0], old[0]) else 3
    check(ulps == 0 or (transcendental and ulps <= 2),
          f"{tag}: children {ulps} ulp from expr_breed_kernel's")
    if ulps == 0 and got[1] is not None:
        check(torch.equal(got[1], old[1]), f"{tag}: scores differ from expr_breed_kernel's")
    return ulps


def phase_expr_compare(port, fs, device, results):
    """The expression breed against its plain version on the same inputs,
    injected and Philox draws, every row map; times both at the
    workloads' shapes. Where the shape routes to ``expr_pipelined_kernel``
    it is also held against ``expr_breed_kernel`` on the same inputs
    (children and scores bit for bit) and both are timed."""
    import torch

    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.ops.fused_step import is_expression

    loads = expr_workloads()
    # (case, workload, P, L, parity, layout expected, timed)
    cases = [
        ("nk-4M", "nk", None, None, 0, "riffle", True),
        ("nk-padded", "nk", 1000, 64, 1, "pingpong", False),
        ("trap-1M-p0", "trap", None, None, 0, "pingpong", True),
        ("trap-1M-p1", "trap", None, None, 1, "pingpong", False),
        ("knapsack", "knapsack", None, None, 0, "pingpong", True),
        ("one_point-1M-p0", "one_point", None, None, 0, "pingpong", True),
        ("one_point-1M-p1", "one_point", None, None, 1, "pingpong", False),
        ("arithmetic-1M-p1", "arithmetic", None, None, 1, "pingpong", True),
        ("creep-1M-p0", "creep", None, None, 0, "pingpong", True),
        ("creep-40k-riffle", "creep", 40_000, 100, 0, "riffle", False),
        ("one_point-padded", "one_point", 1000, 100, 1, "pingpong", False),
    ]
    for name, load, P, L, parity, want_layout, timed in cases:
        P0, L0, objective, crossover, mutate = loads[load]
        P, L = P or P0, L or L0
        cross, mut, mparams, expr_obj, obj_id = expr_kinds(port, objective, crossover, mutate)
        program = expr_cuda.program_for(cross if is_expression(cross) else None,
                                        mut if is_expression(mut) else None, expr_obj)
        geom = fs.resolve_geometry(P, L, crossover=cross, const_carrying=bool(
            getattr(expr_obj, "kernel_rowwise_consts", ())))
        check(geom.layout == want_layout, f"expr {name}: layout {geom.layout}")
        gen = torch.Generator(device=device).manual_seed(P + L + parity)
        g = torch.rand((geom.Pp, L), generator=gen, device=device)
        g[P:] = 0.0
        s = torch.full((geom.Pp,), -torch.inf, device=device)
        s[:P] = objective(g[:P])
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, device))
        kw = dict(crossover=cross, mutate=mut, obj_id=obj_id, objective=expr_obj,
                  mparams=torch.tensor(list(mparams), dtype=torch.float32, device=device))
        injected = fs.zero_draws(geom.G, geom.K, L, mut, device, cross)
        injected.sel_u = torch.rand(injected.sel_u.shape, generator=gen, device=device)
        injected.mut_u = torch.rand(injected.mut_u.shape, generator=gen, device=device)
        injected.cross = (torch.rand((geom.G, geom.K, L), generator=gen, device=device) < 0.5).to(torch.uint8)
        if injected.expr_gene is not None:
            injected.expr_gene = torch.rand(injected.expr_gene.shape, generator=gen, device=device)
            injected.expr_row = torch.rand(injected.expr_row.shape, generator=gen, device=device)
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        counter = expr_counter(fs.kernels, "expr", program, geom, torch.float32, mut)
        pipelined = counter == "expr_pipelined"
        errs, ulps, old_ulps = [], 0, 0
        for mode, draws in (("injected", injected), ("philox", None)):
            x = dict(seed=seed) if draws is None else dict(draws=draws)
            before = fs.kernels.LAUNCHES[counter]
            got = fs.deme_breed(g, ranks, geom, parity, **x, **kw)
            check(fs.kernels.LAUNCHES[counter] == before + 1, f"expr {name}: not on {counter}")
            if pipelined:
                old_ulps = max(old_ulps, against_expr_breed(
                    got, fs.deme_breed(g, ranks, geom, parity, pipelined=False, **x, **kw),
                    program.transcendental, f"expr {name} {mode}"))
            if draws is None:
                draws = fs.philox_draws(seed, geom.G, geom.K, L, mut, cross)
            want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
            torch.cuda.synchronize()
            if program.transcendental:
                ulps = max(ulps, int(_ulps(got[0], want[0]).max()))
                check(ulps <= 2, f"expr {name} {mode}: genomes {ulps} ulp apart")
            else:
                check(torch.equal(got[0], want[0]), f"expr {name} {mode}: genomes differ")
            real = torch.arange(geom.Pp, device=device) < P
            check(bool(torch.isinf(got[1][~real]).all()), f"expr {name} {mode}: pad scores not -inf")
            a, b = got[1][real], want[1][real]
            close = torch.isclose(a, b, rtol=EXPR_RTOL, atol=EXPR_ATOL_PER_GENE * L)
            err = float((a - b).abs().max())
            check(bool(close.all()), f"expr {name} {mode}: score error {err}")
            errs.append(err)
            del draws, want, got
        line = {"phase": "expr_compare", "case": name, "workload": load, "shape": [P, L],
                "parity": parity, "layout": geom.layout, "K": geom.K, "D": geom.D, "Pp": geom.Pp,
                "genomes_equal": ulps == 0, "genome_max_ulps": ulps, "max_abs_err": max(errs),
                "score_rtol": EXPR_RTOL, "score_atol": EXPR_ATOL_PER_GENE * L,
                "obj_rows": program.obj_rows, "warps_per_block": fs.kernels.expr_warps(
                    geom.K, L, program.obj_rows), "kernel": counter,
                "expr_breed_max_ulps": old_ulps if pipelined else None}
        if pipelined:
            plan = fs.kernels.expr_pipelined_plan(program, geom, torch.float32,
                                                  0 if callable(mut) else fs.kernels.MUTATE_IDS[mut])
            line.update(C=plan.C, child_rows=plan.child_rows, smem=plan.smem)
        r = results.setdefault(load, {})
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), max(errs))
        if timed:
            out = torch.empty_like(g)
            ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, parity, seed=seed, out=out, **kw), 20)
            old_ms = (cuda_ms(lambda: fs.deme_breed(g, ranks, geom, parity, seed=seed, out=out,
                                                    pipelined=False, **kw), 20)
                      if pipelined else None)
            plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
                g, ranks, geom, parity, fs.philox_draws(seed, geom.G, geom.K, L, mut, cross), **kw), 3)
            bound_ms, bound_by, _ = breed_bound(geom, program=program)
            line.update(kernel_ms=ms, expr_breed_ms=old_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, ms_over_bound=ms / bound_ms)
            r.update(ms=ms, expr_breed_ms=old_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, shape=[P, L], layout=geom.layout, K=geom.K, D=geom.D,
                     counter=counter)
        print(json.dumps(line), flush=True)
        del g, s, ranks, injected
        torch.cuda.empty_cache()


def phase_expr_pipelined_floor():
    """The floor the expression breed's pipelined kernel starts from:
    ``deme_pipelined_kernel`` (builtin hooks) at the B = 1 geometries of
    the expression cells beside ``deme_breed_kernel``, ``index_select`` of
    the rows and the bound (``tools/pipelined_variants.b1_floor``, two
    rounds; the two kernels first held equal bit for bit)."""
    from libpga_tpu_torch.tools import pipelined_variants

    t0 = time.perf_counter()
    shapes = pipelined_variants.b1_floor(rounds=2, reps=20)
    print(json.dumps({"phase": "expr_pipelined_step0", "shapes": shapes,
                      "seconds": time.perf_counter() - t0}), flush=True)


def phase_expr_runs(port, kernels, results):
    """PGA.run of every expression workload through the pga_* API, and the
    builtin uniform/point OneMax run beside the operator runs."""
    import torch

    loads = expr_workloads()
    for name, (P, L, objective, crossover, mutate) in loads.items():
        phase = {"nk": "nk_run", "trap": "trap_run", "knapsack": "knapsack_run"}.get(name, "expr_ops_run")
        gens = EXPR_GENS.get(name, EXPR_GENS["ops"])
        pga = port.pga_init(seed=11)
        h = port.pga_create_population(pga, P, L)
        port.pga_set_objective_function(pga, objective)
        port.pga_set_crossover_function(pga, crossover)
        port.pga_set_mutate_function(pga, mutate)
        check(pga.uses_deme_kernel(P, L), f"{name}: not on the deme path")
        start_best = float(objective(pga.population(h).genomes).max())
        check(port.pga_run(pga, 2) == 2, f"{name}: warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        ran = port.pga_run(pga, gens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        genome, best = pga.get_best_with_score(h)
        line = {"phase": phase, "workload": name, "shape": [P, L], "gens": ran,
                "launches": launches, "gens_per_s": ran / seconds, "ms_per_gen": 1e3 * seconds / ran,
                "kernel_ms_per_gen": results[name].get("ms"), "start_best": start_best,
                "best": best, "best_rescored": float(objective(torch.as_tensor(genome, device=pga.device)[None])[0])}
        if name == "knapsack":
            line.update(optimum=285.0, best_counts=[int(x) for x in (genome * 2.0).astype("int64")])
        print(json.dumps(line), flush=True)
        counter = results[name]["counter"]
        check(ran == gens, f"{name}: ran {ran} generations")
        check(launches[counter] == gens and sum(launches.values()) == gens,
              f"{name}: launches {launches} for {gens} generations of {counter}")
        check(math.isfinite(best) and abs(line["best_rescored"] - best) <= EXPR_ATOL_PER_GENE * L
              + EXPR_RTOL * abs(best), f"{name}: best {best} is not its genome's score")
        if name in ("nk", "trap"):
            check(best > start_best, f"{name}: best {start_best} -> {best}")
        results[name]["launches"] = launches[counter]
        results[name]["ms_per_gen"] = line["ms_per_gen"]
        if name != "knapsack":
            # As many generations as the timed run: each pga_run scores its
            # initial population once, so both windows carry that share.
            prof = profile_generations(port, pga, 1e3 * seconds / ran, gens)
            results[name]["device_busy_share"] = prof["device_busy_share"]
            print(json.dumps({"phase": f"{phase}_profile", "workload": name, "shape": [P, L],
                              **prof}), flush=True)
        port.pga_deinit(pga)
        del pga
        torch.cuda.empty_cache()

    # The builtin uniform/point OneMax run at the operators' shape.
    P, L = 1 << 20, 100
    pga = port.pga_init(seed=11)
    port.pga_create_population(pga, P, L)
    port.pga_set_objective_function(pga, "onemax")
    port.pga_run(pga, 2)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ran = port.pga_run(pga, EXPR_GENS["ops"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    print(json.dumps({"phase": "expr_ops_run", "workload": "builtin_uniform_point", "shape": [P, L],
                      "gens": ran, "launches": launches, "gens_per_s": ran / seconds,
                      "ms_per_gen": 1e3 * seconds / ran,
                      "best": pga.get_best_with_score(port.PopulationHandle(0))[1]}), flush=True)
    check(launches["deme_pipelined"] == ran and sum(launches.values()) == ran,
          f"builtin run: launches {launches}")
    port.pga_deinit(pga)


def expr_multigen_workloads():
    """name -> (P, L, objective, crossover, mutate) of the expression
    workloads bred at several generations per launch, as PGA.run gets
    them (None: uniform crossover, point mutation); the runs drive those
    of EXPR_MG_GENS, and gauss-40k is compared only."""
    from libpga_tpu_torch import objectives as obj
    from libpga_tpu_torch.ops import crossover as cx
    from libpga_tpu_torch.ops.breed_expr import mutate_from_expression

    creep = mutate_from_expression(CREEP, rate=0.05, sigma=0.1)
    trap = obj.make_deceptive_trap(5)
    return {
        "nk-4M": (1 << 22, 64, obj.make_nk_landscape(64, 3, seed=0), None, None),
        "trap-1M": (1 << 20, 60, trap, None, None),
        "trap-40k": (40_000, 60, trap, None, None),
        "knapsack": (4096, 6, obj.default_knapsack, None, None),
        "creep-40k": (40_000, 100, obj.onemax, None, creep),
        "creep-1M": (1 << 20, 100, obj.onemax, None, creep),
        "one_point-40k": (40_000, 100, obj.onemax, cx.one_point_crossover, None),
        "one_point-1M": (1 << 20, 100, obj.onemax, cx.one_point_crossover, None),
        "gauss-40k": (40_000, 100, obj.onemax, None,
                      mutate_from_expression(GAUSS_EXPR, rate=0.05, sigma=0.1)),
    }


def expr_multigen_draws(fs, geom, steps, mut, cross, gen, device):
    """Random injected draws of ``steps`` sub-generations, the expression
    planes and row words included where the hooks read them."""
    import torch

    z = fs.zero_draws(geom.G, geom.K, geom.L, mut, device, cross, steps=max(steps, 1))

    def rand(t):
        return torch.rand(t.shape, generator=gen, device=device)

    z.sel_u, z.mut_u = rand(z.sel_u), rand(z.mut_u)
    z.cross = torch.randint(0, 2, z.cross.shape, generator=gen, device=device, dtype=torch.uint8)
    z.tie = torch.randint(0, 2**32, z.tie.shape, generator=gen, device=device)
    if z.expr_gene is not None:
        z.expr_gene, z.expr_row = rand(z.expr_gene), rand(z.expr_row)
    return z


def phase_expr_multigen_compare(port, fs, device, results):
    """The expression multigen kernel against its plain version on the
    same inputs, injected and Philox draws, every row map, 1, 3 and 8
    steps, per-deme elites and a target that freezes some groups; times
    the kernel at 1 and 8 steps and the plain version at 8 at each
    workload's full shape."""
    import torch

    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.ops.fused_step import is_expression

    loads = expr_multigen_workloads()
    # (case, workload, P, L, parity, steps, elitism, freeze, layout expected);
    # P, L None: the workload's shape, timed; freeze: a target at the
    # median of the groups' entry bests.
    cases = [
        ("nk-4M", "nk-4M", None, None, 0, 8, 0, False, "riffle"),
        ("nk-65k-p1-e2-freeze", "nk-4M", 65_536, 64, 1, 3, 2, True, "pingpong"),
        ("nk-padded-p1", "nk-4M", 1000, 64, 1, 3, 0, False, "pingpong"),
        ("trap-1M", "trap-1M", None, None, 0, 8, 0, False, "riffle"),
        ("trap-40k", "trap-40k", None, None, 0, 8, 0, False, "riffle"),
        ("trap-40k-e2-freeze", "trap-40k", None, None, 0, 3, 2, True, "riffle"),
        ("knapsack", "knapsack", None, None, 0, 8, 0, False, "pingpong"),
        ("knapsack-p1-e2", "knapsack", 4096, 6, 1, 3, 2, False, "pingpong"),
        ("knapsack-p0-steps1", "knapsack", 4096, 6, 0, 1, 0, False, "pingpong"),
        ("creep-40k", "creep-40k", None, None, 0, 8, 0, False, "riffle"),
        ("creep-1M", "creep-1M", None, None, 0, 8, 0, False, "riffle"),
        ("creep-65k-p0-freeze", "creep-1M", 65_536, 100, 0, 3, 0, True, "pingpong"),
        ("one_point-40k", "one_point-40k", None, None, 0, 8, 0, False, "riffle"),
        ("one_point-1M", "one_point-1M", None, None, 0, 8, 0, False, "riffle"),
        ("one_point-40k-e2-steps1", "one_point-40k", 40_000, 100, 0, 1, 2, False, "riffle"),
        ("one_point-padded-p0", "one_point-1M", 1000, 100, 0, 3, 0, False, "pingpong"),
        ("one_point-padded-p1-steps0", "one_point-1M", 1000, 100, 1, 0, 0, False, "pingpong"),
        ("gauss-40k-steps1", "gauss-40k", 40_000, 100, 0, 1, 0, False, "riffle"),
    ]
    for name, load, P, L, parity, steps, e, freeze, want_layout in cases:
        P0, L0, objective, crossover, mutate = loads[load]
        timed = P is None
        P, L = P or P0, L or L0
        cross, mut, mparams, expr_obj, obj_id = expr_kinds(port, objective, crossover, mutate)
        program = expr_cuda.program_for(cross if is_expression(cross) else None,
                                        mut if is_expression(mut) else None, expr_obj)
        geom = fs.resolve_geometry(P, L, crossover=cross, multigen=True, elitism=e,
                                   const_carrying=bool(getattr(expr_obj, "kernel_rowwise_consts", ())))
        check(geom.layout == want_layout, f"expr multigen {name}: layout {geom.layout}")
        if timed:
            check((geom.layout, geom.K, geom.D, geom.S) == EXPR_MG_GEOMETRY[load],
                  f"expr multigen {name}: geometry {geom}")
        gen = torch.Generator(device=device).manual_seed(P + L + parity + steps)
        g = torch.rand((geom.Pp, L), generator=gen, device=device)
        g[P:] = 0.0
        s = torch.full((geom.Pp,), -torch.inf, device=device)
        s[:P] = objective(g[:P])
        kw = dict(crossover=cross, mutate=mut, obj_id=obj_id, elitism=e,
                  mparams=torch.tensor(list(mparams), dtype=torch.float32, device=device))
        if expr_obj is not None:
            kw.update(objective=expr_obj)
        target, frozen = None, None
        if freeze:
            read, _ = geom.row_maps(parity, device)
            best = torch.where(read < P, s[read], -torch.inf).reshape(geom.S, -1).amax(dim=1)
            target = float(best.median())
            frozen = int((best >= target).sum())
            check(0 < frozen < geom.S, f"expr multigen {name}: {frozen} of {geom.S} groups frozen")
        tgt = math.inf if target is None else target
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        errs, ulps = [], 0
        # The cluster schedule wherever its plan holds the group (L a
        # multiple of 4 at these shapes), held against the one-block one.
        route = mg_route(fs.kernels, geom, torch.float32, kw)
        check(route["route"] == ("one_block" if L % 4 else "cluster"),
              f"expr multigen {name}: {route}")
        for mode in (dict(draws=expr_multigen_draws(fs, geom, steps, mut, cross, gen, device)),
                     dict(seed=seed)):
            tag = f"expr multigen {name} {'injected' if 'draws' in mode else 'philox'}"
            got = fs.multigen_breed(g, s, geom, parity, steps, target, **mode, **kw)
            want = fs.multigen_breed_reference(g, s, geom, parity, steps, tgt, **mode, **kw)
            torch.cuda.synchronize()
            check(torch.equal(torch.isinf(got[1]), torch.isinf(want[1]))
                  and bool(torch.isinf(got[1][P:]).all()), f"{tag}: -inf rows differ")
            fin = torch.isfinite(want[1])
            if program.transcendental:
                check(steps <= 1, f"{tag}: transcendental hooks are compared at one step")
                ulps = max(ulps, int(_ulps(got[0], want[0]).max()))
                check(ulps <= 2, f"{tag}: genomes {ulps} ulp apart")
                a, b = got[1][fin], want[1][fin]
                check(bool(torch.isclose(a, b, rtol=EXPR_RTOL, atol=EXPR_ATOL_PER_GENE * L).all()),
                      f"{tag}: score error {float((a - b).abs().max())}")
            else:
                check(torch.equal(got[0], want[0]), f"{tag}: genomes differ")
                check(torch.equal(got[1][fin], want[1][fin]), f"{tag}: scores differ")
            errs.append(float((got[1][fin] - want[1][fin]).abs().max()))
            if steps:
                check(not torch.equal(got[0], g), f"{tag}: nothing bred")
            if route["route"] == "cluster":
                same_schedules(fs, got, g, s, geom, parity, steps, target, tag, **mode, **kw)
            del got, want
        line = {"phase": "expr_multigen_compare", "case": name, "workload": load, "shape": [P, L],
                "parity": parity, "steps": steps, "elitism": e, "target": target,
                "groups_frozen_at_entry": frozen, "layout": geom.layout, "K": geom.K,
                "D": geom.D, "S": geom.S, "Pp": geom.Pp, "genomes_equal": ulps == 0,
                "genome_max_ulps": ulps, "scores_equal": max(errs) == 0.0,
                "max_abs_err": max(errs), "obj_rows": program.obj_rows,
                "same_as_one_block": route["route"] == "cluster",
                "one_block_warps": fs.kernels.expr_warps(geom.K, L, program.obj_rows, D=geom.D),
                **route}
        r = results.setdefault(load, {})
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), max(errs))
        if timed:
            out = torch.empty_like(g)
            work = [torch.empty_like(g), torch.empty_like(g)]
            big = geom.Pp * L > 10_000_000
            ms = {T: cuda_ms(lambda: fs.multigen_breed(
                g, s, geom, 0, T, None, seed=seed, out=out, work=work, **kw), 10 if big else 50)
                for T in (1, EXPR_MG_T)}
            one_block_ms = None
            if route["route"] == "cluster":
                one_block_ms = cuda_ms(lambda: fs.multigen_breed(
                    g, s, geom, 0, EXPR_MG_T, None, seed=seed, out=out, work=work, cluster=False,
                    **kw), 10 if big else 50)
            plain_ms = cuda_ms(lambda: fs.multigen_breed_reference(
                g, s, geom, 0, EXPR_MG_T, math.inf, seed=seed, **kw), 1)
            bound_ms, bound_by, _ = breed_bound(geom, program=program, steps=EXPR_MG_T)
            line.update(kernel_ms_by_steps=ms, one_block_ms=one_block_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        ms_over_bound=ms[EXPR_MG_T] / bound_ms)
            r.update(ms=ms[EXPR_MG_T], ms_at_1_step=ms[1], plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, shape=[P, L], layout=geom.layout, K=geom.K, D=geom.D,
                     schedule=route["route"], C=route.get("C"), one_block_ms=one_block_ms)
            del out, work
        print(json.dumps(line), flush=True)
        del g, s
        torch.cuda.empty_cache()


def phase_expr_multigen_runs(port, kernels, results):
    """PGA.run of every expression workload through the pga_* API at
    generations_per_launch=8 beside the same run at one generation per
    launch, then a torch.profiler window over as many generations."""
    import torch

    T = EXPR_MG_T
    loads = expr_multigen_workloads()
    for name, gens in EXPR_MG_GENS.items():
        P, L, objective, crossover, mutate = loads[name]

        def solver(per_launch):
            pga = port.pga_init(seed=13, config=port.PGAConfig(generations_per_launch=per_launch))
            h = port.pga_create_population(pga, P, L)
            port.pga_set_objective_function(pga, objective)
            port.pga_set_crossover_function(pga, crossover)
            port.pga_set_mutate_function(pga, mutate)
            check(pga.uses_deme_kernel(P, L), f"{name}: not on the deme path")
            return pga, h

        pga, h = solver(T)
        geom = pga._run_fn(P, L)[0].geom
        check((geom.layout, geom.K, geom.D, geom.S) == EXPR_MG_GEOMETRY[name],
              f"{name}: geometry {geom}")
        start_best = float(objective(pga.population(h).genomes).max())
        check(port.pga_run(pga, T) == T, f"{name}: warm-up")
        kernels.reset_launches()
        ran, seconds = timed_run(port, pga, gens)
        launches = dict(kernels.LAUNCHES)
        genome, best = pga.get_best_with_score(h)
        pop = pga.population(h)
        rescored = objective(pop.genomes)
        check(ran == gens, f"{name}: ran {ran} generations")
        check(launches["expr_multigen"] == -(-gens // T) and sum(launches.values()) == -(-gens // T),
              f"{name}: launches {launches} for {gens} generations at T={T}")
        on_cluster = results[name]["schedule"] == "cluster"
        check(kernels.CLUSTER_LAUNCHES == ({"expr_multigen": -(-gens // T)} if on_cluster else {}),
              f"{name}: cluster-schedule launches {kernels.CLUSTER_LAUNCHES}")
        check(bool(torch.isfinite(pop.scores).all()) and bool(torch.isclose(
            pop.scores, rescored, rtol=EXPR_RTOL, atol=EXPR_ATOL_PER_GENE * L).all()),
              f"{name}: scores are not the genomes' objective")
        check(best >= start_best, f"{name}: best {start_best} -> {best}")
        if name == "knapsack":
            check(best == 285.0, f"knapsack: best {best}, optimum 285")
        one, _ = solver(None)
        port.pga_run(one, 2)
        kernels.reset_launches()
        ran1, seconds1 = timed_run(port, one, gens)
        one_launches = kernels.LAUNCHES["expr"] + kernels.LAUNCHES["expr_pipelined"]
        check(one_launches == gens and sum(kernels.LAUNCHES.values()) == gens,
              f"{name}: one per launch {kernels.LAUNCHES}")
        port.pga_deinit(one)
        r = results[name]
        line = {"phase": "expr_multigen_run", "workload": name, "shape": [P, L],
                "generations_per_launch": T, "gens": ran, "launches": launches,
                "gens_per_s": ran / seconds, "ms_per_gen": 1e3 * seconds / ran,
                "one_per_launch_gens_per_s": ran1 / seconds1,
                "one_per_launch_ms_per_gen": 1e3 * seconds1 / ran1,
                "kernel_ms_per_launch": r["ms"], "kernel_ms_per_gen": r["ms"] / T,
                "bound_ms_per_launch": r["bound_ms"], "start_best": start_best, "best": best}
        if name == "knapsack":
            line.update(optimum=285.0, best_counts=[int(x) for x in (genome * 2.0).astype("int64")])
        print(json.dumps(line), flush=True)
        prof = profile_generations(port, pga, 1e3 * seconds / ran, gens)
        print(json.dumps({"phase": "expr_multigen_profile", "workload": name, "shape": [P, L],
                          "generations_per_launch": T, **prof}), flush=True)
        r.update(launches=launches["expr_multigen"], ms_per_gen=line["ms_per_gen"],
                 one_per_launch_ms_per_gen=line["one_per_launch_ms_per_gen"],
                 device_busy_share=prof["device_busy_share"], best=best)
        port.pga_deinit(pga)
        del pga, pop, rescored
        torch.cuda.empty_cache()


def order_workloads():
    """name -> (objective, crossover, mutate) of the order-crossover
    slice, as PGA.run gets them: the tour expression with swap mutation
    (cases 1 and 3), the coordinate TSP with the creep expression on its
    random keys (case 2), OneMax with swap mutation (case 4)."""
    from libpga_tpu_torch import objectives as obj
    from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
    from libpga_tpu_torch.ops.crossover import order_preserving_crossover
    from libpga_tpu_torch.ops.mutate import make_swap_mutate

    xy = obj.random_tsp_coords(ORDER_GEOMETRY["tour"][0][1], seed=2)
    tsp = obj.make_tsp_coords(obj.random_tsp_coords(ORDER_GEOMETRY["tsp_creep"][0][1], seed=2),
                              duplicate_mode="genes")
    return {
        "tour": (obj.from_expression(TOUR_EXPR, X=xy[:, 0], Y=xy[:, 1]),
                 order_preserving_crossover, make_swap_mutate(0.5)),
        "tsp_creep": (tsp, order_preserving_crossover,
                      mutate_from_expression(CREEP, rate=0.05, sigma=0.1)),
        "onemax": (obj.onemax, order_preserving_crossover, make_swap_mutate(0.5)),
    }


def order_kinds(port, name):
    """(P, L, objective, mutate kind, mparams, expression objective,
    builtin objective id, program or None) of an order workload."""
    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.ops.fused_step import is_expression

    (P, L), _, _ = ORDER_GEOMETRY[name]
    objective, crossover, mutate = order_workloads()[name]
    cross, mut, mparams, expr_obj, obj_id = expr_kinds(port, objective, crossover, mutate)
    assert cross == "order"
    program = None
    if is_expression(mut) or expr_obj is not None:
        program = expr_cuda.program_for(None, mut if is_expression(mut) else None, expr_obj)
    return P, L, objective, mut, mparams, expr_obj, obj_id, program


def order_draws(fs, geom, mut, gen, device, steps=None):
    """Random injected draws of an order breed: selection, mutation, the
    walk's fallback plane, the expression planes the hooks read and, for
    ``steps``, the tie words of every sub-generation."""
    import torch

    z = fs.zero_draws(geom.G, geom.K, geom.L, mut, device, "order", steps=steps)
    for f in ("sel_u", "mut_u", "fill", "expr_gene", "expr_row", "gauss"):
        if getattr(z, f) is not None:
            setattr(z, f, torch.rand(getattr(z, f).shape, generator=gen, device=device))
    if z.tie is not None:
        z.tie = torch.randint(0, 2**32, z.tie.shape, generator=gen, device=device)
    return z


def order_population(objective, geom, gen, device):
    """Random keys with zero pad rows and their scores, -inf on pads."""
    import torch

    g = torch.rand((geom.Pp, geom.L), generator=gen, device=device)
    g[geom.P:] = 0.0
    s = torch.full((geom.Pp,), -torch.inf, device=device)
    s[:geom.P] = objective(g[:geom.P])
    return g, s


def phase_order_expr_compare(port, fs, device, results):
    """The expression order kernel (cases 1-2) against its plain version
    on the same inputs, injected and Philox draws; times both at the full
    shapes beside the bound and the walk's chain."""
    import torch

    from libpga_tpu_torch.ops.breed_expr import mutate_from_expression

    # (case, workload, P, L, mutation override): P None = the workload's
    # shape, timed
    cases = [
        ("tour-65k", "tour", None, None, None),
        ("tour-65k-creep", "tour", None, None, "creep"),
        ("tour-1000-padded", "tour", 1000, None, None),
        ("tsp_creep-8k", "tsp_creep", None, None, None),
    ]
    for name, load, P, _, override in cases:
        P0, L, objective, mut, mparams, expr_obj, obj_id, program = order_kinds(port, load)
        if override == "creep":
            from libpga_tpu_torch.ops import expr_cuda

            mut = mutate_from_expression(CREEP, rate=0.05, sigma=0.1)
            mparams = (0.05, 0.1)
            program = expr_cuda.program_for(None, mut, expr_obj)
        timed = P is None
        P = P or P0
        geom = fs.resolve_geometry(P, L, crossover="order", const_carrying=expr_obj is not None)
        if timed:
            check((geom.layout, geom.K, geom.D, geom.S) == ORDER_GEOMETRY[load][1],
                  f"order {name}: geometry {geom}")
        gen = torch.Generator(device=device).manual_seed(P + L)
        g, s = order_population(objective, geom, gen, device)
        ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(gen, geom.Pp, device))
        kw = dict(crossover="order", mutate=mut, obj_id=obj_id, objective=expr_obj,
                  mparams=torch.tensor(list(mparams), dtype=torch.float32, device=device))
        n_cities = 0
        if obj_id:
            n_cities = objective.coords.shape[0]
            kw.update(coords=objective.coords.to(device), penalty=objective.penalty)
        rtol, atol = (TSP_RTOL, 0.0) if n_cities else (EXPR_RTOL, EXPR_ATOL_PER_GENE * L)
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        errs = []
        for mode, draws in (("injected", order_draws(fs, geom, mut, gen, device)), ("philox", None)):
            if draws is None:
                got = fs.deme_breed(g, ranks, geom, 0, seed=seed, **kw)
                draws = fs.philox_draws(seed, geom.G, geom.K, L, mut, "order")
            else:
                got = fs.deme_breed(g, ranks, geom, 0, draws=draws, **kw)
            want = fs.deme_breed_reference(g, ranks, geom, 0, draws, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]), f"order {name} {mode}: genomes differ")
            check(bool(torch.isinf(got[1][P:]).all()) and bool(torch.isfinite(got[1][:P]).all()),
                  f"order {name} {mode}: pad rows not -inf or real rows not finite")
            a, b = got[1][:P], want[1][:P]
            check(bool(torch.isclose(a, b, rtol=rtol, atol=atol).all()),
                  f"order {name} {mode}: score error {float((a - b).abs().max())}")
            errs.append(float((a - b).abs().max()))
            del got, want, draws
        line = {"phase": "order_expr_compare", "case": name, "workload": load, "shape": [P, L],
                "layout": geom.layout, "K": geom.K, "D": geom.D, "Pp": geom.Pp,
                "genomes_equal": True, "max_abs_err": max(errs), "score_rtol": rtol,
                "score_atol": atol, "obj_rows": program.obj_rows}
        r = results.setdefault(f"expr_order[{load}]", {})
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), max(errs))
        if timed and override is None:
            out = torch.empty_like(g)
            ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seed, out=out, **kw), 20)
            plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
                g, ranks, geom, 0, fs.philox_draws(seed, geom.G, geom.K, L, mut, "order"), **kw), 2)
            bound_ms, bound_by, chain = breed_bound(geom, program=program, order=True,
                                                    n_cities=n_cities)
            line.update(kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        chain_steps=chain, chain_ms=chain_ms(chain, L),
                        ms_over_bound=ms / bound_ms)
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     chain_steps=chain, chain_ms=chain_ms(chain, L), shape=[P, L], K=geom.K)
        print(json.dumps(line), flush=True)
        del g, s, ranks
        torch.cuda.empty_cache()


def phase_order_multigen_compare(port, fs, device, results):
    """The multi-generation kernels' order case (3: the expression kernel
    with the tour; 4: the builtin kernel with OneMax) against the plain
    version, injected and Philox draws, at 0, 1, 3 and 8 steps, with
    per-deme elites and half the groups frozen at entry; times the kernel
    at 1 and 8 steps, its no_cross case at 8 (nothing walked: the walk
    alone is the difference, priced a step) and the plain version at 8 at
    the full shapes."""
    import torch

    # (case, workload, steps, elitism, freeze, P override)
    cases = [
        ("tour-65k-steps8", "tour", 8, 0, False, None),
        ("tour-65k-steps3-e2-freeze", "tour", 3, 2, True, None),
        ("tour-65k-steps1-e2", "tour", 1, 2, False, None),
        ("tour-4096-steps0", "tour", 0, 0, False, 4096),
        ("onemax-40k-steps8", "onemax", 8, 0, False, None),
        ("onemax-40k-steps3-e2-freeze", "onemax", 3, 2, True, None),
        ("onemax-40k-steps1", "onemax", 1, 0, False, None),
        ("onemax-1000-steps0", "onemax", 0, 0, False, 1000),
    ]
    for name, load, steps, e, freeze, P in cases:
        P0, L, objective, mut, mparams, expr_obj, obj_id, program = order_kinds(port, load)
        timed = P is None and steps == ORDER_T
        P = P or P0
        geom = fs.resolve_geometry(P, L, crossover="order", multigen=True, elitism=e,
                                   const_carrying=expr_obj is not None)
        if P == P0:
            check((geom.layout, geom.K, geom.D, geom.S) == ORDER_GEOMETRY[load][2],
                  f"order multigen {name}: geometry {geom}")
        gen = torch.Generator(device=device).manual_seed(P + L + steps)
        g, s = order_population(objective, geom, gen, device)
        kw = dict(crossover="order", mutate=mut, obj_id=obj_id, elitism=e,
                  mparams=torch.tensor(list(mparams), dtype=torch.float32, device=device))
        if expr_obj is not None:
            kw.update(objective=expr_obj)
        target, frozen = None, None
        if freeze:
            read, _ = geom.row_maps(0, device)
            best = torch.where(read < P, s[read], -torch.inf).reshape(geom.S, -1).amax(dim=1)
            target = float(best.median())
            frozen = int((best >= target).sum())
            check(0 < frozen < geom.S, f"order multigen {name}: {frozen} of {geom.S} frozen")
        tgt = math.inf if target is None else target
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        errs = []
        for mode in (dict(draws=order_draws(fs, geom, mut, gen, device, steps=max(steps, 1))),
                     dict(seed=seed)):
            tag = f"order multigen {name} {'injected' if 'draws' in mode else 'philox'}"
            got = fs.multigen_breed(g, s, geom, 0, steps, target, **mode, **kw)
            want = fs.multigen_breed_reference(g, s, geom, 0, steps, tgt, **mode, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]), f"{tag}: genomes differ")
            check(torch.equal(got[1], want[1]) and bool(torch.isinf(got[1][P:]).all()),
                  f"{tag}: scores differ")
            errs.append(0.0)
            if steps:
                check(not torch.equal(got[0], g), f"{tag}: nothing bred")
            del got, want
        line = {"phase": "order_multigen_compare", "case": name, "workload": load,
                "shape": [P, L], "steps": steps, "elitism": e, "target": target,
                "groups_frozen_at_entry": frozen, "layout": geom.layout, "K": geom.K,
                "D": geom.D, "S": geom.S, "Pp": geom.Pp, "genomes_equal": True,
                "scores_equal": True}
        kernel = "expr_multigen_order" if expr_obj is not None else "multigen_order"
        r = results.setdefault(f"{kernel}[{load}]", {})
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), max(errs))
        if timed:
            out = torch.empty_like(g)
            work = [torch.empty_like(g), torch.empty_like(g)]
            ms = {T: cuda_ms(lambda: fs.multigen_breed(
                g, s, geom, 0, T, None, seed=seed, out=out, work=work, **kw), 20)
                for T in (1, ORDER_T)}
            # The walk alone: production less the harness's no_cross case
            # (nothing walked), in this run, priced a step over the launch's
            # waves (one 1,024-thread block an SM) beside the probe's step.
            no_cross_ms = cuda_ms(lambda: fs.multigen_breed(
                g, s, geom, 0, ORDER_T, None, seed=seed, out=out, work=work,
                ablate=("no_cross",), **kw), 20)
            waves = -(-geom.S // torch.cuda.get_device_properties(0).multi_processor_count)
            walk_ms = ms[ORDER_T] - no_cross_ms
            plan = fs.kernels.multigen_order_plan(
                geom, program if expr_obj is not None else None)
            plain_ms = cuda_ms(lambda: fs.multigen_breed_reference(
                g, s, geom, 0, ORDER_T, math.inf, seed=seed, **kw), 1)
            bound_ms, bound_by, chain = breed_bound(geom, program=program, order=True,
                                                    steps=ORDER_T)
            walk = dict(no_cross_ms=no_cross_ms, walk_ms=walk_ms, waves=waves,
                        walk_ns_per_step=1e6 * walk_ms / (ORDER_T * L * waves),
                        walk_step_ns=1e6 * walk_step_ms(L), walkers_per_pass=plan.P,
                        breeding_warps=plan.warps, smem=plan.smem)
            line.update(kernel_ms_by_steps=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, chain_steps_per_generation=chain,
                        ms_over_bound=ms[ORDER_T] / bound_ms, **walk)
            r.update(ms=ms[ORDER_T], ms_at_1_step=ms[1], plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, chain_steps=chain * ORDER_T, shape=[P, L], K=geom.K,
                     **walk)
            del out, work
        print(json.dumps(line), flush=True)
        del g, s
        torch.cuda.empty_cache()


def phase_order_runs(port, kernels, results):
    """PGA.run with order crossover through the pga_* API: the tour
    expression at 65,536x200 at T = 1 and T = 8, the coordinate TSP with
    the creep expression at 8,192x1,000 at T = 1 (the best must rise),
    OneMax at 40,000x100 with elitism 2 at T = 8 beside T = 1 (a
    permutation's genes cannot beat a random genome's sum: the best must
    not fall); launches, gens/s, the best, a profile."""
    import torch

    # (workload, generations per launch, the counter it must launch, key)
    runs = [
        ("tour", 1, "expr_order", "expr_order[tour]"),
        ("tour", ORDER_T, "expr_multigen_order", "expr_multigen_order[tour]"),
        ("tsp_creep", 1, "expr_order", "expr_order[tsp_creep]"),
        ("onemax", ORDER_T, "multigen_order", "multigen_order[onemax]"),
        ("onemax", 1, "order", None),
    ]
    loads = order_workloads()
    for load, T, counter, key in runs:
        (P, L), geo1, geo8 = ORDER_GEOMETRY[load]
        objective, crossover, mutate = loads[load]
        elitism = 2 if load == "onemax" else 0
        pga = port.pga_init(seed=17, config=port.PGAConfig(
            generations_per_launch=None if T == 1 else T, elitism=elitism))
        h = port.pga_create_population(pga, P, L)
        port.pga_set_objective_function(pga, objective)
        port.pga_set_crossover_function(pga, crossover)
        port.pga_set_mutate_function(pga, mutate)
        check(pga.uses_deme_kernel(P, L), f"order {load}: not on the deme path")
        if T > 1:
            geom = pga._run_fn(P, L)[0].geom
            check((geom.layout, geom.K, geom.D, geom.S) == geo8, f"order {load}: geometry {geom}")
        start = objective(pga.population(h).genomes)
        start_best = float(start.max())
        _, start_dups = tour(pga.population(h).genomes[int(torch.argmax(start))])
        check(port.pga_run(pga, T) == T, f"order {load}: warm-up")
        kernels.reset_launches()
        ran, seconds = timed_run(port, pga, ORDER_GENS)
        launches = dict(kernels.LAUNCHES)
        genome, best = pga.get_best_with_score(h)
        _, dups = tour(genome)
        pop = pga.population(h)
        rescored = objective(pop.genomes)
        want = -(-ORDER_GENS // T)
        line = {"phase": "order_run", "workload": load, "shape": [P, L],
                "generations_per_launch": T, "elitism": elitism, "gens": ran, "launches": launches,
                "gens_per_s": ran / seconds, "ms_per_gen": 1e3 * seconds / ran,
                "start_best": start_best, "best": best,
                "start_best_distinct_cities": L - start_dups, "best_distinct_cities": L - dups}
        if key is not None:
            r = results.setdefault(key, {})
            line.update(kernel_ms_per_launch=r.get("ms"), bound_ms_per_launch=r.get("bound_ms"),
                        chain_steps_per_launch=r.get("chain_steps"))
        print(json.dumps(line), flush=True)
        check(ran == ORDER_GENS, f"order {load} T={T}: ran {ran} generations")
        check(launches[counter] == want and sum(launches.values()) == want,
              f"order {load} T={T}: launches {launches} for {ran} generations")
        check(best >= start_best if elitism else best > start_best,
              f"order {load} T={T}: best {start_best} -> {best}")
        check(bool(torch.isfinite(pop.scores).all()) and bool(torch.isclose(
            pop.scores, rescored, rtol=EXPR_RTOL, atol=EXPR_ATOL_PER_GENE * L).all()),
              f"order {load} T={T}: scores are not the genomes' objective")
        if key is not None:
            prof = profile_generations(port, pga, 1e3 * seconds / ran, ORDER_GENS)
            print(json.dumps({"phase": "order_profile", "workload": load, "shape": [P, L],
                              "generations_per_launch": T, **prof}), flush=True)
            r.update(launches=launches[counter], ms_per_gen=line["ms_per_gen"],
                     gens_per_s=line["gens_per_s"], device_busy_share=prof["device_busy_share"],
                     best=best, best_distinct_cities=L - dups)
        port.pga_deinit(pga)
        del pga, pop, rescored
        torch.cuda.empty_cache()


def island_objective(name: str, L: int):
    from libpga_tpu_torch import objectives as obj

    if name == "tsp":
        return obj.make_tsp_coords(obj.random_tsp_coords(L, seed=2), duplicate_mode="genes")
    return obj.get(name)


def island_draws(fs, geom, I, steps, cross, mutate, gen, device, multigen):
    """Random injected draws with a leading island axis (the multigen
    kernel's with a sub-generation axis after it)."""
    import torch

    lead = (I, steps) if multigen else (I,)
    G, K, L = geom.G, geom.K, geom.L

    def rand(*shape):
        return torch.rand(lead + shape, generator=gen, device=device)

    return fs.Draws(
        sel_u=rand(G, K, 2),
        cross=(rand(G, K, L) < 0.5).to(torch.uint8) if cross == "uniform" else None,
        mut_u=rand(G, K, 4),
        gauss=rand(3, G, K, L) if mutate == "gaussian" else None,
        fill=rand(G, K, L) if cross == "order" else None,
        tie=torch.randint(0, 2**32, lead + (G, K), generator=gen, device=device)
        if multigen else None,
    )


def phase_island_compare(fs, device, results):
    """Island launches of the deme, order and multigen kernels (the
    islands a second grid axis) against their plain version, against I
    single-population launches with each island's seed or draws, and
    with one island against the single launch; times the island launch
    beside its bound and beside the loop of I single launches."""
    import torch

    from libpga_tpu_torch.ops.evaluate import evaluate

    for name, kernel, I, S, L, cross, mutate, oname, steps in ISLAND_CASES:
        multigen = kernel == "multigen_breed"
        geom = fs.resolve_geometry(S, L, crossover=cross, multigen=multigen)
        o = island_objective(oname, L)
        kw = dict(crossover=cross, mutate=mutate, obj_id=o.fused_id, mparams=torch.tensor(
            [0.15, 0.05] if mutate == "gaussian" else [0.05, 0.0], device=device))
        if oname == "tsp":
            kw.update(coords=o.coords.to(device), penalty=o.penalty)
        gen = torch.Generator(device=device).manual_seed(S + L + I)
        g = torch.rand((I, geom.Pp, L), generator=gen, device=device)
        g[:, S:] = 0.0
        s = torch.full((I, geom.Pp), -torch.inf, device=device)
        s[:, :S] = evaluate(o, g[:, :S].reshape(-1, L)).view(I, S)
        seeds = torch.randint(0, 2**62, (I,), generator=gen, device=device)
        tie = fs.draw_tie_words(gen, I * geom.Pp, device).view(I, geom.Pp)
        G, K = geom.G, geom.K
        real = torch.arange(geom.Pp, device=device) < S
        errs = []
        for parity in range(geom.parities):
            ranks = None if multigen else fs.compute_ranks(s, geom, parity, tie)

            def launch(i, n=None, plain=False, **x):
                """Islands i .. i + n - 1 in one launch (n given), or island
                i in a single-population launch; ``plain``: the plain
                version of the island launch."""
                pick = slice(i, i + n) if n else i
                if multigen:
                    if plain:
                        return fs.multigen_breed_reference(
                            g[pick], s[pick], geom, parity, steps, math.inf, **x, **kw)
                    return fs.multigen_breed(g[pick], s[pick], geom, parity, steps, None,
                                             islands=n, **x, **kw)
                r = ranks[i * G:(i + (n or 1)) * G]
                if plain:
                    d = x.get("draws") or fs.island_philox_draws(x["seed"], G, K, L, mutate, cross)
                    return fs.deme_breed_reference(g[pick], r, geom, parity, d, **kw)
                return fs.deme_breed(g[pick], r, geom, parity, islands=n, **x, **kw)

            draws = island_draws(fs, geom, I, steps, cross, mutate, gen, device, multigen)
            for mode, x in (("injected", dict(draws=draws)), ("philox", dict(seed=seeds))):
                got, want = launch(0, I, **x), launch(0, I, plain=True, **x)
                torch.cuda.synchronize()
                tag = f"islands {name} parity {parity} {mode}"
                if multigen:
                    same_schedules(fs, got, g, s, geom, parity, steps, None, tag, islands=I,
                                   **x, **kw)
                elif kernel == "deme_breed":
                    same_deme_kernels(fs, got, g, ranks, geom, parity, tag, islands=I, **x, **kw)
                if mutate == "gaussian":
                    check(bool(torch.isclose(got[0], want[0], rtol=0, atol=GAUSS_ATOL).all()),
                          f"{tag}: genomes differ beyond {GAUSS_ATOL}")
                else:
                    check(torch.equal(got[0], want[0]), f"{tag}: genomes differ")
                check(bool(torch.isinf(got[1][:, ~real]).all()), f"{tag}: pad scores not -inf")
                a, b = got[1][:, real], want[1][:, real]
                if oname == "onemax":
                    err, tol = float((a - b).abs().max()), SCORE_ATOL
                else:
                    err = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                    tol = TSP_RTOL if oname == "tsp" else FUSED_RTOL
                check(err <= tol, f"{tag}: score error {err} above {tol}")
                errs.append(err)
                for i in range(I):
                    one = launch(i, **(dict(draws=draws.island(i)) if mode == "injected"
                                       else dict(seed=seeds[i:i + 1])))
                    check(torch.equal(got[0][i], one[0]) and torch.equal(got[1][i], one[1]),
                          f"{tag}: island {i} differs from its single-population launch")
            solo, one = launch(0, 1, seed=seeds[:1]), launch(0, seed=seeds[:1])
            check(torch.equal(solo[0][0], one[0]) and torch.equal(solo[1][0], one[1]),
                  f"islands {name}: one island differs from the single-population launch")
            del draws

        # Times at parity 0 (the last parity's ranks serve the loop too).
        out = torch.empty_like(g)
        work = [torch.empty_like(g), torch.empty_like(g)] if multigen else None

        def island_launch():
            if multigen:
                return fs.multigen_breed(g, s, geom, 0, steps, None, seed=seeds, out=out,
                                         work=work, islands=I, **kw)
            return fs.deme_breed(g, ranks, geom, 0, seed=seeds, out=out, islands=I, **kw)

        def single_launches():
            for i in range(I):
                if multigen:
                    fs.multigen_breed(g[i], s[i], geom, 0, steps, None, seed=seeds[i:i + 1],
                                      out=out[i], work=[w[i] for w in work], **kw)
                else:
                    fs.deme_breed(g[i], ranks[i * G:(i + 1) * G], geom, 0,
                                  seed=seeds[i:i + 1], out=out[i], **kw)

        reps = 10 if multigen else 20
        ms, loop_ms = cuda_ms(island_launch, reps), cuda_ms(single_launches, reps)
        plain_ms = cuda_ms(lambda: launch(0, I, plain=True, seed=seeds), 2)
        route = one_block_ms = deme_ms = None
        if kernel == "deme_breed":
            deme_ms = cuda_ms(lambda: fs.kernels.deme_breed_cuda(
                g, ranks, geom, 0, seed=seeds, out=out, islands=I, pipelined=False, **kw), reps)
        if multigen:
            bound_ms, bound_by, _ = breed_bound(geom, steps=steps)
            rank_ms = chain = None
            route = mg_route(fs.kernels, geom, torch.float32, kw)
            check(route["route"] == "cluster", f"islands {name}: {route}")
            one_block_ms = cuda_ms(lambda: fs.multigen_breed(
                g, s, geom, 0, steps, None, seed=seeds, out=out, work=work, islands=I,
                cluster=False, **kw), reps)
        else:
            rank_ms = cuda_ms(lambda: fs.compute_ranks(s, geom, 0, tie), 20)
            order = cross == "order"
            bound_ms, bound_by, chain = breed_bound(geom, order=order, n_cities=L * order)
            chain = chain if order else None
        line = {"phase": "island_compare", "case": name, "kernel": kernel, "islands": I,
                "island_shape": [S, L], "layout": geom.layout, "K": K, "D": geom.D,
                "Pp": geom.Pp, "steps": steps, "genomes_equal": mutate != "gaussian",
                "single_launches_equal": True, "one_island_equal": True,
                "max_err": max(errs), "kernel_ms": ms, "loop_ms": loop_ms,
                "loop_over_island": loop_ms / ms, "plain_ms": plain_ms, "rank_ms": rank_ms,
                "bound_ms": I * bound_ms, "bound_by": bound_by, "chain_steps": chain,
                "chain_ms": chain_ms(chain, L),
                "kernel_over_bound": ms / (I * bound_ms), "schedule": route,
                "one_block_ms": one_block_ms, "deme_breed_ms": deme_ms,
                "counter": deme_key(fs.kernels, geom, islands=True)
                if kernel == "deme_breed" else None}
        print(json.dumps(line), flush=True)
        r = {k: line[k] for k in ("case", "ms", "loop_ms", "plain_ms", "rank_ms", "bound_ms",
                                  "bound_by", "chain_steps", "chain_ms", "layout", "K", "D",
                                  "steps", "schedule", "one_block_ms", "deme_breed_ms")
             if k in line} | {"ms": ms, "max_abs_err": max(errs), "shape": [I, S, L]}
        if kernel in results:
            results[kernel].setdefault("other_cases", {})[name] = r
            results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], max(errs))
        else:
            results[kernel] = r
        del g, s, out, work
        torch.cuda.empty_cache()


def island_solver(port, shape, seed, objective="onemax", **config):
    """A solver holding ``shape`` = (islands, rows, genes) populations
    through the pga_* API."""
    I, S, L = shape
    pga = port.pga_init(seed=seed, config=port.PGAConfig(**config))
    for _ in range(I):
        port.pga_create_population(pga, S, L)
    port.pga_set_objective_function(pga, objective)
    return pga


def best_of(pga) -> float:
    return max(pga.get_best_with_score(h)[1] for h in pga._handles())


def phase_island_run(port, kernels, results, single, multigen):
    """pga_run_islands at bench.py's island config: launches, gens/s,
    busy share, the migration's ms per epoch and the ratio to the single
    1,048,576x100 run of this script, at one and at 8 generations per
    launch; a target run; TSP islands through the order kernel."""
    import torch

    from libpga_tpu_torch.objectives import make_tsp_coords, random_tsp_coords
    from libpga_tpu_torch.ops.crossover import order_preserving_crossover
    from libpga_tpu_torch.ops.mutate import make_swap_mutate
    from libpga_tpu_torch.parallel import islands as pis

    from libpga_tpu_torch.ops import fused_step as fs

    I, S, L = ISLAND_RUN
    deme = deme_key(kernels, fs.resolve_geometry(S, L), islands=True)
    check(deme == "islands_deme_pipelined", f"islands: {deme}")
    for T, key in ((None, deme), (ISLAND_T, "islands_multigen")):
        pga = island_solver(port, ISLAND_RUN, 7, generations_per_launch=T)
        start_best = max(float(p.genomes.sum(dim=1).max()) for p in pga._populations)
        check(port.pga_run_islands(pga, ISLAND_M, ISLAND_M, ISLAND_PCT) == ISLAND_M, "island warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        before = pga.launches
        t0 = time.perf_counter()
        gens = port.pga_run_islands(pga, ISLAND_GENS, ISLAND_M, ISLAND_PCT)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        want = ISLAND_GENS if T is None else ISLAND_GENS // ISLAND_M * math.ceil(ISLAND_M / T)
        best = best_of(pga)
        check(gens == ISLAND_GENS, f"islands T={T}: ran {gens} generations")
        check(launches[key] == want and sum(launches.values()) == want
              and pga.launches - before == want,
              f"islands T={T}: launches {launches} for {gens} generations, want {want}")
        check(best > start_best + 10.0 and best < L, f"islands T={T}: best {start_best} -> {best}")
        for p in pga._populations:
            check(bool(torch.isclose(p.scores, p.genomes.sum(dim=1), rtol=0, atol=SCORE_ATOL).all()),
                  f"islands T={T}: scores are not the genomes' onemax")
        g = torch.stack([p.genomes for p in pga._populations])
        s = torch.stack([p.scores for p in pga._populations])
        # The island breed on the run's evolved islands (the random start of
        # island_compare aside): one generation (ranks, seeds, launch), or
        # one launch of T generations.
        breed, out = pga._islands[(S, L, I)], torch.empty_like(g)
        if T is None:
            breed_ms = cuda_ms(lambda: breed(g, s, 0, pga.generator, out=out), 20)
        else:
            work = [torch.empty_like(g), torch.empty_like(g)]
            breed_ms = cuda_ms(lambda: breed(g, s, 0, T, math.inf, pga.generator, out=out,
                                             work=work), 5)
            del work
        migrate_ms = cuda_ms(lambda: pis.migrate_local(g, s, int(S * ISLAND_PCT), "ring"), 20)
        del g, s, out
        ms_per_gen = 1e3 * seconds / gens
        ref = (single["pingpong"]["gens_per_s"] if T is None
               else 1e3 / multigen["riffle"]["shapes"][1 << 20]["ms_per_gen"])
        prof = profile_generations(port, pga, ms_per_gen, ISLAND_PROFILE_GENS,
                                   run=lambda n: port.pga_run_islands(pga, n, ISLAND_M, ISLAND_PCT))
        line = {"phase": "island_run", "islands": I, "island_shape": [S, L], "m": ISLAND_M,
                "pct": ISLAND_PCT, "generations_per_launch": T, "gens": gens,
                "launches": launches, "gens_per_s": gens / seconds, "ms_per_gen": ms_per_gen,
                "migrate_ms_per_epoch": migrate_ms, "breed_ms_on_evolved_islands": breed_ms,
                "single_1M_gens_per_s": ref, "island_over_single": (gens / seconds) / ref,
                "start_best": start_best, "best": best, **prof}
        print(json.dumps(line), flush=True)
        kernel = "deme_breed" if T is None else "multigen_breed"
        results[kernel].update(launches=launches[key], run=line)
        port.pga_deinit(pga)
        del pga
        torch.cuda.empty_cache()

    # Target: the stop is seen at an epoch boundary; an epoch earlier the
    # best was below it.
    target = 70.0
    pga = island_solver(port, ISLAND_RUN, 8)
    gens = port.pga_run_islands(pga, 10_000, ISLAND_M, ISLAND_PCT, target=target)
    best = best_of(pga)
    port.pga_deinit(pga)
    earlier = island_solver(port, ISLAND_RUN, 8)
    port.pga_run_islands(earlier, gens - ISLAND_M, ISLAND_M, ISLAND_PCT, target=target)
    prev = best_of(earlier)
    port.pga_deinit(earlier)
    print(json.dumps({"phase": "island_target", "islands": I, "island_shape": [S, L],
                      "target": target, "m": ISLAND_M, "gens": gens, "best": best,
                      "best_one_epoch_earlier": prev}), flush=True)
    check(0 < gens < 10_000 and gens % ISLAND_M == 0 and best >= target > prev,
          f"island target: {gens} generations, best {best}, an epoch earlier {prev}")

    # TSP islands: order crossover, swap mutation, the fused tour score.
    tsp = make_tsp_coords(random_tsp_coords(ISLAND_TSP[2], seed=2), duplicate_mode="genes")
    pga = island_solver(port, ISLAND_TSP, 9, objective=tsp)
    port.pga_set_crossover_function(pga, order_preserving_crossover)
    port.pga_set_mutate_function(pga, make_swap_mutate(0.5))
    start_best = max(float(tsp(p.genomes).max()) for p in pga._populations)
    check(port.pga_run_islands(pga, ISLAND_M, ISLAND_M, ISLAND_PCT) == ISLAND_M, "TSP islands warm-up")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    gens = port.pga_run_islands(pga, ISLAND_TSP_GENS, ISLAND_M, ISLAND_PCT)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    best = best_of(pga)
    print(json.dumps({"phase": "island_tsp_run", "islands": ISLAND_TSP[0],
                      "island_shape": list(ISLAND_TSP[1:]), "gens": gens, "launches": launches,
                      "gens_per_s": gens / seconds, "ms_per_gen": 1e3 * seconds / gens,
                      "start_best": start_best, "best": best}), flush=True)
    check(gens == ISLAND_TSP_GENS and launches["islands_order"] == gens
          and sum(launches.values()) == gens, f"TSP islands: launches {launches} for {gens}")
    check(best > start_best, f"TSP islands: best {start_best} -> {best}")
    results["order_breed"]["launches"] = launches["islands_order"]
    port.pga_deinit(pga)


def phase_rastrigin_islands(port, kernels):
    """The five annealing phases of tools/bench_rastrigin.py through
    pga_run_islands: 8 x 16,384 x 30 Rastrigin, elitism 2, gaussian
    mutation, ring migration of 5% every 20 generations, 400 generations
    a phase, read every 100. The best must not fall within a phase (within
    FUSED_RTOL: each run_islands call rescores its islands with torch's
    cos where the kernel used cosf) and must rise over the run."""
    import torch

    from libpga_tpu_torch.objectives import rastrigin
    from libpga_tpu_torch.ops.mutate import make_gaussian_mutate

    pga = island_solver(port, RASTRIGIN_ISLANDS, 11, objective="rastrigin", elitism=2)
    start = max(float(rastrigin(p.genomes).max()) for p in pga._populations)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phases = []
    for rate, sigma in RASTRIGIN_PHASES:
        port.pga_set_mutate_function(pga, make_gaussian_mutate(rate=rate, sigma=sigma))
        bests = []
        for _ in range(RASTRIGIN_GENS // RASTRIGIN_CHUNK):
            ran = port.pga_run_islands(pga, RASTRIGIN_CHUNK, RASTRIGIN_M, RASTRIGIN_PCT)
            check(ran == RASTRIGIN_CHUNK, f"rastrigin islands: ran {ran}")
            bests.append(best_of(pga))
        check(all(b >= a - FUSED_RTOL * abs(a) for a, b in zip(bests, bests[1:])),
              f"rastrigin islands, sigma {sigma}: the best fell, {bests}")
        phases.append({"rate": rate, "sigma": sigma, "best_every_100": bests})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    total = len(RASTRIGIN_PHASES) * RASTRIGIN_GENS
    best_genome = torch.as_tensor(port.pga_get_best_all(pga),
                                  device=pga.population(port.PopulationHandle(0)).genomes.device)[None]
    best = float(rastrigin(best_genome)[0])
    print(json.dumps({"phase": "rastrigin_islands", "islands": RASTRIGIN_ISLANDS[0],
                      "island_shape": list(RASTRIGIN_ISLANDS[1:]), "elitism": 2,
                      "m": RASTRIGIN_M, "pct": RASTRIGIN_PCT, "gens": total,
                      "launches": launches, "seconds": seconds, "gens_per_s": total / seconds,
                      "start_best": start, "phases": phases, "best_rastrigin": best,
                      "genes_at_half": float((best_genome - 0.5).abs().mean())}), flush=True)
    check(launches["islands_deme_pipelined"] == total and sum(launches.values()) == total,
          f"rastrigin islands: launches {launches} for {total} generations")
    check(phases[-1]["best_every_100"][-1] > start, f"rastrigin islands: best {start} -> {best}")
    port.pga_deinit(pga)


def island_expr_workloads():
    """name -> (objective, crossover, mutate) of the expression island
    cases, as PGA.run_islands gets them."""
    loads, order = expr_workloads(), order_workloads()
    return {"creep": loads["creep"][2:], "nk": loads["nk"][2:], "trap": loads["trap"][2:],
            "tour": order["tour"], "tsp_creep": order["tsp_creep"]}


def island_expr_breed(port, fs, load, S, L, steps, bf16, device):
    """(geometry, breed keywords, program, cities) of an island expression
    case at island size S x L: what make_island_breed / make_island_multigen
    build for it, the operators routed as the solver routes them."""
    import torch

    from libpga_tpu_torch.ops import expr_cuda

    objective, crossover, mutate = island_expr_workloads()[load]
    cross, mut, mparams, expr_obj, _ = expr_kinds(port, objective, crossover, mutate)
    make = fs.make_fused_multigen if steps > 1 else fs.make_fused_breed
    single = make(S, L, objective, crossover=cross, mutate=mut, mparams=mparams, device=device,
                  gene_dtype=torch.bfloat16 if bf16 else torch.float32)
    program = expr_cuda.program_for(cross if fs.is_expression(cross) else None,
                                    mut if fs.is_expression(mut) else None, expr_obj)
    cities = single.kw["coords"].shape[0] if "coords" in single.kw else 0
    return single.geom, single.kw, program, cities


def island_expr_draws(fs, geom, I, steps, cross, mut, gen, device):
    """Random injected draws of an island expression launch: a leading
    island axis (and, at several generations per launch, a sub-generation
    axis after it), the expression planes and words where a breeding hook
    reads them."""
    import torch

    lead = (I, steps) if steps > 1 else (I,)
    G, K, L = geom.G, geom.K, geom.L
    hooks = fs.is_expression(cross) or fs.is_expression(mut)

    def rand(*shape):
        return torch.rand(lead + shape, generator=gen, device=device)

    return fs.Draws(
        sel_u=rand(G, K, 2),
        cross=torch.randint(0, 2, lead + (G, K, L), generator=gen, device=device,
                            dtype=torch.uint8) if cross == "uniform" else None,
        mut_u=rand(G, K, 4),
        gauss=rand(3, G, K, L) if mut == "gaussian" else None,
        fill=rand(G, K, L) if cross == "order" else None,
        tie=torch.randint(0, 2**32, lead + (G, K), generator=gen, device=device)
        if steps > 1 else None,
        expr_gene=rand(4, G, K, L) if hooks else None,
        expr_row=rand(G, K, 4) if hooks else None,
    )


def phase_island_expr_compare(port, fs, kernels, device, results):
    """The island launch of the expression kernels (expr_breed_kernel,
    expr_order_kernel, expr_multigen_kernel<false/true>; float32 and bf16)
    against its plain version (genomes bit for bit, scores within the
    expression gates), against I single-population launches (each with its
    island's seed or slice of the injected draws: bit for bit) and, with
    one island, against the single launch, with injected and with Philox
    draws, every parity. Times the island launch by CUDA events beside the
    loop of I single launches, I times the island's bound and the plain
    version."""
    import torch

    from libpga_tpu_torch.ops.evaluate import evaluate

    loads = island_expr_workloads()
    for name, counter, I, S, L, load, steps, bf16 in ISLAND_EXPR_CASES:
        objective = loads[load][0]
        geom, kw, program, cities = island_expr_breed(port, fs, load, S, L, steps, bf16, device)
        mut, cross = kw["mutate"], kw["crossover"]
        multigen = steps > 1
        dtype = torch.bfloat16 if bf16 else torch.float32
        if counter == "expr":
            counter = expr_counter(kernels, counter, program, geom, dtype, mut)
        key = "islands_" + counter + ("_bf16" if bf16 else "")
        pipelined = counter == "expr_pipelined"
        old_ulps = 0
        gen = torch.Generator(device=device).manual_seed(S + L + I + steps)
        g = torch.rand((I, geom.Pp, L), generator=gen, device=device).to(dtype)
        g[:, S:] = 0
        s = torch.full((I, geom.Pp), -torch.inf, device=device)
        s[:, :S] = evaluate(objective, g[:, :S].float().reshape(-1, L)).view(I, S)
        seeds = torch.randint(0, 2**62, (I,), generator=gen, device=device)
        tie = fs.draw_tie_words(gen, I * geom.Pp, device).view(I, geom.Pp)
        G, K = geom.G, geom.K
        real = torch.arange(geom.Pp, device=device) < S
        rtol, atol = (TSP_RTOL, 0.0) if cities else (EXPR_RTOL, EXPR_ATOL_PER_GENE * L)
        errs, launched = [], 0
        for parity in range(geom.parities):
            ranks = None if multigen else fs.compute_ranks(s, geom, parity, tie)

            def launch(i, n=None, plain=False, **x):
                """Islands i .. i + n - 1 in one launch (n given), or island
                i in a single-population launch; ``plain``: the plain
                version of the island launch."""
                pick = slice(i, i + n) if n else i
                if multigen:
                    if plain:
                        return fs.multigen_breed_reference(
                            g[pick], s[pick], geom, parity, steps, math.inf, **x, **kw)
                    return fs.multigen_breed(g[pick], s[pick], geom, parity, steps, None,
                                             islands=n, **x, **kw)
                r = ranks[i * G:(i + (n or 1)) * G]
                if plain:
                    d = x.get("draws") or fs.island_philox_draws(x["seed"], G, K, L, mut, cross)
                    return fs.deme_breed_reference(g[pick], r, geom, parity, d, **kw)
                return fs.deme_breed(g[pick], r, geom, parity, islands=n, **x, **kw)

            draws = island_expr_draws(fs, geom, I, steps, cross, mut, gen, device)
            for mode, x in (("injected", dict(draws=draws)), ("philox", dict(seed=seeds))):
                before = kernels.LAUNCHES[key]
                got = launch(0, I, **x)
                launched += kernels.LAUNCHES[key] - before
                tag = f"expression islands {name} parity {parity} {mode}"
                if multigen and cross != "order":
                    same_schedules(fs, got, g, s, geom, parity, steps, None, tag, islands=I,
                                   **x, **kw)
                if pipelined:
                    old_ulps = max(old_ulps, against_expr_breed(
                        got, fs.deme_breed(g, ranks, geom, parity, islands=I, pipelined=False,
                                           **x, **kw), program.transcendental, tag))
                want = launch(0, I, plain=True, **x)
                torch.cuda.synchronize()
                check(got[0].dtype == dtype and torch.equal(got[0], want[0]),
                      f"{tag}: genomes differ from the plain version")
                check(bool(torch.isinf(got[1][:, ~real]).all())
                      and bool(torch.isfinite(got[1][:, real]).all()),
                      f"{tag}: pad scores not -inf or real scores not finite")
                a, b = got[1][:, real], want[1][:, real]
                err = float((a - b).abs().max())
                check(bool(torch.isclose(a, b, rtol=rtol, atol=atol).all()),
                      f"{tag}: score error {err}")
                errs.append(err)
                del want
                for i in range(I):
                    one = launch(i, **(dict(draws=draws.island(i)) if mode == "injected"
                                       else dict(seed=seeds[i:i + 1])))
                    check(torch.equal(got[0][i], one[0]) and torch.equal(got[1][i], one[1]),
                          f"{tag}: island {i} differs from its single-population launch")
                del got
            solo, one = launch(0, 1, seed=seeds[:1]), launch(0, seed=seeds[:1])
            check(torch.equal(solo[0][0], one[0]) and torch.equal(solo[1][0], one[1]),
                  f"expression islands {name}: one island differs from the single launch")
            del draws, solo, one
        check(launched == 2 * geom.parities,
              f"expression islands {name}: {launched} launches under {key}")

        # Times at parity 0 (the last parity's ranks serve the loop too).
        out = torch.empty_like(g)
        work = [torch.empty_like(g), torch.empty_like(g)] if multigen else None

        def island_launch():
            if multigen:
                return fs.multigen_breed(g, s, geom, 0, steps, None, seed=seeds, out=out,
                                         work=work, islands=I, **kw)
            return fs.deme_breed(g, ranks, geom, 0, seed=seeds, out=out, islands=I, **kw)

        def single_launches():
            for i in range(I):
                if multigen:
                    fs.multigen_breed(g[i], s[i], geom, 0, steps, None, seed=seeds[i:i + 1],
                                      out=out[i], work=[w[i] for w in work], **kw)
                else:
                    fs.deme_breed(g[i], ranks[i * G:(i + 1) * G], geom, 0,
                                  seed=seeds[i:i + 1], out=out[i], **kw)

        reps = 5 if multigen else 20
        ms, loop_ms = cuda_ms(island_launch, reps), cuda_ms(single_launches, reps)
        old_ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seeds, out=out, islands=I,
                                               pipelined=False, **kw), reps) if pipelined else None
        plain_ms = cuda_ms(lambda: launch(0, I, plain=True, seed=seeds), 1 if multigen else 2)
        route = one_block_ms = None
        if multigen:
            route = mg_route(kernels, geom, dtype, kw)
            check(route["route"] == ("one_block" if cross == "order" else "cluster"),
                  f"expression islands {name}: {route}")
            if route["route"] == "cluster":
                one_block_ms = cuda_ms(lambda: fs.multigen_breed(
                    g, s, geom, 0, steps, None, seed=seeds, out=out, work=work, islands=I,
                    cluster=False, **kw), reps)
        gene_bytes = 2 if bf16 else 4
        chain = None
        bound_ms, bound_by, chain = breed_bound(geom, program=program, order=cross == "order",
                                                n_cities=cities, steps=steps,
                                                gene_bytes=gene_bytes)
        chain = chain if cross == "order" else None
        line = {"phase": "island_expr_compare", "case": name, "counter": key, "islands": I,
                "island_shape": [S, L], "steps": steps, "gene_dtype": str(dtype)[6:],
                "layout": geom.layout, "K": K, "D": geom.D, "Pp": geom.Pp,
                "genomes_equal": True, "single_launches_equal": True, "one_island_equal": True,
                "max_abs_err": max(errs), "score_rtol": rtol, "score_atol": atol,
                "kernel_ms": ms, "loop_ms": loop_ms, "loop_over_island": loop_ms / ms,
                "plain_ms": plain_ms, "bound_ms": I * bound_ms, "bound_by": bound_by,
                "chain_steps": chain, "chain_ms": chain_ms(chain, L),
                "kernel_over_bound": ms / (I * bound_ms),
                "schedule": route, "one_block_ms": one_block_ms, "expr_breed_ms": old_ms,
                "expr_breed_max_ulps": old_ulps if pipelined else None}
        print(json.dumps(line), flush=True)
        results[name] = {"counter": counter, "ms": ms, "loop_ms": loop_ms, "plain_ms": plain_ms,
                         "schedule": route, "expr_breed_ms": old_ms, "one_block_ms": one_block_ms,
                         "bound_ms": I * bound_ms, "bound_by": bound_by, "chain_steps": chain,
                         "chain_ms": chain_ms(chain, L),
                         "max_abs_err": max(errs), "shape": [I, S, L], "steps": steps,
                         "layout": geom.layout, "K": K, "D": geom.D,
                         "gene_dtype": str(dtype)[6:]}
        del g, s, out, work, ranks
        torch.cuda.empty_cache()


def phase_island_expr_runs(port, kernels, results, refs):
    """pga_run_islands with an expression hook, m = ISLAND_M, pct =
    ISLAND_PCT, after a warm-up epoch, for every ISLAND_EXPR_RUNS entry:
    launches of the island expression kernel equal the generations (T = 1)
    or ceil(m / T) per epoch and nothing else launches, the best rises,
    the scores are the genomes' objective; gens/s, ms/gen, the migration's
    ms per epoch and the busy share of a torch.profiler window, beside the
    same configuration's single-population run (``refs``: this script's
    earlier results). Then a target run of the creep islands, which must
    stop at an epoch boundary with the best below the target an epoch
    earlier."""
    import torch

    from libpga_tpu_torch.parallel import islands as pis

    cases = {c[0]: c for c in ISLAND_EXPR_CASES}
    loads = island_expr_workloads()
    for name, gens, src, ref_key in ISLAND_EXPR_RUNS:
        _, _, I, S, L, load, steps, bf16 = cases[name]
        counter = results[name]["counter"]  # the route island_expr_compare found
        objective, crossover, mutate = loads[load]
        T = steps if steps > 1 else None
        key = "islands_" + counter + ("_bf16" if bf16 else "")
        dtype = torch.bfloat16 if bf16 else torch.float32
        pga = island_solver(port, (I, S, L), 21, objective=objective, generations_per_launch=T,
                            gene_dtype=dtype)
        port.pga_set_crossover_function(pga, crossover)
        port.pga_set_mutate_function(pga, mutate)
        start_best = max(float(objective(p.genomes.float()).max()) for p in pga._populations)
        check(port.pga_run_islands(pga, ISLAND_M, ISLAND_M, ISLAND_PCT) == ISLAND_M,
              f"expression islands {name}: warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        before = pga.launches
        t0 = time.perf_counter()
        ran = port.pga_run_islands(pga, gens, ISLAND_M, ISLAND_PCT)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        want = gens if T is None else gens // ISLAND_M * math.ceil(ISLAND_M / T)
        best = best_of(pga)
        check(ran == gens, f"expression islands {name}: ran {ran} generations")
        check(launches[key] == want and sum(launches.values()) == want
              and pga.launches - before == want,
              f"expression islands {name}: launches {launches} for {gens} generations, want {want}")
        check(best > start_best, f"expression islands {name}: best {start_best} -> {best}")
        rtol, atol = ((TSP_RTOL, 0.0) if load == "tsp_creep"
                      else (EXPR_RTOL, EXPR_ATOL_PER_GENE * L))
        for p in pga._populations:
            check(p.genomes.dtype == dtype and bool(torch.isclose(
                p.scores, objective(p.genomes.float()), rtol=rtol, atol=atol).all()),
                f"expression islands {name}: scores are not the genomes' objective")
        g = torch.stack([p.genomes for p in pga._populations])
        s = torch.stack([p.scores for p in pga._populations])
        migrate_ms = cuda_ms(lambda: pis.migrate_local(g, s, int(S * ISLAND_PCT), "ring"), 20)
        del g, s
        ms_per_gen = 1e3 * seconds / ran
        ref = refs[src][ref_key]
        single = ref["gens_per_s"] if "gens_per_s" in ref else 1e3 / ref["ms_per_gen"]
        prof = profile_generations(port, pga, ms_per_gen, ISLAND_PROFILE_GENS,
                                   run=lambda n: port.pga_run_islands(pga, n, ISLAND_M, ISLAND_PCT))
        line = {"phase": "island_expr_run", "case": name, "islands": I, "island_shape": [S, L],
                "m": ISLAND_M, "pct": ISLAND_PCT, "generations_per_launch": T,
                "gene_dtype": str(dtype)[6:], "gens": ran, "launches": launches,
                "gens_per_s": ran / seconds, "ms_per_gen": ms_per_gen,
                "migrate_ms_per_epoch": migrate_ms, "single_run": ref_key,
                "single_gens_per_s": single, "island_over_single": (ran / seconds) / single,
                "start_best": start_best, "best": best, **prof}
        print(json.dumps(line), flush=True)
        results[name].update(launches=launches[key], gens_per_s=line["gens_per_s"],
                             ms_per_gen=ms_per_gen, single_gens_per_s=single,
                             migrate_ms_per_epoch=migrate_ms,
                             device_busy_share=prof["device_busy_share"])
        port.pga_deinit(pga)
        del pga
        torch.cuda.empty_cache()

    # Target: the creep islands stop at an epoch boundary; an epoch earlier
    # the best was below the target.
    objective, crossover, mutate = loads["creep"]
    _, _, I, S, L, _, _, _ = cases["creep-8x131072"]

    def solver():
        pga = island_solver(port, (I, S, L), 22)
        port.pga_set_mutate_function(pga, mutate)
        return pga

    pga = solver()
    gens = port.pga_run_islands(pga, 10_000, ISLAND_M, ISLAND_PCT, target=ISLAND_EXPR_TARGET)
    best = best_of(pga)
    port.pga_deinit(pga)
    earlier = solver()
    port.pga_run_islands(earlier, gens - ISLAND_M, ISLAND_M, ISLAND_PCT,
                         target=ISLAND_EXPR_TARGET)
    prev = best_of(earlier)
    port.pga_deinit(earlier)
    print(json.dumps({"phase": "island_expr_target", "islands": I, "island_shape": [S, L],
                      "mutate": CREEP, "target": ISLAND_EXPR_TARGET, "m": ISLAND_M, "gens": gens,
                      "best": best, "best_one_epoch_earlier": prev}), flush=True)
    check(0 < gens < 10_000 and gens % ISLAND_M == 0 and best >= ISLAND_EXPR_TARGET > prev,
          f"expression island target: {gens} generations, best {best}, an epoch earlier {prev}")


def bf16_population(geom, gen, device, islands=None):
    """bfloat16 genomes (uniform draws, rounded) with zero pad rows; a
    leading island axis where ``islands`` is given."""
    import torch

    lead = () if islands is None else (islands,)
    g = torch.rand(lead + (geom.Pp, geom.L), generator=gen, device=device).to(torch.bfloat16)
    g[..., geom.P:, :] = 0
    return g


def bf16_check(tag, got, want, f32_rounded, P, rtol, atol, gene_ulps=0) -> float:
    """A bf16 launch ``got`` against its plain version ``want``: genomes
    bit for bit (or within ``gene_ulps`` bf16 ulps), scores within
    rtol/atol, -inf on pad rows; and against the float32 kernel's
    children rounded to bf16 (``f32_rounded``, bit for bit; None: not
    compared). Returns the largest score difference."""
    import torch

    check(got[0].dtype == torch.bfloat16, f"{tag}: children are {got[0].dtype}")
    if gene_ulps:
        ulps = (got[0].view(torch.int16).to(torch.int32)
                - want[0].view(torch.int16).to(torch.int32)).abs()
        check(int(ulps.max()) <= gene_ulps, f"{tag}: genomes {int(ulps.max())} bf16 ulps apart")
    else:
        check(torch.equal(got[0], want[0]), f"{tag}: genomes differ from the plain version")
    if f32_rounded is not None:
        check(torch.equal(got[0], f32_rounded),
              f"{tag}: genomes differ from the float32 kernel's children, rounded")
    real = torch.arange(got[1].shape[-1], device=got[1].device) < P
    check(bool(torch.isinf(got[1][..., ~real]).all()), f"{tag}: pad scores not -inf")
    a, b = got[1][..., real], want[1][..., real]
    err = float((a - b).abs().max())
    check(bool(torch.isclose(a, b, rtol=rtol, atol=atol).all()), f"{tag}: score error {err}")
    return err


def phase_bf16_compare(port, fs, device, results):
    """The bf16 cases of the deme, multigen, expression and island
    launches against their plain versions and against the float32
    kernels' children rounded, with injected and with Philox draws; times
    each beside its 2-byte bound, the float32 kernel on the same shape and
    the plain version."""
    import torch

    from libpga_tpu_torch import objectives as obj
    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.ops.fused_step import is_expression

    bf = torch.bfloat16

    def record(name, geom, errs, ms, f32_ms, plain_ms, bound, steps=1, **extra):
        r = results.setdefault(name, {})
        r.update(max_abs_err=max(errs), ms=ms, f32_ms=f32_ms, plain_ms=plain_ms,
                 bound_ms=bound[0], bound_by=bound[1], layout=geom.layout, K=geom.K, D=geom.D,
                 steps=steps, **extra)
        print(json.dumps({"phase": "bf16_compare", "case": name, "layout": geom.layout,
                          "K": geom.K, "D": geom.D, "Pp": geom.Pp, "q": geom.q, "steps": steps,
                          "genomes_equal": True, "f32_kernel_rounded_equal": True,
                          "max_abs_err": max(errs), "kernel_ms": ms, "f32_kernel_ms": f32_ms,
                          "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                          "kernel_over_bound": ms / bound[0], **extra}), flush=True)

    # One generation: ping-pong at 1,048,576x100, riffle at 40,000x100, and
    # gaussian mutation (whose clip can round to 1.0) at 65,536x100.
    for name, (P, L), parities, layout, mutate in (
        ("deme_breed[pingpong,bf16]", MAIN_SHAPES["pingpong"], (0, 1), "pingpong", "point"),
        ("deme_breed[riffle,bf16]", MAIN_SHAPES["riffle"], (0,), "riffle", "point"),
        ("gaussian-65536", (65_536, 100), (1,), "pingpong", "gaussian"),
    ):
        geom = fs.resolve_geometry(P, L, gene_dtype=bf)
        check(geom.layout == layout and geom.q == 16, f"bf16 {name}: geometry {geom}")
        gen = torch.Generator(device=device).manual_seed(P + 16)
        g = bf16_population(geom, gen, device)
        s = torch.full((geom.Pp,), -torch.inf, device=device)
        s[:P] = g[:P].float().sum(dim=1)
        gauss = mutate == "gaussian"
        kw = dict(mutate=mutate, obj_id=obj.onemax.fused_id, mparams=torch.tensor(
            [0.15, 0.05] if gauss else [0.05, 0.0], device=device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        errs, ulps_seen = [], 0
        for parity in parities:
            ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, device))
            G, K = geom.G, geom.K
            injected = fs.Draws(
                sel_u=torch.rand((G, K, 2), generator=gen, device=device),
                cross=(torch.rand((G, K, L), generator=gen, device=device) < 0.5).to(torch.uint8),
                mut_u=torch.rand((G, K, 4), generator=gen, device=device),
                gauss=torch.rand((3, G, K, L), generator=gen, device=device) if gauss else None)
            for mode, x in (("injected", dict(draws=injected)), ("philox", dict(seed=seed))):
                got = fs.deme_breed(g, ranks, geom, parity, **x, **kw)
                f32 = fs.deme_breed(g.float(), ranks, geom, parity, **x, **kw)[0].to(bf)
                d = x.get("draws") or fs.philox_draws(seed, G, K, L, mutate)
                want = fs.deme_breed_reference(g, ranks, geom, parity, d, **kw)
                torch.cuda.synchronize()
                # Gaussian genes: logf/cosf on the card against torch's may
                # differ in the last float ulp, which can move a rounding.
                errs.append(bf16_check(f"bf16 {name} parity {parity} {mode}", got, want, f32, P,
                                       0.0, SCORE_ATOL, gene_ulps=1 if gauss else 0))
                same_deme_kernels(fs, got, g, ranks, geom, parity,
                                  f"bf16 {name} parity {parity} {mode}", **x, **kw)
                if gauss:
                    ulps_seen = max(ulps_seen, int((got[0] != want[0]).sum()))
                    check(bool((got[0] == 1.0).any()), f"bf16 {name}: no gene rounded to 1.0")
                del got, want, f32, d
        out = torch.empty_like(g)
        g32, out32 = g.float(), torch.empty((geom.Pp, L), device=device)
        ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seed, out=out, **kw), 50)
        deme_ms = cuda_ms(lambda: fs.kernels.deme_breed_cuda(
            g, ranks, geom, 0, seed=seed, out=out, pipelined=False, **kw), 50)
        f32_ms = cuda_ms(lambda: fs.deme_breed(g32, ranks, geom, 0, seed=seed, out=out32, **kw), 50)
        plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
            g, ranks, geom, 0, fs.philox_draws(seed, geom.G, geom.K, L, mutate), **kw), 5)
        record(name, geom, errs, ms, f32_ms, plain_ms, breed_bound(geom, gene_bytes=2),
               shape=[P, L], f32_bound_ms=breed_bound(geom)[0], deme_breed_ms=deme_ms,
               counter=deme_key(fs.kernels, geom, bf),
               **({"genes_1_ulp_apart": ulps_seen} if gauss else {}))
        del g, g32, out, out32, injected
        torch.cuda.empty_cache()

    # Several generations per launch: 1,048,576x100 (ping-pong, D=8) and
    # 40,000x100 (riffle); 3 steps injected with per-deme elites, 8 and 1
    # with Philox draws (1 step: against the float32 kernel rounded).
    mparams = torch.tensor([0.05, 0.0], device=device)
    for name, (P, L), layout in (
        ("multigen_breed[pingpong,bf16]", MAIN_SHAPES["pingpong"], "pingpong"),
        ("multigen_breed[riffle,bf16]", MAIN_SHAPES["riffle"], "riffle"),
    ):
        geom = fs.resolve_geometry(P, L, multigen=True, gene_dtype=bf)
        check(geom.layout == layout, f"bf16 {name}: layout {geom.layout}")
        gen = torch.Generator(device=device).manual_seed(P + 17)
        g = bf16_population(geom, gen, device)
        s = torch.full((geom.Pp,), -torch.inf, device=device)
        s[:P] = g[:P].float().sum(dim=1)
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        errs = []
        for parity, steps, mode, e in ((geom.parities - 1, 3, "injected", 2),
                                       (0, MULTIGEN_T, "philox", 0), (0, 1, "philox", 0)):
            kw = dict(mparams=mparams, obj_id=obj.onemax.fused_id, elitism=e)
            x = (dict(draws=multigen_draws(fs, geom, steps, gen, device)) if mode == "injected"
                 else dict(seed=seed))
            got = fs.multigen_breed(g, s, geom, parity, steps, None, **x, **kw)
            want = fs.multigen_breed_reference(g, s, geom, parity, steps, math.inf, **x, **kw)
            f32 = (fs.multigen_breed(g.float(), s, geom, parity, steps, None, **x, **kw)[0].to(bf)
                   if steps == 1 else None)
            torch.cuda.synchronize()
            errs.append(bf16_check(f"bf16 {name} {steps} steps {mode}", got, want, f32, P,
                                   0.0, SCORE_ATOL))
            same_schedules(fs, got, g, s, geom, parity, steps, None, f"bf16 {name}", **x, **kw)
            check(not torch.equal(got[0], g), f"bf16 {name}: nothing bred")
            del got, want, f32, x
        kw = dict(seed=seed, mparams=mparams, obj_id=obj.onemax.fused_id)
        out, work = torch.empty_like(g), [torch.empty_like(g), torch.empty_like(g)]
        g32 = g.float()
        out32, work32 = torch.empty_like(g32), [torch.empty_like(g32), torch.empty_like(g32)]
        reps = 10 if P > 100_000 else 50
        route = mg_route(fs.kernels, geom, bf, kw)
        check(route["route"] == "cluster", f"bf16 {name}: {route}")
        ms = cuda_ms(lambda: fs.multigen_breed(g, s, geom, 0, MULTIGEN_T, None, out=out,
                                               **kw), reps)
        one_block_ms = cuda_ms(lambda: fs.multigen_breed(g, s, geom, 0, MULTIGEN_T, None,
                                                         out=out, work=work, cluster=False,
                                                         **kw), reps)
        f32_ms = cuda_ms(lambda: fs.multigen_breed(g32, s, geom, 0, MULTIGEN_T, None, out=out32,
                                                   work=work32, **kw), reps)
        plain_ms = cuda_ms(lambda: fs.multigen_breed_reference(
            g, s, geom, 0, MULTIGEN_T, math.inf, **kw), 2)
        record(name, geom, errs, ms, f32_ms, plain_ms,
               breed_bound(geom, steps=MULTIGEN_T, gene_bytes=2), steps=MULTIGEN_T, shape=[P, L],
               f32_bound_ms=breed_bound(geom, steps=MULTIGEN_T)[0], schedule=route,
               one_block_ms=one_block_ms)
        del g, g32, out, work, out32, work32
        torch.cuda.empty_cache()

    # Expression hooks: the trap at 1,048,576x60 (both parities), OneMax with
    # one-point crossover at 1,048,576x100; the trap at T = 8.
    loads, mg_loads = expr_workloads(), expr_multigen_workloads()
    for name, (P, L, objective, crossover, mutate), parities, steps in (
        ("expr_breed[trap,bf16]", loads["trap"], (0, 1), None),
        ("expr_breed[one_point,bf16]", loads["one_point"], (0,), None),
        ("expr_multigen[trap,bf16]", mg_loads["trap-1M"], None, EXPR_MG_T),
    ):
        cross, mut, mp, expr_obj, obj_id = expr_kinds(port, objective, crossover, mutate)
        program = expr_cuda.program_for(cross if is_expression(cross) else None,
                                        mut if is_expression(mut) else None, expr_obj)
        const = bool(getattr(expr_obj, "kernel_rowwise_consts", ()))
        geom = fs.resolve_geometry(P, L, crossover=cross, const_carrying=const,
                                   multigen=steps is not None, gene_dtype=bf)
        gen = torch.Generator(device=device).manual_seed(P + L + 18)
        g = bf16_population(geom, gen, device)
        s = torch.full((geom.Pp,), -torch.inf, device=device)
        s[:P] = objective(g[:P].float())
        kw = dict(crossover=cross, mutate=mut, obj_id=obj_id, objective=expr_obj,
                  mparams=torch.tensor(list(mp), dtype=torch.float32, device=device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        tol = dict(rtol=EXPR_RTOL, atol=EXPR_ATOL_PER_GENE * L)
        errs, extra = [], {}
        if steps is None:
            counter = expr_counter(fs.kernels, "expr_bf16", program, geom, bf, mut)
            pipelined = counter == "expr_pipelined_bf16"
            extra["counter"] = counter
            for parity in parities:
                ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, device))
                injected = expr_multigen_draws(fs, geom, 1, mut, cross, gen, device).at(0)
                for mode, x in (("injected", dict(draws=injected)), ("philox", dict(seed=seed))):
                    got = fs.deme_breed(g, ranks, geom, parity, **x, **kw)
                    if pipelined:
                        against_expr_breed(got, fs.deme_breed(g, ranks, geom, parity,
                                                              pipelined=False, **x, **kw),
                                           program.transcendental,
                                           f"bf16 {name} parity {parity} {mode}")
                    f32 = fs.deme_breed(g.float(), ranks, geom, parity, **x, **kw)[0].to(bf)
                    d = x.get("draws") or fs.philox_draws(seed, geom.G, geom.K, L, mut, cross)
                    want = fs.deme_breed_reference(g, ranks, geom, parity, d, **kw)
                    torch.cuda.synchronize()
                    errs.append(bf16_check(f"bf16 {name} parity {parity} {mode}", got, want, f32,
                                           P, **tol))
                    del got, want, f32, d

            def launch(genomes, out, **how):
                return fs.deme_breed(genomes, ranks, geom, 0, seed=seed, out=out, **how, **kw)

            def plain():
                return fs.deme_breed_reference(g, ranks, geom, 0, fs.philox_draws(
                    seed, geom.G, geom.K, L, mut, cross), **kw)

            if pipelined:
                out = torch.empty_like(g)
                extra["expr_breed_ms"] = cuda_ms(lambda: launch(g, out, pipelined=False), 20)
            bound = breed_bound(geom, program=program, gene_bytes=2)
            f32_bound = breed_bound(geom, program=program)
        else:
            for parity, t, mode in ((geom.parities - 1, 3, "injected"), (0, steps, "philox"),
                                    (0, 1, "philox")):
                x = (dict(draws=expr_multigen_draws(fs, geom, t, mut, cross, gen, device))
                     if mode == "injected" else dict(seed=seed))
                got = fs.multigen_breed(g, s, geom, parity, t, None, **x, **kw)
                want = fs.multigen_breed_reference(g, s, geom, parity, t, math.inf, **x, **kw)
                f32 = (fs.multigen_breed(g.float(), s, geom, parity, t, None, **x, **kw)[0].to(bf)
                       if t == 1 else None)
                torch.cuda.synchronize()
                errs.append(bf16_check(f"bf16 {name} {t} steps {mode}", got, want, f32, P, **tol))
                same_schedules(fs, got, g, s, geom, parity, t, None, f"bf16 {name} {t} steps",
                               **x, **kw)
                del got, want, f32, x
            work = {}

            def launch(genomes, out):
                w = work.setdefault(genomes.dtype, [torch.empty_like(genomes) for _ in range(2)])
                return fs.multigen_breed(genomes, s, geom, 0, steps, None, seed=seed, out=out,
                                         work=w, **kw)

            def plain():
                return fs.multigen_breed_reference(g, s, geom, 0, steps, math.inf, seed=seed, **kw)

            bound = breed_bound(geom, program=program, steps=steps, gene_bytes=2)
            f32_bound = breed_bound(geom, program=program, steps=steps)
        out, g32 = torch.empty_like(g), g.float()
        out32 = torch.empty_like(g32)
        reps = 5 if steps else 20
        ms = cuda_ms(lambda: launch(g, out), reps)
        f32_ms = cuda_ms(lambda: launch(g32, out32), reps)
        plain_ms = cuda_ms(plain, 2)
        if steps:
            extra["schedule"] = mg_route(fs.kernels, geom, bf, kw)
            check(extra["schedule"]["route"] == "cluster", f"bf16 {name}: {extra['schedule']}")
            extra["one_block_ms"] = cuda_ms(lambda: fs.multigen_breed(
                g, s, geom, 0, steps, None, seed=seed, out=out,
                work=[torch.empty_like(g), torch.empty_like(g)], cluster=False, **kw), reps)
        record(name, geom, errs, ms, f32_ms, plain_ms, bound, steps=steps or 1, shape=[P, L],
               f32_bound_ms=f32_bound[0], **extra)
        del g, g32, out, out32
        torch.cuda.empty_cache()

    # Islands: bench.py's 8 x 131,072x100 in one launch, against the plain
    # version, each island's single launch and the float32 island launch.
    I, S, L = ISLAND_RUN
    name = "deme_breed[islands,bf16]"
    geom = fs.resolve_geometry(S, L, gene_dtype=bf)
    gen = torch.Generator(device=device).manual_seed(S + 19)
    g = bf16_population(geom, gen, device, islands=I)
    s = torch.full((I, geom.Pp), -torch.inf, device=device)
    s[:, :S] = g[:, :S].float().sum(dim=2)
    seeds = torch.randint(0, 2**62, (I,), generator=gen, device=device)
    tie = fs.draw_tie_words(gen, I * geom.Pp, device).view(I, geom.Pp)
    kw = dict(mparams=mparams, obj_id=obj.onemax.fused_id)
    G, K, errs = geom.G, geom.K, []
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, tie)
        draws = island_draws(fs, geom, I, 1, "uniform", "point", gen, device, False)
        for mode, x in (("injected", dict(draws=draws)), ("philox", dict(seed=seeds))):
            got = fs.deme_breed(g, ranks, geom, parity, islands=I, **x, **kw)
            f32 = fs.deme_breed(g.float(), ranks, geom, parity, islands=I, **x, **kw)[0].to(bf)
            d = x.get("draws") or fs.island_philox_draws(seeds, G, K, L)
            want = fs.deme_breed_reference(g, ranks, geom, parity, d, **kw)
            torch.cuda.synchronize()
            tag = f"bf16 {name} parity {parity} {mode}"
            errs.append(bf16_check(tag, got, want, f32, S, 0.0, SCORE_ATOL))
            same_deme_kernels(fs, got, g, ranks, geom, parity, tag, islands=I, **x, **kw)
            for i in range(I):
                one = fs.deme_breed(g[i], ranks[i * G:(i + 1) * G], geom, parity, **(
                    dict(draws=draws.island(i)) if mode == "injected" else dict(seed=seeds[i:i + 1])),
                    **kw)
                check(torch.equal(got[0][i], one[0]) and torch.equal(got[1][i], one[1]),
                      f"{tag}: island {i} differs from its single-population launch")
            del got, want, f32, d
        del draws
    out, g32 = torch.empty_like(g), g.float()
    out32 = torch.empty_like(g32)

    def single_launches():
        for i in range(I):
            fs.deme_breed(g[i], ranks[i * G:(i + 1) * G], geom, 0, seed=seeds[i:i + 1],
                          out=out[i], **kw)

    ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seeds, out=out, islands=I, **kw), 20)
    f32_ms = cuda_ms(lambda: fs.deme_breed(g32, ranks, geom, 0, seed=seeds, out=out32, islands=I,
                                           **kw), 20)
    loop_ms = cuda_ms(single_launches, 20)
    deme_ms = cuda_ms(lambda: fs.kernels.deme_breed_cuda(
        g, ranks, geom, 0, seed=seeds, out=out, islands=I, pipelined=False, **kw), 20)
    plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
        g, ranks, geom, 0, fs.island_philox_draws(seeds, G, K, L), **kw), 2)
    bound = breed_bound(geom, gene_bytes=2)
    record(name, geom, errs, ms, f32_ms, plain_ms, (I * bound[0], bound[1]), shape=[I, S, L],
           loop_ms=loop_ms, f32_bound_ms=I * breed_bound(geom)[0], deme_breed_ms=deme_ms,
           counter=deme_key(fs.kernels, geom, bf, islands=True))
    del g, g32, out, out32
    torch.cuda.empty_cache()


def phase_bf16_runs(port, kernels, results):
    """PGA.run and PGA.run_islands at gene_dtype=bfloat16 through the
    pga_* API, each the main-path run of its kernels-line entry (launches
    of the bf16 kernel equal generations, ceil(gens / T) or island
    generations, and nothing else launches; the genomes stay bf16; the
    best rises; the scores are the stored genomes' objective), beside the
    same configuration at float32 over as many generations, run just
    before it; a torch.profiler window of the 1,048,576x100 OneMax run;
    order crossover at bf16 takes the panmictic path."""
    import torch

    from libpga_tpu_torch.ops.crossover import order_preserving_crossover
    from libpga_tpu_torch.ops.mutate import make_swap_mutate

    loads = expr_workloads()
    for name, load, P, L, T, I, counter, gens in BF16_RUNS:
        counter = results[name].get("counter", counter)  # the route bf16_compare found
        objective, crossover = "onemax", None
        if load != "onemax":
            _, _, objective, crossover, _ = loads[load]
        want = gens if T is None else -(-gens // T)

        def timed(dtype):
            """A solver of this case at ``dtype``, warmed up, then ``gens``
            generations: (solver, generations run, seconds, launches by
            counter, launches by the solver, best before the run)."""
            pga = port.pga_init(seed=21, config=port.PGAConfig(
                gene_dtype=dtype, generations_per_launch=T))
            for _ in range(I or 1):
                port.pga_create_population(pga, P, L)
            port.pga_set_objective_function(pga, objective)
            port.pga_set_crossover_function(pga, crossover)
            check(pga.uses_deme_kernel(P, L), f"{dtype} {name}: not on the deme path")
            start_best = max(float(pga._objective(p.genomes.float()).max())
                             for p in pga._populations)

            def run(n):
                if I:
                    return port.pga_run_islands(pga, n, ISLAND_M, ISLAND_PCT)
                return port.pga_run(pga, n)

            check(run(ISLAND_M if I else (T or WARMUP_GENS)) > 0, f"{dtype} {name}: warm-up")
            torch.cuda.synchronize()
            kernels.reset_launches()
            before = pga.launches
            t0 = time.perf_counter()
            ran = run(gens)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            check(ran == gens, f"{dtype} {name}: ran {ran} generations")
            check(sum(launches.values()) == want and pga.launches - before == want,
                  f"{dtype} {name}: launches {launches} for {ran} generations, want {want}")
            return pga, ran, seconds, launches, start_best

        f32, f32_ran, f32_seconds, _, _ = timed(torch.float32)
        port.pga_deinit(f32)
        del f32
        torch.cuda.empty_cache()
        pga, ran, seconds, launches, start_best = timed(torch.bfloat16)
        fn = pga._objective
        end_best = max(pga.get_best_with_score(h)[1] for h in pga._handles())
        f32_gens_per_s = f32_ran / f32_seconds
        line = {"phase": "bf16_run", "case": name, "workload": load, "shape": [P, L],
                "islands": I, "generations_per_launch": T, "gens": ran, "launches": launches,
                "gens_per_s": ran / seconds, "ms_per_gen": 1e3 * seconds / ran,
                "f32_gens": f32_ran, "f32_gens_per_s": f32_gens_per_s,
                "bf16_over_f32": (ran / seconds) / f32_gens_per_s,
                "start_best": start_best, "best": end_best}
        check(launches[counter] == want,
              f"bf16 {name}: launches {launches} for {ran} generations, want {want} of {counter}")
        check(end_best > start_best, f"bf16 {name}: best {start_best} -> {end_best}")
        for p in pga._populations:
            check(p.genomes.dtype == torch.bfloat16, f"bf16 {name}: genomes are {p.genomes.dtype}")
            check(bool(torch.isclose(p.scores, fn(p.genomes.float()), rtol=EXPR_RTOL,
                                     atol=max(SCORE_ATOL, EXPR_ATOL_PER_GENE * L)).all()),
                  f"bf16 {name}: scores are not the stored genomes' objective")
        if name == "deme_breed[pingpong,bf16]":
            line.update(profile_generations(port, pga, line["ms_per_gen"]))
        print(json.dumps(line), flush=True)
        results[name].update(launches=launches[counter], gens_per_s=line["gens_per_s"],
                             f32_gens_per_s=f32_gens_per_s,
                             device_busy_share=line.get("device_busy_share"))
        port.pga_deinit(pga)
        del pga
        torch.cuda.empty_cache()

    # Order crossover at bf16: declined by the deme path, as JAX declines it.
    pga = port.pga_init(seed=22, config=port.PGAConfig(gene_dtype=torch.bfloat16))
    h = port.pga_create_population(pga, 1000, 20)
    port.pga_set_objective_function(pga, "onemax")
    port.pga_set_crossover_function(pga, order_preserving_crossover)
    port.pga_set_mutate_function(pga, make_swap_mutate(0.5))
    kernels.reset_launches()
    ran = port.pga_run(pga, 5)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "bf16_order_panmictic", "shape": [1000, 20], "gens": ran,
                      "launches": dict(kernels.LAUNCHES),
                      "dtype": str(pga.population(h).genomes.dtype)}), flush=True)
    check(not pga.uses_deme_kernel(1000, 20) and ran == 5 and sum(kernels.LAUNCHES.values()) == 0
          and pga.population(h).genomes.dtype == torch.bfloat16,
          "bf16 order crossover: not the panmictic path")
    port.pga_deinit(pga)


def copy_bound(geom, gene_bytes: int, scored: bool) -> tuple:
    """Least time (ms) of the copy and what sets it: the harness's
    copy_bound_ms (every row read once and written once and, scored, the
    handed scores read and the scores written; no operations)."""
    from libpga_tpu_torch.tools.ablate_floor import copy_bound_ms

    return copy_bound_ms(geom, gene_bytes, scored), "bytes"


def phase_floor_compare(fs, onemax, device, results):
    """Each ablated case of the breed kernels (the floor harness, B7)
    against its plain version on the same inputs: genomes bit for bit,
    scores within SCORE_ATOL, copies equal to their row permutation;
    timed by CUDA events beside the production kernel of the same call,
    the bound and the plain version."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    mparams = (0.05, 0.0)
    for shape, (P, L, K) in FLOOR_SHAPES.items():
        for dtype in ((f32, bf16) if shape == "1M" else (f32,)):
            gb = 2 if dtype == bf16 else 4
            gen = torch.Generator(device=device).manual_seed(P + gb)
            prod = fs.make_fused_breed(P, L, onemax, deme_size=K, device=device, gene_dtype=dtype,
                                       mparams=mparams)
            g = torch.rand((prod.geom.Pp, L), generator=gen, device=device).to(dtype)
            g[P:] = 0
            s = g.float().sum(dim=1)
            s[P:] = -torch.inf
            seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
            ranks = fs.compute_ranks(s, prod.geom, 0, fs.draw_tie_words(gen, prod.geom.Pp, device))
            out = torch.empty_like(g)
            full_ms = cuda_ms(lambda: fs.deme_breed(g, ranks, prod.geom, 0, seed=seed, out=out,
                                                    **prod.kw), 20)
            full_bound = breed_bound(prod.geom, gene_bytes=gb)
            for name, ablate, scored in FLOOR_CASES:
                if dtype == bf16 and name not in FLOOR_BF16_CASES:
                    continue
                copy = "copy_only" in ablate
                breed = fs.make_fused_breed(
                    P, L, onemax if scored else None, deme_size=K, layout="riffle",
                    device=device, gene_dtype=dtype, mparams=mparams, ablate=ablate)
                geom, kw = breed.geom, breed.kw
                tag = f"floor {name} {shape} {str(dtype)[6:]}"
                errs, library_ms, deme_ms = [], None, None
                if copy:
                    handed = s.view(geom.G, geom.K)
                    alias = "alias_io" in ablate
                    src = g.clone() if alias else g
                    want = fs.deme_breed_reference(g, handed, geom, 0, None, **kw)
                    got = fs.deme_breed(src, handed, geom, 0, out=src if alias else None, **kw)
                    torch.cuda.synchronize()
                    _, write = geom.row_maps(0, device)
                    check(torch.equal(got[0], want[0]), f"{tag}: genomes differ")
                    check(torch.equal(got[0][write.reshape(-1)], g), f"{tag}: not the row map")
                    errs.append(float((got[0].float() - want[0].float()).abs().max()))
                    if scored:
                        check(torch.equal(got[1], want[1]), f"{tag}: scores differ")
                        fin = torch.isfinite(want[1])
                        errs.append(float((got[1][fin] - want[1][fin]).abs().max()))
                    dst = src if alias else torch.empty_like(g)
                    ms = cuda_ms(lambda: fs.deme_breed(src, handed, geom, 0, out=dst, **kw), 20)
                    plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
                        g, handed, geom, 0, None, **kw), 3)
                    bound_ms, bound_by = copy_bound(geom, gb, scored)
                    if not scored and not alias:
                        # One PyTorch call of the same function: index_select
                        # of each output row's source row.
                        read, _ = geom.row_maps(0, device)
                        rows = torch.empty(geom.Pp, dtype=torch.long, device=device)
                        rows[write.reshape(-1)] = read.reshape(-1)
                        lib = torch.empty_like(g)
                        check(torch.equal(torch.index_select(g, 0, rows, out=lib), got[0]),
                              f"{tag}: index_select differs")
                        library_ms = cuda_ms(lambda: torch.index_select(g, 0, rows, out=lib), 20)
                else:
                    r = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(gen, geom.Pp, device))
                    injected = fs.Draws(
                        sel_u=torch.rand((geom.G, K, 2), generator=gen, device=device),
                        cross=(torch.rand((geom.G, K, L), generator=gen, device=device)
                               < 0.5).to(torch.uint8),
                        mut_u=torch.rand((geom.G, K, 4), generator=gen, device=device))
                    for mode, draws in (("injected", injected), ("philox", None)):
                        if draws is None:
                            x = dict(seed=seed)
                            got = fs.deme_breed(g, r, geom, 0, **x, **kw)
                            draws = fs.philox_draws(seed, geom.G, K, L)
                        else:
                            x = dict(draws=draws)
                            got = fs.deme_breed(g, r, geom, 0, **x, **kw)
                        want = fs.deme_breed_reference(g, r, geom, 0, draws, **kw)
                        torch.cuda.synchronize()
                        check(torch.equal(got[0], want[0]), f"{tag} {mode}: genomes differ")
                        # The stage harness follows the route: deme_pipelined_kernel's
                        # case; deme_breed_kernel's case of the mask is held to it.
                        same_deme_kernels(fs, got, g, r, geom, 0, f"{tag} {mode}", **x, **kw)
                        errs.append(float((got[0].float() - want[0].float()).abs().max()))
                        if scored:
                            real = torch.arange(geom.Pp, device=device) < P
                            check(bool(torch.isinf(got[1][~real]).all()), f"{tag}: pad scores")
                            errs.append(float((got[1][real] - want[1][real]).abs().max()))
                            check(errs[-1] <= SCORE_ATOL, f"{tag} {mode}: score error {errs[-1]}")
                    dst = torch.empty_like(g)
                    ms = cuda_ms(lambda: fs.deme_breed(g, r, geom, 0, seed=seed, out=dst, **kw), 20)
                    deme_ms = cuda_ms(lambda: fs.kernels.deme_breed_cuda(
                        g, r, geom, 0, seed=seed, out=dst, pipelined=False, **kw), 20)
                    plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
                        g, r, geom, 0, fs.philox_draws(seed, geom.G, K, L), **kw), 3)
                    bound_ms, bound_by, _ = breed_bound(geom, ablate=ablate, gene_bytes=gb,
                                                        scored=scored)
                line = {"phase": "floor_compare", "case": name, "shape": [P, L],
                        "gene_dtype": str(dtype)[6:], "ablate": list(ablate),
                        "layout": geom.layout, "K": geom.K, "Pp": geom.Pp,
                        "genomes_equal": True, "max_abs_err": max(errs), "kernel_ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, "production_ms": full_ms,
                        "production_layout": prod.geom.layout,
                        "production_bound_ms": full_bound[0], "deme_breed_ms": deme_ms,
                        "kernel": "deme_breed_copy" if copy else "deme_pipelined"}
                print(json.dumps(line), flush=True)
                key = "ablate_copy" if copy else "ablate_stages"
                entry = results.setdefault(key, {"max_abs_err": 0.0, "cases": {}})
                entry["max_abs_err"] = max(entry["max_abs_err"], max(errs))
                entry["cases"][f"{name}-{shape}-{str(dtype)[6:]}"] = {
                    k: line[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "production_ms", "production_layout",
                                         "deme_breed_ms")}
                if shape == "1M" and dtype == f32 and name in ("copy_riffle", "floor"):
                    entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=library_ms, case=name, shape=[P, L],
                                 deme_breed_ms=deme_ms)
                del breed, got, want

    # The multi-generation kernel's cases at T = 8, at 1,048,576x100.
    P, L, K = FLOOR_SHAPES["1M"]
    prod = fs.make_fused_multigen(P, L, onemax, deme_size=K, device=device, mparams=mparams)
    geom = prod.geom
    gen = torch.Generator(device=device).manual_seed(17)
    g, s = population(geom, gen, device)
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
    out = torch.empty_like(g)
    work = [torch.empty_like(g), torch.empty_like(g)]
    full_ms = cuda_ms(lambda: fs.multigen_breed(g, s, geom, 0, FLOOR_T, None, seed=seed, out=out,
                                                **prod.kw), 10)
    full_one_block_ms = cuda_ms(lambda: fs.multigen_breed(
        g, s, geom, 0, FLOOR_T, None, seed=seed, out=out, work=work, cluster=False, **prod.kw), 10)
    route = mg_route(fs.kernels, geom, torch.float32, prod.kw)
    check(route["route"] == "cluster", f"floor multigen: {route}")
    for flag, target in FLOOR_MULTIGEN_CASES:
        launch = fs.make_fused_multigen(P, L, onemax, deme_size=K, device=device, mparams=mparams,
                                        ablate=(flag,))
        kw, tgt = launch.kw, math.inf if target is None else target
        errs = []
        for mode in (dict(draws=multigen_draws(fs, geom, FLOOR_T, gen, device)), dict(seed=seed)):
            got = fs.multigen_breed(g, s, geom, 0, FLOOR_T, target, **mode, **kw)
            want = fs.multigen_breed_reference(g, s, geom, 0, FLOOR_T, tgt, **mode, **kw)
            torch.cuda.synchronize()
            tag = f"floor multigen {flag} {'injected' if 'draws' in mode else 'philox'}"
            check(torch.equal(got[0], want[0]), f"{tag}: genomes differ")
            check(torch.equal(torch.isinf(got[1]), torch.isinf(want[1])), f"{tag}: -inf rows")
            fin = torch.isfinite(want[1])
            errs.append(float((got[1][fin] - want[1][fin]).abs().max()))
            check(errs[-1] <= SCORE_ATOL, f"{tag}: score error {errs[-1]}")
            same_schedules(fs, got, g, s, geom, 0, FLOOR_T, target, tag, **mode, **kw)
        ms = cuda_ms(lambda: fs.multigen_breed(g, s, geom, 0, FLOOR_T, None, seed=seed, out=out,
                                               **kw), 10)
        one_block_ms = cuda_ms(lambda: fs.multigen_breed(
            g, s, geom, 0, FLOOR_T, None, seed=seed, out=out, work=work, cluster=False, **kw), 10)
        plain_ms = cuda_ms(lambda: fs.multigen_breed_reference(
            g, s, geom, 0, FLOOR_T, math.inf, seed=seed, **kw), 2)
        bound_ms, bound_by, _ = breed_bound(geom, steps=FLOOR_T)
        line = {"phase": "floor_compare", "case": f"multigen_{flag}", "shape": [P, L],
                "steps": FLOOR_T, "compare_target": target, "layout": geom.layout, "K": geom.K,
                "D": geom.D, **route, "genomes_equal": True, "same_as_one_block": True,
                "max_abs_err": max(errs), "kernel_ms": ms, "one_block_ms": one_block_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "production_ms": full_ms, "production_one_block_ms": full_one_block_ms}
        print(json.dumps(line), flush=True)
        entry = results.setdefault("ablate_multigen", {"max_abs_err": 0.0, "cases": {}})
        entry["max_abs_err"] = max(entry["max_abs_err"], max(errs))
        entry["cases"][flag] = {k: line[k] for k in ("kernel_ms", "one_block_ms", "plain_ms",
                                                     "production_ms", "production_one_block_ms")}
        if flag == "no_freeze":
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         case=flag, shape=[P, L], steps=FLOOR_T)


def phase_floor_partition(kernels, results):
    """This slice's path: the port's floor harness
    (libpga_tpu_torch/tools/ablate_floor.py with --dsweep and --tsweep) at
    1,048,576x100 and 40,000x100 float32 and 1,048,576x100 bf16, then the
    stage harness (tools/ablate_kernel.py) at 1,048,576x100, the launch
    counts set to 0 just before and read just after: every kernel of the
    path must have launched."""
    from libpga_tpu_torch.tools import ablate_floor, ablate_kernel

    kernels.reset_launches()
    records = []
    for argv in FLOOR_RUNS:
        rec = ablate_floor.main(argv + ["--rounds", str(FLOOR_ROUNDS), "--dsweep", "--tsweep"])
        records.append(rec)
        print(json.dumps({"phase": "floor_partition", "args": argv, **{
            k: rec[k] for k in ("medians_ms_per_gen", "copy_bound_ms", "floor_partition",
                                "coverage", "floor_partition_out_of_place",
                                "coverage_out_of_place", "dsweep_fixed_warps_ms",
                                "dispatch_us_per_block", "dsweep_ms",
                                "dsweep_8_warps_us_per_block", "tsweep_ms")}}), flush=True)
    stages = ablate_kernel.main(["f32", "512", "--rounds", str(FLOOR_ROUNDS)])
    launches = dict(kernels.LAUNCHES)
    print(json.dumps({"phase": "floor_stages", "shape": [1 << 20, 100], "medians_ms_per_gen":
                      stages, "launches": launches}), flush=True)
    for key in ("ablate_copy", "ablate_pipelined", "ablate_multigen", "ablate_copy_bf16",
                "ablate_pipelined_bf16", "ablate_multigen_bf16", "multigen", "multigen_bf16",
                "deme_pipelined", "deme_pipelined_bf16"):
        check(launches[key] > 0, f"floor_partition: {key} never launched ({launches})")
    for rec in records:
        check(all(v == v for v in rec["medians_ms_per_gen"].values()),
              f"floor_partition {rec['pop']} {rec['dtype']}: a median rests on no sample")
    for key, counter in (("ablate_copy", "ablate_copy"), ("ablate_stages", "ablate_pipelined"),
                         ("ablate_multigen", "ablate_multigen")):
        results[key]["launches"] = launches[counter]
    results["partition"] = records


def hook_floor_programs(fs) -> list:
    """The generated units of the hook sets of HOOK_FLOOR_ROWS, whose
    floor-harness units the build makes beside the production ones."""
    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.tools.ablate_kernel import hook_kinds

    progs = []
    for _, hooks, P, L, K, T, _, _, _ in HOOK_FLOOR_ROWS:
        kinds = hook_kinds(hooks, L)
        expr_obj = getattr(kinds["objective"], "expr_fused", None)
        mut = kinds["mutate"] if fs.is_expression(kinds["mutate"]) else None
        if mut is None and expr_obj is None:
            continue
        prog = expr_cuda.program_for(None, mut, expr_obj)
        if all(prog is not q for q in progs):
            progs.append(prog)
    return progs


def hook_case_flags(case) -> tuple:
    """The ablate flags of a hook-floor case: a name or a tuple of flags."""
    if isinstance(case, tuple):
        return case
    return {"floor": FLOOR_STAGES, "copy": FLOOR_COPY}.get(case, (case,))


def launched_once(kernels, key: str, mask: int, fn, tag: str):
    """``fn()``, checking that it launched kernel ``key``'s case ``mask``
    (kernels.MASK_LAUNCHES) exactly once."""
    before = kernels.MASK_LAUNCHES.get((key, mask), 0)
    out = fn()
    check(kernels.MASK_LAUNCHES.get((key, mask), 0) == before + 1,
          f"{tag}: {key} of mask {mask} did not launch once")
    return out


def phase_hook_floor_compare(fs, kernels, device, results, rows=HOOK_FLOOR_ROWS,
                             phase="hook_floor_compare"):
    """Each ablated case of ``rows`` (HOOK_FLOOR_ROWS: the floor harness
    with an expression hook or order crossover: expr_breed_kernel,
    expr_order_kernel, order_breed_kernel, expr_multigen_kernel<false/true>,
    multigen_breed_kernel<true>, and deme_breed_kernel's copy with the
    creep hook; B10_HOOK_ROWS: the creep hook at B = 2 and the builtin
    kernels' flag combinations) against its plain version at the row's
    shape, injected and Philox draws (at B > 1 both parities): each
    launch is the kernel's case of that mask, once; genomes bit for bit,
    scores within the tolerance of the objective (onemax SCORE_ATOL,
    expressions EXPR_RTOL / EXPR_ATOL_PER_GENE * L, the coordinate TSP
    TSP_RTOL); a multi-generation case at the row's T (8), as it is timed;
    a combination from a DEME_ABLATE_EXTRA unit. Timed by CUDA events
    beside the production launch of the same call, the bound and the
    plain version (a multi-generation row's: its Philox-mode comparison
    run). Each line printed is labelled ``phase``."""
    import torch

    from libpga_tpu_torch.ops import expr_cuda
    from libpga_tpu_torch.ops.evaluate import evaluate
    from libpga_tpu_torch.tools.ablate_kernel import hook_kinds

    for row, hooks, P, L, K, T, B, entry_name, cases in rows:
        kinds = hook_kinds(hooks, L)
        objective = kinds.pop("objective")
        multigen = T > 1
        kinds["subblock"] = B  # the multi-generation factory ignores it, as JAX's does
        make = fs.make_fused_multigen if multigen else fs.make_fused_breed
        prod = make(P, L, objective, deme_size=K, device=device, **kinds)
        geom, order = prod.geom, kinds["crossover"] == "order"
        check(geom.B == B, f"hook floor {row}: {geom}")
        expr_obj = prod.kw.get("objective")
        mut = kinds["mutate"]
        program = None
        if fs.is_expression(mut) or expr_obj is not None:
            program = expr_cuda.program_for(None, mut if fs.is_expression(mut) else None,
                                            expr_obj)
        n_cities = L if getattr(objective, "fused_id", 0) == 3 and not multigen else 0
        if expr_obj is not None:
            rtol, atol = EXPR_RTOL, EXPR_ATOL_PER_GENE * L
        elif n_cities:
            rtol, atol = TSP_RTOL, 0.0
        else:
            rtol, atol = 0.0, SCORE_ATOL
        gen = torch.Generator(device=device).manual_seed(P + L + T)
        g = torch.zeros((geom.Pp, L), device=device)
        g[:P] = torch.rand((P, L), generator=gen, device=device)
        s = torch.full((geom.Pp,), -torch.inf, device=device)
        s[:P] = evaluate(objective, g[:P])
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        out = torch.empty_like(g)
        work = [torch.empty_like(g), torch.empty_like(g)]
        route = None
        if multigen:
            prod_ms = cuda_ms(lambda: fs.multigen_breed(g, s, geom, 0, T, None, seed=seed, out=out,
                                                        work=work, **prod.kw), 5)
            route = mg_route(kernels, geom, torch.float32, prod.kw)
            # Uniform crossover takes the cluster schedule, hooks or not.
            check(route["route"] == ("one_block" if order else "cluster"),
                  f"hook floor {row}: {route}")
        else:
            ranks = fs.compute_ranks(s, geom, 0, fs.draw_tie_words(gen, geom.Pp, device))
            prod_ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seed, out=out,
                                                    **prod.kw), 20)
        cluster = route is not None and route["route"] == "cluster"
        pipelined = entry_name == "ablate_expr_pipelined"
        if pipelined:  # the route's kernel, from the shape
            check(expr_counter(kernels, "ablate_expr", program, geom, torch.float32, mut)
                  == entry_name, f"hook floor {row}: not on {entry_name}")
        prod_bound = breed_bound(geom, program=program, order=order, n_cities=n_cities, steps=T)
        for case in cases:
            ablate = hook_case_flags(case)
            name = "+".join(case) if isinstance(case, tuple) else case
            tag = f"hook floor {row} {name}"
            copy = "copy_only" in ablate
            key = "ablate_copy" if copy else entry_name
            mask = kernels.ablate_mask(ablate, multigen=True)
            if isinstance(case, tuple) and not copy:
                check(kernels.deme_macro(COMBO_UNITS[key], mask).startswith(
                      "#define DEME_ABLATE_EXTRA"), f"{tag}: mask {mask} is not an extra unit's")
            breed = make(P, L, objective, deme_size=K, device=device, ablate=ablate, **kinds)
            cg, kw = breed.geom, breed.kw
            errs, one_block_ms, old_ms = [], None, None
            if copy:
                handed = s.view(cg.G, cg.K)
                got = launched_once(kernels, key, mask,
                                    lambda: fs.deme_breed(g, handed, cg, 0, **kw), tag)
                want = fs.deme_breed_reference(g, handed, cg, 0, None, **kw)
                torch.cuda.synchronize()
                _, write = cg.row_maps(0, device)
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                      and torch.equal(got[0][write.reshape(-1)], g),
                      f"{tag}: differs from the plain copy")
                errs.append(float((got[0] - want[0]).abs().max()))
                ms = cuda_ms(lambda: fs.deme_breed(g, handed, cg, 0, out=out, **kw), 20)
                plain_ms = cuda_ms(lambda: fs.deme_breed_reference(g, handed, cg, 0, None, **kw), 2)
                bound = (*copy_bound(cg, 4, True), 0)
            elif multigen:
                # At the T the launch is timed at; the Philox plain run is
                # the one plain_ms times.
                tgt = float(s[:P].min()) if "no_freeze" in ablate else None
                draws = order_draws(fs, cg, mut, gen, device, steps=T) if order else \
                    expr_multigen_draws(fs, cg, T, mut, kinds["crossover"], gen, device)
                for mode in (dict(draws=draws), dict(seed=seed)):
                    m = "injected" if "draws" in mode else "philox"
                    got = launched_once(kernels, key, mask, lambda: fs.multigen_breed(
                        g, s, cg, 0, T, tgt, **mode, **kw), f"{tag} {m}")
                    want, plain_ms = cuda_run(lambda: fs.multigen_breed_reference(
                        g, s, cg, 0, T, math.inf if tgt is None else tgt, **mode, **kw))
                    check(torch.equal(got[0], want[0]), f"{tag} {m}: genomes differ")
                    fin = torch.isfinite(want[1])
                    check(torch.equal(fin, torch.isfinite(got[1])), f"{tag} {m}: -inf rows")
                    errs.append(float((got[1][fin] - want[1][fin]).abs().max()))
                    check(bool(torch.allclose(got[1][fin], want[1][fin], rtol=rtol, atol=atol)),
                          f"{tag} {m}: score error {errs[-1]}")
                    if cluster:
                        same_schedules(fs, got, g, s, cg, 0, T, tgt, f"{tag} {m}", **mode, **kw)
                del draws
                ms = cuda_ms(lambda: fs.multigen_breed(g, s, cg, 0, T, None, seed=seed, out=out,
                                                       work=work, **kw), 5)
                if cluster:
                    one_block_ms = cuda_ms(lambda: fs.multigen_breed(
                        g, s, cg, 0, T, None, seed=seed, out=out, work=work, cluster=False, **kw),
                        5)
                bound = breed_bound(cg, ablate=ablate, program=program, order=order, steps=T)
            else:
                injected = order_draws(fs, cg, mut, gen, device) if order else \
                    expr_multigen_draws(fs, cg, 1, mut, kinds["crossover"], gen, device).at(0)
                philox = fs.philox_draws(seed, cg.G, cg.K, L, mut, kinds["crossover"])
                # At B > 1 the row maps differ by parity: both are checked.
                r = [fs.compute_ranks(s, cg, parity, fs.draw_tie_words(gen, cg.Pp, device))
                     for parity in ((0, 1) if B > 1 else (0,))]
                real = torch.arange(cg.Pp, device=device) < P
                for parity, rp in enumerate(r):
                    for m, mode, draws in (("injected", dict(draws=injected), injected),
                                           ("philox", dict(seed=seed), philox)):
                        m += f" parity {parity}" if B > 1 else ""
                        got = launched_once(kernels, key, mask, lambda: fs.deme_breed(
                            g, rp, cg, parity, **mode, **kw), f"{tag} {m}")
                        if pipelined and not copy:  # expr_breed_kernel's case of the mask
                            against_expr_breed(got, fs.deme_breed(
                                g, rp, cg, parity, pipelined=False, **mode, **kw),
                                program.transcendental, f"{tag} {m}")
                        want = fs.deme_breed_reference(g, rp, cg, parity, draws, **kw)
                        torch.cuda.synchronize()
                        check(torch.equal(got[0], want[0]), f"{tag} {m}: genomes differ")
                        check(bool(torch.isinf(got[1][~real]).all()), f"{tag}: pad scores")
                        errs.append(float((got[1][real] - want[1][real]).abs().max()))
                        check(bool(torch.allclose(got[1][real], want[1][real], rtol=rtol,
                                                  atol=atol)), f"{tag} {m}: score error {errs[-1]}")
                del injected
                ms = cuda_ms(lambda: fs.deme_breed(g, r[0], cg, 0, seed=seed, out=out, **kw), 20)
                if pipelined:
                    old_ms = cuda_ms(lambda: fs.deme_breed(g, r[0], cg, 0, seed=seed, out=out,
                                                           pipelined=False, **kw), 20)
                plain_ms = cuda_ms(lambda: fs.deme_breed_reference(g, r[0], cg, 0, philox, **kw),
                                   2)
                bound = breed_bound(cg, ablate=ablate, program=program, order=order,
                                    n_cities=n_cities)
            line = {"phase": phase, "row": row, "case": name, "ablate": list(ablate),
                    "kernel": "deme_breed_copy" if copy else entry_name, "mask": mask,
                    "shape": [P, L], "steps": T, "layout": cg.layout, "K": cg.K, "D": cg.D,
                    "B": cg.B, "genomes_equal": True, "max_abs_err": max(errs), "kernel_ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                    "chain_steps": bound[2], "production_ms": prod_ms,
                    "production_bound_ms": prod_bound[0], "production_bound_by": prod_bound[1],
                    "production_chain_steps": prod_bound[2], "schedule": route,
                    "one_block_ms": one_block_ms, "expr_breed_ms": old_ms}
            print(json.dumps(line), flush=True)
            results.setdefault("lines", {})[f"{row}-{name}"] = line
            entry = results.setdefault(entry_name, {"max_abs_err": 0.0, "cases": {}})
            entry["max_abs_err"] = max(entry["max_abs_err"], max(errs))
            entry["cases"][f"{row}-{name}"] = {k: line[k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by", "production_ms",
                "production_bound_ms", "kernel", "schedule", "one_block_ms", "expr_breed_ms")}
            if f"{row}-{name}" == HOOK_FLOOR_ENTRIES.get(entry_name, (None,) * 3)[2]:
                entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                             case=f"{row}-{name}", shape=[P, L], steps=T,
                             production_ms=prod_ms)
            del breed, got, want
        del prod, g, s, out, work
        torch.cuda.empty_cache()


def phase_hook_floor_partition(kernels, results):
    """This slice's path: the stage harness (libpga_tpu_torch/tools/
    ablate_kernel.py --hooks) over every row of HOOK_FLOOR_ROWS at its
    shape, the launch counts set to 0 just before and read just after:
    every hook kernel's ablated cases and production launches must have
    launched. Prints each row's medians (ms a generation)."""
    from libpga_tpu_torch.tools import ablate_kernel

    kernels.reset_launches()
    medians = {}
    for row, hooks, P, L, K, T, _, _, _ in HOOK_FLOOR_ROWS:
        t0 = time.perf_counter()
        med = ablate_kernel.main(["f32", str(K), "--pop", str(P), "--len", str(L), "--hooks", hooks,
                                  "--steps", str(T), "--rounds", str(HOOK_FLOOR_ROUNDS)])
        medians[row] = med
        print(json.dumps({"phase": "hook_floor_partition", "row": row, "hooks": hooks,
                          "shape": [P, L], "K": K, "steps": T, "medians_ms_per_gen": med,
                          "stage_ms": {k: med["full"] - v for k, v in med.items() if k != "full"},
                          "seconds": time.perf_counter() - t0}), flush=True)
    launches = dict(kernels.LAUNCHES)
    print(json.dumps({"phase": "hook_floor_launches", "launches": launches}), flush=True)
    for key in ("ablate_expr_pipelined", "ablate_expr_order", "ablate_order",
                "ablate_expr_multigen", "ablate_expr_multigen_order", "ablate_multigen_order",
                "ablate_copy", "expr_pipelined", "expr_order", "order", "expr_multigen",
                "expr_multigen_order", "multigen_order"):
        check(launches[key] > 0, f"hook_floor_partition: {key} never launched ({launches})")
    for row, med in medians.items():
        check(all(v == v for v in med.values()), f"hook_floor_partition {row}: a median rests"
              " on no sample")
    for entry in HOOK_FLOOR_ENTRIES:
        results[entry]["launches"] = launches[entry]
    results["partition"] = medians


def warp_order_scores(fs, genomes, P, obj_id):
    """The breed kernels' scores of ``genomes`` as stored: each child's
    terms summed in a warp's lane order (pad rows, at and past ``P``,
    -inf)."""
    s = fs.rowwise_scores(obj_id, genomes.float(), warp_order=True)
    s[..., P:] = -math.inf
    return s


def pipe_info(kernels, geom, dtype) -> dict:
    """The pipelined kernel's plan at ``geom``: blocks a cluster, the
    bytes a block stages a deme (its parent rows and the deme's ranks),
    its shared memory."""
    plan = kernels.pipelined_plan(geom.K, geom.L, 2 if "bfloat16" in str(dtype) else 4, geom.q)
    return {"C": plan.C, "staged_bytes_per_block": plan.staged, "smem_bytes": plan.smem}


def floor_and_library_ms(fs, onemax, g, geom, dtype, device, reps=20) -> tuple:
    """(ms of the pipelined kernel's floor, every stage off and unscored;
    ms of one torch.index_select of the same row permutation, checked
    equal to the floor's children) at parity 0."""
    import torch

    floor = fs.make_fused_breed(geom.P, geom.L, None, device=device, gene_dtype=dtype,
                                subblock=geom.B, layout="pingpong", mparams=(0.05, 0.0),
                                ablate=FLOOR_STAGES)
    check((floor.geom.B, floor.geom.D) == (geom.B, geom.D), f"subblock floor geometry {floor.geom}")
    geom = floor.geom
    gen = torch.Generator(device=device).manual_seed(geom.L)
    ranks = fs.compute_ranks(g.float().sum(dim=1), geom, 0, fs.draw_tie_words(gen, geom.Pp, device))
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
    out = torch.empty_like(g)
    read, write = geom.row_maps(0, device)
    rows = torch.empty(geom.Pp, dtype=torch.long, device=device)
    rows[write.reshape(-1)] = read.reshape(-1)
    got = fs.deme_breed(g, ranks, geom, 0, seed=seed, **floor.kw)
    check(torch.equal(torch.index_select(g, 0, rows, out=out), got[0]),
          f"subblock floor {geom.P}x{geom.L}: index_select differs from the floor")
    floor_ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seed, out=out, **floor.kw),
                       reps)
    library_ms = cuda_ms(lambda: torch.index_select(g, 0, rows, out=out), reps)
    return floor_ms, library_ms


def phase_subblock_compare(port, fs, onemax, kernels, device, results):
    """The pipelined deme breed (B8) against its plain version at full
    width, injected and Philox draws, both parities: genomes bit for bit
    (and equal to deme_breed_kernel's at the same geometry), scores equal
    to the children's warp-order sums bit for bit, pad scores -inf; every
    cluster size the cells reach (C = 1 bf16, 2 float32 and the islands, 4
    at L = 128). Times it beside deme_breed_kernel at the same B-aware
    geometry, B1 (the same rows at subblock None), its floor (every stage
    off, unscored), one torch.index_select of the floor's row permutation
    and the plain version, with the bound. A sweep of genome lengths that
    take each cluster size; a shape no cluster holds, which must breed
    through deme_breed_kernel; the creep expression at B = 2 through
    expr_breed_kernel on the B-aware maps."""
    import torch

    for name, P, L, dtype_name, B, islands in SUBBLOCK_CASES:
        dtype = getattr(torch, dtype_name)
        geom = fs.resolve_geometry(P, L, gene_dtype=dtype, subblock=B)
        b1 = fs.resolve_geometry(P, L, gene_dtype=dtype)
        check(geom.layout == "pingpong" and geom.B == B, f"subblock {name}: geometry {geom}")
        check(kernels.pipelined_holds(geom, dtype), f"subblock {name}: no cluster holds a deme")
        n = islands or 1
        lead = () if islands is None else (islands,)
        gen = torch.Generator(device=device).manual_seed(P + B)
        g = torch.rand(lead + (geom.Pp, L), generator=gen, device=device).to(dtype)
        s = g.float().sum(dim=-1)
        kw = dict(mparams=torch.tensor([0.05, 0.0], device=device), obj_id=onemax.fused_id)
        key = ("deme_pipelined" if islands is None else "islands_deme_pipelined") + (
            "_bf16" if dtype == torch.bfloat16 else "")
        errs, sum_errs = [], []
        for parity in (0, 1):
            tie = fs.draw_tie_words(gen, n * geom.Pp, device).view(lead + (geom.Pp,))
            ranks = fs.compute_ranks(s, geom, parity, tie)
            seed = torch.randint(0, 2**62, (n,), generator=gen, device=device)
            injected = fs.Draws(
                sel_u=torch.rand(lead + (geom.G, geom.K, 2), generator=gen, device=device),
                cross=(torch.rand(lead + (geom.G, geom.K, L), generator=gen, device=device)
                       < 0.5).to(torch.uint8),
                mut_u=torch.rand(lead + (geom.G, geom.K, 4), generator=gen, device=device),
            )
            draw = fs.philox_draws if islands is None else fs.island_philox_draws
            for mode, draws in (("injected", injected), ("philox", None)):
                before = kernels.LAUNCHES[key]
                if draws is None:
                    got = fs.deme_breed(g, ranks, geom, parity, seed=seed, islands=islands, **kw)
                    draws = draw(seed, geom.G, geom.K, L)
                else:
                    got = fs.deme_breed(g, ranks, geom, parity, draws=draws, islands=islands,
                                        **kw)
                same_geom = kernels.deme_breed_cuda(g, ranks, geom, parity, draws=draws,
                                                    islands=islands, **kw)
                want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
                torch.cuda.synchronize()
                tag = f"subblock {name} parity {parity} {mode}"
                check(kernels.LAUNCHES[key] == before + 1, f"{tag}: {key} did not launch")
                check(torch.equal(got[0], want[0]), f"{tag}: genomes differ from the plain version")
                check(torch.equal(got[0], same_geom[0]), f"{tag}: genomes differ from"
                      " deme_breed_kernel at the same geometry")
                wo = warp_order_scores(fs, want[0], P, onemax.fused_id)
                check(torch.equal(got[1], wo),
                      f"{tag}: scores differ from the plain version's warp-order sums")
                check(torch.equal(got[1], same_geom[1]), f"{tag}: scores differ from"
                      " deme_breed_kernel's")
                real = torch.arange(geom.Pp, device=device) < P
                errs.append(max(float((got[0].float() - want[0].float()).abs().max()),
                                float((got[1][..., real] - wo[..., real]).abs().max())))
                sum_errs.append(float((got[1][..., real] - want[1][..., real]).abs().max()))
        out = torch.empty_like(g)
        tie = fs.draw_tie_words(gen, n * geom.Pp, device).view(lead + (geom.Pp,))
        ranks, ranks1 = fs.compute_ranks(s, geom, 0, tie), fs.compute_ranks(s, b1, 0, tie)
        ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seed, islands=islands,
                                           out=out, **kw), 50)
        same_ms = cuda_ms(lambda: kernels.deme_breed_cuda(g, ranks, geom, 0, seed=seed,
                                                          islands=islands, out=out, **kw), 50)
        b1_ms = cuda_ms(lambda: fs.deme_breed(g, ranks1, b1, 0, seed=seed, islands=islands,
                                              out=out, **kw), 50)
        ms_again = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seed, islands=islands,
                                                 out=out, **kw), 50)
        plain_ms = cuda_ms(lambda: fs.deme_breed_reference(
            g, ranks, geom, 0, draw(seed, geom.G, geom.K, L), **kw), 3)
        floor_ms = library_ms = None
        if islands is None:
            floor_ms, library_ms = floor_and_library_ms(fs, onemax, g, geom, dtype, device)
        bound_ms, bound_by, _ = breed_bound(geom, gene_bytes=2 if dtype == torch.bfloat16 else 4)
        bound_ms *= n
        line = {"phase": "subblock_compare", "case": name, "shape": [P, L], "islands": islands,
                "gene_dtype": dtype_name, "K": geom.K, "D": geom.D, "B": geom.B, "S": geom.S,
                **pipe_info(kernels, geom, dtype), "b1_D": b1.D, "genomes_equal": True,
                "scores_equal": True, "max_abs_err": max(errs),
                "score_err_to_torch_sum": max(sum_errs), "ms": ms, "ms_again": ms_again,
                "floor_ms": floor_ms, "library_ms": library_ms,
                "library_call": "torch.index_select of the floor's row permutation",
                "deme_breed_same_geometry_ms": same_ms, "b1_ms": b1_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
        print(json.dumps(line), flush=True)
        results[name] = line
        del g, s, out
        torch.cuda.empty_cache()

    # Each cluster size: the pipelined kernel beside deme_breed_kernel at the
    # same geometry, 1,048,576 rows float32 at B = 2, over genome lengths
    # that take clusters of 1, 2, 4 and 8 blocks.
    sweep = []
    for L, C in SUBBLOCK_CLUSTER_SWEEP.items():
        geom = fs.resolve_geometry(1 << 20, L, subblock=2)
        info = pipe_info(kernels, geom, torch.float32)
        check(info["C"] == C, f"cluster sweep L={L}: C {info['C']}, expected {C}")
        gen = torch.Generator(device=device).manual_seed(L)
        g = torch.rand((geom.Pp, L), generator=gen, device=device)
        ranks = fs.compute_ranks(g.sum(dim=1), geom, 0, fs.draw_tie_words(gen, geom.Pp, device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        kw = dict(mparams=torch.tensor([0.05, 0.0], device=device), obj_id=onemax.fused_id)
        out = torch.empty_like(g)
        got = kernels.deme_breed_cuda(g, ranks, geom, 0, seed=seed, pipelined=True, **kw)
        want = kernels.deme_breed_cuda(g, ranks, geom, 0, seed=seed, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"cluster sweep L={L}: the pipelined kernel differs from deme_breed_kernel")
        del got, want
        sweep.append({"L": L, "K": geom.K, **info,
                      "ms": cuda_ms(lambda: kernels.deme_breed_cuda(
                          g, ranks, geom, 0, seed=seed, out=out, pipelined=True, **kw), 20),
                      "deme_breed_same_geometry_ms": cuda_ms(lambda: kernels.deme_breed_cuda(
                          g, ranks, geom, 0, seed=seed, out=out, **kw), 20),
                      "bound_ms": breed_bound(geom)[0]})
        del g, out
    print(json.dumps({"phase": "subblock_compare", "case": "cluster sweep f32 B=2",
                      "rows": 1 << 20, "points": sweep}), flush=True)
    results["cluster_sweep"] = sweep
    torch.cuda.empty_cache()

    # A deme no cluster holds: deme_breed_kernel breeds it, counted as such.
    P, L = SUBBLOCK_NO_CLUSTER
    geom = fs.resolve_geometry(P, L, subblock=2)
    check(geom.B == 2 and not kernels.pipelined_holds(geom, torch.float32),
          f"subblock no-cluster: {geom} is held")
    gen = torch.Generator(device=device).manual_seed(L)
    g = torch.rand((geom.Pp, L), generator=gen, device=device)
    kw = dict(mparams=torch.tensor([0.05, 0.0], device=device), obj_id=onemax.fused_id)
    for parity in (0, 1):
        ranks = fs.compute_ranks(g.sum(dim=1), geom, parity,
                                 fs.draw_tie_words(gen, geom.Pp, device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        before = dict(kernels.LAUNCHES)
        got = fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}
        check(launched == {"pingpong": 1}, f"subblock no-cluster: launches {launched}")
        want = fs.deme_breed_reference(g, ranks, geom, parity,
                                       fs.philox_draws(seed, geom.G, geom.K, L), **kw)
        check(torch.equal(got[0], want[0]), f"subblock no-cluster parity {parity}: genomes")
        check(torch.equal(got[1], warp_order_scores(fs, want[0], P, onemax.fused_id)),
              f"subblock no-cluster parity {parity}: scores")
        del got, want
    out = torch.empty_like(g)
    line = {"phase": "subblock_compare", "case": "no cluster holds a deme", "shape": [P, L],
            "K": geom.K, "D": geom.D, "B": geom.B,
            "deme_bytes": geom.K * L * 4, "launched": "deme_breed_kernel (pingpong)",
            "genomes_equal": True, "scores_equal": True,
            "ms": cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 1, seed=seed, out=out, **kw), 20),
            "bound_ms": breed_bound(geom)[0]}
    print(json.dumps(line), flush=True)
    results["no_cluster"] = line
    del g, out
    torch.cuda.empty_cache()

    # The creep expression at B = 2: expr_pipelined_kernel on the B-aware
    # maps, against expr_breed_kernel on the same inputs.
    op = port.mutate_from_expression(CREEP, rate=0.05, sigma=0.1)
    geom = fs.resolve_geometry(1 << 20, 100, subblock=2)
    gen = torch.Generator(device=device).manual_seed(13)
    g = torch.rand((geom.Pp, 100), generator=gen, device=device)
    s = g.sum(dim=1)
    kw = dict(mparams=torch.tensor([0.05, 0.1], device=device), obj_id=onemax.fused_id, mutate=op)
    counter = expr_counter(kernels, "expr", op_program(op), geom, torch.float32, op)
    check(counter == "expr_pipelined", f"subblock creep: routed to {counter}")
    errs = []
    for parity in (0, 1):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        before = kernels.LAUNCHES[counter]
        got = fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw)
        check(kernels.LAUNCHES[counter] == before + 1, f"subblock creep: {counter} did not launch")
        against_expr_breed(got, fs.deme_breed(g, ranks, geom, parity, seed=seed, pipelined=False,
                                              **kw), False, f"subblock creep parity {parity}")
        want = fs.deme_breed_reference(g, ranks, geom, parity,
                                       fs.philox_draws(seed, geom.G, geom.K, 100, op), **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]), f"subblock creep parity {parity}: genomes differ")
        errs.append(float((got[1] - want[1]).abs().max()))
        check(errs[-1] <= SCORE_ATOL, f"subblock creep parity {parity}: score error {errs[-1]}")
    out = torch.empty_like(g)
    ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 1, seed=seed, out=out, **kw), 20)
    old_ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 1, seed=seed, out=out, pipelined=False,
                                           **kw), 20)
    # The same hook on the same rows at B = 1 (subblock None), in turns.
    b1 = fs.resolve_geometry(1 << 20, 100)
    ranks1 = fs.compute_ranks(s, b1, 1, fs.draw_tie_words(gen, b1.Pp, device))
    b1_ms = cuda_ms(lambda: fs.deme_breed(g, ranks1, b1, 1, seed=seed, out=out, **kw), 20)
    ms_again = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 1, seed=seed, out=out, **kw), 20)
    b1_again = cuda_ms(lambda: fs.deme_breed(g, ranks1, b1, 1, seed=seed, out=out, **kw), 20)
    line = {"phase": "subblock_compare", "case": "creep-B2 (expr_pipelined_kernel)",
            "shape": [1 << 20, 100], "K": geom.K, "D": geom.D, "B": geom.B,
            "genomes_equal": True, "max_abs_err": max(errs), "ms": ms, "ms_again": ms_again,
            "expr_breed_ms": old_ms,
            "b1_ms": b1_ms, "b1_ms_again": b1_again, "b1_D": b1.D,
            "bound_ms": breed_bound(geom, program=op_program(op))[0]}
    print(json.dumps(line), flush=True)
    results["creep-B2"] = line
    del g, s, out
    torch.cuda.empty_cache()


def op_program(op):
    """The generated hooks of an expression mutation (for its bound)."""
    from libpga_tpu_torch.ops import expr_cuda

    return expr_cuda.program_for(None, op, None)


def phase_subblock_run(port, kernels, results, single, islands_single):
    """PGA.run of OneMax 1,048,576x100 at subblock=2 (float32, 200
    generations; bf16, 100) and pga_run_islands at 8 x 131,072x100 (200
    generations, m = 10) after a warm-up, the counts set to 0 just before
    and read just after: launches of the pipelined kernel equal the
    generations and nothing else launches, the best rises, the scores are
    the genomes' onemax. gens/s beside the subblock=None run of the same
    shape in this call, and a torch.profiler window's busy share."""
    import torch

    for name, dtype_name, gens_want, key in (
            ("f32-B2", "float32", SUBBLOCK_RUN_GENS, "deme_pipelined"),
            ("bf16-B2", "bfloat16", SUBBLOCK_RUN_GENS // 2, "deme_pipelined_bf16")):
        P, L = MAIN_SHAPES["pingpong"]
        pga = port.pga_init(seed=1, config=port.PGAConfig(
            subblock=2, gene_dtype=getattr(torch, dtype_name)))
        h = port.pga_create_population(pga, P, L)
        port.pga_set_objective_function(pga, "onemax")
        start_best = float(pga.population(h).genomes.float().sum(dim=1).max())
        check(port.pga_run(pga, WARMUP_GENS) == WARMUP_GENS, "subblock warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        gens = port.pga_run(pga, gens_want)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        pop = pga.population(h)
        _, best = pga.get_best_with_score(h)
        check(gens == gens_want, f"subblock run {name}: ran {gens} generations")
        check(launches[key] == gens and sum(launches.values()) == gens,
              f"subblock run {name}: launches {launches} for {gens} generations")
        check(best > start_best + 10.0 and best < L, f"subblock run {name}: best {start_best} -> {best}")
        check(bool(torch.isclose(pop.scores, pop.genomes.float().sum(dim=1), rtol=0,
                                 atol=SCORE_ATOL).all()), f"subblock run {name}: scores")
        ref = single["pingpong"]["gens_per_s"] if dtype_name == "float32" else None
        line = {"phase": "subblock_run", "case": name, "shape": [P, L], "subblock": 2,
                **{k: results[name][k] for k in SUBBLOCK_PLAN_KEYS},
                "gens": gens, "launches": launches, "gens_per_s": gens / seconds,
                "ms_per_gen": 1e3 * seconds / gens, "subblock_none_gens_per_s": ref,
                "start_best": start_best, "best": best,
                **profile_generations(port, pga, 1e3 * seconds / gens)}
        print(json.dumps(line), flush=True)
        results[name].update(launches=launches[key], run=line)
        port.pga_deinit(pga)
        del pga, pop
        torch.cuda.empty_cache()

    I, S, L = ISLAND_RUN
    pga = island_solver(port, ISLAND_RUN, 7, subblock=2)
    start_best = max(float(p.genomes.sum(dim=1).max()) for p in pga._populations)
    check(port.pga_run_islands(pga, ISLAND_M, ISLAND_M, ISLAND_PCT) == ISLAND_M,
          "subblock island warm-up")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    gens = port.pga_run_islands(pga, SUBBLOCK_RUN_GENS, ISLAND_M, ISLAND_PCT)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    best = best_of(pga)
    key = "islands_deme_pipelined"
    check(gens == SUBBLOCK_RUN_GENS, f"subblock islands: ran {gens} generations")
    check(launches[key] == gens and sum(launches.values()) == gens,
          f"subblock islands: launches {launches} for {gens} generations")
    check(best > start_best + 10.0 and best < L, f"subblock islands: best {start_best} -> {best}")
    for p in pga._populations:
        check(bool(torch.isclose(p.scores, p.genomes.sum(dim=1), rtol=0, atol=SCORE_ATOL).all()),
              "subblock islands: scores are not the genomes' onemax")
    ms_per_gen = 1e3 * seconds / gens
    line = {"phase": "subblock_run", "case": "islands-B2", "islands": I, "island_shape": [S, L],
            **{k: results["islands-B2"][k] for k in SUBBLOCK_PLAN_KEYS},
            "m": ISLAND_M, "pct": ISLAND_PCT, "gens": gens, "launches": launches,
            "gens_per_s": gens / seconds, "ms_per_gen": ms_per_gen,
            "subblock_none_gens_per_s": islands_single, "start_best": start_best, "best": best,
            **profile_generations(port, pga, ms_per_gen, ISLAND_PROFILE_GENS,
                                  run=lambda n: port.pga_run_islands(pga, n, ISLAND_M,
                                                                     ISLAND_PCT))}
    print(json.dumps(line), flush=True)
    results["islands-B2"].update(launches=launches[key], run=line)
    port.pga_deinit(pga)
    del pga
    torch.cuda.empty_cache()


def phase_subblock_floor_compare(fs, onemax, kernels, device, results):
    """The floor harness at B > 1 (B10): every stage case of
    deme_pipelined_kernel (each flag alone and the floor, scored and
    unscored) at subblock_compare's geometries against the plain version
    at the same geometry, injected and Philox draws, both parities:
    genomes bit for bit, scores equal to the children's warp-order sums.
    Timed by CUDA events beside the production launch of the same call,
    the bound and the plain version; the unscored floor, a row
    permutation, also beside one torch.index_select of the same rows."""
    import torch

    mparams = (0.05, 0.0)
    for name, P, L, dtype_name, B in SUBBLOCK_FLOOR_CASES:
        dtype = getattr(torch, dtype_name)
        gb = 2 if dtype == torch.bfloat16 else 4
        prod = fs.make_fused_breed(P, L, onemax, device=device, gene_dtype=dtype, subblock=B,
                                   mparams=mparams)
        geom = prod.geom
        check(geom.layout == "pingpong" and geom.B == B, f"subblock floor {name}: {geom}")
        gen = torch.Generator(device=device).manual_seed(P + B + gb)
        g = torch.rand((geom.Pp, L), generator=gen, device=device).to(dtype)
        s = g.float().sum(dim=1)
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=device)
        injected = fs.Draws(
            sel_u=torch.rand((geom.G, geom.K, 2), generator=gen, device=device),
            cross=(torch.rand((geom.G, geom.K, L), generator=gen, device=device) < 0.5).to(
                torch.uint8),
            mut_u=torch.rand((geom.G, geom.K, 4), generator=gen, device=device))
        philox = fs.philox_draws(seed, geom.G, geom.K, L)
        ranks = [fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, device))
                 for parity in (0, 1)]
        out = torch.empty_like(g)
        prod_ms = cuda_ms(lambda: fs.deme_breed(g, ranks[0], geom, 0, seed=seed, out=out,
                                                **prod.kw), 20)
        prod_bound = breed_bound(geom, gene_bytes=gb)
        cases = {}
        for flag_name, flags in SUBBLOCK_FLOOR_FLAGS:
            for scored in (True, False):
                breed = fs.make_fused_breed(P, L, onemax if scored else None, device=device,
                                            gene_dtype=dtype, subblock=B, layout="pingpong",
                                            mparams=mparams, ablate=flags)
                cg, kw = breed.geom, breed.kw
                check((cg.B, cg.D) == (geom.B, geom.D), f"subblock floor {name}: {cg}")
                tag = f"subblock floor {name} {flag_name} {'scored' if scored else 'unscored'}"
                errs = []
                for parity in (0, 1):
                    for mode, draws in (("injected", injected), ("philox", philox)):
                        arg = dict(draws=injected) if mode == "injected" else dict(seed=seed)
                        got = fs.deme_breed(g, ranks[parity], cg, parity, **arg, **kw)
                        want = fs.deme_breed_reference(g, ranks[parity], cg, parity, draws, **kw)
                        torch.cuda.synchronize()
                        check(torch.equal(got[0], want[0]),
                              f"{tag} parity {parity} {mode}: genomes differ")
                        errs.append(float((got[0].float() - want[0].float()).abs().max()))
                        if scored:
                            wo = warp_order_scores(fs, want[0], P, onemax.fused_id)
                            check(torch.equal(got[1], wo), f"{tag} parity {parity} {mode}:"
                                  " scores differ from the warp-order sums")
                            errs.append(float((got[1] - wo).abs().nan_to_num().max()))
                        else:
                            check(got[1] is None, f"{tag}: scored an unscored breed")
                        del got, want
                ms = cuda_ms(lambda: fs.deme_breed(g, ranks[0], cg, 0, seed=seed, out=out, **kw),
                             20)
                plain_ms = cuda_ms(lambda: fs.deme_breed_reference(g, ranks[0], cg, 0, philox,
                                                                   **kw), 3)
                bound_ms, bound_by, _ = breed_bound(cg, ablate=flags, gene_bytes=gb,
                                                    scored=scored)
                library_ms = None
                if flag_name == "floor" and not scored:
                    # Child (g, k) is slot k's staged row: out[write] =
                    # g[read], one index_select of each output row's source.
                    read, write = cg.row_maps(0, device)
                    rows = torch.empty(cg.Pp, dtype=torch.long, device=device)
                    rows[write.reshape(-1)] = read.reshape(-1)
                    lib = torch.empty_like(g)
                    got = fs.deme_breed(g, ranks[0], cg, 0, seed=seed, **kw)
                    check(torch.equal(torch.index_select(g, 0, rows, out=lib), got[0]),
                          f"{tag}: index_select differs")
                    library_ms = cuda_ms(lambda: torch.index_select(g, 0, rows, out=lib), 20)
                    del got, lib, rows
                line = {"phase": "subblock_floor_compare", "case": name, "flags": flag_name,
                        "scored": scored, "shape": [P, L], "gene_dtype": dtype_name,
                        "K": cg.K, "D": cg.D, "B": cg.B, **pipe_info(kernels, cg, dtype),
                        "genomes_equal": True,
                        "max_abs_err": max(errs), "kernel_ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                        "production_ms": prod_ms, "production_bound_ms": prod_bound[0]}
                print(json.dumps(line), flush=True)
                cases[f"{flag_name}-{'scored' if scored else 'unscored'}"] = {
                    k: line[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "max_abs_err")}
                del breed
        results[name] = {"cases": cases, "production_ms": prod_ms, "K": geom.K, "D": geom.D,
                         "B": B, "shape": [P, L], "gene_dtype": dtype_name,
                         **pipe_info(kernels, geom, dtype)}
        del g, s, out, injected, philox
        torch.cuda.empty_cache()


def phase_subblock_floor_partition(kernels, results):
    """This slice's path: the stage harness (libpga_tpu_torch/tools/
    ablate_kernel.py) at --subblock 2 (float32 with a combination, bf16,
    the creep hook) and with the combinations of the other builtin kernels
    (SUBBLOCK_FLOOR_RUNS), the launch counts set to 0 just before and read
    just after: the pipelined kernel's cases, the creep hook's at B = 2
    and every combination's unit must have launched. Prints each run's
    medians (ms a generation)."""
    from libpga_tpu_torch.tools import ablate_kernel

    kernels.reset_launches()
    medians = []
    for argv in SUBBLOCK_FLOOR_RUNS:
        t0 = time.perf_counter()
        med = ablate_kernel.main(argv + ["--rounds", str(SUBBLOCK_FLOOR_ROUNDS)])
        medians.append({"args": argv, "medians_ms_per_gen": med})
        print(json.dumps({"phase": "subblock_floor_partition", "args": argv,
                          "medians_ms_per_gen": med,
                          "stage_ms": {k: med["full"] - v for k, v in med.items() if k != "full"},
                          "seconds": time.perf_counter() - t0}), flush=True)
    launches = dict(kernels.LAUNCHES)
    by_mask = {f"{k}:{m}": v for (k, m), v in sorted(kernels.MASK_LAUNCHES.items())}
    plans = {c[0]: {"C": results[c[0]]["C"],
                    "staged_bytes_per_block": results[c[0]]["staged_bytes_per_block"],
                    "production_ms": results[c[0]]["production_ms"],
                    "floor_ms": results[c[0]]["cases"]["floor-unscored"]["kernel_ms"],
                    "library_ms": results[c[0]]["cases"]["floor-unscored"]["library_ms"]}
             for c in SUBBLOCK_FLOOR_CASES}
    print(json.dumps({"phase": "subblock_floor_launches", "launches": launches,
                      "by_mask": by_mask, "plans": plans}), flush=True)
    for key in ("ablate_pipelined", "ablate_pipelined_bf16", "deme_pipelined",
                "deme_pipelined_bf16", "ablate_expr_pipelined", "expr_pipelined"):
        check(launches[key] > 0, f"subblock_floor_partition: {key} never launched ({launches})")
    floor = kernels.ABLATE_FLOOR
    for key in ("ablate_pipelined", "ablate_pipelined_bf16"):
        for mask in kernels.PIPELINED_HARNESS_MASKS:
            check(kernels.MASK_LAUNCHES.get((key, mask), 0) > 0,
                  f"subblock_floor_partition: {key} mask {mask} never launched")
    check(kernels.MASK_LAUNCHES.get(("ablate_expr_pipelined", floor), 0) > 0,
          "subblock_floor_partition: the creep floor never launched")
    for case, key, flags, *_ in ABLATE_COMBOS:
        mask = kernels.ablate_mask(flags, multigen=True)
        check(kernels.MASK_LAUNCHES.get((key, mask), 0) > 0,
              f"subblock_floor_partition: {case} ({key} mask {mask}) never launched")
    for rec in medians:
        check(all(v == v for v in rec["medians_ms_per_gen"].values()),
              f"subblock_floor_partition {rec['args']}: a median rests on no sample")
    results["launches"] = launches
    results["mask_launches"] = dict(kernels.MASK_LAUNCHES)
    results["partition"] = medians


def shard_solver(port, P, L, S, dtype_name="float32", mutate=None, seed=1):
    """A solver of one P x L OneMax population at ``pop_shards=S`` through
    the pga_* API (``mutate`` "creep": the creep expression)."""
    import torch

    pga = port.pga_init(seed=seed, config=port.PGAConfig(
        pop_shards=S, gene_dtype=getattr(torch, dtype_name)))
    port.pga_create_population(pga, P, L)
    port.pga_set_objective_function(pga, "onemax")
    if mutate == "creep":
        port.pga_set_mutate_function(pga, port.mutate_from_expression(CREEP, rate=0.05, sigma=0.1))
    return pga


def shard_key(kernels, geom, dtype_name, mutate) -> str:
    """The counter of a sharded run's launch: the island breed's (the
    builtin hooks: deme_pipelined_kernel's where a cluster holds the
    shard's deme)."""
    import torch

    if not mutate:
        return deme_key(kernels, geom, getattr(torch, dtype_name), islands=True)
    return "islands_expr" + ("_bf16" if dtype_name == "bfloat16" else "")


def phase_shard_compare(port, fs, kernels, device, results):
    """The sharded run's launch (B9: the island breed over the S shards,
    elitism 0) at 1,048,576x128 against its plain version, both parities:
    the step the solver builds, on Philox draws replayed from its
    generator, and the same launch on those draws injected; genomes bit
    for bit, scores within SCORE_ATOL. Times the launch, the whole step
    (ranks and seeds included), the plain version and the unsharded
    deme_breed_kernel at 1,048,576x128 by CUDA events, beside the bound
    (breed_bound over each shard)."""
    import torch

    P, L = SHARD_SHAPE
    for name, S, dtype_name, mutate in SHARD_CASES:
        dtype = getattr(torch, dtype_name)
        pga = shard_solver(port, P, L, S, dtype_name, mutate)
        check(pga.sharded_kernel_route(P // S, L), f"shards {name}: not on the kernel route")
        step, _ = pga._sharded_local_step(P // S, L)
        geom, kw = step.breed.geom, step.breed.kw
        key = shard_key(kernels, geom, dtype_name, mutate)
        if mutate:
            key = expr_counter(kernels, key, op_program(kw["mutate"]), geom, dtype, kw["mutate"])
        pipelined = "expr_pipelined" in key
        gen = torch.Generator(device=device).manual_seed(S)
        g = torch.rand((S, geom.Pp, L), generator=gen, device=device).to(dtype)
        s = g.float().sum(dim=-1)
        errs = []
        for parity in range(geom.parities):
            before = kernels.LAUNCHES[key]
            got = step(g, s, parity, torch.Generator(device=device).manual_seed(parity))
            replay = torch.Generator(device=device).manual_seed(parity)
            tie = fs.draw_tie_words(replay, S * geom.Pp, device).view(S, geom.Pp)
            ranks = fs.compute_ranks(s, geom, parity, tie)
            seeds = torch.randint(0, 2**63 - 1, (S,), generator=replay, device=device)
            draws = fs.island_philox_draws(seeds, geom.G, geom.K, L, kw["mutate"],
                                           kw["crossover"])
            injected = fs.deme_breed(g, ranks, geom, parity, draws=draws, islands=S, **kw)
            tag = f"shards {name} parity {parity}"
            check(kernels.LAUNCHES[key] == before + 2, f"{tag}: {key} did not launch")
            if pipelined:
                against_expr_breed(got, fs.deme_breed(g, ranks, geom, parity, seed=seeds,
                                                      islands=S, pipelined=False, **kw),
                                   False, f"{tag} philox")
                against_expr_breed(injected, fs.deme_breed(g, ranks, geom, parity, draws=draws,
                                                           islands=S, pipelined=False, **kw),
                                   False, f"{tag} injected")
            else:
                same_deme_kernels(fs, got, g, ranks, geom, parity, f"{tag} philox", seed=seeds,
                                  islands=S, **kw)
                same_deme_kernels(fs, injected, g, ranks, geom, parity, f"{tag} injected",
                                  draws=draws, islands=S, **kw)
            want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
            torch.cuda.synchronize()
            for mode, out in (("philox", got), ("injected", injected)):
                check(torch.equal(out[0], want[0]), f"{tag} {mode}: genomes differ")
                err = float((out[1] - want[1]).abs().max())
                check(err <= SCORE_ATOL, f"{tag} {mode}: score error {err}")
                errs.append(err)
        out = torch.empty_like(g)
        ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seeds, islands=S, out=out,
                                           **kw), 20)
        step_ms = cuda_ms(lambda: step(g, s, 0, gen), 20)
        old_ms = cuda_ms(lambda: fs.deme_breed(g, ranks, geom, 0, seed=seeds, islands=S, out=out,
                                               pipelined=False, **kw), 20) if pipelined else None
        deme_ms = None if mutate else cuda_ms(lambda: kernels.deme_breed_cuda(
            g, ranks, geom, 0, seed=seeds, islands=S, out=out, pipelined=False, **kw), 20)
        plain_ms = cuda_ms(lambda: fs.deme_breed_reference(g, ranks, geom, 0, draws, **kw), 2)
        one = fs.resolve_geometry(P, L, gene_dtype=dtype)
        g1, out1 = g.view(P, L), out.view(P, L)
        r1 = fs.compute_ranks(s.view(P), one, 0, fs.draw_tie_words(gen, P, device))
        unsharded_ms = cuda_ms(lambda: fs.deme_breed(g1, r1, one, 0, seed=seeds[:1], out=out1,
                                                     **kw), 20)
        bound_ms, bound_by, _ = breed_bound(geom, gene_bytes=2 if dtype == torch.bfloat16 else 4)
        line = {"phase": "shard_compare", "case": name, "shape": [P, L], "shards": S,
                "gene_dtype": dtype_name, "mutate": mutate or "point", "layout": geom.layout,
                "K": geom.K, "D": geom.D, "shard_rows": geom.Pp, "genomes_equal": True,
                "max_abs_err": max(errs), "score_atol": SCORE_ATOL, "ms": ms, "step_ms": step_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms * S, "bound_by": bound_by,
                "unsharded_ms": unsharded_ms, "unsharded_layout": one.layout,
                "unsharded_D": one.D, "counter": key, "expr_breed_ms": old_ms,
                "deme_breed_ms": deme_ms}
        print(json.dumps(line), flush=True)
        results[name] = line
        port.pga_deinit(pga)
        del g, s, out, g1, out1, pga
        torch.cuda.empty_cache()


def shard_giant_check(port, fs, pga, P, L, S, device) -> float:
    """One step of a sharded solver's kernel route on its own population
    (at 16,777,216x128, S = 8: 32,768 blocks in one launch, shard 7 past
    2^31 bytes), both parities, shards 0 and S-1 each held against the
    plain version built from its slice of the genomes, its ranks and its
    Philox draws: genomes bit for bit, scores within SCORE_ATOL. Returns
    the largest score error."""
    import torch

    Ps = P // S
    check(pga.sharded_kernel_route(Ps, L), "shard giant: not on the kernel route")
    step, _ = pga._sharded_local_step(Ps, L)
    geom, kw = step.breed.geom, step.breed.kw
    g = pga.population(port.PopulationHandle(0)).genomes.view(S, Ps, L)
    s = g.float().sum(dim=-1)
    errs = []
    for parity in range(geom.parities):
        got_g, got_s = step(g, s, parity, torch.Generator(device=device).manual_seed(parity))
        replay = torch.Generator(device=device).manual_seed(parity)
        tie = fs.draw_tie_words(replay, S * geom.Pp, device).view(S, geom.Pp)
        ranks = fs.compute_ranks(s, geom, parity, tie).view(S, geom.G, geom.K)
        seeds = torch.randint(0, 2**63 - 1, (S,), generator=replay, device=device)
        for i in (0, S - 1):
            draws = fs.island_philox_draws(seeds[i:i + 1], geom.G, geom.K, L, kw["mutate"],
                                           kw["crossover"])
            want_g, want_s = fs.deme_breed_reference(g[i:i + 1], ranks[i], geom, parity, draws,
                                                     **kw)
            tag = f"shard giant parity {parity} shard {i}"
            check(torch.equal(got_g[i], want_g[0]), f"{tag}: genomes differ")
            err = float((got_s[i] - want_s[0]).abs().max())
            check(err <= SCORE_ATOL, f"{tag}: score error {err}")
            errs.append(err)
            del draws, want_g, want_s
        del got_g, got_s, tie, ranks
        torch.cuda.empty_cache()
    return max(errs)


def phase_shard_run(port, fs, kernels, device, results):
    """PGA.run at pop_shards > 1 through the pga_* API, the counts set to 0
    just before each run and read just after: every SHARD_CASES case at
    1,048,576x128 for 100 generations after a warm-up (launches of its
    island counter equal the generations and nothing else launches; the
    best rises; the scores are the genomes' onemax), S = 4 float32 beside
    pop_shards=1 at the same shape with a torch.profiler window each; the
    giant population 16,777,216x128 at S = 8, first one step against the
    plain version (:func:`shard_giant_check`), then a run whose best must
    rise; and the panmictic route at 65,536x64, S = 4, which launches
    nothing."""
    import torch

    def timed(pga, gens, tag):
        """Warm up (both parities), then ``gens`` generations: (seconds,
        launches, best before, best after); the scores must be the genomes'
        onemax."""
        h = port.PopulationHandle(0)
        start_best = float(pga.population(h).genomes.float().sum(dim=1).max())
        check(port.pga_run(pga, WARMUP_GENS) == WARMUP_GENS, f"{tag}: warm-up")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        ran = port.pga_run(pga, gens)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        pop = pga.population(h)
        _, best = pga.get_best_with_score(h)
        check(ran == gens, f"{tag}: ran {ran} generations")
        check(best > start_best, f"{tag}: best {start_best} -> {best}")
        check(bool(torch.isclose(pop.scores, pop.genomes.float().sum(dim=1), rtol=0,
                                 atol=SCORE_ATOL).all()), f"{tag}: scores are not the onemax")
        return seconds, launches, start_best, best

    P, L = SHARD_SHAPE
    for name, S, dtype_name, mutate in [("S1-f32", 1, "float32", None), *SHARD_CASES]:
        pga = shard_solver(port, P, L, S, dtype_name, mutate)
        seconds, launches, start_best, best = timed(pga, SHARD_RUN_GENS, f"shard run {name}")
        key = (deme_key(kernels, pga._deme_geometry(P, L)) if S == 1
               else results[name]["counter"])
        check(launches == {key: SHARD_RUN_GENS}, f"shard run {name}: launches {launches}")
        ms_per_gen = 1e3 * seconds / SHARD_RUN_GENS
        line = {"phase": "shard_run", "case": name, "shape": [P, L], "shards": S,
                "gene_dtype": dtype_name, "mutate": mutate or "point", "gens": SHARD_RUN_GENS,
                "launches": launches, "gens_per_s": SHARD_RUN_GENS / seconds,
                "ms_per_gen": ms_per_gen, "start_best": start_best, "best": best}
        if name in ("S1-f32", "S4-f32"):
            line.update(profile_generations(port, pga, ms_per_gen))
        print(json.dumps(line), flush=True)
        results.setdefault(name, {}).update(launches=launches[key], run=line)
        port.pga_deinit(pga)
        del pga
        torch.cuda.empty_cache()

    P, L, S = SHARD_GIANT
    torch.cuda.reset_peak_memory_stats()
    pga = shard_solver(port, P, L, S)
    giant_err = shard_giant_check(port, fs, pga, P, L, S, device)
    seconds, launches, start_best, best = timed(pga, SHARD_GIANT_GENS, "shard giant")
    giant = shard_key(kernels, pga._sharded_local_step(P // S, L)[0].breed.geom, "float32", None)
    check(launches == {giant: SHARD_GIANT_GENS}, f"shard giant: launches {launches}")
    print(json.dumps({"phase": "shard_run", "case": "giant-S8", "shape": [P, L], "shards": S,
                      "gens": SHARD_GIANT_GENS, "launches": launches, "checked_shards": [0, S - 1],
                      "genomes_equal": True, "max_abs_err": giant_err,
                      "gens_per_s": SHARD_GIANT_GENS / seconds,
                      "ms_per_gen": 1e3 * seconds / SHARD_GIANT_GENS, "start_best": start_best,
                      "best": best, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}),
          flush=True)
    port.pga_deinit(pga)
    del pga
    torch.cuda.empty_cache()

    P, L, S = SHARD_PANMICTIC
    pga = shard_solver(port, P, L, S)
    check(not pga.sharded_kernel_route(P // S, L), "shard panmictic: on the kernel route")
    seconds, launches, start_best, best = timed(pga, SHARD_RUN_GENS, "shard panmictic")
    check(launches == {} and pga.launches == 0, f"shard panmictic: launches {launches}")
    print(json.dumps({"phase": "shard_run", "case": "panmictic-S4", "shape": [P, L],
                      "shards": S, "gens": SHARD_RUN_GENS, "launches": launches,
                      "gens_per_s": SHARD_RUN_GENS / seconds, "start_best": start_best,
                      "best": best}), flush=True)
    port.pga_deinit(pga)


def b10_entries(b10_results, lines) -> list:
    """The kernels-line entries of B10: the pipelined kernel's stage cases
    (float32, bf16), the creep hook's at B = 2 and one entry a combination
    (``lines``: B10_HOOK_ROWS' hook_floor_compare lines by row-case)."""
    entries = []
    mask_launches = b10_results["mask_launches"]
    for name, case in (("ablate_pipelined", "f32-B2"), ("ablate_pipelined_bf16", "bf16-B2")):
        # ms, plain_ms, library_ms and the bound: the floor (unscored) at
        # 1,048,576x100; launches from subblock_floor_partition; every case
        # (B = 4 too) under "cases".
        r = b10_results[case]
        floor = r["cases"]["floor-unscored"]
        cases = {f"{c[0]}-{k}": v for c in SUBBLOCK_FLOOR_CASES if c[3] == r["gene_dtype"]
                 for k, v in b10_results[c[0]]["cases"].items()}
        entries.append({
            "name": name, "route": "cuda", "source": "libpga_tpu_torch/csrc/deme_breed.cu",
            "replaces": SUBBLOCK_FLOOR_REPLACES[0], "also_replaces": SUBBLOCK_FLOOR_REPLACES[1],
            "launches": b10_results["launches"][name],
            "max_abs_err": max(v["max_abs_err"] for v in cases.values()),
            "ms": floor["kernel_ms"], "plain_ms": floor["plain_ms"],
            "bound_ms": floor["bound_ms"], "bound_by": floor["bound_by"],
            "library_ms": floor["library_ms"],
            "case": f"{case}-floor-unscored", "shape": r["shape"], "K": r["K"], "D": r["D"],
            "B": r["B"], "C": r["C"], "staged_bytes_per_block": r["staged_bytes_per_block"],
            "production_ms": r["production_ms"],
            "launches_by_mask": {str(m): v for (n, m), v in sorted(mask_launches.items())
                                 if n == name},
            "cases": cases,
        })
    creep = {c: lines[f"creep-B2-{c}"] for c in ("no_mut", "floor")}
    r = creep["floor"]
    entries.append({
        "name": "ablate_expr_pipelined[creep-B2]", "route": "cuda",
        "source": "libpga_tpu_torch/csrc/expr_breed.cu",
        "replaces": SUBBLOCK_FLOOR_REPLACES[0],
        "also_replaces": "libpga_tpu/ops/pallas_step.py:750",  # the callable mutation
        "launches": b10_results["launches"]["ablate_expr_pipelined"],
        "max_abs_err": max(v["max_abs_err"] for v in creep.values()),
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "case": "creep-B2-floor",
        "shape": r["shape"], "K": r["K"], "D": r["D"], "B": r["B"],
        "production_ms": r["production_ms"],
        "cases": {c: {k: v[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                          "max_abs_err")} for c, v in creep.items()},
    })
    for case, key, _ in ABLATE_COMBOS:
        # One entry a combination: its ms beside its production launch;
        # launches of its kernel bitmask from subblock_floor_partition. At
        # B = 1 the pipelined kernel's combinations replace _deme_child's.
        r = lines[case]
        replaces = ABLATE_COMBO_REPLACES[
            "ablate_breed" if key == "ablate_pipelined" and r["B"] == 1 else key]
        entries.append({
            "name": f"{key}[{case}]", "route": "cuda",
            "source": "libpga_tpu_torch/csrc/deme_breed.cu",
            "replaces": replaces[0], "also_replaces": replaces[1],
            "launches": mask_launches.get((key, r["mask"]), 0),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "mask": r["mask"], "shape": r["shape"], "steps": r["steps"], "layout": r["layout"],
            "K": r["K"], "D": r["D"], "B": r["B"], "production_ms": r["production_ms"],
        })
    return entries


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
        from libpga_tpu_torch.tools import ablate_floor
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    global H100_BYTES_PER_S
    H100_BYTES_PER_S = ablate_floor.H100_BYTES_PER_S

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log", type=Path, help="also write every printed line to this file")
    log = parser.parse_args().log
    if log is None:
        return drive(torch, port, onemax, fs, kernels)
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as f, contextlib.redirect_stdout(Tee(sys.stdout, f)):
        return drive(torch, port, onemax, fs, kernels)


def drive(torch, port, onemax, fs, kernels) -> int:
    """Every phase, then the kernels line, the card's line and the
    result line."""
    device = torch.device("cuda", 0)
    started = time.perf_counter()
    smi = nvidia_smi()
    print(json.dumps({"phase": "device", "name": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)

    t0 = time.perf_counter()
    programs = expr_programs(port)
    unit_seconds = kernels.build_all(verbose=True, programs=programs,
                                     harness=hook_floor_programs(fs))
    generated = {k: v for k, v in unit_seconds.items() if k.startswith("expr_breed")}
    harness = {k: v for k, v in unit_seconds.items() if k.startswith("expr_harness")}
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "sources": sorted(p.name for p in kernels.CSRC.glob("*.cu")),
                      "unit_seconds": unit_seconds, "generated_units": len(generated),
                      "generated_seconds_max": max(generated.values()),
                      "harness_units": len(harness), "harness_seconds": harness}), flush=True)
    # The deme_breed.cu units of B10, after the production build and apart
    # from it: the pipelined kernel's harness unit and the combinations'.
    t0 = time.perf_counter()
    b10_units = [kernels.deme_macro("pipelined", kernels.ABLATE_FLOOR)] + sorted({
        kernels.deme_macro(COMBO_UNITS[key], kernels.ablate_mask(flags, multigen=True))
        for _, key, flags, *_ in ABLATE_COMBOS if key != "ablate_copy"})
    b10_seconds = kernels.build_all(deme_units=b10_units)
    print(json.dumps({"phase": "build_b10", "seconds": time.perf_counter() - t0,
                      "units": {m.strip(): b10_seconds[f"deme_unit[{i}]"]
                                for i, m in enumerate(b10_units)}}), flush=True)

    results = {"pingpong": {}, "riffle": {}}
    phase_compare(fs, onemax, device, results)
    phase_philox_stats(fs, device)
    phase_run(port, kernels, results)
    gp_results = {}
    phase_gp_compare(device, gp_results)
    phase_gp_run(port, kernels, gp_results)
    tsp_results = {}
    phase_tsp_compare(fs, device, tsp_results)
    phase_tsp_run(port, kernels, tsp_results)
    phase_fused_objectives(fs, device, results)
    mg_results = {}
    phase_multigen_compare(fs, kernels, device, mg_results)
    phase_multigen_run(port, kernels, mg_results)
    expr_results = {}
    phase_expr_compare(port, fs, device, expr_results)
    phase_expr_pipelined_floor()
    phase_expr_runs(port, kernels, expr_results)
    expr_mg_results = {}
    phase_expr_multigen_compare(port, fs, device, expr_mg_results)
    phase_expr_multigen_runs(port, kernels, expr_mg_results)
    order_results = {}
    phase_order_expr_compare(port, fs, device, order_results)
    phase_order_multigen_compare(port, fs, device, order_results)
    phase_order_runs(port, kernels, order_results)
    island_results = {}
    phase_island_compare(fs, device, island_results)
    phase_island_run(port, kernels, island_results, results, mg_results)
    phase_rastrigin_islands(port, kernels)
    bf16_results = {}
    phase_bf16_compare(port, fs, device, bf16_results)
    phase_bf16_runs(port, kernels, bf16_results)
    island_expr_results = {}
    phase_island_expr_compare(port, fs, kernels, device, island_expr_results)
    phase_island_expr_runs(port, kernels, island_expr_results, {
        "expr": expr_results, "expr_mg": expr_mg_results, "order": order_results,
        "bf16": bf16_results})
    floor_results = {}
    phase_floor_compare(fs, onemax, device, floor_results)
    phase_floor_partition(kernels, floor_results)
    hook_floor_results = {}
    phase_hook_floor_compare(fs, kernels, device, hook_floor_results)
    phase_hook_floor_partition(kernels, hook_floor_results)
    subblock_results = {}
    phase_subblock_compare(port, fs, onemax, kernels, device, subblock_results)
    phase_subblock_run(port, kernels, subblock_results, results,
                       island_results["deme_breed"]["run"]["gens_per_s"])
    shard_results = {}
    phase_shard_compare(port, fs, kernels, device, shard_results)
    phase_shard_run(port, fs, kernels, device, shard_results)
    b10_results, b10_hook_results = {}, {}
    phase_subblock_floor_compare(fs, onemax, kernels, device, b10_results)
    phase_hook_floor_compare(fs, kernels, device, b10_hook_results, B10_HOOK_ROWS,
                             "ablate_combo_compare")
    phase_subblock_floor_partition(kernels, b10_results)

    entries = []
    for layout, r in results.items():
        # PGA.run's B = 1 launch: deme_pipelined_kernel, deme_breed_kernel's
        # time of the same call beside it.
        entries.append({
            "name": f"deme_pipelined[{layout}]", "route": "cuda",
            "source": "libpga_tpu_torch/csrc/deme_breed.cu",
            "replaces": REPLACES[layout], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "C": r["C"], "deme_breed_ms": r["deme_breed_ms"],
            "fused_objective_rel_err": r["fused_objective_rel_err"],
        })
    for layout, r in mg_results.items():
        # ms, plain_ms, bound and launches: T = 8 at the layout's first
        # run shape.
        (P, L), rest = MULTIGEN_RUN_SHAPES[layout][0], MULTIGEN_RUN_SHAPES[layout][1:]
        first = r["shapes"][P]
        entries.append({
            "name": f"multigen_breed[{layout}]", "route": "cuda",
            "source": "libpga_tpu_torch/csrc/deme_breed.cu",
            "replaces": MULTIGEN_REPLACES, "launches": first["launches"],
            "max_abs_err": r["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "shape": [P, L], "steps": MULTIGEN_T, "schedule": first["route"], "C": first["C"],
            "one_block_ms": first["one_block_ms"],
            "deme_breed_x8_ms": 8 * results["pingpong"]["ms"] if P == 1 << 20 else None,
            "plain_ms_at_3_steps": first["plain_ms_at_3_steps"],
            "ms_by_steps": first["ms_by_steps"],
            "other_shapes": {str(p): r["shapes"][p] for p, _ in rest},
        })
    for mode, r in gp_results.items():
        main_r, bench_r = r["main"], r["bench"]
        entries.append({
            "name": f"gp_eval[{mode}]", "route": "cuda",
            "source": "libpga_tpu_torch/csrc/gp_eval.cu",
            "replaces": GP_REPLACES[mode], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": main_r["ms"], "plain_ms": main_r["plain_ms"],
            "bound_ms": main_r["bound_ms"], "bound_by": main_r["bound_by"], "library_ms": None,
            "mean_live_length": main_r["mean_live_length"],
            "mean_function_tokens": main_r["mean_function_tokens"],
            "ns_per_token_sample": main_r["ns_per_token_sample"], "v_share": main_r["v_share"],
            "sm_clock_mhz": main_r["sm_clock_mhz"],
            "thread_instructions_per_token_sample": main_r["thread_instructions_per_token_sample"],
            "bit_exact_rows_differing": r["bit_exact"]["rows_differing"],
            "arithmetic_set": {k: r["bit_exact"][k] for k in (
                "kernel_ms", "mean_live_length", "mean_function_tokens", "ns_per_token_sample",
                "sm_clock_mhz", "thread_instructions_per_token_sample")},
            "ptxas": r["ptxas"],
            "bench_shape": {k: bench_r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "mean_live_length",
                "mean_function_tokens", "ns_per_token_sample")},
        })
    main_r, ref_r = tsp_results["main"], tsp_results["reference"]
    entries.append({
        "name": "order_breed[tsp]", "route": "cuda",
        "source": "libpga_tpu_torch/csrc/deme_breed.cu",
        "replaces": TSP_REPLACES, "also_replaces": TSP_ALSO_REPLACES,
        "launches": main_r["launches"], "max_abs_err": max(main_r["max_abs_err"], ref_r["max_abs_err"]),
        "ms": main_r["ms"], "plain_ms": main_r["plain_ms"], "bound_ms": main_r["bound_ms"],
        "bound_by": main_r["bound_by"], "library_ms": None, "chain_steps": main_r["chain_steps"],
        "chain_ms": main_r["chain_ms"], "walk_step_ns": main_r["walk_step_ns"],
        "reference_shape": {k: ref_r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "chain_steps", "chain_ms", "launches")},
    })
    for name, r in expr_results.items():
        # The kernel the workload's run launched: expr_pipelined_kernel,
        # with expr_breed_kernel's time at the same call beside it, or
        # expr_breed_kernel.
        entries.append({
            "name": f"{EXPR_ENTRY[r['counter']]}[{name}]", "route": "cuda",
            "source": "libpga_tpu_torch/csrc/expr_breed.cu",
            "replaces": EXPR_REPLACES, "also_replaces": EXPR_ALSO_REPLACES,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "layout": r["layout"],
            "expr_breed_ms": r["expr_breed_ms"],
            "ms_per_gen": r["ms_per_gen"], "device_busy_share": r.get("device_busy_share"),
        })
    for name in EXPR_MG_GENS:
        # ms, plain_ms, bound and launches: T = 8 at the workload's shape.
        r = expr_mg_results[name]
        entries.append({
            "name": f"expr_multigen[{name}]", "route": "cuda",
            "source": "libpga_tpu_torch/csrc/expr_breed.cu", "replaces": EXPR_MG_REPLACES,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "layout": r["layout"], "steps": EXPR_MG_T,
            "schedule": r["schedule"], "C": r["C"], "one_block_ms": r["one_block_ms"],
            "ms_at_1_step": r["ms_at_1_step"], "ms_per_gen": r["ms_per_gen"],
            "one_per_launch_ms_per_gen": r["one_per_launch_ms_per_gen"],
            "device_busy_share": r["device_busy_share"], "best": r["best"],
        })
    for key, r in order_results.items():
        # ms, plain_ms, bound and launches at the workload's full shape;
        # the multigen entries at T = 8.
        kernel = key.split("[")[0]
        entries.append({
            "name": key, "route": "cuda",
            "source": "libpga_tpu_torch/csrc/" + (
                "deme_breed.cu" if kernel == "multigen_order" else "expr_breed.cu"),
            "replaces": ORDER_REPLACES[kernel], "also_replaces": TSP_REPLACES,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "K": r["K"],
            "steps": 1 if kernel == "expr_order" else ORDER_T,
            "chain_steps": r["chain_steps"], "chain_ms": r.get("chain_ms"),
            "ms_at_1_step": r.get("ms_at_1_step"),
            "ms_per_gen": r["ms_per_gen"], "gens_per_s": r["gens_per_s"],
            "device_busy_share": r["device_busy_share"], "best": r["best"],
            "best_distinct_cities": r["best_distinct_cities"],
            # the multigen entries' walk: production less no_cross, a step
            **{k: r[k] for k in ("no_cross_ms", "walk_ms", "walk_ns_per_step", "walk_step_ns",
                                 "walkers_per_pass") if k in r},
        })
    for kernel, r in island_results.items():
        # ms, plain_ms, bound and loop_ms at the kernel's first case;
        # launches from the island run at that shape.
        entries.append({
            "name": ("deme_pipelined[islands,b1]" if kernel == "deme_breed"
                     else f"{kernel}[islands]"),
            "route": "cuda", "source": "libpga_tpu_torch/csrc/deme_breed.cu",
            "replaces": ISLAND_REPLACES[kernel][0], "also_replaces": ISLAND_REPLACES[kernel][1],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "loop_ms": r["loop_ms"], "library_ms": None, "case": r["case"], "shape": r["shape"],
            "steps": r["steps"], "rank_ms": r.get("rank_ms"), "schedule": r.get("schedule"),
            "one_block_ms": r.get("one_block_ms"), "deme_breed_ms": r.get("deme_breed_ms"),
            "other_cases": r.get("other_cases", {}),
        })
    for name, r in bf16_results.items():
        # ms, plain_ms and the bound at the entry's shape (multigen: T = 8);
        # launches from its bf16 run; f32_ms: the float32 kernel on the
        # same shape in this call.
        if name not in BF16_REPLACES:
            continue
        counter = r.get("counter", "expr_bf16")
        entries.append({
            "name": name.replace("expr_breed", EXPR_ENTRY.get(counter, "expr_breed")).replace(
                "deme_breed", "deme_pipelined" if "deme_pipelined" in counter else "deme_breed"),
            "route": "cuda",
            "source": "libpga_tpu_torch/csrc/" + (
                "expr_breed.cu" if name.startswith("expr") else "deme_breed.cu"),
            "replaces": BF16_REPLACES[name][0], "also_replaces": BF16_REPLACES[name][1],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "gene_dtype": "bfloat16", "shape": r["shape"],
            "layout": r["layout"], "K": r["K"], "D": r["D"], "steps": r["steps"],
            "f32_ms": r["f32_ms"], "f32_bound_ms": r["f32_bound_ms"], "loop_ms": r.get("loop_ms"),
            "expr_breed_ms": r.get("expr_breed_ms"), "deme_breed_ms": r.get("deme_breed_ms"),
            "schedule": r.get("schedule"), "one_block_ms": r.get("one_block_ms"),
            "gens_per_s": r["gens_per_s"], "f32_gens_per_s": r["f32_gens_per_s"],
            "device_busy_share": r.get("device_busy_share"),
        })
    for name, r in island_expr_results.items():
        # ms, plain_ms, loop_ms and the bound at the case's shape; launches
        # and gens/s from its island run.
        multigen = r["steps"] > 1
        entries.append({
            "name": f"{ISLAND_EXPR_ENTRY[r['counter']]}[islands,{name}]", "route": "cuda",
            "source": "libpga_tpu_torch/csrc/expr_breed.cu",
            "replaces": ISLAND_EXPR_REPLACES["multigen" if multigen else r["layout"]],
            "also_replaces": "libpga_tpu/parallel/islands.py:" + ("192" if multigen else "110"),
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "loop_ms": r["loop_ms"], "shape": r["shape"],
            "expr_breed_ms": r["expr_breed_ms"], "one_block_ms": r["one_block_ms"],
            "schedule": r["schedule"], "steps": r["steps"], "gene_dtype": r["gene_dtype"],
            "layout": r["layout"],
            "K": r["K"], "D": r["D"], "chain_steps": r["chain_steps"],
            "gens_per_s": r["gens_per_s"], "single_gens_per_s": r["single_gens_per_s"],
            "device_busy_share": r["device_busy_share"],
        })
    for name, key in (("ablate_copy", "ablate_copy"), ("ablate_pipelined[b1]", "ablate_stages"),
                      ("ablate_multigen", "ablate_multigen")):
        # ms, plain_ms and the bound: copy_riffle, floor and no_freeze (T = 8)
        # at 1,048,576x100 float32; launches from floor_partition. The stage
        # cases at B = 1 follow the route to deme_pipelined_kernel's harness
        # unit, deme_breed_kernel's case of the same call beside them.
        r = floor_results[key]
        entries.append({
            "name": name, "route": "cuda", "source": "libpga_tpu_torch/csrc/deme_breed.cu",
            "replaces": FLOOR_REPLACES[key][0], "also_replaces": FLOOR_REPLACES[key][1],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "case": r["case"], "shape": r["shape"],
            "steps": r.get("steps", 1), "deme_breed_ms": r.get("deme_breed_ms"),
            "cases": r["cases"],
        })
    for name, (replaces, also, _) in HOOK_FLOOR_ENTRIES.items():
        # ms, plain_ms and the bound: the row-case HOOK_FLOOR_ENTRIES names
        # (T = 8 for the multi-generation kernels); launches from
        # hook_floor_partition; every case's numbers under "cases".
        r = hook_floor_results[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "libpga_tpu_torch/csrc/" + (
                "deme_breed.cu" if name in ("ablate_order", "ablate_multigen_order")
                else "expr_breed.cu"),
            "replaces": replaces, "also_replaces": also,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "case": r["case"], "shape": r["shape"], "steps": r["steps"],
            "production_ms": r["production_ms"], "cases": r["cases"],
        })
    for case, name in SUBBLOCK_ENTRIES.items():
        # ms, plain_ms and the bound at 1,048,576x100 (islands: 8 x
        # 131,072x100) at parity 0; launches from its subblock_run. No one
        # call computes the breed; floor_library_ms is the index_select of
        # its floor's row permutation.
        r = subblock_results[case]
        entries.append({
            "name": name, "route": "cuda", "source": "libpga_tpu_torch/csrc/deme_breed.cu",
            "replaces": SUBBLOCK_REPLACES, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "floor_ms": r["floor_ms"], "floor_library_ms": r["library_ms"],
            "shape": r["shape"], "islands": r["islands"], "gene_dtype": r["gene_dtype"],
            "K": r["K"], "D": r["D"], "B": r["B"], "C": r["C"],
            "staged_bytes_per_block": r["staged_bytes_per_block"],
            "deme_breed_same_geometry_ms": r["deme_breed_same_geometry_ms"],
            "b1_ms": r["b1_ms"], "gens_per_s": r["run"]["gens_per_s"],
            "subblock_none_gens_per_s": r["run"]["subblock_none_gens_per_s"],
            "device_busy_share": r["run"]["device_busy_share"],
            "b4_ms": subblock_results["f32-B4"]["ms"] if case == "f32-B2" else None,
            "other_cases": {c: {k: subblock_results[c][k] for k in (
                "ms", "floor_ms", "library_ms", "bound_ms", "C", "staged_bytes_per_block")}
                for c in ("f32-B4", "f32-L128-B2") if case == "f32-B2"},
            "cluster_sweep": subblock_results["cluster_sweep"] if case == "f32-B2" else None,
        })
    for name, _, _, mutate in SHARD_CASES:
        # ms, plain_ms and the bound at 1,048,576x128, parity 0; launches
        # from the case's shard_run.
        r = shard_results[name]
        entries.append({
            "name": (EXPR_ENTRY[r["counter"]] if mutate else "deme_pipelined"
                     if "deme_pipelined" in r["counter"] else "deme_breed") + f"[shards,{name}]",
            "route": "cuda",
            "source": "libpga_tpu_torch/csrc/" + ("expr_breed.cu" if mutate else "deme_breed.cu"),
            "replaces": SHARD_REPLACES[0], "also_replaces": SHARD_REPLACES[1],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "shards": r["shards"],
            "gene_dtype": r["gene_dtype"], "K": r["K"], "D": r["D"], "step_ms": r["step_ms"],
            "unsharded_ms": r["unsharded_ms"], "expr_breed_ms": r["expr_breed_ms"],
            "deme_breed_ms": r["deme_breed_ms"],
            "gens_per_s": r["run"]["gens_per_s"],
            "unsharded_gens_per_s": shard_results["S1-f32"]["run"]["gens_per_s"],
            "device_busy_share": r["run"].get("device_busy_share"),
        })
    entries += b10_entries(b10_results, b10_hook_results["lines"])
    print(json.dumps({"phase": "total", "seconds": time.perf_counter() - started}), flush=True)
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
