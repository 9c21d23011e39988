// expr_breed.cu: the deme breed with expression hooks (B6), a template, in
// four kernels: expr_breed_kernel (one generation, a warp a child),
// expr_pipelined_kernel (its function on deme_pipelined_kernel's schedule,
// 8 lanes a child: the route of every shape its plan holds, see its
// section), expr_order_kernel (the order-crossover case) and, at the end of
// this file, expr_multigen_kernel (up to T generations per launch, B6 x B4,
// uniform or order crossover, on one block a group or, with the pipelined
// kernel's eight-lane child, on a thread-block cluster); one build of a hook
// set serves all four: the crossover kind and the schedule are runtime
// arguments. ops/expr_cuda.py
// writes the hooks (expr_crossover, expr_mutate, expr_objective and the
// objective's eight-lane form expr_objective8) and the macros EXPR_CROSS,
// EXPR_MUT, EXPR_OBJ, EXPR_OBJ_ROWS, EXPR_OBJ_CHILD, EXPR_GENE_STREAMS and
// EXPR_ROW_STREAMS in front of this text; ops/kernels.py compiles the whole
// with nvcc (-I csrc, --fmad=false, no fast math), keyed by a hash of it.
// This file alone does not compile.
//
// Replaces, in libpga_tpu/ops/pallas_step.py, the expression branches of
// _deme_child (callable crossover :636-647, callable mutation :750-763) and
// the fused kernel_rowwise objectives that carry constants (:1143-1146), in
// _breed_kernel (:946, riffle) and _pp_breed_kernel (:1173, ping-pong
// parities 0 and 1). The plain PyTorch version is
// libpga_tpu_torch/ops/fused_step.py::deme_breed_reference with an
// expression crossover, mutation or objective; JAX traces the jnp that
// objectives/expr.py and ops/breed_expr.py emit, this kernel runs the same
// syntax trees lowered to C++.
//
// What it computes: deme_breed_kernel's breed (rank-space selection from
// row_of_rank[] in shared memory, exact parent gathers, the row maps of
// breed_core.cuh), with three hooks:
//   crossover: expr_crossover(p1[l], p2[l], r, r2, q, q2, l, L, consts) per
//              gene, else uniform crossover (the deme kernel's bits);
//   mutation:  expr_mutate(c, r, r2, q, q2, l, L, rate, sigma, consts) per
//              gene, rate and sigma read from mparams (so an annealing
//              schedule reuses one build), else point / gaussian / swap;
//   objective: expr_objective over the child as written, else a builtin
//              rowwise-fused id (onemax, onemax_bits, sphere, rastrigin,
//              ackley) or none.
// In expr_breed_kernel each warp breeds one child into its row of shared
// memory (swap mutation exchanges two genes there), writes it to its
// physical row with coalesced stores, then scores it from that row;
// expr_objective may use EXPR_OBJ_ROWS more rows of L floats per warp for
// values that roll() reads. expr_pipelined_kernel breeds 8 lanes a child
// with the child in registers (its section). Pad children (row >= P) score
// -inf.
//
// Randomness. Production mode: the deme kernel's Philox streams (selection
// 0, mutation 1, crossover bits 2+t, gaussian 0x40000000+l) and, only for
// the streams the hooks read, STREAM_EXPR_GENE / STREAM_EXPR_ROW
// (breed_core.cuh): a per-gene plane's call serves four genes, lane i of a
// tile computing the call of genes 128*tile + 4i .. 4i+3 and shuffling each
// word to the lane that holds its gene. Injected mode reads the planes
// ex.gene (4, G, K, L) and words ex.row (G, K, 4) the plain version reads.
// The counter's fourth word is the sub-generation: 0 here.
//
// Bound. Bytes: the population read once and written once plus the scores
// and the constant tables, (2*Pp*L + 2*Pp)*4 bytes: 0.651 ms for NK at
// 4,194,304x64, 0.153 ms for the trap at 1,048,576x60, 0.253 ms for OneMax
// at 1,048,576x100 at 3.35 TB/s. The arithmetic of these expressions (a
// few operations per gene, one Philox call per four genes per stream) is
// far below the card's rate. expr_breed_kernel's design is
// deme_breed_kernel's: one block per deme, one warp per child, lanes over
// genes; the shared row adds a store and two loads per gene. Blocks run 8
// warps, fewer where the per-warp rows would not fit in 227 KB of shared
// memory (the wrapper picks the count). It breeds the shapes
// expr_pipelined_kernel's plan does not hold (L not a multiple of 4, a
// deme no cluster holds), and every comparison of the two.
//
// bfloat16 genomes. expr_breed_kernel and expr_multigen_kernel<false> are
// templates over the gene type (float or __nv_bfloat16), and both launchers
// take gene_dtype (0 float32, 1 bfloat16), as deme_breed.cu's do: a bf16
// kernel loads the parents as float, the hooks take and return float as
// they do for float32 genes, and each gene of the warp's shared child row is
// rounded to bf16 (round_gene) as it is written there, so the stored child,
// its score (the objective reads that row) and the next sub-generation's
// parents are the rounded genes (pallas_step.py:1114-1125, :1663-1669).
// The generated hooks do not depend on the gene type, so one unit holds both
// instantiations. expr_order_kernel and expr_multigen_kernel<true> stay
// float32 only (order crossover at bf16 is declined, as in JAX).
//
// Islands. All three kernels also breed I equal populations in one launch,
// the islands of PGA.run_islands with an expression hook: blockIdx.y is the
// island. This replaces the TPU's island path, which vmaps the breed kernels
// _breed_kernel (:946), _pp_breed_kernel (:1173) and _multigen_kernel
// (:1460) over the islands (libpga_tpu/parallel/islands.py:
// make_stacked_pallas_epoch, :110; make_multigen_stacked_epoch, :192). A
// block first moves every pointer to its island's slice, as deme_breed.cu's
// kernels do (breed_core.cuh: island_slice, island_draws keyed by
// seed[island], island_io; island_expr_draws below for the injected planes
// (I, [T,] 4, G, K, L) and words (I, [T,] G, K, 4)). The constant tables cb
// and the TSP coordinates are one objective's, shared by every island. The
// Philox counters do not carry the island, so island i of a launch is, bit
// for bit, the single launch of island i's tensors with seed[i], and a
// launch of height 1 is the single launch. Shared memory per block does not
// change with the island count, and the hook text does not either: one
// generated unit serves single and island launches. Bound: I times the
// island's bytes (8 x 131,072x100 is 1,048,576x100's 0.253 ms).
//
// The floor harness (B7; deme_breed.cu, "The floor harness", gives each
// flag's meaning). All three kernels take an ABLATE template parameter,
// breed_core.cuh's ABL_* stage bits (and, in expr_multigen_kernel,
// ABL_NO_FREEZE and ABL_NO_RANK_CUBE); 0 is the production code above.
// Replaces _deme_child's sel_const / no_matmul / no_cross / no_mut branches
// (pallas_step.py:514, :592, :634, :748) with a crossover or mutation hook,
// an objective hook or order crossover, in _breed_kernel (:946),
// _pp_breed_kernel at B = 1 (:1173) and _multigen_kernel (:1460, :1617,
// :1638, :1661). ABL_SEL_CONST and ABL_NO_GATHER breed child k from slot k's
// row (an elite is then bred, not copied, and stays unmutated); ABL_NO_CROSS
// runs neither the crossover hook nor the uniform bits nor the order walk
// (the child is parent 1); ABL_NO_MUT runs no mutation; the objective always
// runs. A removed stage draws nothing, and the streams of the stages that
// remain keep their Philox counters, so the rest of the child is the
// production kernel's bit for bit. The copy is deme_breed.cu's. The hooks are
// generated per program, so the cases build per unit (ops/kernels.py,
// expr_unit): the production unit instantiates ABLATE = 0 alone; a unit with
// EXPR_HARNESS defined also the harness's cases (each stage bit alone, the
// floor, and in the multi-generation kernel ABL_NO_FREEZE and
// ABL_NO_RANK_CUBE); a unit with EXPR_ABLATE_EXTRA defined also that one
// mask, any other combination. dispatch_expr_ablate picks the case at launch
// and refuses a mask the unit does not hold.

#include "breed_core.cuh"
#include "expr_plan.cuh"
#include "pipe_core.cuh"

#ifndef EXPR_HARNESS
#define EXPR_HARNESS 0
#endif
#ifndef EXPR_ABLATE_EXTRA
#define EXPR_ABLATE_EXTRA 0u
#endif

namespace {

struct ExprDraws {
  const float* gene;  // (4, G, K, L): crossover r, r2, mutation r, r2 (injected mode)
  const float* row;   // (G, K, 4): crossover q, q2, mutation q, q2 (injected mode)
};

// The expression draws of island blockIdx.y: the injected planes and words
// carry a leading island axis of T sub-generations each (T = 1 in the
// one-generation kernels).
__device__ __forceinline__ ExprDraws island_expr_draws(ExprDraws ex, const Geometry& geo, int T) {
  const size_t rows = (size_t)T * geo.G * geo.K;
  ex.gene = island_slice(ex.gene, rows * 4 * geo.L);
  ex.row = island_slice(ex.row, rows * 4);
  return ex;
}

// v[j][m]: per-gene plane j of gene 128*tile + lane + 32*m in sub-generation
// t, for the planes in STREAMS (those the hooks read and the harness keeps),
// else 0.
template <unsigned STREAMS>
__device__ __forceinline__ void gene_draws(
    const BreedCtx& cx, const ExprDraws& ex, int k, int g, uint32_t t, int tile, int lane,
    size_t child, float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int m = 0; m < 4; ++m) v[j][m] = 0.0f;
    if (!((STREAMS >> j) & 1u)) continue;
    if (cx.philox_mode) {
      const uint32_t call = STREAM_EXPR_GENE + ((uint32_t)j << 22) + 32u * tile + lane;
      const uint4 w = philox(cx.k0, cx.k1, make_uint4(k, g, call, t));
      const int pick = lane & 3;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int src = (lane >> 2) + 8 * m;
        const uint32_t x = __shfl_sync(FULL, w.x, src), y = __shfl_sync(FULL, w.y, src);
        const uint32_t z = __shfl_sync(FULL, w.z, src), u = __shfl_sync(FULL, w.w, src);
        v[j][m] = to_uniform(pick == 0 ? x : pick == 1 ? y : pick == 2 ? z : u);
      }
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int l = 128 * tile + lane + 32 * m;
        if (l < cx.L) v[j][m] = ex.gene[(size_t)j * cx.plane + child * cx.L + l];
      }
    }
  }
}

// One warp breeds child k of deme g (sub-generation t; `child` = g*K + k)
// from parents p1 and p2 into its shared row `grow`: the crossover hook, else
// uniform crossover; then the mutation hook, else point / gaussian / swap.
// `ex` is at sub-generation t in injected mode. LDG reads the parents
// through the read-only path: the one-generation kernel may, the
// multi-generation kernel may not (its parents from t = 1 on are rows that
// other warps of the block wrote earlier in the launch). Ends with the row
// complete (each gene rounded to the gene type Gene) and the warp
// synchronised. ORDER: the child was walked already and
// p1 is that row (p2 unused): every gene is p1's, no crossover bit is drawn,
// and only the mutation runs (a unit with order crossover has no crossover
// hook). ABLATE (the floor harness): ABL_NO_CROSS takes every gene from p1
// as ORDER does, with neither the hook nor its streams nor crossover bits;
// ABL_NO_MUT runs no mutation and draws none of its streams. may_mutate
// false (an elite bred under ABL_SEL_CONST or ABL_NO_GATHER) leaves the
// crossed child unmutated.
template <bool LDG, bool ORDER = false, class Gene = float, unsigned ABLATE = 0u>
__device__ __forceinline__ void expr_child(
    const BreedCtx& cx, const Draws& dr, const ExprDraws& ex, const Gene* p1, const Gene* p2,
    float* grow, const ChildRand& r, int k, int g, uint32_t t, int lane, size_t child,
    const float* __restrict__ cb, bool may_mutate = true) {
  constexpr bool CROSSES = !(ABLATE & ABL_NO_CROSS);
  constexpr bool MUTATES = !(ABLATE & ABL_NO_MUT);
  // The streams that remain: planes / words 0-1 are the crossover's, 2-3
  // the mutation's.
  constexpr unsigned KEEP = (CROSSES ? 3u : 0u) | (MUTATES ? 12u : 0u);
  constexpr unsigned GENE_STREAMS = (unsigned)(EXPR_GENE_STREAMS) & KEEP;
  constexpr unsigned ROW_STREAMS = (unsigned)(EXPR_ROW_STREAMS) & KEEP;
  const int L = cx.L;
  (void)cb;
  float xq[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // crossover q, q2, mutation q, q2
  if (ROW_STREAMS) {
    if (cx.philox_mode) {
      const uint4 w = philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_EXPR_ROW, t));
      xq[0] = to_uniform(w.x);
      xq[1] = to_uniform(w.y);
      xq[2] = to_uniform(w.z);
      xq[3] = to_uniform(w.w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((ROW_STREAMS >> j) & 1u) xq[j] = ex.row[child * 4 + j];
    }
  }
  // Builtin point / swap mutation: gene pos takes mu2 when mu1 < rate;
  // genes pos, pj exchange when mu2 < rate.
  const int pos = (int)floorf(r.mu0 * (float)L);
  const int pj = (int)floorf(r.mu1 * (float)L);
  const bool fire = MUTATES && !EXPR_MUT && may_mutate &&
                    (cx.mutate == MUT_SWAP ? r.mu2 < cx.rate : r.mu1 < cx.rate);

  // Tile i: genes 128*i + lane + 32*m, m < 4; bit m of `bits` is the
  // uniform crossover's bit of gene m (set: parent 2).
  auto tile = [&](int i, uint32_t bits) {
    float gd[4][4];
    gene_draws<GENE_STREAMS>(cx, ex, k, g, t, i, lane, child, gd);
    (void)bits;
    float c[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int l = 128 * i + lane + 32 * m;
      c[m] = 0.0f;
      if (l < L) {
        if constexpr (!CROSSES) {
          c[m] = load_gene<LDG>(p1 + l);
        } else {
#if EXPR_CROSS
          c[m] = expr_crossover(load_gene<LDG>(p1 + l), load_gene<LDG>(p2 + l), gd[0][m],
                                gd[1][m], xq[0], xq[1], l, L, cb);
#else
          c[m] = load_gene<LDG>((((bits >> m) & 1u) ? p2 : p1) + l);
#endif
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int l = 128 * i + lane + 32 * m;
      if (l >= L) continue;
      float x = c[m];
      if constexpr (MUTATES) {
#if EXPR_MUT
        if (may_mutate)
          x = expr_mutate(x, gd[2][m], gd[3][m], xq[2], xq[3], l, L, cx.rate, cx.sigma, cb);
#else
        if (cx.mutate == MUT_POINT) {
          if (fire && l == pos) x = r.mu2;
        } else if (cx.mutate == MUT_GAUSSIAN) {
          x = gauss_mutate(cx, dr, x, k, g, t, l, child, may_mutate);
        }
#endif
      }
      grow[l] = round_gene<Gene>(x);
    }
  };

  if constexpr (EXPR_CROSS || ORDER || !CROSSES) {
    for (int i = 0; i < cx.ntiles; ++i) tile(i, 0u);
  } else if (cx.philox_mode) {
    // Crossover bits of tile i: call 2 + i, computed 32 calls at a time
    // by the warp's lanes as deme_breed_kernel does.
    uint4 w = r.w;
    for (int base = 0; base < cx.ncalls; base += 32) {
      if (base) {
        const uint32_t c = base + lane;
        w = c < (uint32_t)cx.ncalls ? philox(cx.k0, cx.k1, make_uint4(k, g, c, t))
                                    : make_uint4(0u, 0u, 0u, 0u);
      }
      const int t_hi = min(base + 30, cx.ntiles);
      for (int i = max(base - 2, 0); i < t_hi; ++i) {
        const int src = i + (int)STREAM_CROSS - base;
        const uint32_t b0 = __shfl_sync(FULL, w.x, src), b1 = __shfl_sync(FULL, w.y, src);
        const uint32_t b2 = __shfl_sync(FULL, w.z, src), b3 = __shfl_sync(FULL, w.w, src);
        tile(i, ((b0 >> lane) & 1u) | (((b1 >> lane) & 1u) << 1) |
                    (((b2 >> lane) & 1u) << 2) | (((b3 >> lane) & 1u) << 3));
      }
    }
  } else {
    const uint8_t* bits = dr.cross + child * L;
    for (int i = 0; i < cx.ntiles; ++i) {
      uint32_t b = 0u;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int l = 128 * i + lane + 32 * m;
        if (l < L && bits[l]) b |= 1u << m;
      }
      tile(i, b);
    }
  }
  __syncwarp();
  if (!EXPR_MUT && cx.mutate == MUT_SWAP && fire && pos < L && pj < L) {
    if (lane == 0) {
      const float x = grow[pos];
      grow[pos] = grow[pj];
      grow[pj] = x;
    }
    __syncwarp();
  }
}

// The score of the child in the warp's row `grow` (on every lane): the
// objective hook, else the builtin rowwise-fused objective `obj`, its terms
// summed per lane over l = lane, lane+32, ... and combined by warp_sum.
__device__ __forceinline__ float expr_score(
    const float* grow, float* erows, int obj, int L, int lane, const float* __restrict__ cb) {
  (void)erows;
  (void)cb;
#if EXPR_OBJ
  (void)obj;
  return expr_objective(grow, erows, L, lane, cb);
#else
  float a = 0.0f, b = 0.0f;
  for (int l = lane; l < L; l += 32) obj_add(obj, grow[l], a, b);
  return obj_finish(obj, warp_sum(a), warp_sum(b), L);
#endif
}

template <class Gene, unsigned ABLATE>
__global__ void __launch_bounds__(THREADS) expr_breed_kernel(
    const Gene* __restrict__ gin, Gene* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr0, ExprDraws ex0,
    const float* __restrict__ cb, Geometry geo, Selection sel, int mutate, int obj) {
  extern __shared__ int smem[];
  __shared__ int s_valid;
  const int g = blockIdx.x, K = geo.K, L = geo.L;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, (size_t)geo.G * K);
  const Draws dr = island_draws(dr0, geo, 1);
  const ExprDraws ex = island_expr_draws(ex0, geo, 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int* row_of_rank = smem;
  float* grow = reinterpret_cast<float*>(smem + K) + (size_t)warp * (1 + EXPR_OBJ_ROWS) * L;
  float* erows = grow + L;
  if (threadIdx.x == 0) s_valid = 0;
  __syncthreads();
  int alive = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int r = ranks[(size_t)g * K + k];
    if (r >= 0 && r < K) row_of_rank[r] = k;
    alive += read_row(geo, g, k) < geo.P;
  }
  alive = warp_sum(alive);
  if (lane == 0) atomicAdd(&s_valid, alive);
  __syncthreads();

  const float V = (float)max(s_valid, 1);
  BreedCtx cx = breed_ctx(dr, mparams, geo, mutate, obj);
  // Selection and mutation only: no crossover bits.
  if (EXPR_CROSS || (ABLATE & ABL_NO_CROSS)) cx.ncalls = 2;
  const bool scored = EXPR_OBJ || obj != OBJ_NONE;

  for (int k = warp; k < K; k += nwarps) {
    const size_t child = (size_t)g * K + k;
    const ChildRand r = child_rand(cx, dr, k, g, 0u, lane, child);
    int s1 = k, s2 = k;  // sel_const, no_matmul: child k's parents are slot k
    if constexpr (!(ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER))) {
      const int r1 = winner_rank(winner_fraction(sel, r.su0), V);
      const int r2 = winner_rank(winner_fraction(sel, r.su1), V);
      s1 = min(max(row_of_rank[r1], 0), K - 1);
      s2 = min(max(row_of_rank[r2], 0), K - 1);
    }
    const Gene* p1 = gin + (size_t)read_row(geo, g, s1) * L;
    const Gene* p2 = gin + (size_t)read_row(geo, g, s2) * L;
    const int orow = write_row(geo, g, k);
    expr_child<true, false, Gene, ABLATE>(cx, dr, ex, p1, p2, grow, r, k, g, 0u, lane, child, cb);
    Gene* out = gout + (size_t)orow * L;
    for (int l = lane; l < L; l += 32) store_gene(out + l, grow[l]);
    if (scored) {
      const float score = expr_score(grow, erows, obj, L, lane, cb);
      if (lane == 0) sout[orow] = orow < geo.P ? score : -INFINITY;
    }
    __syncwarp();  // the next child overwrites this warp's rows
  }
}

// ---------------------------------------------------------------------------
// expr_pipelined_kernel: expr_breed_kernel's function on the pipelined
// schedule (B6 redesigned for Hopper).
//
// Replaces, in libpga_tpu/ops/pallas_step.py, the same expression branches as
// expr_breed_kernel: _deme_child's callable crossover (:636-647) and callable
// mutation (:750-763) and the fused kernel_rowwise objectives that carry
// constants (:1143-1146), in _breed_kernel (:946, riffle) and _pp_breed_kernel
// (:1173, ping-pong parities 0 and 1, and its B > 1 case :1287-1390 at the
// sub-block geometries). It computes exactly expr_breed_kernel's function:
// the children bit for bit (a hook that calls a transcendental within 2 ulp:
// nvcc may inline it differently), the scores bit for bit, with the same
// Philox counters and injected draws. The plain version is
// fused_step.deme_breed_reference with the hooks.
//
// Bound. expr_breed_kernel's: the population read once and written once plus
// the scores (0.651 ms for NK at 4,194,304x64, 0.153 ms for the trap at
// 1,048,576x60, 0.253 ms at 1,048,576x100; half the genome bytes at bf16).
// The operations (one Philox call a plane for four genes, a few operations a
// gene for each hook statement) stay below it.
//
// Why. expr_breed_kernel breeds a warp a child through a shared row (a store
// and two loads a gene) in blocks of 8 warps, and each per-gene random plane
// costs it one Philox call for four genes plus 16 shuffles and selects a tile
// to bring each word to the lane of its gene: with every stage off it still
// took 0.62 of its 1.31 ms for creep at 1M x 100 (PERF.md). This kernel is
// deme_pipelined_kernel's schedule (pipe_core.cuh: pipe_demes, the deme
// staged whole by TMA across a cluster of C blocks, one cluster barrier a
// deme, closed-form row maps, a persistent grid shared by the islands,
// 16 warps of 512 threads) with its child: 8 lanes a child, four children a
// warp, sub-lane jl taking genes 128*t + 32*it + 4*jl + 0..3 as a 16-byte
// (bf16: 8-byte) vector, the child in registers from the parents' staged
// rows to its write row. Sub-lane jl's four genes of a chunk are exactly the
// four words of Philox call 32*t + 8*it + jl of each expression plane, so
// each lane computes its own calls (STREAM_EXPR_GENE + (j << 22) + call, at
// counter (k, g, call, 0)) with no shuffle; sub-lane 3 computes the row
// words (STREAM_EXPR_ROW), sub-lanes 0-2 the selection, mutation and first
// crossover calls, as deme_pipelined_kernel. The hooks are the generated
// ones: expr_crossover and expr_mutate per gene, and the objective's
// eight-lane form (ops/expr_cuda.py: expr_obj8_genes, expr_objective8), whose
// reductions keep a partial a warp-lane position 4*jl + i and combine in
// warp_sum's butterfly order, so each score is expr_breed_kernel's. Its first
// stage is fused into the breed (four genes as they are written); its later
// stages loop over the lane's genes, reading back the materialised rows
// (EXPR_OBJ_ROWS a child, written before a sync of the warp) and, where the
// objective reads the child back (EXPR_OBJ_CHILD) or a builtin swap mutation
// must re-score it, the child's own row. Those rows are expr_plan.cuh's:
// PIPE_CHILDREN children in flight, after pipe_plan.cuh's layout, at an odd
// stride, so that a warp's four children hit distinct banks (at a stride of
// a multiple of 4 floats every access was 4-way conflicted); the plan takes
// the least cluster that holds them too. The builtin crossover bits,
// selection, point / gaussian / swap mutation and builtin rowwise objectives
// are deme_pipelined_kernel's (swap exchanges its genes in the written row,
// and in the child's row, then re-scores the child).
//
// Route. expr_plan.cuh holds the rule: four genes a lane need L % 4 == 0 (the
// knapsack's L = 6 stays on expr_breed_kernel), and a cluster of at most 8
// blocks must hold the deme and the children's rows; elsewhere
// kernels.expr_breed_cuda launches expr_breed_kernel, decided from the shape
// before any launch. Order crossover stays on expr_order_kernel.
//
// ABLATE: expr_breed_kernel's meaning (the stage bits; the copy is
// deme_breed_kernel's); the harness and extra units instantiate its cases as
// they do expr_breed_kernel's (dispatch_expr_ablate).

// Plane j of genes l0 .. l0 + 3 in sub-generation t (Philox call `call` of
// the plane), for the planes in STREAMS, else 0.
template <unsigned STREAMS>
__device__ __forceinline__ void pipe_gene_draws(const BreedCtx& cx, const ExprDraws& ex, int k,
                                                int g, uint32_t t, uint32_t call, size_t child,
                                                int l0, float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[j][i] = 0.0f;
    if (!((STREAMS >> j) & 1u)) continue;
    if (cx.philox_mode) {
      const uint4 w =
          philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_EXPR_GENE + ((uint32_t)j << 22) + call, t));
      v[j][0] = to_uniform(w.x);
      v[j][1] = to_uniform(w.y);
      v[j][2] = to_uniform(w.z);
      v[j][3] = to_uniform(w.w);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[j][i] = ex.gene[(size_t)j * cx.plane + child * cx.L + l0 + i];
    }
  }
}

// A child's two parent rows, as the caller's selection gives them, the row
// it is written to, and where its score goes: `score` (nullptr where nothing
// is scored), -inf in place of the score where `real` is false (a pad row).
template <class Gene>
struct ChildRows {
  const Gene* p1;
  const Gene* p2;
  Gene* out;
  float* score;
  bool real;
};

// The eight-lane expression child, which expr_pipelined_kernel and
// expr_multigen_kernel<false>'s cluster schedule both breed: lane group h of
// the warp breeds child k of deme g in sub-generation t (`child` = g*K + k
// indexes the injected draws, `dr` and `ex` at sub-generation t), its
// sub-lane jl four genes at a time (128*tile + 32*it + 4*jl + 0..3; L, the
// genome length, a multiple of 4), the child in registers. Sub-lanes 0-3
// make the selection, mutation, first crossover and row-word calls (counter
// (k, g, stream, t)); a sub-lane's four genes of a chunk are the four words
// of Philox call 32*tile + 8*it + jl of each expression plane, so it
// computes its own calls with no shuffle. rows(su0, su1) gives the two
// parent rows from the selection draws, the child's row `out` and where its
// score goes (ChildRows), asked for after the draws so that none of them is
// live across their Philox calls.
// The crossover hook, else uniform crossover's bits; the mutation hook, else
// point / gaussian / swap; each gene rounded to the gene type and stored to
// `out`; then the score: the objective hook's eight-lane form
// (expr_objective8; its first stage fused into the breed unless ROWED, when
// its stages read the child back from its float row; its materialised rows
// in `erows`) or the builtin rowwise objective `obj`, summed in warp_sum's
// order (pipe_sum4). OWN_ROW: the child is also written to `crow`, its own
// float row; else `out` is its float row (float genes), or none is read.
// elite (the multi-generation kernel's k < elitism): the child is its
// parent verbatim, no hook run on it, unless SAME (sel_const, no_matmul:
// then crossed from slot k alone); either way it is not mutated. The group's
// first lane (jl == 0) stores the score here: returned to the caller, it
// cost expr_pipelined_kernel 10 more registers and 4% at creep 1M (PERF.md
// section 5).
template <class Gene, unsigned ABLATE, bool ROWED, bool OWN_ROW, class Rows>
__device__ __forceinline__ void expr_child8(
    const BreedCtx& cx, const Draws& dr, const ExprDraws& ex, const float* __restrict__ cb, int L,
    int k, int g, uint32_t t, size_t child, int mutate, int obj, bool elite, float* crow,
    float* erows, const Rows& rows) {
  constexpr bool SAME = (ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER)) != 0u;
  constexpr bool DRAWS_SEL = !(ABLATE & ABL_SEL_CONST);
  constexpr bool CROSSES = !(ABLATE & ABL_NO_CROSS);
  constexpr bool MUTATES = !(ABLATE & ABL_NO_MUT);
  constexpr bool BITS = CROSSES && !EXPR_CROSS;        // the builtin crossover's bits
  constexpr bool BUILTIN_MUT = MUTATES && !EXPR_MUT;  // point / gaussian / swap
  // The streams that remain: planes / words 0-1 are the crossover's, 2-3
  // the mutation's.
  constexpr unsigned KEEP = (CROSSES ? 3u : 0u) | (MUTATES ? 12u : 0u);
  constexpr unsigned GENE_STREAMS = (unsigned)(EXPR_GENE_STREAMS) & KEEP;
  constexpr unsigned ROW_STREAMS = (unsigned)(EXPR_ROW_STREAMS) & KEEP;
  // Bit c: sub-lane c makes its call (0 selection, 1 mutation, 2 the first
  // crossover tile, 3 the row words).
  constexpr unsigned CALLS = (DRAWS_SEL ? 1u : 0u) | (BUILTIN_MUT ? 2u : 0u) |
                             (BITS ? 4u : 0u) | (ROW_STREAMS ? 8u : 0u);
  const int lane = threadIdx.x & 31, jl = lane % PIPE_LANES, lead = lane - jl;
  const bool copy = elite && !SAME;  // the parent verbatim: no hook, no mutation
  (void)cb;
  (void)ex;
  (void)crow;
  (void)erows;
  (void)copy;
  float su0 = 0.0f, su1 = 0.0f, mu0 = 0.0f, mu1 = 0.0f, mu2 = 0.0f;
  float xq[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // crossover q, q2, mutation q, q2
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (cx.philox_mode) {
    if (jl < 4 && ((CALLS >> jl) & 1u))
      w = philox(cx.k0, cx.k1, make_uint4(k, g, jl == 3 ? STREAM_EXPR_ROW : (uint32_t)jl, t));
    if constexpr (DRAWS_SEL) {
      su0 = to_uniform(__shfl_sync(FULL, w.x, lead));
      su1 = to_uniform(__shfl_sync(FULL, w.y, lead));
    }
    if constexpr (BUILTIN_MUT) {
      mu0 = to_uniform(__shfl_sync(FULL, w.x, lead + 1));
      mu1 = to_uniform(__shfl_sync(FULL, w.y, lead + 1));
      mu2 = to_uniform(__shfl_sync(FULL, w.z, lead + 1));
    }
    if constexpr (ROW_STREAMS != 0u) {
      xq[0] = to_uniform(__shfl_sync(FULL, w.x, lead + 3));
      xq[1] = to_uniform(__shfl_sync(FULL, w.y, lead + 3));
      xq[2] = to_uniform(__shfl_sync(FULL, w.z, lead + 3));
      xq[3] = to_uniform(__shfl_sync(FULL, w.w, lead + 3));
    }
    if constexpr (BITS) {
      w = make_uint4(__shfl_sync(FULL, w.x, lead + STREAM_CROSS),
                     __shfl_sync(FULL, w.y, lead + STREAM_CROSS),
                     __shfl_sync(FULL, w.z, lead + STREAM_CROSS),
                     __shfl_sync(FULL, w.w, lead + STREAM_CROSS));
    }
  } else {
    if constexpr (DRAWS_SEL) {
      su0 = dr.sel_u[child * 2];
      su1 = dr.sel_u[child * 2 + 1];
    }
    if constexpr (BUILTIN_MUT) {
      mu0 = dr.mut_u[child * 4];
      mu1 = dr.mut_u[child * 4 + 1];
      mu2 = dr.mut_u[child * 4 + 2];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((ROW_STREAMS >> j) & 1u) xq[j] = ex.row[child * 4 + j];
  }
  const ChildRows<Gene> cr = rows(su0, su1);
  const Gene* p1 = cr.p1;
  const Gene* p2 = cr.p2;
  Gene* out = cr.out;
  if constexpr (!OWN_ROW) crow = reinterpret_cast<float*>(out);
  const int pos = (int)floorf(mu0 * (float)L);
  const int pj = (int)floorf(mu1 * (float)L);
  const bool fire =
      BUILTIN_MUT && !elite && (mutate == MUT_SWAP ? mu2 < cx.rate : mu1 < cx.rate);
#if EXPR_OBJ
  ExprAcc8 acc[1];
  expr_obj8_begin(acc[0]);
#endif
  // The builtin objective's partials (ackley's cosine sums in e), one a
  // warp-lane position 4*jl + i.
  float a[4], e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = e[i] = 0.0f;
  auto add4 = [&](const float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (obj == OBJ_ONEMAX) {
        a[i] += x[i];
      } else {
        const float2 d = pipe_terms(obj, x[i]);
        a[i] += d.x;
        e[i] += d.y;
      }
    }
  };

  // Cross, mutate, round, store and score the child, 128 genes (one
  // crossover call) a tile, four a lane a step.
  for (int tile = 0; 128 * tile < L; ++tile) {
    if (BITS && cx.philox_mode && tile > 0)
      w = philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_CROSS + tile, t));
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int l0 = 128 * tile + 32 * it + 4 * jl;
      if (l0 >= L) continue;
      float x[4];
      load4(p1 + l0, x);
      float gd[4][4];
      pipe_gene_draws<GENE_STREAMS>(cx, ex, k, g, t, 32u * tile + 8u * it + jl, child, l0, gd);
      if constexpr (CROSSES) {
        float y[4];
        load4(p2 + l0, y);
#if EXPR_CROSS
        if (!copy) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[i] = expr_crossover(x[i], y[i], gd[0][i], gd[1][i], xq[0], xq[1], l0 + i, L, cb);
        }
#else
        uint32_t bits;  // gene l0 + i takes p2's gene where bit i is set
        if (cx.philox_mode) {
          bits = (it == 0 ? w.x : it == 1 ? w.y : it == 2 ? w.z : w.w) >> (4 * jl);
        } else {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(dr.cross + child * L + l0);
          bits = ((u & 0xffu) != 0u) | (((u >> 8) & 0xffu) != 0u) << 1 |
                 (((u >> 16) & 0xffu) != 0u) << 2 | ((u >> 24) != 0u) << 3;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((bits >> i) & 1u) x[i] = y[i];
#endif
      }
      if constexpr (MUTATES) {
#if EXPR_MUT
        if (!elite) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[i] = expr_mutate(x[i], gd[2][i], gd[3][i], xq[2], xq[3], l0 + i, L, cx.rate,
                               cx.sigma, cb);
        }
#else
        if (mutate == MUT_POINT) {
          if (fire && (unsigned)(pos - l0) < 4u) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (l0 + i == pos) x[i] = mu2;
          }
        } else if (mutate == MUT_GAUSSIAN && !elite) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = mg_gauss(cx, dr, x[i], k, g, t, l0 + i, child);
        }
#endif
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = round_gene<Gene>(x[i]);
      store4(out + l0, x);
#if EXPR_OBJ
      if constexpr (ROWED) {
        if constexpr (OWN_ROW) {
#pragma unroll
          for (int i = 0; i < 4; ++i) crow[l0 + i] = x[i];
        }
      } else {
        expr_obj8_genes(acc[0], x, l0, L, crow, erows, cb);
      }
#else
      if (obj != OBJ_NONE) add4(x);
#endif
    }
  }
  if (BUILTIN_MUT && mutate == MUT_SWAP) {
    const bool swap = fire && pos < L && pj < L;
    __syncwarp();
    if (swap && jl == 0) {
      const Gene x = out[pos], y = out[pj];
      out[pos] = y;
      out[pj] = x;
#if EXPR_OBJ
      if constexpr (ROWED && OWN_ROW) {
        const float u = crow[pos];
        crow[pos] = crow[pj];
        crow[pj] = u;
      }
#endif
    }
    __syncwarp();
#if !EXPR_OBJ
    if (swap && obj != OBJ_NONE) {
      // The score is of the child as written: sum again after the swap.
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = e[i] = 0.0f;
      for (int l0 = 4 * jl; l0 < L; l0 += 32) {
        float x[4];
        load4(out + l0, x);
        add4(x);
      }
    }
#endif
  }
#if EXPR_OBJ
  if constexpr (ROWED) __syncwarp();  // the child's row is whole
  const float score = expr_objective8<!ROWED>(acc, crow, erows, L, jl, cb);
  if (jl == 0) *cr.score = cr.real ? score : -INFINITY;
  __syncwarp();  // the next child overwrites the group's rows
#else
  if (obj != OBJ_NONE) {
    const float sa = pipe_sum4(a);
    float se = 0.0f;  // ackley's cosine sum; no other objective has a second
    if (obj == OBJ_ACKLEY) se = pipe_sum4(e);
    if (jl == 0) *cr.score = cr.real ? obj_finish(obj, sa, se, L) : -INFINITY;
  }
#endif
}

// ROWED: each child in flight keeps its own row in shared memory (the
// objective reads it back, EXPR_OBJ_CHILD, or a builtin swap re-scores it);
// a template parameter, so that the breed's loop has one path: a runtime
// choice between the two spilled 88 bytes of its 128 registers.
template <class Gene, unsigned ABLATE, bool ROWED>
__global__ void __launch_bounds__(PIPE_THREADS, 1) expr_pipelined_kernel(
    const Gene* __restrict__ gin, Gene* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr0, ExprDraws ex0,
    const float* __restrict__ cb, Geometry geo, Selection sel, int mutate, int obj,
    ExprPipePlan plan) {
  constexpr bool SAME = (ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER)) != 0u;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char pipe_smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int K = geo.K, L = geo.L, R = plan.pipe.rows;
  const int c = (int)cluster.block_rank(), rs = __ffs(R) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, (size_t)geo.G * K);
  const Draws dr = island_draws(dr0, geo, 1);
  const ExprDraws ex = island_expr_draws(ex0, geo, 1);
  const BreedCtx cx = breed_ctx(dr, mparams, geo, mutate, obj);
  const bool scored = EXPR_OBJ || obj != OBJ_NONE;
  // Lane group h of the warp breeds one child.
  const int h = lane / PIPE_LANES;
  float* crow = nullptr;  // the child's rows in shared memory (expr_plan.cuh): its own
  float* erows = nullptr;  // where ROWED, then the objective's
#if EXPR_OBJ
  crow = reinterpret_cast<float*>(pipe_smem + plan.rows_at) +
         (size_t)(warp * PIPE_KIDS + h) * plan.stride;
  erows = crow + (ROWED ? L : 0);
#endif

  auto breed = [&](int g, const Gene* staged, const int* row_of_rank, float V, const RowMap& wr) {
    for (int k0 = c * R + warp * PIPE_KIDS; k0 < (c + 1) * R; k0 += PIPE_WARPS * PIPE_KIDS) {
      const int k = k0 + h;
      // Slot s is row s % R of the buffer of the cluster's block s / R.
      auto rows = [&](float su0, float su1) {
        int s1 = k, s2 = k;  // sel_const, no_matmul: child k's parents are slot k
        if constexpr (!SAME) {
          s1 = min(max(row_of_rank[winner_rank(winner_fraction(sel, su0), V)], 0), K - 1);
          s2 = min(max(row_of_rank[winner_rank(winner_fraction(sel, su1), V)], 0), K - 1);
        }
        const int o1 = s1 >> rs, o2 = s2 >> rs;
        const int orow = wr(k);
        return ChildRows<Gene>{
            (o1 == c ? staged : cluster.map_shared_rank(staged, o1)) + (size_t)(s1 & (R - 1)) * L,
            (o2 == c ? staged : cluster.map_shared_rank(staged, o2)) + (size_t)(s2 & (R - 1)) * L,
            gout + (size_t)orow * L, scored ? sout + orow : nullptr, orow < geo.P};
      };
      expr_child8<Gene, ABLATE, ROWED, ROWED>(cx, dr, ex, cb, L, k, g, 0u, (size_t)g * K + k,
                                              mutate, obj, false, crow, erows, rows);
    }
  };
  pipe_demes(gin, ranks, geo, plan.pipe, pipe_smem, breed);
}

// ---------------------------------------------------------------------------
// expr_order_kernel: one generation with order crossover and expression hooks
// (cases of B5 x B6).
//
// Replaces, in libpga_tpu/ops/pallas_step.py, _breed_kernel (:946) where
// _deme_child runs the order walk (:653-732) and then a callable mutation
// (:750-763), or scores the children with a fused kernel_rowwise objective
// that carries constants (:1143-1146) or with _tsp_eval_gene_major (:819). The
// plain PyTorch version is fused_step.deme_breed_reference with
// crossover="order" and an expression mutation or objective. Riffle row map
// only (JAX pins D = 1 and the riffle for order crossover).
//
// What it computes, per child: order_breed_kernel's selection and walk
// (breed_core.cuh's order_tiles, fallback genes from stream 0x20000000 + l/4
// or the injected plane), then the mutation: the hook per gene (its planes
// and row words as expr_breed_kernel draws them, lane i of tile m computing
// the call of genes 128*m + 4i .. 4i+3), else point / gaussian / swap; then
// the score of the child as written: the objective hook, a builtin
// rowwise-fused id, or the coordinate TSP (OBJ_TSP, gene-major, summed in l
// order as order_breed_kernel sums it).
//
// Design. The walk is a sequential chain of L dependent steps, one thread per
// child; the hooks run one warp per child with lanes over genes and a shared
// child row. So a block holds ORDER_THREADS children of one deme (as
// order_breed_kernel: 8,192x1,000 still fills ~128 SMs) and works in phases:
// the block walks its children in step on shared-memory tiles
// (breed_core.cuh's order_tiles, layout order_plan.cuh: both parents' next
// tile staged by cp.async copies while the block walks this one, the child
// stored with coalesced stores into its physical row; the block's third and
// fourth warps share the copies and walk nothing); a block barrier; then each
// warp with rows (all four where their rows fit) takes its children in turn,
// reads the walked row
// back with coalesced loads into its shared row, mutates it there (swap
// exchanges two genes there), writes it back with coalesced stores and
// scores it from the shared row; for OBJ_TSP a second barrier and the block
// reads the children back on the same tiles (order_rescan), each thread
// scoring its own (its edges added in l order, its duplicate genes counted
// on its bitmask column, the coordinates staged as float2). Shared memory:
// order_plan's layout with each warp's child and objective rows.
//
// Bound. Bytes: the population read once and written once plus the scores,
// (2*Pp*L + 2*Pp)*4 (0.0313 ms at 65,536x200, 0.0196 ms at 8,192x1,000 at 3.35
// TB/s). Operations: a few per gene for the walk and the hooks, far below the
// card's rate. As in order_breed_kernel, each thread's walk is a chain of L
// dependent steps through shared memory and the TSP score's edge sum a chain
// of L adds: the chains, not the bytes, are expected to set the time.

template <unsigned ABLATE>
__global__ void __launch_bounds__(2 * ORDER_THREADS) expr_order_kernel(
    const float* __restrict__ gin, float* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr0, ExprDraws ex0,
    const float* __restrict__ cb, const float* __restrict__ coords, int C, float penalty,
    Geometry geo, Selection sel, int mutate, int obj, OrderPlan plan, int vec, int warps) {
  extern __shared__ __align__(16) unsigned char order_smem[];
  constexpr int NT = 2 * ORDER_THREADS;  // the block: the walk's two warps and two more
  const int K = geo.K, L = geo.L, G = geo.G, tid = threadIdx.x;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, (size_t)G * K);
  const Draws dr = island_draws(dr0, geo, 1);
  const ExprDraws ex = island_expr_draws(ex0, geo, 1);
  const int lane = tid & 31, warp = tid >> 5;
  const bool walker = tid < ORDER_THREADS;  // the walk's threads; `warps` warps run phase 2
  const int per_deme = K / ORDER_THREADS;
  const int g = blockIdx.x / per_deme, first = (blockIdx.x % per_deme) * ORDER_THREADS;
  const int Cs = obj == OBJ_TSP ? min(C, L) : 0;
  float* const bufs = reinterpret_cast<float*>(order_smem);
  float2* const xy = reinterpret_cast<float2*>(order_smem + plan.xy);
  unsigned* const vis = reinterpret_cast<unsigned*>(order_smem + plan.vis) + tid;
  // Phase 2's rows share the tile buffers' bytes (order_plan.cuh).
  float* const grow = reinterpret_cast<float*>(order_smem) + (size_t)warp * (1 + EXPR_OBJ_ROWS) * L;
  float* const erows = grow + L;
  int* const row_of_rank = reinterpret_cast<int*>(order_smem + plan.ror);
  int* const srow = reinterpret_cast<int*>(order_smem + plan.srow);

  for (int i = tid; i < K; i += NT) {
    const int r = ranks[(size_t)g * K + i];
    if (r >= 0 && r < K) row_of_rank[r] = i;
  }
  for (int i = tid; i < Cs; i += NT)
    xy[i] = make_float2(coords[2 * i], coords[2 * i + 1]);
  __syncthreads();

  const float V = (float)max(min(K, geo.P - g * K), 1);
  BreedCtx cx = breed_ctx(dr, mparams, geo, mutate, obj);
  cx.ncalls = 2;  // selection and mutation: no crossover bits
  constexpr bool SAME = (ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER)) != 0u;
  constexpr bool WALK = !(ABLATE & ABL_NO_CROSS);
  auto out_row = [=](int r) { return (first + r) * G + g; };

  // Phase 1: the block walks its children into their physical rows (under
  // no_cross nothing is walked).
  if constexpr (WALK) {
    const int k = first + tid % ORDER_THREADS;
    const size_t child = (size_t)g * K + k;
    int s1 = k, s2 = k;  // sel_const, no_matmul: slot k's row with itself
    if (!SAME && walker) {
      float su0, su1;
      if (cx.philox_mode) {
        const uint4 w = philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_SEL, 0u));
        su0 = to_uniform(w.x);
        su1 = to_uniform(w.y);
      } else {
        su0 = dr.sel_u[child * 2];
        su1 = dr.sel_u[child * 2 + 1];
      }
      s1 = min(max(row_of_rank[winner_rank(winner_fraction(sel, su0), V)], 0), K - 1);
      s2 = min(max(row_of_rank[winner_rank(winner_fraction(sel, su1), V)], 0), K - 1);
    }
    if (walker) {
      srow[tid] = g * K + s1;
      srow[ORDER_THREADS + tid] = g * K + s2;
    }
    __syncthreads();  // srow
    const FillSource fill{cx.philox_mode, cx.k0, cx.k1, k, g, 0u,
                          cx.philox_mode ? nullptr : dr.fill + child * L};
    auto src_row = [=](int r) { return srow[r]; };
    auto as_walked = [](int, float(&)[4], int) {};
    if (cx.philox_mode)
      order_tiles<true, true, NT>(bufs, gin, gout, src_row, out_row, L, vec != 0, vis, fill,
                                  as_walked);
    else
      order_tiles<true, false, NT>(bufs, gin, gout, src_row, out_row, L, vec != 0, vis, fill,
                                   as_walked);
  }
  __syncthreads();

  // Phase 2: one warp per child: mutation, write-back, score. Under no_cross
  // the warp mutates parent 1 itself, selected from the same draws.
  const bool warp_scored = EXPR_OBJ || (obj != OBJ_NONE && obj != OBJ_TSP);
  for (int j = warp; warp < warps && j < ORDER_THREADS; j += warps) {
    const int k = first + j, orow = k * G + g;
    const size_t child = (size_t)g * K + k;
    float* out = gout + (size_t)orow * L;
    const ChildRand r = child_rand(cx, dr, k, g, 0u, lane, child);
    const float* p1 = out;
    if constexpr (!WALK) {
      int s1 = k;
      if constexpr (!SAME)
        s1 = min(max(row_of_rank[winner_rank(winner_fraction(sel, r.su0), V)], 0), K - 1);
      p1 = gin + ((size_t)g * K + s1) * L;
    }
    expr_child<!WALK, true, float, ABLATE>(cx, dr, ex, p1, p1, grow, r, k, g, 0u, lane, child,
                                            cb);
    for (int l = lane; l < L; l += 32) out[l] = grow[l];
    if (warp_scored) {
      const float score = expr_score(grow, erows, obj, L, lane, cb);
      if (lane == 0) sout[orow] = orow < geo.P ? score : -INFINITY;
    }
    __syncwarp();  // the next child overwrites this warp's rows
  }

  // Phase 3 (OBJ_TSP): each thread scores its child as phase 2 stored it,
  // read back on the tiles.
  if (obj == OBJ_TSP) {
    if (walker)
      for (int w = 0; w < (L + 31) / 32; ++w) vis[w * ORDER_THREADS] = 0u;
    __syncthreads();  // every child stored
    TourScore tour;
    order_rescan<NT>(bufs, gout, out_row, L, vec != 0, 0, [&](int l0, const float(&x)[4], int m) {
      tour.chunk<true>(x, l0, m, L, vis, xy, C, 0, L);
    });
    if (walker) {
      const int orow = out_row(tid);
      const float score = tour.score(penalty, TourScore::duplicates(vis, L));
      sout[orow] = orow < geo.P ? score : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// expr_multigen_kernel: up to T generations per launch with expression hooks
// (B6 x B4).
//
// Replaces, in libpga_tpu/ops/pallas_step.py, _multigen_kernel (:1460) with
// _kernel_ranks (:1398) in its expression cases: callable crossover / mutate
// kinds (cross_consts / mut_consts, :1534-1542) and fused objectives that
// carry constants (const_refs, obj(child, *consts), :1670-1673), as
// make_pallas_multigen (:2724) builds them and pl.pallas_call (:2872) runs
// them. The plain PyTorch version is fused_step.multigen_breed_reference with
// an expression crossover, mutation or objective; the kernel computes exactly
// that function, scores included (the plain version sums every reduction of
// the objective in this kernel's lane order, objectives/expr.warp_order_sum).
//
// What it computes: multigen_breed_kernel's loop (multigen_group of
// breed_core.cuh: the freeze flag, in-kernel ranks, selection, per-deme
// elites, the write-back), with the children of expr_breed_kernel. Each warp
// breeds its child into its row of shared memory through the hooks
// (expr_child), copies it to the work buffer (or, in the last
// sub-generation, to its physical row) and scores it from that row with the
// objective hook or the builtin fused objective. An elite child (k <
// elitism) is a verbatim copy of its rank-k parent: no hook runs on it. The
// expression draws carry the sub-generation t as Philox's fourth counter
// word, like every other stream; in injected mode the planes are (T, 4, G, K,
// L) and the row words (T, G, K, 4).
//
// Bound. As multigen_breed_kernel's: the population and its scores read once
// and written once, (2*Pp*L + 2*Pp)*4 bytes, whatever the step count: 0.651
// ms for NK at 4,194,304x64, 0.153 ms for the trap at 1,048,576x60, 0.253 ms
// for OneMax at 1,048,576x100 and 9.7 us at 40,000x100, at 3.35 TB/s. The
// operations (K*log2(K) compares per deme and a few per gene for every
// statement of the hooks, per sub-generation) stay below that at T = 8 for
// these expressions (chip_smoke.py's expr_multigen_bound counts them).
//
// Two schedules compute that function. Where expr_plan.cuh's expr_mg_plan
// holds the group (L a multiple of 4, uniform or expression crossover, the
// group and its children's objective rows within a cluster of at most 8
// blocks) the route (kernels.expr_multigen_cuda, from the shape before any
// launch) takes the cluster schedule, the overload after this kernel:
// multigen_breed_kernel<false>'s (a group held in a cluster's shared memory
// for the launch, ranks by a merge of warp-sorted runs, one cluster barrier a
// sub-generation; deme_breed.cu describes it) with expr_pipelined_kernel's
// eight-lane child (expr_child8). Its first version, a warp a child through
// the hooks' warp forms, was issue-bound and slower than the one-block
// schedule at every cell (PERF.md); the eight-lane hooks it lacked came with
// expr_pipelined_kernel. Elsewhere (order crossover, the
// knapsack's L = 6, a group no cluster holds) the one-block schedule: one
// block a group (multigen_group), a warp a child through its shared row.
//
// Design of the one-block schedule. Parents are read with plain loads (see
// expr_child). Shared memory holds the group's keys, scores, row_of_rank and
// alive flags (17 bytes per row) and, after them, each warp's child row and
// EXPR_OBJ_ROWS objective rows of L floats; the wrapper picks the warp count
// (up to 32) that fits in 227 KB. Blocks are of up to 1,024 threads, as the
// builtin kernel's.
//
// Order crossover (expr_multigen_kernel<true>, _multigen_kernel's
// order_refs, :1548, walked in VMEM by _deme_child, :653-732): the block is
// of MG_THREADS threads, and multigen_group<true> walks the group's children
// in step on shared-memory tiles (order_tiles; layout order_plan.cuh's
// mg_order_plan: passes of P children, one thread a child, both parents'
// next tile staged by cp.async beside the walk of this one, the child
// stored with coalesced stores to its row); after a block barrier each
// breeding warp reads its walked child into its shared row (expr_child<false,
// true>), mutates and scores it there. Those rows share the ring's bytes,
// their phases apart, and the layout gives as many warps as their rows fit
// (all 32 at the tour, 65,536x200); a shape where not even one warp's rows
// fit beside the walk is refused from the shape before the launch
// (kernels.multigen_order_plan). The block's thread count is fixed so that
// the walk's copy loops keep a stride known at compile time (a stride read
// from blockDim slowed the one-generation walk, PERF.md). An elite child is
// its rank-k parent verbatim. D is 1 and the row map the riffle, as in JAX.
// Bound: the bytes above; but the walk is a chain of L dependent steps per
// sub-generation on the group's K = 256 walkers, which with the warps' breed
// sets the time (65,536x200: 256 blocks of one group on 132 SMs); the tiles
// keep the chain's loads in shared memory, off L2.

template <bool ORDER, class Gene, unsigned ABLATE>
__global__ void __launch_bounds__(MG_THREADS) expr_multigen_kernel(
    MultigenIO<Gene> io, const float* __restrict__ mparams, Draws dr0, ExprDraws ex0,
    const float* __restrict__ cb, Geometry geo, Selection sel, int mutate, int obj,
    int elitism, int draw_steps) {
  extern __shared__ long long mg_smem[];
  io = island_io(io, geo);
  dr0 = island_draws(dr0, geo, draw_steps);
  ex0 = island_expr_draws(ex0, geo, draw_steps);
  const int L = geo.L, W = geo.D * geo.K, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Order crossover: the walk's layout, whose ring the warps' rows share
  // (order_plan.cuh); else the rows follow the group's arrays.
  const MgOrderPlan walk =
      ORDER ? mg_walk_plan(W, L, (size_t)(1 + EXPR_OBJ_ROWS) * L * sizeof(float)) : MgOrderPlan{};
  const size_t fixed = ORDER ? walk.ring : mg_rows_bytes(W);
  float* grow = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(mg_smem) + fixed) +
                (size_t)warp * (1 + EXPR_OBJ_ROWS) * L;
  float* erows = grow + L;
  BreedCtx cx = breed_ctx(dr0, mparams, geo, mutate, obj);
  // Selection and mutation only: no crossover bits.
  if (EXPR_CROSS || ORDER || (ABLATE & ABL_NO_CROSS)) cx.ncalls = 2;
  const size_t GK = (size_t)geo.G * geo.K;
  // sel_const, no_matmul: an elite is bred (and left unmutated), not copied.
  constexpr bool SAME = (ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER)) != 0u;
  auto breed_child = [&](const Draws& dr, uint32_t t, int g, int k, size_t child,
                         const Gene* p1, const Gene* p2, Gene* out, const ChildRand& r,
                         bool elite) {
    if (elite && !SAME) {
      for (int l = lane; l < L; l += 32) grow[l] = load_gene<false>(p1 + l);
      __syncwarp();
    } else {
      ExprDraws ex = ex0;
      if (!cx.philox_mode) {
        if (ex.gene) ex.gene += (size_t)t * 4 * cx.plane;
        if (ex.row) ex.row += (size_t)t * GK * 4;
      }
      expr_child<false, ORDER, Gene, ABLATE>(cx, dr, ex, p1, p2, grow, r, k, g, t, lane, child,
                                             cb, !(SAME && elite));
    }
    for (int l = lane; l < L; l += 32) store_gene(out + l, grow[l]);
    const float score = expr_score(grow, erows, obj, L, lane, cb);
    __syncwarp();  // the next child overwrites this warp's rows
    return score;
  };
  multigen_group<ORDER, ABLATE>(io, geo, cx, dr0, sel, elitism, mg_smem, breed_child, walk);
}

// expr_multigen_kernel<false>'s cluster schedule: the one-block schedule's
// function (above) on multigen_breed_kernel<false>'s schedule
// (breed_core.cuh's multigen_cluster, plan expr_mg_plan in expr_plan.cuh):
// a cluster of plan.mg.C blocks holds a group in shared memory for the whole
// launch, and each sub-generation breeds the block's children from one copy
// of the group into the other with the eight-lane expression child
// (expr_child8: 8 lanes a child, four genes a lane, the hooks' eight-lane
// forms), its parents read through mg_parent (a peer block's through
// distributed shared memory), its score into the block's score row. An
// elite (k < elitism) is its rank-k parent verbatim, no hook run on it (SAME:
// crossed from slot k alone, unmutated). The expression draws carry the
// sub-generation t as Philox's fourth counter word; in injected mode the
// planes and row words are island `st.island`'s at t. The objective's
// materialised rows are the plan's, a child's at an odd stride; where the
// objective reads the child back (ROWED) a float child is read from its row
// of the group's copy and a bf16 one from a float row of its own. Children
// and scores are the one-block schedule's bit for bit.
template <bool ORDER, class Gene, unsigned ABLATE, bool ROWED>
__global__ void __launch_bounds__(MGC_THREADS, 1) expr_multigen_kernel(
    MultigenIO<Gene> io, const float* __restrict__ mparams, Draws dr0, ExprDraws ex0,
    const float* __restrict__ cb, Geometry geo, Selection sel, int mutate, int obj, int elitism,
    int draw_steps, int islands, ExprMgPlan plan) {
  static_assert(!ORDER, "order crossover breeds on the one-block schedule");
  constexpr bool SAME = (ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER)) != 0u;
  constexpr bool BITS = !(ABLATE & ABL_NO_CROSS) && !EXPR_CROSS;
  constexpr bool OWN_ROW = ROWED && !std::is_same_v<Gene, float>;
  extern __shared__ __align__(16) unsigned char pipe_smem[];
  const int K = geo.K, L = geo.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, h = lane / PIPE_LANES;
  const size_t GK = (size_t)geo.G * K;
  float* crow = nullptr;   // a bf16 child's own float row (OWN_ROW)
  float* erows = nullptr;  // then the objective's materialised rows
#if EXPR_OBJ
  crow = reinterpret_cast<float*>(pipe_smem + plan.rows_at) +
         (size_t)(warp * PIPE_KIDS + h) * plan.stride;
  erows = crow + (OWN_ROW ? L : 0);
#endif

  auto breed = [&](const MgStep<Gene>& st, const cg::cluster_group& cl) {
    ExprDraws ex = ex0;
    if (!st.cx.philox_mode) {
      const size_t at = (size_t)st.island * draw_steps + st.t;
      if (ex.gene) ex.gene += at * 4 * GK * L;
      if (ex.row) ex.row += at * GK * 4;
    }
    for (int x0 = warp * PIPE_KIDS; x0 < st.R; x0 += MGC_THREADS / 32 * PIPE_KIDS) {
      const int xl = x0 + h, x = st.c * st.R + xl, k = x & (K - 1);
      const int g = st.i * geo.D + (x >> st.ks);
      const bool elite = k < elitism;
      auto rows = [&](float su0, float su1) {
        const int2 s = mg_parents<SAME>(st, sel, x, elite, su0, su1);
        // A pad row's score is the write-back's -inf.
        return ChildRows<Gene>{mg_parent(st, cl, s.x, L), mg_parent(st, cl, s.y, L),
                               st.next + (size_t)xl * L, st.score + xl, true};
      };
      expr_child8<Gene, ABLATE, ROWED, OWN_ROW>(st.cx, st.dr, ex, cb, L, k, g, st.t,
                                                (size_t)g * K + k, mutate, obj, elite, crow,
                                                erows, rows);
    }
  };
  multigen_cluster<ABLATE, MGC_THREADS>(io, geo, plan.mg, dr0, mparams, mutate, obj, draw_steps,
                                        islands, !BITS, pipe_smem, breed);
}

// The one-block schedule's kernel of crossover ORDER and the cluster
// schedule's of ROWED, apart from each other (two overloads of the template).
template <bool ORDER, class Gene, unsigned ABLATE>
auto expr_multigen_one_block() {
  return static_cast<void (*)(MultigenIO<Gene>, const float*, Draws, ExprDraws, const float*,
                              Geometry, Selection, int, int, int, int)>(
      expr_multigen_kernel<ORDER, Gene, ABLATE>);
}

template <class Gene, unsigned ABLATE, bool ROWED>
auto expr_multigen_cluster() {
  return static_cast<void (*)(MultigenIO<Gene>, const float*, Draws, ExprDraws, const float*,
                              Geometry, Selection, int, int, int, int, int, ExprMgPlan)>(
      expr_multigen_kernel<false, Gene, ABLATE, ROWED>);
}

// Launches `launch` at the ABLATE case `ablate` where this unit holds it:
// 0 always; with EXPR_HARNESS each stage bit alone and the floor (and, for
// the multi-generation kernel, ABL_NO_FREEZE and ABL_NO_RANK_CUBE); with
// EXPR_ABLATE_EXTRA that mask. cudaErrorInvalidValue otherwise.
template <bool MULTIGEN, class F>
int dispatch_expr_ablate(unsigned ablate, F launch) {
  using std::integral_constant;
  if (ablate == 0u) return launch(integral_constant<unsigned, 0u>{});
#if EXPR_HARNESS
  switch (ablate) {
    case ABL_SEL_CONST: return launch(integral_constant<unsigned, ABL_SEL_CONST>{});
    case ABL_NO_GATHER: return launch(integral_constant<unsigned, ABL_NO_GATHER>{});
    case ABL_NO_CROSS: return launch(integral_constant<unsigned, ABL_NO_CROSS>{});
    case ABL_NO_MUT: return launch(integral_constant<unsigned, ABL_NO_MUT>{});
    case ABL_STAGES: return launch(integral_constant<unsigned, ABL_STAGES>{});
    default: break;
  }
  if constexpr (MULTIGEN) {
    if (ablate == ABL_NO_FREEZE) return launch(integral_constant<unsigned, ABL_NO_FREEZE>{});
    if (ablate == ABL_NO_RANK_CUBE)
      return launch(integral_constant<unsigned, ABL_NO_RANK_CUBE>{});
  }
#endif
#if EXPR_ABLATE_EXTRA
  if (ablate == (unsigned)(EXPR_ABLATE_EXTRA))
    return launch(integral_constant<unsigned, (unsigned)(EXPR_ABLATE_EXTRA)>{});
#endif
  return (int)cudaErrorInvalidValue;
}

// expr_pipelined_kernel's launch: the plan of expr_plan.cuh (C = 0: refused),
// clusters of C blocks, as many as the card holds at once (at most G an
// island), blockIdx.y the island.
template <class Gene>
int expr_pipelined_launch(const void* gin, void* gout, float* sout, const int* ranks,
                          const float* mparams, const Draws& dr, const ExprDraws& ex,
                          const float* consts, const Geometry& geo, const Selection& sel,
                          int mutate, int obj, int islands, unsigned ablate,
                          cudaStream_t stream) {
  const ExprPipePlan plan =
      expr_pipe_plan(geo.K, geo.L, (int)sizeof(Gene), geo.q, expr_child_rows(mutate));
  if (!plan.pipe.C) return (int)cudaErrorInvalidValue;
  return dispatch_expr_ablate<false>(ablate, [&](auto tag) {
    constexpr unsigned A = decltype(tag)::value;
    auto launch = [&](auto kernel) {
      return pipe_launch(kernel, plan.pipe.C, plan.pipe.smem, geo.G, islands, stream,
                         static_cast<const Gene*>(gin), static_cast<Gene*>(gout), sout, ranks,
                         mparams, dr, ex, consts, geo, sel, mutate, obj, plan);
    };
    // The child's own row: always where the objective reads it back; with a
    // builtin swap mutation where it re-scores it (expr_child_rows).
    if constexpr (EXPR_OBJ && !EXPR_OBJ_CHILD && !EXPR_MUT) {
      if (mutate == MUT_SWAP) return launch(expr_pipelined_kernel<Gene, A, true>);
    }
    return launch(expr_pipelined_kernel<Gene, A, (bool)(EXPR_OBJ && EXPR_OBJ_CHILD)>);
  });
}

// expr_multigen_kernel<false>'s cluster schedule at the geometry: the plan
// of expr_plan.cuh (C = 0, the one-block schedule's group: refused), as many
// clusters as the card holds at once, each walking its run of the groups of
// every island.
template <class Gene>
int expr_multigen_cluster_launch(const MultigenIO<Gene>& io, const float* mparams,
                                 const Draws& dr, const ExprDraws& ex, const float* consts,
                                 const Geometry& geo, const Selection& sel, int mutate, int obj,
                                 int elitism, int draw_steps, int islands, unsigned ablate,
                                 cudaStream_t stream) {
  const ExprMgPlan plan = expr_mg_plan(geo.D, geo.K, geo.L, (int)sizeof(Gene), geo.q, mutate);
  if (!plan.mg.C) return (int)cudaErrorInvalidValue;
  return dispatch_expr_ablate<true>(ablate, [&](auto tag) {
    constexpr unsigned A = decltype(tag)::value;
    auto launch = [&](auto kernel) {
      return launch_clusters(kernel, plan.mg.C, plan.mg.smem, MGC_THREADS, islands * geo.S,
                             stream, io, mparams, dr, ex, consts, geo, sel, mutate, obj, elitism,
                             draw_steps, islands, plan);
    };
    // The child read back: always where the objective reads it; with a
    // builtin swap mutation where it re-scores it (expr_child_rows).
    if constexpr (EXPR_OBJ && !EXPR_OBJ_CHILD && !EXPR_MUT) {
      if (mutate == MUT_SWAP) return launch(expr_multigen_cluster<Gene, A, true>());
    }
    return launch(expr_multigen_cluster<Gene, A, (bool)(EXPR_OBJ && EXPR_OBJ_CHILD)>());
  });
}

}  // namespace

// cross_kind 0: expr_breed_kernel (uniform crossover or the crossover
// hook; `warps` warps per block) or, with `pipelined`, expr_pipelined_kernel
// (the shape must be one expr_plan.cuh's plan holds; gin and ranks 16-byte
// aligned for the TMA copies, gout for the vector stores; `warps` unread);
// 1: expr_order_kernel (order crossover,
// riffle only, `fill` genes, ORDER_THREADS children a block of four warps,
// `warps` of them (2 or 4) with rows for phase 2; obj may be OBJ_TSP with
// `coords` (C, 2) and `penalty`; float32 genes only).
// islands: the grid's second axis (1: a single population), every tensor
// but mparams, consts and coords with a leading island axis, one seed per
// island. gene_dtype: GENE_F32 or GENE_BF16, the type of gin and gout.
// ablate: 0, or a floor-harness case this unit holds (dispatch_expr_ablate).
extern "C" int expr_breed_launch(
    const void* gin, void* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const unsigned char* cross, const float* fill, const float* mut_u,
    const float* gauss, const float* xgene, const float* xrow, const long long* seed,
    const float* consts, const float* coords, int C, float penalty, int P, int Pp, int L, int K,
    int G, int mode, int S, int D, int q, int B, int sel_kind, int tk, float sel_param,
    int cross_kind, int mutate, int obj, int warps, int islands, int gene_dtype,
    unsigned ablate, int pipelined, void* stream) {
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q, B};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed, nullptr, fill};
  const ExprDraws ex{xgene, xrow};
  if ((gene_dtype != GENE_F32 && gene_dtype != GENE_BF16) || islands < 1 || islands > 65535 ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  if (pipelined) {
    if (cross_kind) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (gene_dtype == GENE_BF16)
      return expr_pipelined_launch<__nv_bfloat16>(gin, gout, sout, ranks, mparams, dr, ex,
                                                  consts, geo, sel, mutate, obj, islands, ablate,
                                                  st);
    return expr_pipelined_launch<float>(gin, gout, sout, ranks, mparams, dr, ex, consts, geo, sel,
                                        mutate, obj, islands, ablate, st);
  }
  if (cross_kind) {
    if (EXPR_CROSS || mode != MODE_RIFFLE || K % ORDER_THREADS || (obj == OBJ_TSP && C < 1) ||
        gene_dtype != GENE_F32)
      return (int)cudaErrorInvalidValue;
    // Blocks of four warps; `warps` of them (2 or 4: where their rows fit,
    // all) run phase 2. order_plan.cuh's layout with each such warp's child
    // and objective rows.
    if (warps != ORDER_THREADS / 32 && warps != 2 * ORDER_THREADS / 32)
      return (int)cudaErrorInvalidValue;
    const int Cs = obj == OBJ_TSP ? (C < L ? C : L) : 0;
    const OrderPlan plan =
        order_plan(K, L, Cs, false, (size_t)warps * (1 + EXPR_OBJ_ROWS) * L * 4);
    if (plan.smem > ORDER_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    // 16-byte copies and stores where every row is 16-byte aligned.
    const int vec = L % 4 == 0 && (uintptr_t)gin % 16 == 0 && (uintptr_t)gout % 16 == 0;
    return dispatch_expr_ablate<false>(ablate, [&](auto tag) {
      return launch_with_smem(expr_order_kernel<decltype(tag)::value>,
                              dim3(G * (K / ORDER_THREADS), islands), 2 * ORDER_THREADS, plan.smem,
                              (cudaStream_t)stream, static_cast<const float*>(gin),
                              static_cast<float*>(gout), sout, ranks, mparams, dr, ex, consts,
                              coords, C, penalty, geo, sel, mutate, obj, plan, vec, warps);
    });
  }
  if (warps < 1 || warps > THREADS / 32) return (int)cudaErrorInvalidValue;
  // row_of_rank, then each warp's child row and objective rows.
  const size_t smem = (size_t)K * sizeof(int) + (size_t)warps * (1 + EXPR_OBJ_ROWS) * L * 4;
  return dispatch_expr_ablate<false>(ablate, [&](auto tag) {
    constexpr unsigned A = decltype(tag)::value;
    if (gene_dtype == GENE_BF16) {
      using B = __nv_bfloat16;
      return launch_with_smem(expr_breed_kernel<B, A>, dim3(G, islands), warps * 32, smem,
                              (cudaStream_t)stream,
                              static_cast<const B*>(gin), static_cast<B*>(gout), sout, ranks,
                              mparams, dr, ex, consts, geo, sel, mutate, obj);
    }
    return launch_with_smem(expr_breed_kernel<float, A>, dim3(G, islands), warps * 32, smem,
                            (cudaStream_t)stream,
                            static_cast<const float*>(gin), static_cast<float*>(gout), sout,
                            ranks, mparams, dr, ex, consts, geo, sel, mutate, obj);
  });
}

// cross_kind 0: uniform crossover or the crossover hook; 1: order crossover
// (`fill` genes, D = 1, float32 genes only). draw_steps: the sub-generations
// each island's injected draws hold (their stride; unread in production
// mode). islands: the grid's second axis, as expr_breed_launch's.
// gene_dtype: GENE_F32 or GENE_BF16, the type of gin, gout and the work
// buffers. ablate: as expr_breed_launch's. cluster: the cluster schedule
// (uniform or expression crossover; the plan must hold the group; gin and
// gout 16-byte aligned; no work buffers, `warps` unread), else the one-block
// schedule (`warps` warps a block; order crossover: a block of MG_THREADS
// threads, whose warps that breed the walk's layout picks, `warps` unread).
extern "C" int expr_multigen_launch(
    const void* gin, const float* sin, void* gout, float* sout, void* work0, void* work1,
    int steps, float target, const float* mparams, const float* sel_u,
    const unsigned char* cross, const float* fill, const float* mut_u, const float* gauss,
    const long long* tie, const float* xgene, const float* xrow, const long long* seed,
    const float* consts, int P, int Pp, int L, int K, int G, int mode, int S, int D, int q,
    int sel_kind, int tk, float sel_param, int cross_kind, int mutate, int obj, int elitism,
    int warps, int draw_steps, int islands, int gene_dtype, unsigned ablate, int cluster,
    void* stream) {
  if (D < 1 || D > MG_MAX_D ||
      (!cluster && !cross_kind && (warps < 1 || warps > MG_THREADS / 32)) ||
      (cross_kind && (cluster || EXPR_CROSS || D != 1 || gene_dtype != GENE_F32)) ||
      (gene_dtype != GENE_F32 && gene_dtype != GENE_BF16) || islands < 1 || islands > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q, 1};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed, tie, fill};
  const ExprDraws ex{xgene, xrow};
  const cudaStream_t st = (cudaStream_t)stream;
  if (cluster && gene_dtype == GENE_BF16) {
    using B = __nv_bfloat16;
    const MultigenIO<B> io{static_cast<const B*>(gin), sin, static_cast<B*>(gout), sout,
                           nullptr, nullptr, steps, target};
    return expr_multigen_cluster_launch(io, mparams, dr, ex, consts, geo, sel, mutate, obj,
                                        elitism, draw_steps, islands, ablate, st);
  }
  if (cluster) {
    const MultigenIO<float> io{static_cast<const float*>(gin), sin, static_cast<float*>(gout),
                               sout, nullptr, nullptr, steps, target};
    return expr_multigen_cluster_launch(io, mparams, dr, ex, consts, geo, sel, mutate, obj,
                                        elitism, draw_steps, islands, ablate, st);
  }
  // The group's keys, scores, row_of_rank and alive flags, then each warp's
  // child row and objective rows; with order crossover the walk's layout
  // (mg_walk_plan), whose ring the rows share, in a block of MG_THREADS.
  const size_t warp_bytes = (size_t)(1 + EXPR_OBJ_ROWS) * L * sizeof(float);
  const MgOrderPlan walk = cross_kind ? mg_walk_plan(D * K, L, warp_bytes) : MgOrderPlan{};
  if (cross_kind && !walk.P) return (int)cudaErrorInvalidValue;
  const int threads = cross_kind ? MG_THREADS : warps * 32;
  const size_t smem = cross_kind ? walk.smem : mg_rows_bytes(D * K) + (size_t)warps * warp_bytes;
  return dispatch_expr_ablate<true>(ablate, [&](auto tag) {
    constexpr unsigned A = decltype(tag)::value;
    if (gene_dtype == GENE_BF16) {
      using B = __nv_bfloat16;
      const MultigenIO<B> io{static_cast<const B*>(gin), sin, static_cast<B*>(gout), sout,
                             static_cast<B*>(work0), static_cast<B*>(work1), steps, target};
      return launch_with_smem(expr_multigen_one_block<false, B, A>(), dim3(S, islands),
                              threads, smem, st, io, mparams, dr, ex, consts, geo, sel, mutate,
                              obj, elitism, draw_steps);
    }
    const MultigenIO<float> io{static_cast<const float*>(gin), sin, static_cast<float*>(gout),
                               sout, static_cast<float*>(work0), static_cast<float*>(work1),
                               steps, target};
    return cross_kind
               ? launch_with_smem(expr_multigen_one_block<true, float, A>(), dim3(S, islands),
                                  threads, smem, st, io, mparams, dr, ex, consts, geo, sel,
                                  mutate, obj, elitism, draw_steps)
               : launch_with_smem(expr_multigen_one_block<false, float, A>(), dim3(S, islands),
                                  threads, smem, st, io, mparams, dr, ex, consts, geo, sel,
                                  mutate, obj, elitism, draw_steps);
  });
}

// expr_multigen_kernel<true>'s walk at a group of K rows of L genes (D = 1,
// order_plan.cuh's mg_order_plan with these hooks' warp rows): out =
// (children a pass, warps that breed, dynamic shared bytes). Returns the
// children a pass (0: no layout holds, and the launcher refuses the shape).
extern "C" int expr_multigen_order_plan(int K, int L, long long* out) {
  const MgOrderPlan p = mg_walk_plan(K, L, (size_t)(1 + EXPR_OBJ_ROWS) * L * sizeof(float));
  out[0] = p.P;
  out[1] = p.warps;
  out[2] = (long long)p.smem;
  return p.P;
}

extern "C" const char* expr_breed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
