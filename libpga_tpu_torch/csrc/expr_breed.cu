// expr_breed.cu: the deme breed with expression hooks (B6), a template, in
// three kernels: expr_breed_kernel (one generation), expr_order_kernel (its
// order-crossover case) and, at the end of this file, expr_multigen_kernel
// (up to T generations per launch, B6 x B4, uniform or order crossover); one
// build of a hook set serves all three: the crossover kind is a runtime
// argument. ops/expr_cuda.py writes the hooks (expr_crossover,
// expr_mutate, expr_objective) and the macros EXPR_CROSS, EXPR_MUT,
// EXPR_OBJ, EXPR_OBJ_ROWS, EXPR_GENE_STREAMS and EXPR_ROW_STREAMS in front
// of this text; ops/kernels.py compiles the whole with nvcc (-I csrc,
// --fmad=false, no fast math), keyed by a hash of it. This file alone does
// not compile.
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
// Each warp breeds one child into its row of shared memory (swap mutation
// exchanges two genes there), writes it to its physical row with coalesced
// stores, then scores it from that row; expr_objective may use EXPR_OBJ_ROWS
// more rows of L floats per warp for values that roll() reads. Pad children
// (row >= P) score -inf.
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
// far below the card's rate. The design is deme_breed_kernel's: one block
// per deme, one warp per child, lanes over genes; the shared row adds a
// store and two loads per gene. Blocks run 8 warps, fewer where the
// per-warp rows would not fit in 227 KB of shared memory (the wrapper picks
// the count).
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

#include "breed_core.cuh"

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
// t, for the planes the hooks read (EXPR_GENE_STREAMS), else 0.
__device__ __forceinline__ void gene_draws(
    const BreedCtx& cx, const ExprDraws& ex, int k, int g, uint32_t t, int tile, int lane,
    size_t child, float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int m = 0; m < 4; ++m) v[j][m] = 0.0f;
    if (!((EXPR_GENE_STREAMS >> j) & 1)) continue;
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
// hook).
template <bool LDG, bool ORDER = false, class Gene = float>
__device__ __forceinline__ void expr_child(
    const BreedCtx& cx, const Draws& dr, const ExprDraws& ex, const Gene* p1, const Gene* p2,
    float* grow, const ChildRand& r, int k, int g, uint32_t t, int lane, size_t child,
    const float* __restrict__ cb) {
  const int L = cx.L;
  (void)cb;
  float xq[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // crossover q, q2, mutation q, q2
  if (EXPR_ROW_STREAMS) {
    if (cx.philox_mode) {
      const uint4 w = philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_EXPR_ROW, t));
      xq[0] = to_uniform(w.x);
      xq[1] = to_uniform(w.y);
      xq[2] = to_uniform(w.z);
      xq[3] = to_uniform(w.w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((EXPR_ROW_STREAMS >> j) & 1) xq[j] = ex.row[child * 4 + j];
    }
  }
  // Builtin point / swap mutation: gene pos takes mu2 when mu1 < rate;
  // genes pos, pj exchange when mu2 < rate.
  const int pos = (int)floorf(r.mu0 * (float)L);
  const int pj = (int)floorf(r.mu1 * (float)L);
  const bool fire = !EXPR_MUT && (cx.mutate == MUT_SWAP ? r.mu2 < cx.rate : r.mu1 < cx.rate);

  // Tile i: genes 128*i + lane + 32*m, m < 4; bit m of `bits` is the
  // uniform crossover's bit of gene m (set: parent 2).
  auto tile = [&](int i, uint32_t bits) {
    float gd[4][4];
    gene_draws(cx, ex, k, g, t, i, lane, child, gd);
    (void)bits;
    float c[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int l = 128 * i + lane + 32 * m;
      c[m] = 0.0f;
      if (l < L) {
#if EXPR_CROSS
        c[m] = expr_crossover(load_gene<LDG>(p1 + l), load_gene<LDG>(p2 + l), gd[0][m],
                              gd[1][m], xq[0], xq[1], l, L, cb);
#else
        c[m] = load_gene<LDG>((((bits >> m) & 1u) ? p2 : p1) + l);
#endif
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int l = 128 * i + lane + 32 * m;
      if (l >= L) continue;
      float x = c[m];
#if EXPR_MUT
      x = expr_mutate(x, gd[2][m], gd[3][m], xq[2], xq[3], l, L, cx.rate, cx.sigma, cb);
#else
      if (cx.mutate == MUT_POINT) {
        if (fire && l == pos) x = r.mu2;
      } else if (cx.mutate == MUT_GAUSSIAN) {
        x = gauss_mutate(cx, dr, x, k, g, t, l, child, true);
      }
#endif
      grow[l] = round_gene<Gene>(x);
    }
  };

#if EXPR_CROSS
  for (int i = 0; i < cx.ntiles; ++i) tile(i, 0u);
#else
  if constexpr (ORDER) {
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
#endif
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

template <class Gene>
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
  if (EXPR_CROSS) cx.ncalls = 2;  // selection and mutation: no crossover bits
  const bool scored = EXPR_OBJ || obj != OBJ_NONE;

  for (int k = warp; k < K; k += nwarps) {
    const size_t child = (size_t)g * K + k;
    const ChildRand r = child_rand(cx, dr, k, g, 0u, lane, child);
    const int r1 = winner_rank(winner_fraction(sel, r.su0), V);
    const int r2 = winner_rank(winner_fraction(sel, r.su1), V);
    const int s1 = min(max(row_of_rank[r1], 0), K - 1);
    const int s2 = min(max(row_of_rank[r2], 0), K - 1);
    const Gene* p1 = gin + (size_t)read_row(geo, g, s1) * L;
    const Gene* p2 = gin + (size_t)read_row(geo, g, s2) * L;
    const int orow = write_row(geo, g, k);
    expr_child<true>(cx, dr, ex, p1, p2, grow, r, k, g, 0u, lane, child, cb);
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
// (breed_core.cuh's order_walk, fallback genes from stream 0x20000000 + l/4
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
// every thread walks its child straight into the child's physical row (its
// visited bitmask [word][child] in shared memory); a block barrier; then each
// of the two warps takes its children in turn, reads the walked row back with
// plain loads into its shared row, mutates it there (swap exchanges two genes
// there), writes it back with coalesced stores and scores it from the shared
// row; for OBJ_TSP a second barrier and each thread scores its own child from
// the row (tsp_walk_score, the coordinates staged as float2). Shared memory:
// row_of_rank, the bitmasks, the coordinates and each warp's child and
// objective rows.
//
// Bound. Bytes: the population read once and written once plus the scores,
// (2*Pp*L + 2*Pp)*4 (0.0313 ms at 65,536x200, 0.0196 ms at 8,192x1,000 at 3.35
// TB/s). Operations: a few per gene for the walk and the hooks, far below the
// card's rate. As in order_breed_kernel, each thread's walk (and the TSP
// score's) is a chain of L dependent steps through shared memory, and the
// walked row makes a second round trip through L2: the chain, not the bytes,
// is expected to set the time.

__global__ void __launch_bounds__(ORDER_THREADS) expr_order_kernel(
    const float* __restrict__ gin, float* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr0, ExprDraws ex0,
    const float* __restrict__ cb, const float* __restrict__ coords, int C, float penalty,
    Geometry geo, Selection sel, int mutate, int obj) {
  extern __shared__ int smem[];
  const int K = geo.K, L = geo.L, G = geo.G, tid = threadIdx.x;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, (size_t)G * K);
  const Draws dr = island_draws(dr0, geo, 1);
  const ExprDraws ex = island_expr_draws(ex0, geo, 1);
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = (L + 31) / 32;
  const int per_deme = K / ORDER_THREADS;
  const int g = blockIdx.x / per_deme, first = (blockIdx.x % per_deme) * ORDER_THREADS;
  const int Cs = obj == OBJ_TSP ? min(C, L) : 0;
  int* row_of_rank = smem;                                          // K
  unsigned* vis = reinterpret_cast<unsigned*>(smem + K) + tid;      // [nw][ORDER_THREADS]
  float2* xy = reinterpret_cast<float2*>(smem + K + nw * ORDER_THREADS);  // Cs
  float* grow = reinterpret_cast<float*>(xy + Cs) + (size_t)warp * (1 + EXPR_OBJ_ROWS) * L;
  float* erows = grow + L;

  for (int i = tid; i < K; i += ORDER_THREADS) {
    const int r = ranks[(size_t)g * K + i];
    if (r >= 0 && r < K) row_of_rank[r] = i;
  }
  for (int i = tid; i < Cs; i += ORDER_THREADS)
    xy[i] = make_float2(coords[2 * i], coords[2 * i + 1]);
  __syncthreads();

  const float V = (float)max(min(K, geo.P - g * K), 1);
  BreedCtx cx = breed_ctx(dr, mparams, geo, mutate, obj);
  cx.ncalls = 2;  // selection and mutation: no crossover bits

  // Phase 1: this thread walks child `first + tid` into its physical row.
  {
    const int k = first + tid;
    const size_t child = (size_t)g * K + k;
    float su0, su1;
    if (cx.philox_mode) {
      const uint4 w = philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_SEL, 0u));
      su0 = to_uniform(w.x);
      su1 = to_uniform(w.y);
    } else {
      su0 = dr.sel_u[child * 2];
      su1 = dr.sel_u[child * 2 + 1];
    }
    const int s1 = min(max(row_of_rank[winner_rank(winner_fraction(sel, su0), V)], 0), K - 1);
    const int s2 = min(max(row_of_rank[winner_rank(winner_fraction(sel, su1), V)], 0), K - 1);
    const FillSource fill{cx.philox_mode, cx.k0, cx.k1, k, g, 0u,
                          cx.philox_mode ? nullptr : dr.fill + child * L};
    order_walk<true>(gin + ((size_t)g * K + s1) * L, gin + ((size_t)g * K + s2) * L,
                     gout + ((size_t)k * G + g) * L, L, vis, ORDER_THREADS, fill,
                     [](int, float x) { return x; });
  }
  __syncthreads();

  // Phase 2: one warp per child: mutation, write-back, score.
  const bool warp_scored = EXPR_OBJ || (obj != OBJ_NONE && obj != OBJ_TSP);
  for (int j = warp; j < ORDER_THREADS; j += ORDER_THREADS / 32) {
    const int k = first + j, orow = k * G + g;
    const size_t child = (size_t)g * K + k;
    float* out = gout + (size_t)orow * L;
    const ChildRand r = child_rand(cx, dr, k, g, 0u, lane, child);
    expr_child<false, true>(cx, dr, ex, out, out, grow, r, k, g, 0u, lane, child, cb);
    for (int l = lane; l < L; l += 32) out[l] = grow[l];
    if (warp_scored) {
      const float score = expr_score(grow, erows, obj, L, lane, cb);
      if (lane == 0) sout[orow] = orow < geo.P ? score : -INFINITY;
    }
    __syncwarp();  // the next child overwrites this warp's rows
  }

  // Phase 3 (OBJ_TSP): this thread scores its child from its row.
  if (obj == OBJ_TSP) {
    __syncthreads();
    const int orow = (first + tid) * G + g;
    const float score = tsp_walk_score(gout + (size_t)orow * L, L, vis, ORDER_THREADS, xy, C,
                                       penalty);
    sout[orow] = orow < geo.P ? score : -INFINITY;
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
// Design. Parents are read with plain loads (see expr_child). Shared memory
// holds the group's keys, scores, row_of_rank and alive flags (17 bytes per
// row) and, after them, each warp's child row and EXPR_OBJ_ROWS objective
// rows of L floats; the wrapper picks the warp count (up to 32) that fits in
// 227 KB. Blocks are of up to 1,024 threads, as the builtin kernel's.
//
// Order crossover (expr_multigen_kernel<true>, _multigen_kernel's
// order_refs, :1548): multigen_group<true> walks every child of the group
// (one thread per child, the visited bitmasks after the group's arrays) into
// its row before the warps run; each warp then reads its walked child into
// its shared row (expr_child<false, true>), mutates and scores it there. An
// elite child is its rank-k parent verbatim. D is 1 and the row map the
// riffle, as in JAX. Bound: the bytes above; but the walk is a chain of L
// dependent steps per sub-generation on 256 of the block's threads at K =
// 256, which is expected to set the time (65,536x200: 256 blocks on 132 SMs).

template <bool ORDER, class Gene>
__global__ void __launch_bounds__(MG_THREADS) expr_multigen_kernel(
    MultigenIO<Gene> io, const float* __restrict__ mparams, Draws dr0, ExprDraws ex0,
    const float* __restrict__ cb, Geometry geo, Selection sel, int mutate, int obj,
    int elitism, int draw_steps) {
  extern __shared__ long long mg_smem[];
  io = island_io(io, geo);
  dr0 = island_draws(dr0, geo, draw_steps);
  ex0 = island_expr_draws(ex0, geo, draw_steps);
  const int L = geo.L, W = geo.D * geo.K, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t fixed = mg_rows_bytes(W) + (ORDER ? mg_walk_bytes(W, L, blockDim.x) : 0);
  float* grow = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(mg_smem) + fixed) +
                (size_t)warp * (1 + EXPR_OBJ_ROWS) * L;
  float* erows = grow + L;
  BreedCtx cx = breed_ctx(dr0, mparams, geo, mutate, obj);
  if (EXPR_CROSS || ORDER) cx.ncalls = 2;  // selection and mutation: no crossover bits
  const size_t GK = (size_t)geo.G * geo.K;
  auto breed_child = [&](const Draws& dr, uint32_t t, int g, int k, size_t child,
                         const Gene* p1, const Gene* p2, Gene* out, const ChildRand& r,
                         bool elite) {
    if (elite) {
      for (int l = lane; l < L; l += 32) grow[l] = load_gene<false>(p1 + l);
      __syncwarp();
    } else {
      ExprDraws ex = ex0;
      if (!cx.philox_mode) {
        if (ex.gene) ex.gene += (size_t)t * 4 * cx.plane;
        if (ex.row) ex.row += (size_t)t * GK * 4;
      }
      expr_child<false, ORDER>(cx, dr, ex, p1, p2, grow, r, k, g, t, lane, child, cb);
    }
    for (int l = lane; l < L; l += 32) store_gene(out + l, grow[l]);
    const float score = expr_score(grow, erows, obj, L, lane, cb);
    __syncwarp();  // the next child overwrites this warp's rows
    return score;
  };
  multigen_group<ORDER>(io, geo, cx, dr0, sel, elitism, mg_smem, breed_child);
}

}  // namespace

// cross_kind 0: expr_breed_kernel (uniform crossover or the crossover
// hook; `warps` warps per block); 1: expr_order_kernel (order crossover,
// riffle only, `fill` genes, ORDER_THREADS threads per block; obj may be
// OBJ_TSP with `coords` (C, 2) and `penalty`; float32 genes only).
// islands: the grid's second axis (1: a single population), every tensor
// but mparams, consts and coords with a leading island axis, one seed per
// island. gene_dtype: GENE_F32 or GENE_BF16, the type of gin and gout.
extern "C" int expr_breed_launch(
    const void* gin, void* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const unsigned char* cross, const float* fill, const float* mut_u,
    const float* gauss, const float* xgene, const float* xrow, const long long* seed,
    const float* consts, const float* coords, int C, float penalty, int P, int Pp, int L, int K,
    int G, int mode, int S, int D, int q, int sel_kind, int tk, float sel_param, int cross_kind,
    int mutate, int obj, int warps, int islands, int gene_dtype, void* stream) {
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed, nullptr, fill};
  const ExprDraws ex{xgene, xrow};
  if ((gene_dtype != GENE_F32 && gene_dtype != GENE_BF16) || islands < 1 || islands > 65535)
    return (int)cudaErrorInvalidValue;
  if (cross_kind) {
    if (EXPR_CROSS || mode != MODE_RIFFLE || K % ORDER_THREADS || (obj == OBJ_TSP && C < 1) ||
        gene_dtype != GENE_F32)
      return (int)cudaErrorInvalidValue;
    // row_of_rank, the bitmasks, the coordinates, each warp's rows.
    const int nw = (L + 31) / 32, Cs = obj == OBJ_TSP ? (C < L ? C : L) : 0;
    const size_t smem = (size_t)(K + nw * ORDER_THREADS) * 4 + (size_t)Cs * 8 +
                        (size_t)(ORDER_THREADS / 32) * (1 + EXPR_OBJ_ROWS) * L * 4;
    return launch_with_smem(expr_order_kernel, dim3(G * (K / ORDER_THREADS), islands),
                            ORDER_THREADS, smem,
                            (cudaStream_t)stream, static_cast<const float*>(gin),
                            static_cast<float*>(gout), sout, ranks, mparams, dr, ex, consts,
                            coords, C, penalty, geo, sel, mutate, obj);
  }
  if (warps < 1 || warps > THREADS / 32) return (int)cudaErrorInvalidValue;
  // row_of_rank, then each warp's child row and objective rows.
  const size_t smem = (size_t)K * sizeof(int) + (size_t)warps * (1 + EXPR_OBJ_ROWS) * L * 4;
  if (gene_dtype == GENE_BF16) {
    using B = __nv_bfloat16;
    return launch_with_smem(expr_breed_kernel<B>, dim3(G, islands), warps * 32, smem,
                            (cudaStream_t)stream,
                            static_cast<const B*>(gin), static_cast<B*>(gout), sout, ranks,
                            mparams, dr, ex, consts, geo, sel, mutate, obj);
  }
  return launch_with_smem(expr_breed_kernel<float>, dim3(G, islands), warps * 32, smem,
                          (cudaStream_t)stream,
                          static_cast<const float*>(gin), static_cast<float*>(gout), sout, ranks,
                          mparams, dr, ex, consts, geo, sel, mutate, obj);
}

// cross_kind 0: uniform crossover or the crossover hook; 1: order crossover
// (`fill` genes, D = 1, float32 genes only). draw_steps: the sub-generations
// each island's injected draws hold (their stride; unread in production
// mode). islands: the grid's second axis, as expr_breed_launch's.
// gene_dtype: GENE_F32 or GENE_BF16, the type of gin, gout and the work
// buffers.
extern "C" int expr_multigen_launch(
    const void* gin, const float* sin, void* gout, float* sout, void* work0, void* work1,
    int steps, float target, const float* mparams, const float* sel_u,
    const unsigned char* cross, const float* fill, const float* mut_u, const float* gauss,
    const long long* tie, const float* xgene, const float* xrow, const long long* seed,
    const float* consts, int P, int Pp, int L, int K, int G, int mode, int S, int D, int q,
    int sel_kind, int tk, float sel_param, int cross_kind, int mutate, int obj, int elitism,
    int warps, int draw_steps, int islands, int gene_dtype, void* stream) {
  if (D < 1 || D > MG_MAX_D || warps < 1 || warps > MG_THREADS / 32 ||
      (cross_kind && (EXPR_CROSS || D != 1 || gene_dtype != GENE_F32)) ||
      (gene_dtype != GENE_F32 && gene_dtype != GENE_BF16) || islands < 1 || islands > 65535)
    return (int)cudaErrorInvalidValue;
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed, tie, fill};
  const ExprDraws ex{xgene, xrow};
  // The group's keys, scores, row_of_rank and alive flags, (order) the
  // walkers' bitmasks, then each warp's child row and objective rows.
  const int threads = warps * 32;
  const size_t smem = mg_rows_bytes(D * K) +
                      (cross_kind ? mg_walk_bytes(D * K, L, threads) : 0) +
                      (size_t)warps * (1 + EXPR_OBJ_ROWS) * L * sizeof(float);
  if (gene_dtype == GENE_BF16) {
    using B = __nv_bfloat16;
    const MultigenIO<B> io{static_cast<const B*>(gin), sin, static_cast<B*>(gout), sout,
                           static_cast<B*>(work0), static_cast<B*>(work1), steps, target};
    return launch_with_smem(expr_multigen_kernel<false, B>, dim3(S, islands), threads, smem,
                            (cudaStream_t)stream, io, mparams, dr, ex, consts, geo, sel, mutate,
                            obj, elitism, draw_steps);
  }
  const MultigenIO<float> io{static_cast<const float*>(gin), sin, static_cast<float*>(gout),
                             sout, static_cast<float*>(work0), static_cast<float*>(work1),
                             steps, target};
  return cross_kind
             ? launch_with_smem(expr_multigen_kernel<true, float>, dim3(S, islands), threads,
                                smem, (cudaStream_t)stream, io, mparams, dr, ex, consts, geo,
                                sel, mutate, obj, elitism, draw_steps)
             : launch_with_smem(expr_multigen_kernel<false, float>, dim3(S, islands), threads,
                                smem, (cudaStream_t)stream, io, mparams, dr, ex, consts, geo,
                                sel, mutate, obj, elitism, draw_steps);
}

extern "C" const char* expr_breed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
