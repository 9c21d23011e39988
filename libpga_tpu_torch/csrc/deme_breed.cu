// deme_breed.cu: the fused deme breed on Hopper, in three kernels:
// deme_breed_kernel (one generation, uniform crossover), order_breed_kernel
// (one generation, order crossover and the fused TSP score) and, at the end
// of this file, multigen_breed_kernel (up to T generations per launch with
// the ranks computed inside the kernel; uniform or order crossover).
//
// deme_breed_kernel replaces, in libpga_tpu/ops/pallas_step.py:
//   _pp_breed_kernel (ping-pong row maps, parity 0 and 1),
//   _breed_kernel    (riffle row map; its fused-builtin, uniform-crossover case),
//   _deme_child      (the breeding core both share).
// The plain PyTorch version of both kernels is libpga_tpu_torch/ops/
// fused_step.py::deme_breed_reference; each computes exactly that function.
//
// What it computes. Block g breeds deme g's K children. Selection is in
// rank space: the ranks (computed outside, as in JAX) are inverted into
// row_of_rank[] in shared memory, so a winner rank is a direct gather
// (JAX gathers with a bf16 hi/lo one-hot matmul, accurate to ~1e-5; the
// gather here is exact). Then uniform crossover, point / gaussian / swap
// mutation, and for a rowwise-fused objective (onemax, onemax_bits, sphere,
// rastrigin, ackley) the child's score. Each child is written to the
// physical row its row map names:
//   mode 0/1 ping-pong parity 0/1: child chunk u of deme d of a group
//            lands at group chunk u*D + d (pingpong_child_rows);
//   mode 2   riffle: child k of deme g lands at row k*G + g.
// A deme's valid count V is the number of its read rows below P (the
// ping-pong alive-mask sum; the riffle's positional count). Pad rows
// rank last, so a rank < V never selects one; pad children score -inf.
//
// Randomness. Production mode: Philox4x32-10, key = the launch seed (one
// int64 on the card, drawn from the engine's torch.Generator), counter =
// (child k, deme g, stream, sub-generation: 0 in the one-generation
// kernels); stream 0 = selection, 1 = mutation, 2+t = crossover bits of
// genes [128t, 128t+128), 0x20000000+t = the order walk's fallback genes
// 4t..4t+3, 0x40000000+l = gaussian draws of gene l, 0x60000000 = the rank
// tie word of row k (multigen only); the expression breed (expr_breed.cu)
// adds 0x70000000 + (j << 22) + t = per-gene plane j of genes 4t..4t+3 and
// 0x71000000 = the per-row words (breed_core.cuh lists them). Uniforms are
// (bits >> 8) * 2^-24. Injected mode reads the draw tensors the plain
// version consumes (seed == nullptr).
//
// Bound. Memory: a generation must read the population once and write
// it once, P*L*4 bytes each way: 0.84 GB at 1,048,576x100, >= 0.25 ms at
// the H100's 3.35 TB/s; 32 MB at 40,000x100, >= 9.6 us, where launch
// overhead dominates. The arithmetic (a few operations per gene plus a
// Philox call per 128 genes) is far below the card's rate. Design for the
// bound: one warp per child with lanes over genes, so every parent read
// and child write is a coalesced 128-byte line; parents are read from
// device memory once per selection (a deme's rows are ~200 KB and mostly
// stay in the 50 MB L2); children go to the other ping-pong buffer, so no
// block reads a row another block writes. Philox calls of one child are
// spread over the warp's lanes and their words shuffled to the lanes that
// need them. Reaching the bound (TMA, persistent blocks, a CUDA graph
// around the run loop) is later work; several generations per launch is
// multigen_breed_kernel below.
//
// Islands. Every kernel of this file also breeds I equal populations in one
// launch, the islands of PGA.run_islands: the grid gains a second axis,
// blockIdx.y = the island, and a block offsets every pointer by its island
// (genomes and work buffers by island*Pp*L, scores by island*Pp, ranks by
// island*G*K, injected draws by their leading island axis) and keys Philox
// with seed[island] (breed_core.cuh: island_slice, island_draws, island_io).
// This replaces the TPU's island path, which vmaps the kernel over the
// islands (libpga_tpu/parallel/islands.py: make_stacked_pallas_epoch, :110,
// and make_multigen_stacked_epoch, :192): a generation of 8 islands of
// 131,072x100 is one launch of 2,048 deme blocks, as a 1,048,576-row
// population is, against the same byte bound (0.25 ms). One island (grid
// height 1) is the single-population launch, bit for bit, and an island
// launch equals a single launch per island with that island's seed.
//
// bfloat16 genomes. deme_breed_kernel and multigen_breed_kernel<false> are
// templates over the gene type (float or __nv_bfloat16), and the launchers
// take gene_dtype (0 float32, 1 bfloat16); this replaces the three breed
// pallas_calls at gene_dtype=bfloat16 (pallas_step.py:2257, :2526, :2872).
// A bf16 kernel loads bf16 parents as float (exact: JAX's 0/1 one-hot
// matmul of bf16 genes is exact too, :595-599), breeds the child in float
// as the float32 kernel does, and rounds each child gene once to bf16
// (round_gene, __float2bfloat16_rn) before it stores and scores it, as JAX
// writes child.astype(bfloat16) (:1114, :1284, :1361, :1590, :1663) and
// scores the stored genes (:1120-1125, :1373, :1667). So a bf16 child is
// the float32 kernel's child on the same (widened) parents, rounded; the
// multigen kernel's sub-generation t + 1 reads step t's rounded rows from
// bf16 work buffers. Draws, draw counts and Philox streams are the float
// kernel's. Bound: 2-byte genes halve the bytes, 2*Pp*L*2 + 8*Pp (0.128 ms
// at 1,048,576x100); the loads stay one scalar per lane and gene (wider
// loads are later work). Order crossover stays float32 only, as in JAX
// (:1758): order_breed_kernel and multigen_breed_kernel<true> have no bf16
// case, and the launchers refuse one.
//
// Built with --fmad=false so the float32 selection arithmetic is not
// contracted into multiply-adds and rounds as the torch version does. The
// row maps, selection, Philox and the draws shared with expr_breed.cu are in
// breed_core.cuh.

#include "breed_core.cuh"

namespace {

// One warp crosses parents p1 and p2 into `out`, mutates (unless
// !may_mutate: an elite copy), rounds each gene to the gene type and sums the
// objective's terms of the child as written: each lane adds its genes l =
// lane, lane+32, ... in that order, then the lanes combine through the
// warp_sum butterfly; the plain version
// (fused_step.rowwise_scores(warp_order=True)) sums in the same order.
// Returns the sums in `a` and `b` on every lane. ORDER: the child was walked
// already (p1 == p2 == out, or an elite's parent): no crossover bits are
// drawn, every gene is p1's.
template <bool LDG, bool ORDER = false, class Gene = float>
__device__ __forceinline__ void breed_genes(
    const BreedCtx& cx, const Draws& dr, const Gene* p1, const Gene* p2, Gene* out,
    ChildRand r, int k, int g, uint32_t t, int lane, size_t child, bool may_mutate,
    float& a, float& b) {
  const int L = cx.L, mutate = cx.mutate, obj = cx.obj;
  // point: gene pos takes mu2 when mu1 < rate; swap: genes pos, pj
  // exchange when mu2 < rate.
  const int pos = (int)floorf(r.mu0 * (float)L);
  const int pj = (int)floorf(r.mu1 * (float)L);
  const bool fire = may_mutate && (mutate == MUT_SWAP ? r.mu2 < cx.rate : r.mu1 < cx.rate);
  a = 0.0f;
  b = 0.0f;

  // Mutates gene l of the crossed child, rounds it to the gene type, writes
  // it and adds its terms.
  auto finish = [&](int l, float c) {
    if (mutate == MUT_POINT) {
      if (fire && l == pos) c = r.mu2;
    } else if (mutate == MUT_GAUSSIAN) {
      c = gauss_mutate(cx, dr, c, k, g, t, l, child, may_mutate);
    }
    c = round_gene<Gene>(c);
    store_gene(out + l, c);
    obj_add(obj, c, a, b);
  };
  // A tile is 128 genes, four per lane. The lane fetches its four parent
  // genes (bit set: parent 2) before it writes any, so the loads are in
  // flight together, and finishes them in l order.
  auto tile = [&](int base, uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
    const int l0 = base + lane, l1 = l0 + 32, l2 = l0 + 64, l3 = l0 + 96;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    if (l0 < L) c0 = load_gene<LDG>((b0 ? p2 : p1) + l0);
    if (l1 < L) c1 = load_gene<LDG>((b1 ? p2 : p1) + l1);
    if (l2 < L) c2 = load_gene<LDG>((b2 ? p2 : p1) + l2);
    if (l3 < L) c3 = load_gene<LDG>((b3 ? p2 : p1) + l3);
    if (l0 < L) finish(l0, c0);
    if (l1 < L) finish(l1, c1);
    if (l2 < L) finish(l2, c2);
    if (l3 < L) finish(l3, c3);
  };

  if constexpr (ORDER) {
    for (int base = 0; base < L; base += 128) tile(base, 0u, 0u, 0u, 0u);
  } else if (cx.philox_mode) {
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
        const uint32_t b0 = __shfl_sync(FULL, w.x, src);
        const uint32_t b1 = __shfl_sync(FULL, w.y, src);
        const uint32_t b2 = __shfl_sync(FULL, w.z, src);
        const uint32_t b3 = __shfl_sync(FULL, w.w, src);
        tile(128 * i, (b0 >> lane) & 1u, (b1 >> lane) & 1u, (b2 >> lane) & 1u,
             (b3 >> lane) & 1u);
      }
    }
  } else {
    const uint8_t* bits = dr.cross + child * L;
    for (int base = 0; base < L; base += 128) {
      const int l0 = base + lane;
      tile(base, l0 < L ? bits[l0] : 0u, l0 + 32 < L ? bits[l0 + 32] : 0u,
           l0 + 64 < L ? bits[l0 + 64] : 0u, l0 + 96 < L ? bits[l0 + 96] : 0u);
    }
  }

  if (mutate == MUT_SWAP && fire && pos < L && pj < L) {
    __syncwarp();
    if (lane == 0) {
      const Gene x = out[pos], y = out[pj];
      out[pos] = y;
      out[pj] = x;
    }
    __syncwarp();
    if (obj != OBJ_NONE) {
      // The score is of the child as written: sum again after the swap.
      a = 0.0f;
      b = 0.0f;
      for (int l = lane; l < L; l += 32) obj_add(obj, load_gene<false>(out + l), a, b);
    }
  }
  if (obj != OBJ_NONE) {
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

template <class Gene>
__global__ void __launch_bounds__(THREADS) deme_breed_kernel(
    const Gene* __restrict__ gin, Gene* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr0,
    Geometry geo, Selection sel, int mutate, int obj) {
  extern __shared__ int row_of_rank[];
  __shared__ int s_valid;
  const int g = blockIdx.x, K = geo.K, L = geo.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, (size_t)geo.G * K);
  const Draws dr = island_draws(dr0, geo, 1);
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
  const BreedCtx cx = breed_ctx(dr, mparams, geo, mutate, obj);

  for (int k = warp; k < K; k += blockDim.x >> 5) {
    const size_t child = (size_t)g * K + k;
    const ChildRand r = child_rand(cx, dr, k, g, 0u, lane, child);
    const int r1 = winner_rank(winner_fraction(sel, r.su0), V);
    const int r2 = winner_rank(winner_fraction(sel, r.su1), V);
    const int s1 = min(max(row_of_rank[r1], 0), K - 1);
    const int s2 = min(max(row_of_rank[r2], 0), K - 1);
    const Gene* p1 = gin + (size_t)read_row(geo, g, s1) * L;
    const Gene* p2 = gin + (size_t)read_row(geo, g, s2) * L;
    const int orow = write_row(geo, g, k);
    float a, b;
    breed_genes<true>(cx, dr, p1, p2, gout + (size_t)orow * L, r, k, g, 0u, lane, child,
                      true, a, b);
    if (obj != OBJ_NONE && lane == 0)
      sout[orow] = orow < geo.P ? obj_finish(obj, a, b, L) : -INFINITY;
  }
}


// ---------------------------------------------------------------------------
// order_breed_kernel: the TSP path's generation (B5).
//
// Replaces, in libpga_tpu/ops/pallas_step.py, _breed_kernel's order-crossover
// case: the order branch of _deme_child (:653-732; scratch _order_scratch_shapes,
// :403), its point / gaussian / swap mutation (:764-813), and the gene-major
// fused TSP scorer _tsp_eval_gene_major (:819-943), or a rowwise-fused
// objective. Riffle row map only (order crossover pins D = 1 and is
// riffle-only in JAX): cohort slot k of deme g is row g*K + k, child k lands
// at row k*G + g.
//
// What it computes, per child: rank-space selection of two parents (as
// deme_breed_kernel), then the order walk: for l = 0..L-1 decode both
// parents' cities, c = clamp(floor(g * L), 0, L-1) in float32; take p1's gene
// if its city is unvisited, else p2's if that city is unvisited, else the
// fallback draw. A city is marked only when a parent's gene was taken (JAX
// never marks the fallback; fallback duplicates are what the penalty selects
// against). Point and gaussian mutation apply per gene as the walk writes it;
// swap mutation exchanges genes pi = floor(u0*L) and pj = floor(u1*L) after
// the walk (no clamp: u < 1). Then, for OBJ_TSP, a second walk over the child
// scores -(open-path length + penalty * (L - distinct cities)), each edge
// sqrtf(dx*dx + dy*dy + 1e-12f), summed in l order with the coordinate lookup
// clamped to C-1; the rowwise-fused objectives (onemax, onemax_bits, sphere,
// rastrigin, ackley) sum the child's terms in l order.
//
// Design. The TPU kernel walks gene-major with sublane bitmask reductions
// (Mosaic has no per-lane control flow) and gathers coordinates with a bf16
// hi/lo one-hot matmul (the MXU cannot gather; ~1e-3 accurate). Here the walk
// is one thread's sequential loop: one thread per child, ORDER_THREADS
// children of one deme per block (so a G = 32 population still fills ~128
// SMs), the deme's row_of_rank[K] rebuilt by each of its blocks. Each child's
// visited-city bitmask is ceil(L/32) words in shared memory laid out
// [word][child], so a warp's lanes hit distinct banks; the coordinates (the
// first min(C, L) cities, the only ones a decode in [0, L) reaches) are staged
// in shared memory as float2 and gathered exactly. The walk (order_walk) and
// the score (tsp_walk_score) are breed_core.cuh's, which the expression and
// multi-generation kernels' order cases share. Parent reads and child
// writes are per-thread strided (each lane its own row): the lines of a row
// are reused from L1 over 32 steps, and at 8,192x1,000 the 32.8 MB population
// stays in the 50 MB L2. Coalescing them through shared-memory tiles is later
// work.
//
// Bound. Bytes: the population read once and written once, 2*Pp*L*4 bytes
// (65.5 MB at 8,192x1,000, >= 19.6 us at 3.35 TB/s). Operations: a few integer
// operations per gene plus a sqrtf per edge, far below the card's rate. But
// each thread's walk is a dependent chain of L steps through its bitmask
// (shared-memory load, test, store), and a second chain of L steps scores the
// child: at 1,000 cities that chain, not the bytes, is expected to set the time.
//
// Randomness. Production mode: Philox4x32-10 keyed by the launch seed, counter
// (k, g, stream, 0): stream 0 = selection, 1 = mutation, 0x20000000 + l/4 =
// fallback gene l (word l % 4; drawn only where the fallback is taken),
// 0x40000000 + l = gaussian draws of gene l. Injected mode reads sel_u, fill,
// mut_u and gauss. --fmad=false and IEEE sqrtf (no fast math) keep the
// selection and the tour arithmetic rounding as torch does.

struct OrderDraws {
  const float* sel_u;     // (G, K, 2)
  const float* fill;      // (G, K, L)
  const float* mut_u;     // (G, K, 4)
  const float* gauss;     // (3, G, K, L)
  const long long* seed;  // production mode when non-null
};

__global__ void __launch_bounds__(ORDER_THREADS) order_breed_kernel(
    const float* __restrict__ gin, float* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, OrderDraws dr,
    const float* __restrict__ coords, int C, float penalty, Geometry geo, Selection sel,
    int mutate, int obj) {
  extern __shared__ int smem[];
  const int K = geo.K, L = geo.L, G = geo.G;
  const int W = (L + 31) / 32;
  const int per_deme = K / ORDER_THREADS;
  const int g = blockIdx.x / per_deme;
  const int k = (blockIdx.x % per_deme) * ORDER_THREADS + threadIdx.x;
  int* row_of_rank = smem;                                          // K
  unsigned* vis = reinterpret_cast<unsigned*>(smem + K) + threadIdx.x;  // [W][ORDER_THREADS]
  float2* xy = reinterpret_cast<float2*>(smem + K + W * ORDER_THREADS);
  const int Cs = obj == OBJ_TSP ? min(C, L) : 0;
  const size_t rows = (size_t)G * K;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, rows);
  dr.sel_u = island_slice(dr.sel_u, rows * 2);
  dr.fill = island_slice(dr.fill, rows * L);
  dr.mut_u = island_slice(dr.mut_u, rows * 4);
  dr.gauss = island_slice(dr.gauss, rows * 3 * L);
  dr.seed = island_slice(dr.seed, 1);

  for (int i = threadIdx.x; i < K; i += ORDER_THREADS) {
    const int r = ranks[(size_t)g * K + i];
    if (r >= 0 && r < K) row_of_rank[r] = i;
  }
  for (int i = threadIdx.x; i < Cs; i += ORDER_THREADS)
    xy[i] = make_float2(coords[2 * i], coords[2 * i + 1]);
  __syncthreads();

  const float V = (float)max(min(K, geo.P - g * K), 1);
  const float rate = mparams[0], sigma = mparams[1];
  const bool philox_mode = dr.seed != nullptr;
  uint32_t k0 = 0, k1 = 0;
  if (philox_mode) {
    const unsigned long long s = (unsigned long long)dr.seed[0];
    k0 = (uint32_t)s;
    k1 = (uint32_t)(s >> 32);
  }
  const size_t child = (size_t)g * K + k;
  float su0, su1, mu0, mu1, mu2;
  if (philox_mode) {
    const uint4 ws = philox(k0, k1, make_uint4(k, g, STREAM_SEL, 0u));
    const uint4 wm = philox(k0, k1, make_uint4(k, g, STREAM_MUT, 0u));
    su0 = to_uniform(ws.x);
    su1 = to_uniform(ws.y);
    mu0 = to_uniform(wm.x);
    mu1 = to_uniform(wm.y);
    mu2 = to_uniform(wm.z);
  } else {
    su0 = dr.sel_u[child * 2];
    su1 = dr.sel_u[child * 2 + 1];
    mu0 = dr.mut_u[child * 4];
    mu1 = dr.mut_u[child * 4 + 1];
    mu2 = dr.mut_u[child * 4 + 2];
  }
  const int r1 = winner_rank(winner_fraction(sel, su0), V);
  const int r2 = winner_rank(winner_fraction(sel, su1), V);
  const int s1 = min(max(row_of_rank[r1], 0), K - 1);
  const int s2 = min(max(row_of_rank[r2], 0), K - 1);
  const float* p1 = gin + ((size_t)g * K + s1) * L;
  const float* p2 = gin + ((size_t)g * K + s2) * L;
  const int orow = k * G + g;
  float* out = gout + (size_t)orow * L;

  const int pos = (int)floorf(mu0 * (float)L);
  const int pj = (int)floorf(mu1 * (float)L);
  const bool fire = mutate == MUT_SWAP ? mu2 < rate : mu1 < rate;
  const size_t plane = (size_t)G * K * L;

  // Point and gaussian mutation apply per gene as the walk writes it.
  auto mutate_gene = [=](int l, float c) {
    if (mutate == MUT_POINT) {
      if (fire && l == pos) c = mu2;
    } else if (mutate == MUT_GAUSSIAN) {
      float gate, u1, u2;
      if (philox_mode) {
        const uint4 z = philox(k0, k1, make_uint4(k, g, STREAM_GAUSS + l, 0u));
        gate = to_uniform(z.x);
        u1 = to_uniform(z.y);
        u2 = to_uniform(z.z);
      } else {
        const size_t at = child * L + l;
        gate = dr.gauss[at];
        u1 = dr.gauss[plane + at];
        u2 = dr.gauss[2 * plane + at];
      }
      u1 = fminf(fmaxf(u1, 1e-7f), U1_HI);
      const float normal = sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI * u2);
      const float m = fminf(fmaxf(c + sigma * normal, 0.0f), U1_HI);
      if (gate < rate) c = m;
    }
    return c;
  };
  const FillSource fill{philox_mode, k0, k1, k, g, 0u, philox_mode ? nullptr : dr.fill + child * L};
  order_walk<true>(p1, p2, out, L, vis, ORDER_THREADS, fill, mutate_gene);
  if (mutate == MUT_SWAP && fire) {
    const float a = out[pos], b = out[pj];
    out[pos] = b;
    out[pj] = a;
  }
  if (obj == OBJ_NONE) return;

  float score = 0.0f;
  if (obj == OBJ_TSP) {
    score = tsp_walk_score(out, L, vis, ORDER_THREADS, xy, C, penalty);
  } else {
    float a = 0.0f, b = 0.0f;
    for (int l = 0; l < L; ++l) obj_add(obj, out[l], a, b);
    score = obj_finish(obj, a, b, L);
  }
  sout[orow] = orow < geo.P ? score : -INFINITY;
}


// ---------------------------------------------------------------------------
// multigen_breed_kernel: up to T generations per launch (B4).
//
// Replaces, in libpga_tpu/ops/pallas_step.py, _multigen_kernel (:1460) with
// its in-kernel ranks _kernel_ranks (:1398), as built by make_pallas_multigen
// (:2724) and driven by _multigen_run_loop (:2991). The plain PyTorch version
// is fused_step.multigen_breed_reference; the kernel computes exactly that
// function, scores included.
//
// What it computes. Block i owns group i: D demes of K rows, read in the
// parity's cohort order (read_row), private to the block for the whole
// launch. `steps` (0 = identity up to the row permutation) and `target`
// (+inf = never) are runtime arguments, so one build serves every chunk and
// remainder. Each sub-generation t < steps:
//   (a) frozen = the maximum score over the group's alive rows >= target
//       (false when an alive score is NaN, as a maximum that propagates NaN
//       compares): a frozen group keeps genomes and scores, so an individual
//       that reaches the target mid-launch survives to the launch's end;
//   (b) ranks per deme from the scores: descending score, NaN and dead rows
//       as -inf, ties by a fresh random word per row per sub-generation whose
//       low 10 bits are the row's index in its deme ((bits >> 2) & ~1023 | k,
//       so the order is strict), dead rows keyed 0x7FFFFC00 | k so they rank
//       at or after V. Score and tie word pack into one signed 64-bit key;
//       rank[j] = the number of keys below key[j], counted by one thread per
//       row over the deme's K keys in shared memory; row_of_rank inverts it;
//   (c) every child as deme_breed_kernel breeds it (rank-space selection,
//       uniform crossover, point / gaussian / swap mutation), except that
//       children k < elitism are verbatim copies of ranks 0..e-1 (per-deme
//       elitism), and the child's rowwise-fused score;
//   (d) the deme's K rows are replaced by its K children: demes are fixed
//       for the launch, the row maps apply once, at its end.
// A row is alive when its read row is below P (the ping-pong alive mask; the
// riffle tail deme's positional count); alive is per cohort slot and static
// for the launch. Write-back: child k of deme g to write_row(g, k), its score
// beside it, -inf on rows >= P. Steps (a), (b), (d), the selection of (c)
// and the write-back are multigen_group of breed_core.cuh, which
// expr_multigen_kernel (expr_breed.cu) shares; this kernel gives it the
// builtin breed of one child, breed_genes.
//
// Bound. Bytes: the population and its scores read once and written once,
// 2*Pp*L*4 + 2*Pp*4, whatever `steps` is (0.253 ms at 1,048,576x100, 9.7 us
// at 40,000x100 at 3.35 TB/s). Operations the function needs per
// sub-generation (loads are not operations): K*log2(K) compares to rank a
// deme, plus 2*Pp*L for crossover and score, over 67 TFLOP/s float32: about
// 0.0033 ms per sub-generation at 1,048,576x100, so bytes set the bound at
// every step count measured (up to 32). The K*K rank count below is this
// kernel's choice, not the function's need.
//
// Design. Children of sub-generation t must not overwrite parents other warps still read, so a deme needs two copies; two
// copies of a K = 512, L = 100 deme (410 KB) exceed a block's 227 KB of
// shared memory. The group's working copies therefore live in two global
// work buffers in cohort order (row g*K + k): sub-generation 0 reads `gin`
// through read_row, the last one writes `gout` through write_row, the ones
// between alternate the work buffers. A group's slice is 0.1-0.8 MB and is
// re-read from L2 where the launch's groups fit there (32 MB at 40,000x100;
// at 1,048,576x100 the buffers stream from device memory). Scores, keys,
// row_of_rank and alive flags stay in shared memory (17 bytes per row,
// <= 35 KB). __syncthreads() between the phases is the only synchronisation;
// `steps` is a kernel argument, so every thread runs the same trips. One warp
// per child with lanes over genes, as deme_breed_kernel; blocks of 1,024
// threads measured faster than 256 or 512 at every shape tried. Keeping a
// K = 256 deme's two copies in shared memory is later work.
//
// Order crossover (multigen_breed_kernel<true>; _multigen_kernel's order_refs,
// :1548, passed to _deme_child, :1659). D is 1 and the row map the riffle, as
// in JAX. Each sub-generation, after the ranks, every thread walks one child
// of the group at a time (breed_core.cuh's order_walk: its visited bitmask in
// shared memory after the group's arrays, [word][walker]) straight into the
// child's row of the work buffer or of gout; a block barrier; then one warp
// per child reads that row back with plain loads, applies point / gaussian /
// swap mutation and sums the score, as breed_genes<false, true>. An elite
// child (k < elitism) is not walked: it is its rank-k parent verbatim, as
// JAX sets elite rows to p1 after the walk. The fallback genes are stream
// 0x20000000 + l/4 with t as the fourth counter word, or the injected (T, G,
// K, L) plane. Bound: the bytes above, as for uniform crossover; but each
// sub-generation holds every walker on a dependent chain of L steps through
// its bitmask (order_breed_kernel's), and a K = 256 group walks on 256 of the
// block's 1,024 threads, so at L = 200 that chain, not the bytes, is
// expected to set the time.
//
// Randomness. Philox4x32-10 keyed by the launch seed, counter (k, g, stream,
// t) with the streams of deme_breed_kernel and 0x60000000 for the tie word
// (word x of the call); t = 0 reproduces the one-generation kernels' draws.
// A frozen group draws nothing, and since the counter carries t the later
// sub-generations' draws are the same either way. Injected mode reads draw
// tensors with a leading sub-generation axis.

template <bool ORDER, class Gene>
__global__ void __launch_bounds__(MG_THREADS) multigen_breed_kernel(
    MultigenIO<Gene> io, const float* __restrict__ mparams, Draws dr0, Geometry geo,
    Selection sel, int mutate, int obj, int elitism, int draw_steps) {
  extern __shared__ long long mg_smem[];
  io = island_io(io, geo);
  dr0 = island_draws(dr0, geo, draw_steps);
  BreedCtx cx = breed_ctx(dr0, mparams, geo, mutate, obj);
  if (ORDER) cx.ncalls = 2;  // selection and mutation: no crossover bits
  const int lane = threadIdx.x & 31;
  auto breed_child = [&](const Draws& dr, uint32_t t, int g, int k, size_t child,
                         const Gene* p1, const Gene* p2, Gene* out, const ChildRand& r,
                         bool elite) {
    float a, b;
    breed_genes<false, ORDER>(cx, dr, p1, p2, out, r, k, g, t, lane, child, !elite, a, b);
    return obj_finish(obj, a, b, geo.L);
  };
  multigen_group<ORDER>(io, geo, cx, dr0, sel, elitism, mg_smem, breed_child);
}


}  // namespace

// gene_dtype: GENE_F32 (0) or GENE_BF16 (1), the type of gin and gout.
extern "C" int deme_breed_launch(
    const void* gin, void* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const unsigned char* cross, const float* mut_u, const float* gauss,
    const long long* seed, int P, int Pp, int L, int K, int G, int mode, int S, int D, int q,
    int sel_kind, int tk, float sel_param, int mutate, int obj, int islands, int gene_dtype,
    void* stream) {
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed};
  const dim3 grid(G, islands);
  const size_t smem = K * sizeof(int);
  if (gene_dtype == GENE_BF16) {
    deme_breed_kernel<__nv_bfloat16><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(gin), static_cast<__nv_bfloat16*>(gout), sout, ranks,
        mparams, dr, geo, sel, mutate, obj);
  } else if (gene_dtype == GENE_F32) {
    deme_breed_kernel<float><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const float*>(gin), static_cast<float*>(gout), sout, ranks, mparams, dr,
        geo, sel, mutate, obj);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* deme_breed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int order_breed_launch(
    const float* gin, float* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const float* fill, const float* mut_u, const float* gauss,
    const long long* seed, const float* coords, int C, float penalty, int P, int Pp, int L,
    int K, int G, int sel_kind, int tk, float sel_param, int mutate, int obj, int islands,
    void* stream) {
  const Geometry geo{P, Pp, L, K, G, MODE_RIFFLE, G, 1, 8};
  const Selection sel{sel_kind, tk, sel_param};
  const OrderDraws dr{sel_u, fill, mut_u, gauss, seed};
  // Dynamic shared memory: row_of_rank, the visited bitmasks and, for
  // OBJ_TSP, the staged coordinates. Above 48 KB it needs the attribute;
  // past the block's 227 KB the attribute call fails and its error returns.
  const int W = (L + 31) / 32;
  const int smem = (K + W * ORDER_THREADS) * 4 + (obj == OBJ_TSP ? (C < L ? C : L) * 8 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        order_breed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  order_breed_kernel<<<dim3(G * (K / ORDER_THREADS), islands), ORDER_THREADS, smem,
                       (cudaStream_t)stream>>>(gin, gout, sout, ranks, mparams, dr, coords, C,
                                               penalty, geo, sel, mutate, obj);
  return (int)cudaGetLastError();
}

// cross_kind 0: uniform crossover (`cross` bits); 1: order crossover (`fill`
// genes; D must be 1; float32 genes only). draw_steps: the sub-generations
// each island's injected draws hold (their stride; unread in production
// mode). gene_dtype: GENE_F32 or GENE_BF16, the type of gin, gout and the
// work buffers.
extern "C" int multigen_breed_launch(
    const void* gin, const float* sin, void* gout, float* sout, void* work0, void* work1,
    int steps, float target, const float* mparams, const float* sel_u,
    const unsigned char* cross, const float* fill, const float* mut_u, const float* gauss,
    const long long* tie, const long long* seed, int P, int Pp, int L, int K, int G, int mode,
    int S, int D, int q, int sel_kind, int tk, float sel_param, int cross_kind, int mutate,
    int obj, int elitism, int draw_steps, int islands, int gene_dtype, void* stream) {
  if (D < 1 || D > MG_MAX_D || (cross_kind && D != 1)) return (int)cudaErrorInvalidValue;
  if ((gene_dtype != GENE_F32 && gene_dtype != GENE_BF16) || (cross_kind && gene_dtype != GENE_F32))
    return (int)cudaErrorInvalidValue;
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed, tie, fill};
  // Keys, scores, row_of_rank and alive flags of the group's D*K rows, then
  // (order crossover) the walkers' visited bitmasks.
  const int W = D * K;
  if (gene_dtype == GENE_BF16) {
    using B = __nv_bfloat16;
    const MultigenIO<B> io{static_cast<const B*>(gin), sin, static_cast<B*>(gout), sout,
                           static_cast<B*>(work0), static_cast<B*>(work1), steps, target};
    return launch_with_smem(multigen_breed_kernel<false, B>, dim3(S, islands), MG_THREADS,
                            (size_t)W * MG_ROW_BYTES, (cudaStream_t)stream, io, mparams, dr, geo,
                            sel, mutate, obj, elitism, draw_steps);
  }
  const MultigenIO<float> io{static_cast<const float*>(gin), sin, static_cast<float*>(gout),
                             sout, static_cast<float*>(work0), static_cast<float*>(work1),
                             steps, target};
  if (cross_kind)
    return launch_with_smem(multigen_breed_kernel<true, float>, dim3(S, islands), MG_THREADS,
                            mg_rows_bytes(W) + mg_walk_bytes(W, L, MG_THREADS),
                            (cudaStream_t)stream, io, mparams, dr, geo, sel, mutate, obj, elitism,
                            draw_steps);
  return launch_with_smem(multigen_breed_kernel<false, float>, dim3(S, islands), MG_THREADS,
                          (size_t)W * MG_ROW_BYTES, (cudaStream_t)stream, io, mparams, dr, geo,
                          sel, mutate, obj, elitism, draw_steps);
}
