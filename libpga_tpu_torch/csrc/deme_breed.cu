// deme_breed.cu: the fused deme breed on Hopper, in four kernels:
// deme_breed_kernel (one generation, uniform crossover), order_breed_kernel
// (one generation, order crossover and the fused TSP score),
// multigen_breed_kernel (up to T generations per launch with the ranks
// computed inside the kernel; uniform or order crossover) and, at the end of
// this file, deme_pipelined_kernel (deme_breed_kernel's function on a
// persistent grid of thread-block clusters that stage each deme's parent rows
// whole in shared memory by TMA, for the sub-block pipeline's geometries) and
// multigen_breed_kernel<false>'s cluster schedule (a group held in a
// thread-block cluster's shared memory for a whole launch).
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
// multigen kernel's sub-generation t + 1 reads step t's rounded rows (from
// the cluster's bf16 copy in shared memory, or on the one-block schedule
// from bf16 work buffers). Draws, draw counts and Philox streams are the float
// kernel's. Bound: 2-byte genes halve the bytes, 2*Pp*L*2 + 8*Pp (0.128 ms
// at 1,048,576x100); the loads stay one scalar per lane and gene (wider
// loads are later work). Order crossover stays float32 only, as in JAX
// (:1758): order_breed_kernel and multigen_breed_kernel<true> have no bf16
// case, and the launchers refuse one.
//
// The floor harness (B7). deme_breed_kernel<Gene, ABLATE>,
// order_breed_kernel<ABLATE> and multigen_breed_kernel<ORDER, Gene, ABLATE>
// (and, with expression hooks, expr_breed.cu's kernels) also build the
// ablated cases of the TPU kernels' floor-attribution harness
// (pallas_step.py's _VALID_ABLATE, :83-97, reached through make_pallas_breed
// / make_pallas_multigen(_ablate=) and tools/ablate_floor.py,
// tools/ablate_kernel.py); the port's harness is
// libpga_tpu_torch/tools/ablate_floor.py and ablate_kernel.py. ABLATE is a
// compile-time bitmask (breed_core.cuh's ABL_*); ABLATE = 0 is the production
// instantiation and its code is the code above. The flags, by JAX name:
//   copy_only  (ABL_COPY; _breed_kernel :1009-1035) a pure copy: block b
//              copies the rows of demes b*Dc .. b*Dc + Dc - 1 (Dc demes per
//              block, 1 by default: the counterpart of _demes_per_step; Wb
//              warps per block, the breed's THREADS / 32 by default, so a
//              demes-per-block sweep can hold the running warps fixed with
//              Wb = Dc) from read_row to write_row, one warp per row with
//              breed_genes' loads (four genes of a tile in flight per lane,
//              through the read-only path); no draws, no selection. With an
//              objective each copied row's slot gets the score it was handed
//              (the ranks argument holds float32 scores, as JAX's ranks input
//              stands in for the scores; under no_rank_sort they are the raw
//              scores, so s2 == rowsum(g2)).
//   no_riffle  (:2224-2254) the contiguous row map MODE_CONTIG: child k of
//              deme g at row g*K + k.
//   alias_io   (:2246-2254) the copy writes in place (gout == gin); only with
//              copy_only and no_riffle. A breeding warp would overwrite a parent
//              row another warp of the block still reads (JAX loads the whole
//              block into VMEM first), so the wrapper refuses it otherwise.
//   no_rank_sort (:2306) a host-side flag: the caller skips the rank sort
//              and hands the kernel the scores (copy) or identity ranks.
//   sel_const  (ABL_SEL_CONST; _deme_child :514) no selection draws are read:
//              p1 = p2 = slot k's row.
//   no_matmul  (ABL_NO_GATHER; :592) no rank-space gather: p1 = p2 = slot k's
//              row; the selection draws are still made.
//   no_cross   (ABL_NO_CROSS; :634) child = p1, no crossover bits drawn;
//              with order crossover no walk runs and no fallback gene is
//              drawn (JAX tests no_cross before the order branch, :653).
//   no_mut     (ABL_NO_MUT; :748) no mutation.
//   no_freeze  (ABL_NO_FREEZE; _multigen_kernel :1617) no group freezes.
//   no_rank_cube (ABL_NO_RANK_CUBE; :1638) no in-kernel ranks: rank r is slot r.
//   serial_grid (:431-445) no meaning: CUDA blocks have no dimension
//              semantics to choose; the wrapper raises.
//   no_score_t (:2354) no meaning: each score is stored at its child's row,
//              so there is no transpose to skip; raises.
//   scatter_scores (:1157) no meaning: per-child score stores are already the
//              production path; raises.
// Elite rows of the multigen kernel keep their gathered parent only where
// neither sel_const nor no_matmul is set (:736-745), as in JAX: under those
// flags an elite is crossed (order crossover: walked) like any other child,
// and left unmutated. In the multi-generation kernel copy_only, no_riffle,
// alias_io and no_rank_sort raise (JAX validates copy_only there and then
// ignores it). The copy is deme_breed_kernel's whatever the hooks (JAX's copy
// branch returns before a hook runs), at the order geometry under order
// crossover. Any set of flags JAX takes (_validate_ablate, :106-117) is a
// case: copy_only with stage flags is the copy (JAX's copy branch returns
// before any stage runs, :1009-1035); the stage bits combine freely, and in
// multigen_breed_kernel with ABL_NO_FREEZE and ABL_NO_RANK_CUBE; each kernel
// tests each bit on its own under if constexpr, as _deme_child (:514, :592,
// :634, :748) and _multigen_kernel (:1617, :1638, :1661) do. The harness's
// usual cases build in the production unit, the pipelined kernel's and the
// other combinations in units of their own ("The ABLATE cases each unit
// builds", at the end of this file). deme_pipelined_kernel takes the stage
// bits at the sub-block geometries (its section). Bound
// of the copy: the production bound, Pp*L*bytes read and written (0.253 ms
// at 1,048,576x100 float32, 0.0097 ms at 40,000x100), plus the handed scores
// when scored; the harness reads the copy beside it.
//
// Built with --fmad=false so the float32 selection arithmetic is not
// contracted into multiply-adds and rounds as the torch version does. The
// row maps, selection, Philox and the draws shared with expr_breed.cu are in
// breed_core.cuh.

#include <cooperative_groups.h>

#include "breed_core.cuh"
#include "pipe_core.cuh"

// The unit's floor-harness cases (see "The ABLATE cases each unit builds"
// at the end): none but production unless ops/kernels.py defines one.
#ifndef DEME_HARNESS
#define DEME_HARNESS 0
#endif
#ifndef DEME_ABLATE_EXTRA
#define DEME_ABLATE_EXTRA 0u
#endif

namespace {

// One warp crosses parents p1 and p2 into `out`, mutates (unless
// !may_mutate: an elite copy), rounds each gene to the gene type and sums the
// objective's terms of the child as written: each lane adds its genes l =
// lane, lane+32, ... in that order, then the lanes combine through the
// warp_sum butterfly; the plain version
// (fused_step.rowwise_scores(warp_order=True)) sums in the same order.
// Returns the sums in `a` and `b` on every lane. ORDER: the child was walked
// already (p1 == p2 == out, or an elite's parent): no crossover bits are
// drawn, every gene is p1's. ABLATE (the floor harness): ABL_NO_CROSS draws
// no crossover bits and takes every gene from p1, as ORDER does; ABL_NO_MUT
// mutates nothing.
template <bool LDG, bool ORDER = false, class Gene = float, unsigned ABLATE = 0u>
__device__ __forceinline__ void breed_genes(
    const BreedCtx& cx, const Draws& dr, const Gene* p1, const Gene* p2, Gene* out,
    ChildRand r, int k, int g, uint32_t t, int lane, size_t child, bool may_mutate,
    float& a, float& b) {
  const int L = cx.L, mutate = cx.mutate, obj = cx.obj;
  // point: gene pos takes mu2 when mu1 < rate; swap: genes pos, pj
  // exchange when mu2 < rate.
  const int pos = (int)floorf(r.mu0 * (float)L);
  const int pj = (int)floorf(r.mu1 * (float)L);
  constexpr bool MUTATES = !(ABLATE & ABL_NO_MUT);
  const bool fire =
      MUTATES && may_mutate && (mutate == MUT_SWAP ? r.mu2 < cx.rate : r.mu1 < cx.rate);
  a = 0.0f;
  b = 0.0f;

  // Mutates gene l of the crossed child, rounds it to the gene type, writes
  // it and adds its terms.
  auto finish = [&](int l, float c) {
    if (mutate == MUT_POINT) {
      if (fire && l == pos) c = r.mu2;
    } else if (MUTATES && mutate == MUT_GAUSSIAN) {
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

  if constexpr (ORDER || (ABLATE & ABL_NO_CROSS)) {
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

// ABLATE is 0 in production; the floor harness's cases are described under
// "The floor harness" below. In the ABL_COPY case block b copies demes
// b*Dc .. b*Dc + Dc - 1 (Dc = demes_per_block; 1 in every other case) and
// `ranks` holds float32 scores in cohort order, (G, K), the score each copied
// row is handed.
template <class Gene, unsigned ABLATE>
__global__ void __launch_bounds__(THREADS) deme_breed_kernel(
    const Gene* __restrict__ gin, Gene* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr0,
    Geometry geo, Selection sel, int mutate, int obj, int demes_per_block) {
  extern __shared__ int row_of_rank[];
  __shared__ int s_valid;
  const int g = blockIdx.x, K = geo.K, L = geo.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, (size_t)geo.G * K);
  if constexpr ((ABLATE & ABL_COPY) != 0u) {
    // The breed's access pattern without the breed: a warp per row, each
    // lane fetching its four genes of a 128-gene tile through the
    // read-only path before it stores any (breed_genes' tile), the gene
    // bits moved unchanged.
    using Bits = std::conditional_t<sizeof(Gene) == 2, unsigned short, float>;
    const float* handed = reinterpret_cast<const float*>(ranks);
    const int W = demes_per_block * K;
    for (int c = warp; c < W; c += nwarps) {
      const int gg = g * demes_per_block + c / K, k = c % K;
      const Bits* src = reinterpret_cast<const Bits*>(gin + (size_t)read_row(geo, gg, k) * L);
      const int orow = write_row(geo, gg, k);
      Bits* dst = reinterpret_cast<Bits*>(gout + (size_t)orow * L);
      for (int base = 0; base < L; base += 128) {
        Bits v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = base + lane + 32 * j;
          if (l < L) v[j] = __ldg(src + l);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = base + lane + 32 * j;
          if (l < L) dst[l] = v[j];
        }
      }
      if (obj != OBJ_NONE && lane == 0)
        sout[orow] = orow < geo.P ? handed[(size_t)gg * K + k] : -INFINITY;
    }
    return;
  }
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
  BreedCtx cx = breed_ctx(dr, mparams, geo, mutate, obj);
  if constexpr ((ABLATE & ABL_NO_CROSS) != 0u) cx.ncalls = 2;  // no crossover bits

  for (int k = warp; k < K; k += nwarps) {
    const size_t child = (size_t)g * K + k;
    const ChildRand r = child_rand(cx, dr, k, g, 0u, lane, child);
    int s1 = k, s2 = k;  // sel_const, no_matmul: child k's parents are slot k
    if constexpr ((ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER)) == 0u) {
      const int r1 = winner_rank(winner_fraction(sel, r.su0), V);
      const int r2 = winner_rank(winner_fraction(sel, r.su1), V);
      s1 = min(max(row_of_rank[r1], 0), K - 1);
      s2 = min(max(row_of_rank[r2], 0), K - 1);
    }
    const Gene* p1 = gin + (size_t)read_row(geo, g, s1) * L;
    const Gene* p2 = gin + (size_t)read_row(geo, g, s2) * L;
    const int orow = write_row(geo, g, k);
    float a, b;
    breed_genes<true, false, Gene, ABLATE>(cx, dr, p1, p2, gout + (size_t)orow * L, r, k, g, 0u,
                                           lane, child, true, a, b);
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
//
// ABLATE (the floor harness; 0 in production): ABL_SEL_CONST and
// ABL_NO_GATHER walk slot k's row with itself (no selection draw is read);
// ABL_NO_CROSS walks nothing, the child is parent 1 (mutated per gene as it
// is copied); ABL_NO_MUT mutates nothing. The score always runs.

struct OrderDraws {
  const float* sel_u;     // (G, K, 2)
  const float* fill;      // (G, K, L)
  const float* mut_u;     // (G, K, 4)
  const float* gauss;     // (3, G, K, L)
  const long long* seed;  // production mode when non-null
};

template <unsigned ABLATE>
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
  int s1 = k, s2 = k;  // sel_const, no_matmul: child k walks slot k's row
  if constexpr (!(ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER))) {
    const int r1 = winner_rank(winner_fraction(sel, su0), V);
    const int r2 = winner_rank(winner_fraction(sel, su1), V);
    s1 = min(max(row_of_rank[r1], 0), K - 1);
    s2 = min(max(row_of_rank[r2], 0), K - 1);
  }
  const float* p1 = gin + ((size_t)g * K + s1) * L;
  const float* p2 = gin + ((size_t)g * K + s2) * L;
  const int orow = k * G + g;
  float* out = gout + (size_t)orow * L;

  const int pos = (int)floorf(mu0 * (float)L);
  const int pj = (int)floorf(mu1 * (float)L);
  constexpr bool MUTATES = !(ABLATE & ABL_NO_MUT);
  const bool fire = MUTATES && (mutate == MUT_SWAP ? mu2 < rate : mu1 < rate);
  const size_t plane = (size_t)G * K * L;

  // Point and gaussian mutation apply per gene as the walk writes it.
  auto mutate_gene = [=](int l, float c) {
    if (!MUTATES) return c;
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
  if constexpr ((ABLATE & ABL_NO_CROSS) != 0u) {
    for (int l = 0; l < L; ++l) out[l] = mutate_gene(l, __ldg(p1 + l));
  } else {
    const FillSource fill{philox_mode, k0, k1, k, g, 0u,
                          philox_mode ? nullptr : dr.fill + child * L};
    order_walk<true>(p1, p2, out, L, vis, ORDER_THREADS, fill, mutate_gene);
  }
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
// threads measured faster than 256 or 512 at every shape tried. This
// one-block schedule now runs order crossover and the groups no cluster
// holds: uniform crossover keeps a group in a thread-block cluster's shared
// memory ("multigen_breed_kernel<false>'s cluster schedule", below).
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

template <bool ORDER, class Gene, unsigned ABLATE = 0u>
__global__ void __launch_bounds__(MG_THREADS) multigen_breed_kernel(
    MultigenIO<Gene> io, const float* __restrict__ mparams, Draws dr0, Geometry geo,
    Selection sel, int mutate, int obj, int elitism, int draw_steps) {
  extern __shared__ long long mg_smem[];
  io = island_io(io, geo);
  dr0 = island_draws(dr0, geo, draw_steps);
  BreedCtx cx = breed_ctx(dr0, mparams, geo, mutate, obj);
  if (ORDER || (ABLATE & ABL_NO_CROSS)) cx.ncalls = 2;  // selection and mutation: no crossover bits
  const int lane = threadIdx.x & 31;
  auto breed_child = [&](const Draws& dr, uint32_t t, int g, int k, size_t child,
                         const Gene* p1, const Gene* p2, Gene* out, const ChildRand& r,
                         bool elite) {
    float a, b;
    breed_genes<false, ORDER, Gene, ABLATE>(cx, dr, p1, p2, out, r, k, g, t, lane, child, !elite,
                                            a, b);
    return obj_finish(obj, a, b, geo.L);
  };
  multigen_group<ORDER, ABLATE>(io, geo, cx, dr0, sel, elitism, mg_smem, breed_child);
}


// ---------------------------------------------------------------------------
// deme_pipelined_kernel: the sub-block pipeline (B8).
//
// Replaces, in libpga_tpu/ops/pallas_step.py, _pp_breed_kernel's B > 1 case
// (:1287-1390, the pallas_call at :2526 built by make_pallas_breed(_subblock=B)):
// the ping-pong breed of groups of B sub-blocks of D demes, whose rows stream
// through a double-buffered VMEM pair by manual DMA, the next sub-block's
// inbound copy in flight while the current one breeds. What it computes is
// deme_breed_kernel's function at the B-aware geometry (breed_core.cuh's
// read_row / write_row with geo.B): fused_step.deme_breed_reference, the
// children bit for bit, with the same Philox counters (child k, deme g,
// stream, 0) and the same injected draws. Each score is summed in
// breed_genes' order, so it equals deme_breed_kernel's and
// fused_step.rowwise_scores(warp_order=True) bit for bit. Only the schedule
// differs.
//
// Bound. deme_breed_kernel's bytes: the population read once and written once,
// the ranks read and the scores written (0.2529 ms at 1,048,576x100 float32,
// 0.1277 ms bf16, at 3.35 TB/s). The operations (a few a gene, three Philox
// calls a child) are far below the card's rate. Each parent byte is read from
// device memory once, by the staging.
//
// Why this schedule. The first one (PR 13) staged each deme in gene slabs
// (32, 32 and 36 genes at L = 100 float32) by 16-byte cp.async from every
// thread, opened and closed each (deme, slab) with block barriers and carried
// each child's state across the slabs in shared memory. It took 0.7586 ms at
// 1,048,576x100 float32 B = 2 and 0.5731 ms bf16 (PERF.md, PR 16), slower
// than one torch.index_select of the same rows (0.6358, 0.3163 ms), and kept
// 97% of its time with every stage off: the schedule was the cost. Here a
// deme's rows are staged whole by TMA bulk copies, and each child is bred in
// one pass with its state in registers:
//   - A cluster of C blocks shares a deme (pipe_plan.cuh: the least C of 1, 2,
//     4, 8 whose two buffers of K/C rows fit a block; at K = 512, L = 100, C =
//     2 float32 and 1 bf16). Block c stages slots [c*R, (c+1)*R), R = K/C,
//     breeds their children, and reads each parent gene from the block that
//     staged the parent's slot, through distributed shared memory.
//   - Warp 0 stages: one cp.async.bulk a run of contiguous rows (the block's
//     whole run at parity 0; at parity 1 R/q runs of q rows, one a lane), each
//     32*L bytes times a whole number, so 16-byte aligned at any L, and one
//     for the deme's K ranks, all completing on the buffer's mbarrier
//     (expect_tx). Deme n + 1 is staged while deme n breeds.
//   - One cluster barrier a deme. Each block waits on its buffer's barrier,
//     inverts the deme's ranks into row_of_rank and counts the deme's alive
//     rows, then arrives. Past the barrier every block's rows of deme n have
//     landed and every block is done with deme n - 1, whose buffers the
//     elected thread then refills with deme n + 1. row_of_rank and the alive
//     counts are double-buffered, so no other barrier is needed.
//   - 8 lanes a child, four children a warp, 16 warps a block (measured
//     against a warp or 16 lanes a child and 8 to 32 warps a block: PERF.md,
//     PR 18). The child's three Philox
//     calls run on three of its lanes; its selection, mutation decision and
//     score sums stay in registers for the whole row. Where L is a multiple
//     of 4 sub-lane j takes four consecutive genes at a time (one 16-byte
//     float4, or 8 bytes of bf16) at 4*j, 4*j + 32, ..., so a group reads and
//     writes 32 consecutive genes an instruction; it keeps one score partial
//     for each of its warp-lane positions 4*j .. 4*j + 3, which combine in
//     warp_sum's butterfly order (pipe_sum4). Other lengths take one gene a
//     lane (pipe_sum). Gaussian mutation and the transcendental objectives
//     are out of line (pipe_gauss, pipe_terms): inlined into the unrolled
//     loop they spilled its registers.
//   - Each deme's read and write maps are computed once in closed form
//     (RowMap: runs of q rows by shifts), not per child.
//   - Children go from registers to their write row. Swap mutation exchanges
//     its two genes in device memory after the row is written and sums the
//     child again, as breed_genes does.
// The grid is persistent: as many clusters as the card holds at once
// (cudaOccupancyMaxActiveClusters; one block an SM), shared by the islands
// (blockIdx.y); cluster j of an island walks its contiguous run of demes.
// Where no cluster holds a deme (K*L*gene bytes above about 880 KB)
// fused_step.breed_launcher sends the launch to deme_breed_kernel at the same
// geometry, decided from the shape before any launch; this launcher refuses
// such a shape.
//
// The floor harness at B > 1 (B10; _pp_breed_kernel's B > 1 case hands
// `ablate` to _deme_child, :1359, and skips the crossover mask words under
// no_cross, :1331). ABLATE takes the stage bits, with deme_breed_kernel's
// meaning; 0 is the production code above. ABL_SEL_CONST and ABL_NO_GATHER:
// p1 = p2 = slot k's staged row (under ABL_SEL_CONST no selection call is
// made and no injected selection draw read; under ABL_NO_GATHER they are).
// ABL_NO_CROSS: no STREAM_CROSS call and no injected bit read; every gene is
// p1's. ABL_NO_MUT: no mutation call, no mutation. The other stages' Philox
// counters are unchanged, so a no_mut child is the production child at
// mutation rate 0, bit for bit. The staging, the ranks and the row maps are
// the production schedule's in every case. The lane layout, the staging,
// the row maps and the score sums are pipe_core.cuh's, which
// expr_pipelined_kernel (expr_breed.cu) shares.

// Partition cases that tools/pipelined_variants.py builds with -DPIPE_PART=n
// and times beside production (0): 1 breeds no child (the staging, the rank
// inversion and the cluster barrier alone), 2 reads every parent from the
// block's own buffer (slot s taken as this block's row s % R: no distributed
// shared memory; the children are not the function), 3 writes every child to
// row blockIdx.x.
#ifndef PIPE_PART
#define PIPE_PART 0
#endif

template <class Gene, unsigned ABLATE>
__global__ void __launch_bounds__(PIPE_THREADS, 1) deme_pipelined_kernel(
    const Gene* __restrict__ gin, Gene* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr0, Geometry geo,
    Selection sel, int mutate, int obj, PipePlan plan) {
  // The stages this case runs (all of them at ABLATE = 0); bit c of CALLS:
  // Philox call c (0 selection, 1 mutation, 2 the first crossover tile) is
  // made.
  constexpr bool SAME = (ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER)) != 0u;
  constexpr bool DRAWS_SEL = !(ABLATE & ABL_SEL_CONST);
  constexpr bool CROSSES = !(ABLATE & ABL_NO_CROSS);
  constexpr bool MUTATES = !(ABLATE & ABL_NO_MUT);
  constexpr unsigned CALLS = (DRAWS_SEL ? 1u : 0u) | (MUTATES ? 2u : 0u) | (CROSSES ? 4u : 0u);
  namespace cg = cooperative_groups;
  // 16-byte aligned (the bulk copies' need); every kernel's dynamic shared
  // memory is one symbol, so a wider alignment would move theirs too.
  extern __shared__ __align__(16) unsigned char pipe_smem[];
  __shared__ int s_alive[2][PIPE_WARPS];
  const cg::cluster_group cluster = cg::this_cluster();
  const int K = geo.K, L = geo.L, G = geo.G, C = plan.C, R = plan.rows;
  const int c = (int)cluster.block_rank();
  const int qs = __ffs(geo.q) - 1, rs = __ffs(R) - 1;  // both powers of two (pipe_plan)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, (size_t)G * K);
  const Draws dr = island_draws(dr0, geo, 1);
  const BreedCtx cx = breed_ctx(dr, mparams, geo, mutate, obj);
  const size_t kb = (plan.ror - plan.ranks) / 2;  // a rank row's (or row_of_rank's) bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(pipe_smem + plan.bars);
  // This block's cluster j of nc walks demes [g0, g0 + nd).
  const int nc = gridDim.x / C, j = blockIdx.x / C;
  const int g0 = (int)((long long)j * G / nc);
  const int nd = (int)((long long)(j + 1) * G / nc) - g0;

  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0 && nd > 0)
    stage_deme(gin, ranks, geo, plan, pipe_smem, full, read_map(geo, g0, qs), g0, 0, c, lane);

  // Lane group h of the warp breeds one child: its sub-lane jl four genes
  // at a time (4*jl + 0..3, + 32, ...) where L is a multiple of 4, else the
  // genes jl, jl + 8, ...
  const int h = lane / PIPE_LANES, jl = lane % PIPE_LANES, lead = h * PIPE_LANES;
  for (int n = 0; n < nd; ++n) {
    const int g = g0 + n, b = n & 1;
    mbar_wait(&full[b], (n >> 1) & 1);
    // The deme's ranks inverted, and its alive rows counted.
    const int* rk = reinterpret_cast<const int*>(pipe_smem + plan.ranks + b * kb);
    int* row_of_rank = reinterpret_cast<int*>(pipe_smem + plan.ror + b * kb);
    const RowMap rd = read_map(geo, g, qs), wr = write_map(geo, g, qs);
    int alive = 0;
    for (int k = threadIdx.x; k < K; k += PIPE_THREADS) {
      const int r = rk[k];
      if (r >= 0 && r < K) row_of_rank[r] = k;
      alive += rd(k) < geo.P;
    }
    alive = warp_sum(alive);
    if (lane == 0) s_alive[b][warp] = alive;
    // Every block's rows of deme n are in; every block is done with deme n - 1.
    cluster.sync();
    if (warp == 0 && n + 1 < nd)
      stage_deme(gin, ranks, geo, plan, pipe_smem, full, read_map(geo, g + 1, qs), g + 1, b ^ 1,
                 c, lane);
    int v = 0;
    for (int w = 0; w < PIPE_WARPS; ++w) v += s_alive[b][w];
    const float V = (float)max(v, 1);
    Gene* staged = reinterpret_cast<Gene*>(pipe_smem + b * plan.buf);
    if (PIPE_PART == 1) continue;

    for (int k0 = c * R + warp * PIPE_KIDS; k0 < (c + 1) * R; k0 += PIPE_WARPS * PIPE_KIDS) {
      const int k = k0 + h;
      const size_t child = (size_t)g * K + k;
      // child_rand's draws: sub-lane jl computes Philox call jl where its
      // stage runs.
      float su0 = 0.0f, su1 = 0.0f, mu0 = 0.0f, mu1 = 0.0f, mu2 = 0.0f;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (cx.philox_mode) {
        if (jl < 3 && ((CALLS >> jl) & 1u)) w = philox(cx.k0, cx.k1, make_uint4(k, g, jl, 0u));
        if constexpr (DRAWS_SEL) {
          su0 = to_uniform(__shfl_sync(FULL, w.x, lead));
          su1 = to_uniform(__shfl_sync(FULL, w.y, lead));
        }
        if constexpr (MUTATES) {
          mu0 = to_uniform(__shfl_sync(FULL, w.x, lead + 1));
          mu1 = to_uniform(__shfl_sync(FULL, w.y, lead + 1));
          mu2 = to_uniform(__shfl_sync(FULL, w.z, lead + 1));
        }
        if constexpr (CROSSES) {
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
        if constexpr (MUTATES) {
          mu0 = dr.mut_u[child * 4];
          mu1 = dr.mut_u[child * 4 + 1];
          mu2 = dr.mut_u[child * 4 + 2];
        }
      }
      int s1 = k, s2 = k;  // sel_const, no_matmul: child k's parents are slot k
      if constexpr (!SAME) {
        s1 = min(max(row_of_rank[winner_rank(winner_fraction(sel, su0), V)], 0), K - 1);
        s2 = min(max(row_of_rank[winner_rank(winner_fraction(sel, su1), V)], 0), K - 1);
      }
      const int orow = wr(k);
      const int pos = (int)floorf(mu0 * (float)L);
      const int pj = (int)floorf(mu1 * (float)L);
      const bool fire = MUTATES && (mutate == MUT_SWAP ? mu2 < cx.rate : mu1 < cx.rate);
      // Slot s is row s % R of the buffer of the cluster's block s / R: this
      // block's through its own shared memory, a peer's through the cluster's.
      if (PIPE_PART == 2) {
        s1 = c * R + (s1 & (R - 1));
        s2 = c * R + (s2 & (R - 1));
      }
      const int o1 = s1 >> rs, o2 = s2 >> rs;
      const Gene* p1 = (o1 == c ? staged : cluster.map_shared_rank(staged, o1)) +
                       (size_t)(s1 & (R - 1)) * L;
      const Gene* p2 = (o2 == c ? staged : cluster.map_shared_rank(staged, o2)) +
                       (size_t)(s2 & (R - 1)) * L;
      Gene* out = gout + (size_t)(PIPE_PART == 3 ? (int)blockIdx.x : orow) * L;
      // Mutates gene l of the crossed child (x) and rounds it to the gene type.
      auto finish = [&](int l, float x) {
        if (mutate == MUT_POINT) {
          if (fire && l == pos) x = mu2;
        } else if (MUTATES && mutate == MUT_GAUSSIAN) {
          x = pipe_gauss(cx, dr, x, k, g, l, child);
        }
        return round_gene<Gene>(x);
      };
      // Adds gene x's terms to the score partials, as obj_add does.
      const bool plain = obj == OBJ_ONEMAX;
      auto add = [&](float x, float& sa, float& se) {
        if (plain) {
          sa += x;
        } else {
          const float2 d = pipe_terms(obj, x);
          sa += d.x;
          se += d.y;
        }
      };

      // Cross, mutate, round, store and sum the child, 128 genes (one
      // crossover call) a tile.
      // The score's partials (ackley's cosine sums in e): four genes a lane,
      // one a warp-lane position 4*j + i; one gene a lane, j + 8*m.
      float a[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = e[i] = 0.0f;
      // Four genes a lane where rows are whole vectors (L a multiple of 4):
      // group lane j takes genes 32*i + 4*j + 0..3, warp-lane positions
      // 4*j + 0..3, and adds them in gene order.
      auto add4 = [&](const float (&x)[4], int l0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (l0 + i < L) add(x[i], a[i], e[i]);
      };
      const bool vec = L % 4 == 0;
      for (int t = 0; 128 * t < L; ++t) {
        if (CROSSES && cx.philox_mode && t > 0)
          w = philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_CROSS + t, 0u));
        if (vec) {
#pragma unroll
          for (int it = 0; it < 4; ++it) {  // crossover word it: genes 32*it .. of the tile
            const int l0 = 128 * t + 32 * it + 4 * jl;
            float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (l0 < L) {
              load4(p1 + l0, x);
              if constexpr (CROSSES) {
                uint32_t bits;  // gene l0 + i takes p2's gene where bit i is set
                if (cx.philox_mode) {
                  bits = (it == 0 ? w.x : it == 1 ? w.y : it == 2 ? w.z : w.w) >> (4 * jl);
                } else {
                  const uint32_t u = *reinterpret_cast<const uint32_t*>(dr.cross + child * L + l0);
                  bits = ((u & 0xffu) != 0u) | (((u >> 8) & 0xffu) != 0u) << 1 |
                         (((u >> 16) & 0xffu) != 0u) << 2 | ((u >> 24) != 0u) << 3;
                }
                float y[4];
                load4(p2 + l0, y);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  if ((bits >> i) & 1u) x[i] = y[i];
              }
              if (mutate == MUT_POINT) {
                if (fire && (unsigned)(pos - l0) < 4u) {
#pragma unroll
                  for (int i = 0; i < 4; ++i)
                    if (l0 + i == pos) x[i] = mu2;
                }
              } else if (MUTATES && mutate == MUT_GAUSSIAN) {
#pragma unroll
                for (int i = 0; i < 4; ++i) x[i] = pipe_gauss(cx, dr, x[i], k, g, l0 + i, child);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) x[i] = round_gene<Gene>(x[i]);
              store4(out + l0, x);
            }
            if (obj != OBJ_NONE) add4(x, l0);
          }
        } else {
#pragma unroll
          for (int i0 = 0; i0 < 128 / PIPE_LANES; i0 += PIPE_LOADS) {
            if (128 * t + PIPE_LANES * i0 < L) {
              float cv[PIPE_LOADS];
#pragma unroll
              for (int u = 0; u < PIPE_LOADS; ++u) {
                const int lt = jl + PIPE_LANES * (i0 + u), l = 128 * t + lt;
                uint32_t bit = 0u;  // no_cross: every gene from p1
                if constexpr (CROSSES) {
                  if (cx.philox_mode) {
                    const int wi = lt >> 5;
                    bit = ((wi == 0 ? w.x : wi == 1 ? w.y : wi == 2 ? w.z : w.w) >> (lt & 31)) & 1u;
                  } else if (l < L) {
                    bit = dr.cross[child * L + l];
                  }
                }
                cv[u] = l < L ? load_gene<false>((bit ? p2 : p1) + l) : 0.0f;
              }
#pragma unroll
              for (int u = 0; u < PIPE_LOADS; ++u) {
                const int l = 128 * t + jl + PIPE_LANES * (i0 + u);
                if (l < L) {
                  const float x = finish(l, cv[u]);
                  store_gene(out + l, x);
                  add(x, a[(i0 + u) % 4], e[(i0 + u) % 4]);
                }
              }
            }
          }
        }
      }
      if (MUTATES && mutate == MUT_SWAP) {
        const bool swap = fire && pos < L && pj < L;
        __syncwarp();
        if (swap && jl == 0) {
          const Gene x = out[pos], y = out[pj];
          out[pos] = y;
          out[pj] = x;
        }
        __syncwarp();
        if (swap && obj != OBJ_NONE) {
          // The score is of the child as written: sum again after the swap.
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = e[i] = 0.0f;
          if (vec) {
            for (int l0 = 4 * jl; l0 < L; l0 += 32) {
              float x[4];
              load4(out + l0, x);
              add4(x, l0);
            }
          } else {
            for (int i0 = 0; PIPE_LANES * i0 < L; i0 += 4) {
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const int l = jl + PIPE_LANES * (i0 + m);
                if (l < L) add(load_gene<false>(out + l), a[m], e[m]);
              }
            }
          }
        }
      }
      if (obj != OBJ_NONE) {
        const float sa = vec ? pipe_sum4(a) : pipe_sum(a);
        float se = 0.0f;  // ackley's cosine sum; no other objective has a second
        if (obj == OBJ_ACKLEY) se = vec ? pipe_sum4(e) : pipe_sum(e);
        if (jl == 0) sout[orow] = orow < geo.P ? obj_finish(obj, sa, se, L) : -INFINITY;
      }
    }
  }
  cluster.sync();  // no block leaves while another may still read its buffers
}

// ---------------------------------------------------------------------------
// multigen_breed_kernel<false>'s cluster schedule (B4 redesigned for Hopper).
//
// The same function as the one-block schedule above (multigen_group):
// fused_step.multigen_breed_reference, children and scores bit for bit, with
// the same Philox counters (child k, deme g, stream, sub-generation t) and
// injected draws. Only the schedule differs.
//
// Why. The one-block schedule could not keep a group on the chip: two
// copies of a K = 512, L = 100 group exceed a block's 227 KB, so every
// sub-generation read its parents from a global work buffer and wrote its
// children to the other, and at 1,048,576x100 each of the T sub-generations
// streamed the population through device memory; each deme was ranked by a
// K*K count (512 compares a row); and one warp a child in blocks of 1,024
// threads was instruction-bound. A T = 8 launch cost more than eight
// one-generation launches (7.075 against 8 x 0.7934 ms at 1M, PERF.md).
//
// The cluster schedule (breed_core.cuh's multigen_cluster; mg_plan.cuh):
//   - A cluster of C blocks holds a group of W = D*K rows in shared memory
//     for the whole launch, C the least of 1, 2, 4, 8 whose two copies of
//     the group fit (at 1,048,576x100 float32, riffle K = 512 D = 4: C = 8,
//     256 rows a block). Block c holds slots [c*R, (c+1)*R), R = W/C.
//   - The grid is persistent: as many clusters as the card holds at once
//     (cudaOccupancyMaxActiveClusters); cluster j walks its run of the
//     groups of every island (the island is part of the group index). A
//     group's rows are staged from gin through read_row by TMA bulk copies
//     on an mbarrier, the next group's while this one is written back.
//   - Each sub-generation reads its parents from one copy, through
//     distributed shared memory where a parent is a peer's, and writes its
//     children into the other; only the last writes gout, through write_row.
//     No work buffer, and no genome traffic between the launch's first read
//     and last write.
//   - The freeze flag is a cluster reduction: each warp publishes the
//     maximum and the NaN flag of its rows' alive scores, and every warp
//     reads all of them through distributed shared memory after the one
//     cluster barrier a sub-generation (keys, maxima and the previous
//     children are all in by then; the published keys and maxima are
//     double-buffered by t, so no other cluster barrier is needed). A frozen
//     group stays frozen (its scores no longer change), so the cluster stops
//     breeding it.
//   - Ranks by sorting: the 64-bit keys of a deme are distinct (the tie word
//     carries k in its low 10 bits), so any exact sort gives the count's
//     order, and row_of_rank[rank] is the key's low 10 bits. mg_rank merge
//     sorts a deme: each warp sorts runs of 32 keys in its registers (a
//     bitonic network of shuffles), then a key's rank is its place in its
//     run plus a binary search in each other run of the deme. A first
//     version sorted the deme by a whole bitonic network (45 dependent
//     stages, 10 through shared memory): on the critical path of every
//     sub-generation it cost more than the K*K count it replaced (PERF.md
//     section 5). Where a deme spans blocks (R < K) each of its blocks gathers
//     the deme's published keys and ranks them; else a block ranks its
//     demes.
//   - The breed of a child is deme_pipelined_kernel's: 8 lanes a child, four
//     genes a lane (16-byte shared loads and stores; one gene a lane where
//     L % 4 != 0), 16 warps a block, scores in warp_sum's order (pipe_sum4,
//     pipe_sum), gaussian mutation and the transcendental objectives out of
//     line. Children and scores go to shared memory.
// Groups no cluster holds (mg_plan.cuh: C = 0) and order crossover
// (multigen_breed_kernel<true>) keep the one-block schedule above: the route
// is decided from the shape before any launch (kernels.multigen_breed_cuda),
// and a cluster launch of a shape no cluster holds fails. The expression
// kernel (expr_breed.cu, expr_multigen_kernel<false>) runs this schedule with
// the eight-lane expression child where its plan (expr_plan.cuh) holds the
// group; a first version with one warp a child through the hooks measured
// slower than the one-block schedule (PERF.md section 5).
//
// Bound: the one-block schedule's (the population and its scores read once
// and written once). The floor harness's cases (ABL_NO_FREEZE,
// ABL_NO_RANK_CUBE: each deme's rank r is slot r; the stage bits, with
// deme_pipelined_kernel's meaning) run on this schedule wherever the plan
// holds the group.

template <bool ORDER, class Gene, unsigned ABLATE = 0u>
__global__ void __launch_bounds__(MGC_THREADS, 1) multigen_breed_kernel(
    MultigenIO<Gene> io, const float* __restrict__ mparams, Draws dr0, Geometry geo,
    Selection sel, int mutate, int obj, int elitism, int draw_steps, int islands, MgPlan plan) {
  static_assert(!ORDER, "order crossover breeds on the one-block schedule");
  constexpr bool SAME = (ABLATE & (ABL_SEL_CONST | ABL_NO_GATHER)) != 0u;
  constexpr bool DRAWS_SEL = !(ABLATE & ABL_SEL_CONST);
  constexpr bool CROSSES = !(ABLATE & ABL_NO_CROSS);
  constexpr bool MUTATES = !(ABLATE & ABL_NO_MUT);
  constexpr unsigned CALLS = (DRAWS_SEL ? 1u : 0u) | (MUTATES ? 2u : 0u) | (CROSSES ? 4u : 0u);
  extern __shared__ __align__(16) unsigned char mgc_smem[];
  const int K = geo.K, L = geo.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Lane group h of the warp breeds one child, sub-lane jl four genes at a
  // time (4*jl + 0..3, + 32, ...) where L is a multiple of 4, else the genes
  // jl, jl + 8, ...
  const int h = lane / PIPE_LANES, jl = lane % PIPE_LANES, lead = h * PIPE_LANES;
  const bool vec = L % 4 == 0;

  auto breed = [&](const MgStep<Gene>& st, const cg::cluster_group& cl) {
    const BreedCtx& cx = st.cx;
    const Draws& dr = st.dr;
    const uint32_t t = st.t;
    for (int x0 = warp * PIPE_KIDS; x0 < st.R; x0 += MGC_THREADS / 32 * PIPE_KIDS) {
      const int xl = x0 + h, x = st.c * st.R + xl, k = x & (K - 1);
      const int g = st.i * geo.D + (x >> st.ks);
      const size_t child = (size_t)g * K + k;
      // child_rand's draws: sub-lane jl computes Philox call jl where its
      // stage runs.
      float su0 = 0.0f, su1 = 0.0f, mu0 = 0.0f, mu1 = 0.0f, mu2 = 0.0f;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (cx.philox_mode) {
        if (jl < 3 && ((CALLS >> jl) & 1u)) w = philox(cx.k0, cx.k1, make_uint4(k, g, jl, t));
        if constexpr (DRAWS_SEL) {
          su0 = to_uniform(__shfl_sync(FULL, w.x, lead));
          su1 = to_uniform(__shfl_sync(FULL, w.y, lead));
        }
        if constexpr (MUTATES) {
          mu0 = to_uniform(__shfl_sync(FULL, w.x, lead + 1));
          mu1 = to_uniform(__shfl_sync(FULL, w.y, lead + 1));
          mu2 = to_uniform(__shfl_sync(FULL, w.z, lead + 1));
        }
        if constexpr (CROSSES) {
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
        if constexpr (MUTATES) {
          mu0 = dr.mut_u[child * 4];
          mu1 = dr.mut_u[child * 4 + 1];
          mu2 = dr.mut_u[child * 4 + 2];
        }
      }
      // An elite is its rank-k parent verbatim (SAME: bred from slot k
      // alone); either way it is not mutated.
      const bool elite = k < elitism;
      const int2 s = mg_parents<SAME>(st, sel, x, elite, su0, su1);
      const Gene* p1 = mg_parent(st, cl, s.x, L);
      const Gene* p2 = mg_parent(st, cl, s.y, L);
      Gene* out = st.next + (size_t)xl * L;
      const int pos = (int)floorf(mu0 * (float)L);
      const int pj = (int)floorf(mu1 * (float)L);
      const bool fire = MUTATES && !elite && (mutate == MUT_SWAP ? mu2 < cx.rate : mu1 < cx.rate);
      const bool gauss = MUTATES && !elite && mutate == MUT_GAUSSIAN;
      // Adds gene x's terms to the score partials, as obj_add does.
      const bool plain = obj == OBJ_ONEMAX;
      auto add = [&](float x, float& sa, float& se) {
        if (plain) {
          sa += x;
        } else {
          const float2 d = pipe_terms(obj, x);
          sa += d.x;
          se += d.y;
        }
      };
      // The score's partials (ackley's cosine sums in e): four genes a lane,
      // one a warp-lane position 4*j + i; one gene a lane, j + 8*m.
      float a[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = e[i] = 0.0f;
      auto add4 = [&](const float (&x)[4], int l0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (l0 + i < L) add(x[i], a[i], e[i]);
      };
      // Cross, mutate, round, store and sum the child, 128 genes (one
      // crossover call) a tile.
      for (int tile = 0; 128 * tile < L; ++tile) {
        if (CROSSES && cx.philox_mode && tile > 0)
          w = philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_CROSS + tile, t));
        if (vec) {
#pragma unroll
          for (int it = 0; it < 4; ++it) {  // crossover word it: genes 32*it .. of the tile
            const int l0 = 128 * tile + 32 * it + 4 * jl;
            float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (l0 < L) {
              load4(p1 + l0, x);
              if constexpr (CROSSES) {
                uint32_t bits;  // gene l0 + i takes p2's gene where bit i is set
                if (cx.philox_mode) {
                  bits = (it == 0 ? w.x : it == 1 ? w.y : it == 2 ? w.z : w.w) >> (4 * jl);
                } else {
                  const uint32_t u = *reinterpret_cast<const uint32_t*>(dr.cross + child * L + l0);
                  bits = ((u & 0xffu) != 0u) | (((u >> 8) & 0xffu) != 0u) << 1 |
                         (((u >> 16) & 0xffu) != 0u) << 2 | ((u >> 24) != 0u) << 3;
                }
                float y[4];
                load4(p2 + l0, y);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  if ((bits >> i) & 1u) x[i] = y[i];
              }
              if (mutate == MUT_POINT) {
                if (fire && (unsigned)(pos - l0) < 4u) {
#pragma unroll
                  for (int i = 0; i < 4; ++i)
                    if (l0 + i == pos) x[i] = mu2;
                }
              } else if (gauss) {
#pragma unroll
                for (int i = 0; i < 4; ++i) x[i] = mg_gauss(cx, dr, x[i], k, g, t, l0 + i, child);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) x[i] = round_gene<Gene>(x[i]);
              store4(out + l0, x);
            }
            if (obj != OBJ_NONE) add4(x, l0);
          }
        } else {
#pragma unroll
          for (int i0 = 0; i0 < 128 / PIPE_LANES; i0 += PIPE_LOADS) {
            if (128 * tile + PIPE_LANES * i0 < L) {
              float cv[PIPE_LOADS];
#pragma unroll
              for (int u = 0; u < PIPE_LOADS; ++u) {
                const int lt = jl + PIPE_LANES * (i0 + u), l = 128 * tile + lt;
                uint32_t bit = 0u;  // no_cross: every gene from p1
                if constexpr (CROSSES) {
                  if (cx.philox_mode) {
                    const int wi = lt >> 5;
                    bit = ((wi == 0 ? w.x : wi == 1 ? w.y : wi == 2 ? w.z : w.w) >> (lt & 31)) & 1u;
                  } else if (l < L) {
                    bit = dr.cross[child * L + l];
                  }
                }
                cv[u] = l < L ? load_gene<false>((bit ? p2 : p1) + l) : 0.0f;
              }
#pragma unroll
              for (int u = 0; u < PIPE_LOADS; ++u) {
                const int l = 128 * tile + jl + PIPE_LANES * (i0 + u);
                if (l < L) {
                  float x = cv[u];
                  if (mutate == MUT_POINT) {
                    if (fire && l == pos) x = mu2;
                  } else if (gauss) {
                    x = mg_gauss(cx, dr, x, k, g, t, l, child);
                  }
                  x = round_gene<Gene>(x);
                  store_gene(out + l, x);
                  add(x, a[(i0 + u) % 4], e[(i0 + u) % 4]);
                }
              }
            }
          }
        }
      }
      if (MUTATES && mutate == MUT_SWAP) {
        const bool swap = fire && pos < L && pj < L;
        __syncwarp();
        if (swap && jl == 0) {
          const Gene x = out[pos], y = out[pj];
          out[pos] = y;
          out[pj] = x;
        }
        __syncwarp();
        if (swap && obj != OBJ_NONE) {
          // The score is of the child as written: sum again after the swap.
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = e[i] = 0.0f;
          if (vec) {
            for (int l0 = 4 * jl; l0 < L; l0 += 32) {
              float x[4];
              load4(out + l0, x);
              add4(x, l0);
            }
          } else {
            for (int i0 = 0; PIPE_LANES * i0 < L; i0 += 4) {
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const int l = jl + PIPE_LANES * (i0 + m);
                if (l < L) add(load_gene<false>(out + l), a[m], e[m]);
              }
            }
          }
        }
      }
      if (obj != OBJ_NONE) {
        const float sa = vec ? pipe_sum4(a) : pipe_sum(a);
        float se = 0.0f;  // ackley's cosine sum; no other objective has a second
        if (obj == OBJ_ACKLEY) se = vec ? pipe_sum4(e) : pipe_sum(e);
        if (jl == 0) st.score[xl] = obj_finish(obj, sa, se, L);
      }
    }
  };
  multigen_cluster<ABLATE, MGC_THREADS>(io, geo, plan, dr0, mparams, mutate, obj, draw_steps,
                                        islands, !CROSSES, mgc_smem, breed);
}


// The ABLATE cases each unit builds (ops/kernels.py, deme_unit). A launch
// with a mask its unit does not hold fails with cudaErrorInvalidValue;
// ops/kernels.py keeps the same lists (ABLATE_DEME_MASKS, ABLATE_ORDER_MASKS,
// ABLATE_MULTIGEN_MASKS, PIPELINED_HARNESS_MASKS) and picks the unit first.
//   the production unit (no macro): in deme_breed_kernel 0, ABL_COPY, each
//     stage bit alone and all four (the floor); in order_breed_kernel the
//     same but the copy; in multigen_breed_kernel (uniform, both gene types,
//     and order crossover) 0, ABL_NO_FREEZE, ABL_NO_RANK_CUBE, each stage bit
//     alone and the floor; in deme_pipelined_kernel 0 alone;
//   the harness unit (DEME_HARNESS): deme_pipelined_kernel's stage cases
//     (each stage bit alone and the floor), nothing else;
//   an extra unit (DEME_ABLATE_EXTRA = a mask outside those lists, never
//     ABL_COPY: the copy with stage flags is the copy): that mask in every
//     kernel it has a meaning in (the multigen bits only in
//     multigen_breed_kernel), nothing else.
// So the production unit's text is the same whatever the harness builds,
// and a harness or extra unit compiles only its own cases.
constexpr unsigned ABL_FLOOR = ABL_STAGES;  // every stage off: the harness's floor
#define DEME_PRODUCTION (!DEME_HARNESS && !DEME_ABLATE_EXTRA)
// An extra mask without the multigen bits (ABL_NO_FREEZE | ABL_NO_RANK_CUBE).
#define DEME_EXTRA_ONE_GEN (DEME_ABLATE_EXTRA && !((DEME_ABLATE_EXTRA) & 96u))
constexpr unsigned ABL_EXTRA = DEME_ABLATE_EXTRA;

template <unsigned A, class F>
int launch_case(F& launch) {
  return launch(std::integral_constant<unsigned, A>{});
}

// The stage cases of the harness: each stage bit alone and the floor.
template <class F>
int dispatch_stage_ablate(unsigned ablate, F& launch) {
  switch (ablate) {
    case ABL_SEL_CONST: return launch_case<ABL_SEL_CONST>(launch);
    case ABL_NO_GATHER: return launch_case<ABL_NO_GATHER>(launch);
    case ABL_NO_CROSS: return launch_case<ABL_NO_CROSS>(launch);
    case ABL_NO_MUT: return launch_case<ABL_NO_MUT>(launch);
    case ABL_FLOOR: return launch_case<ABL_FLOOR>(launch);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class F>
int dispatch_deme_ablate(unsigned ablate, F launch) {
#if DEME_PRODUCTION
  if (ablate == 0u) return launch_case<0u>(launch);
  if (ablate == ABL_COPY) return launch_case<ABL_COPY>(launch);
  return dispatch_stage_ablate(ablate, launch);
#elif DEME_EXTRA_ONE_GEN
  if (ablate == ABL_EXTRA) return launch_case<ABL_EXTRA>(launch);
#endif
  return (int)cudaErrorInvalidValue;
}

template <class F>
int dispatch_order_ablate(unsigned ablate, F launch) {
#if DEME_PRODUCTION
  if (ablate == 0u) return launch_case<0u>(launch);
  return dispatch_stage_ablate(ablate, launch);
#elif DEME_EXTRA_ONE_GEN
  if (ablate == ABL_EXTRA) return launch_case<ABL_EXTRA>(launch);
#endif
  return (int)cudaErrorInvalidValue;
}

template <class F>
int dispatch_multigen_ablate(unsigned ablate, F launch) {
#if DEME_PRODUCTION
  if (ablate == 0u) return launch_case<0u>(launch);
  if (ablate == ABL_NO_FREEZE) return launch_case<ABL_NO_FREEZE>(launch);
  if (ablate == ABL_NO_RANK_CUBE) return launch_case<ABL_NO_RANK_CUBE>(launch);
  return dispatch_stage_ablate(ablate, launch);
#elif DEME_ABLATE_EXTRA
  if (ablate == ABL_EXTRA) return launch_case<ABL_EXTRA>(launch);
#endif
  return (int)cudaErrorInvalidValue;
}

template <class F>
int dispatch_pipelined_ablate(unsigned ablate, F launch) {
#if DEME_PRODUCTION
  if (ablate == 0u) return launch_case<0u>(launch);
#elif DEME_HARNESS
  return dispatch_stage_ablate(ablate, launch);
#elif DEME_EXTRA_ONE_GEN
  if (ablate == ABL_EXTRA) return launch_case<ABL_EXTRA>(launch);
#endif
  return (int)cudaErrorInvalidValue;
}

template <class Gene>
int deme_launch(const void* gin, void* gout, float* sout, const int* ranks, const float* mparams,
                const Draws& dr, const Geometry& geo, const Selection& sel, int mutate, int obj,
                int islands, unsigned ablate, int demes_per_block, int warps_per_block,
                cudaStream_t stream) {
  const size_t smem = geo.K * sizeof(int);
  return dispatch_deme_ablate(ablate, [&](auto tag) {
    constexpr unsigned A = decltype(tag)::value;
    const int per_block = (A & ABL_COPY) ? demes_per_block : 1;
    const int threads = (A & ABL_COPY) && warps_per_block ? 32 * warps_per_block : THREADS;
    deme_breed_kernel<Gene, A><<<dim3(geo.G / per_block, islands), threads, smem, stream>>>(
        static_cast<const Gene*>(gin), static_cast<Gene*>(gout), sout, ranks, mparams, dr, geo,
        sel, mutate, obj, per_block);
    return (int)cudaGetLastError();
  });
}

// deme_pipelined_kernel's launch: the plan of pipe_plan.cuh (C = 0, no cluster
// holds a deme: refused), clusters of C blocks, as many as the card holds at
// once (at most G an island), blockIdx.y the island.
template <class Gene>
int pipelined_launch(const void* gin, void* gout, float* sout, const int* ranks,
                     const float* mparams, const Draws& dr, const Geometry& geo,
                     const Selection& sel, int mutate, int obj, int islands, unsigned ablate,
                     cudaStream_t stream) {
  const PipePlan plan = pipe_plan(geo.K, geo.L, (int)sizeof(Gene), geo.q);
  if (!plan.C) return (int)cudaErrorInvalidValue;
  return dispatch_pipelined_ablate(ablate, [&](auto tag) {
    return pipe_launch(deme_pipelined_kernel<Gene, decltype(tag)::value>, plan.C, plan.smem, geo.G,
                       islands, stream, static_cast<const Gene*>(gin), static_cast<Gene*>(gout),
                       sout, ranks, mparams, dr, geo, sel, mutate, obj, plan);
  });
}

}  // namespace

// gene_dtype: GENE_F32 (0) or GENE_BF16 (1), the type of gin and gout.
// ablate: 0, or an ABLATE case of the floor harness (ABL_COPY: demes_per_block
// demes per block, dividing G, and warps_per_block warps per block, 1 to
// THREADS / 32 or 0 for THREADS / 32; `ranks` then holds the handed float32
// scores, and gout may be gin with mode MODE_CONTIG).
extern "C" int deme_breed_launch(
    const void* gin, void* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const unsigned char* cross, const float* mut_u, const float* gauss,
    const long long* seed, int P, int Pp, int L, int K, int G, int mode, int S, int D, int q,
    int B, int sel_kind, int tk, float sel_param, int mutate, int obj, int islands,
    int gene_dtype, unsigned ablate, int demes_per_block, int warps_per_block, void* stream) {
  if (demes_per_block < 1 || G % demes_per_block || warps_per_block < 0 ||
      warps_per_block > THREADS / 32 || B < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q, B};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed};
  const cudaStream_t st = (cudaStream_t)stream;
  if (gene_dtype == GENE_BF16)
    return deme_launch<__nv_bfloat16>(gin, gout, sout, ranks, mparams, dr, geo, sel, mutate, obj,
                                      islands, ablate, demes_per_block, warps_per_block, st);
  if (gene_dtype == GENE_F32)
    return deme_launch<float>(gin, gout, sout, ranks, mparams, dr, geo, sel, mutate, obj, islands,
                              ablate, demes_per_block, warps_per_block, st);
  return (int)cudaErrorInvalidValue;
}

// deme_pipelined_kernel at the geometry (any row map; the production path
// launches it where the ping-pong sub-block depth B is above 1 and a cluster
// holds a deme, pipe_plan.cuh; a shape none holds fails with
// cudaErrorInvalidValue). gin and ranks must be 16-byte aligned (the TMA
// copies). ablate: 0, or a stage case of the floor harness this unit holds
// (dispatch_pipelined_ablate).
extern "C" int deme_pipelined_launch(
    const void* gin, void* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const unsigned char* cross, const float* mut_u, const float* gauss,
    const long long* seed, int P, int Pp, int L, int K, int G, int mode, int S, int D, int q,
    int B, int sel_kind, int tk, float sel_param, int mutate, int obj, int islands,
    int gene_dtype, unsigned ablate, void* stream) {
  if (B < 1 || islands < 1 || islands > 65535) return (int)cudaErrorInvalidValue;
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q, B};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed};
  const cudaStream_t st = (cudaStream_t)stream;
  if (gene_dtype == GENE_BF16)
    return pipelined_launch<__nv_bfloat16>(gin, gout, sout, ranks, mparams, dr, geo, sel, mutate,
                                           obj, islands, ablate, st);
  if (gene_dtype == GENE_F32)
    return pipelined_launch<float>(gin, gout, sout, ranks, mparams, dr, geo, sel, mutate, obj,
                                   islands, ablate, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* deme_breed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ablate: 0, or a stage case of the floor harness (dispatch_order_ablate).
extern "C" int order_breed_launch(
    const float* gin, float* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const float* fill, const float* mut_u, const float* gauss,
    const long long* seed, const float* coords, int C, float penalty, int P, int Pp, int L,
    int K, int G, int sel_kind, int tk, float sel_param, int mutate, int obj, int islands,
    unsigned ablate, void* stream) {
  const Geometry geo{P, Pp, L, K, G, MODE_RIFFLE, G, 1, 8, 1};
  const Selection sel{sel_kind, tk, sel_param};
  const OrderDraws dr{sel_u, fill, mut_u, gauss, seed};
  // Dynamic shared memory: row_of_rank, the visited bitmasks and, for
  // OBJ_TSP, the staged coordinates. Above 48 KB it needs the attribute;
  // past the block's 227 KB the attribute call fails and its error returns.
  const int W = (L + 31) / 32;
  const size_t smem =
      (size_t)(K + W * ORDER_THREADS) * 4 + (obj == OBJ_TSP ? (C < L ? C : L) * 8 : 0);
  return dispatch_order_ablate(ablate, [&](auto tag) {
    return launch_with_smem(order_breed_kernel<decltype(tag)::value>,
                            dim3(G * (K / ORDER_THREADS), islands), ORDER_THREADS, smem,
                            (cudaStream_t)stream, gin, gout, sout, ranks, mparams, dr, coords, C,
                            penalty, geo, sel, mutate, obj);
  });
}

namespace {

// The one-block schedule's kernel of crossover ORDER (multigen_group), apart
// from the cluster schedule's overload of the same template.
template <bool ORDER, class Gene, unsigned ABLATE>
auto multigen_one_block() {
  return static_cast<void (*)(MultigenIO<Gene>, const float*, Draws, Geometry, Selection, int,
                              int, int, int)>(multigen_breed_kernel<ORDER, Gene, ABLATE>);
}

// multigen_breed_kernel<false>'s cluster schedule at the geometry: the plan
// of mg_plan.cuh (C = 0, no cluster holds a group: refused).
template <class Gene>
int multigen_cluster_launch(const MultigenIO<Gene>& io, const float* mparams, const Draws& dr,
                            const Geometry& geo, const Selection& sel, int mutate, int obj,
                            int elitism, int draw_steps, int islands, unsigned ablate,
                            cudaStream_t stream) {
  const MgPlan plan = mg_plan(geo.D, geo.K, geo.L, (int)sizeof(Gene), geo.q);
  if (!plan.C) return (int)cudaErrorInvalidValue;
  return dispatch_multigen_ablate(ablate, [&](auto tag) {
    constexpr unsigned A = decltype(tag)::value;
    return launch_clusters(
        static_cast<void (*)(MultigenIO<Gene>, const float*, Draws, Geometry, Selection, int, int,
                             int, int, int, MgPlan)>(multigen_breed_kernel<false, Gene, A>),
        plan.C, plan.smem, MGC_THREADS, islands * geo.S, stream, io, mparams, dr, geo, sel,
        mutate, obj, elitism, draw_steps, islands, plan);
  });
}

}  // namespace

// cross_kind 0: uniform crossover (`cross` bits); 1: order crossover (`fill`
// genes; D must be 1; float32 genes only). draw_steps: the sub-generations
// each island's injected draws hold (their stride; unread in production
// mode). gene_dtype: GENE_F32 or GENE_BF16, the type of gin, gout and the
// work buffers. cluster: uniform crossover on the cluster schedule (the plan
// must hold the group; no work buffers), else the one-block schedule.
extern "C" int multigen_breed_launch(
    const void* gin, const float* sin, void* gout, float* sout, void* work0, void* work1,
    int steps, float target, const float* mparams, const float* sel_u,
    const unsigned char* cross, const float* fill, const float* mut_u, const float* gauss,
    const long long* tie, const long long* seed, int P, int Pp, int L, int K, int G, int mode,
    int S, int D, int q, int sel_kind, int tk, float sel_param, int cross_kind, int mutate,
    int obj, int elitism, int draw_steps, int islands, int gene_dtype, unsigned ablate,
    int cluster, void* stream) {
  if (D < 1 || D > MG_MAX_D || (cross_kind && D != 1)) return (int)cudaErrorInvalidValue;
  if ((gene_dtype != GENE_F32 && gene_dtype != GENE_BF16) || (cross_kind && gene_dtype != GENE_F32))
    return (int)cudaErrorInvalidValue;
  if (cluster && (cross_kind || islands < 1 || islands > 65535)) return (int)cudaErrorInvalidValue;
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q, 1};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed, tie, fill};
  const cudaStream_t st = (cudaStream_t)stream;
  // Keys, scores, row_of_rank and alive flags of the group's D*K rows, then
  // (order crossover) the walkers' visited bitmasks.
  const int W = D * K;
  if (gene_dtype == GENE_BF16) {
    using B = __nv_bfloat16;
    const MultigenIO<B> io{static_cast<const B*>(gin), sin, static_cast<B*>(gout), sout,
                           static_cast<B*>(work0), static_cast<B*>(work1), steps, target};
    if (cluster)
      return multigen_cluster_launch(io, mparams, dr, geo, sel, mutate, obj, elitism, draw_steps,
                                     islands, ablate, st);
    return dispatch_multigen_ablate(ablate, [&](auto tag) {
      return launch_with_smem(multigen_one_block<false, B, decltype(tag)::value>(),
                              dim3(S, islands), MG_THREADS, (size_t)W * MG_ROW_BYTES, st, io,
                              mparams, dr, geo, sel, mutate, obj, elitism, draw_steps);
    });
  }
  const MultigenIO<float> io{static_cast<const float*>(gin), sin, static_cast<float*>(gout),
                             sout, static_cast<float*>(work0), static_cast<float*>(work1),
                             steps, target};
  if (cluster)
    return multigen_cluster_launch(io, mparams, dr, geo, sel, mutate, obj, elitism, draw_steps,
                                   islands, ablate, st);
  if (cross_kind)
    return dispatch_multigen_ablate(ablate, [&](auto tag) {
      return launch_with_smem(multigen_one_block<true, float, decltype(tag)::value>(),
                              dim3(S, islands), MG_THREADS,
                              mg_rows_bytes(W) + mg_walk_bytes(W, L, MG_THREADS), st, io,
                              mparams, dr, geo, sel, mutate, obj, elitism, draw_steps);
    });
  return dispatch_multigen_ablate(ablate, [&](auto tag) {
    return launch_with_smem(multigen_one_block<false, float, decltype(tag)::value>(),
                            dim3(S, islands), MG_THREADS, (size_t)W * MG_ROW_BYTES, st, io,
                            mparams, dr, geo, sel, mutate, obj, elitism, draw_steps);
  });
}
