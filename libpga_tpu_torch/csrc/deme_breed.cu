// deme_breed.cu: the fused deme breed on Hopper, in four kernels:
// deme_breed_kernel (one generation, uniform crossover), order_breed_kernel
// (one generation, order crossover and the fused TSP score),
// multigen_breed_kernel (up to T generations per launch with the ranks
// computed inside the kernel; uniform or order crossover) and, at the end of
// this file, deme_pipelined_kernel (deme_breed_kernel's function on a
// persistent grid that stages each deme's parents in shared memory, for the
// sub-block pipeline's geometries).
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
// crossover. The instantiated masks are 0, ABL_COPY, each stage bit alone
// and all four stage bits (the floor) in deme_breed_kernel; the same but the
// copy in order_breed_kernel; and 0, each of the six multigen and stage bits
// alone and the floor in multigen_breed_kernel, uniform (both gene types) and
// order crossover. Other combinations are ROADMAP Queue B item B10's. Bound
// of the copy: the production bound, Pp*L*bytes read and written (0.253 ms
// at 1,048,576x100 float32, 0.0097 ms at 40,000x100), plus the handed scores
// when scored; the harness reads the copy beside it.
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
// stream) and the same injected draws. Only the schedule differs.
//
// Why a schedule of its own. On the TPU B > 1 shrinks the grid B-fold to cut a
// per-step dispatch cost; on the H100 no cost of a block shows (the floor
// harness's fixed-warps sweep, PERF.md), and deme_breed_kernel's time above its
// copy is the breed's own work, each parent gene fetched from L2 or device
// memory once per selection. What B8 still means here is the overlap: stage a
// deme's parents in shared memory ahead of its breed, so that the breed reads
// no device memory and the loads of the next stage run under the breed of this
// one.
//
// Design. A persistent grid sized to the card: blocks_per_SM x SMs blocks (the
// occupancy API) shared by the islands, blockIdx.y the island; block j of an
// island walks the contiguous run of demes [j*G/nb, (j+1)*G/nb) in deme order,
// which is sub-block order. A deme's K rows of L genes do not fit twice in a
// block's shared memory at float32 (K = 512, L = 100: 204,800 B a deme, 227 KB
// a block), so a deme is staged in gene slabs: slab s holds genes [s*SG,
// s*SG + len) of all K parent rows, and a short last slab that lies in the
// same 128-gene tile as the one before is merged into it (slab_plan; at
// L = 100 float32, SG = 32: slabs of 32, 32 and 36 genes). The block works
// through (deme, slab) items with two slab buffers: while its warps breed item
// n from one buffer, cp.async brings item n + 1 (the deme's next slab, or slab
// 0 of the next deme with that deme's K ranks) into the other;
// cp.async.wait_group 1 and a block barrier open each item, a barrier closes
// it. A warp breeds PIPE_GROUPS = 4 children of a slab at once, PIPE_LANES = 8
// lanes each over the slab's genes, the same lanes for a child across its
// deme's slabs: a parent gene comes from shared memory, the child gene goes to
// its write row in device memory. Four children a warp share each instruction
// of the per-child work a slab repeats (its state, its crossover word, the
// score's group sum), which a warp per child paid four times; at L = 100 that
// work, not the loads, set the time. What a child carries across slabs sits in shared
// memory (PipeChild, 52 B): its parent slots and write row, its mutation
// draws, the crossover words of the current 128-gene tile and its score sums
// so far.
// Slab 0 draws them, the calls deme_breed_kernel makes (child_rand's, here
// by the first three lanes of the child's group), after the block has
// inverted the staged ranks into row_of_rank and counted the deme's alive
// rows. A score is the sum over slabs of each slab's group sum,
// so it may differ from deme_breed_kernel's in the last bits (both stay within
// the chip check's SCORE_ATOL of the plain version's torch.sum); swap mutation
// exchanges the two genes in device memory after the last slab and sums the
// child again, as breed_genes does.
//
// Shared memory at K = 512, L = 100 float32: slab rows of 144 B (the merged
// 36-gene slab) x 512 rows x 2 buffers = 147,456 B, the staged ranks 2 x 2,048,
// row_of_rank 2,048, PipeChild 512 x 52 = 26,624: 180,224 B, so one block an
// SM. bf16 (SG = 64, slabs of 64 and 36 genes): rows of 128 B, 131,072 +
// 32,768 = 163,840 B. The launcher takes the widest SG of 128, 64, 32, 16, 8
// genes whose layout fits a block (pipe_plan), and sizes the grid by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor. The block has 32 warps (64
// registers a thread, so an SM holds no more): the time is the warps'
// per-child work, whose latency more warps hide. On the card 32 warps a block
// ran faster than 16, narrower slabs slower (each slab repeats a child's
// per-slab work), and 8 lanes a child faster than 32, 16 or 4 at L = 100.
//
// Alignment. cp.async copies 16 B where a row's bytes (L x gene bytes) are a
// multiple of 16 (float32 at L = 100: 400 B rows), else 8 or 4 B: a bf16 row
// of L = 100 is 200 B, so odd rows are only 8-byte aligned and take 8-byte
// copies (the genome layout is not changed). A bf16 row of odd L is 2-byte
// aligned and is staged by plain loads and stores. Slab starts are multiples
// of 16 bytes, so every chunk is aligned.
//
// Bound. deme_breed_kernel's bytes: the population read once and written once,
// the ranks read and the scores written (0.2529 ms at 1,048,576x100 float32,
// 0.1277 ms bf16, at 3.35 TB/s). Here each parent byte is read from device
// memory once, by the staging; the children's stores and the per-child work
// of each slab (the draws, the gather from shared memory, a group sum) are what
// remains beside it.

constexpr int PIPE_THREADS = 1024;  // 32 warps a block
constexpr int PIPE_LANES = 8;       // lanes a child in a slab
constexpr int PIPE_GROUPS = 32 / PIPE_LANES;  // children a warp breeds at once
constexpr size_t PIPE_SMEM_LIMIT = 232448 - 1024;  // a block's, beside the static arrays

// The sum of v over the PIPE_LANES lanes of this lane's group, on each of them.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = PIPE_LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// What a child carries across the slabs of its deme.
struct PipeChild {
  int s1, s2, orow;  // its parents' slots; its write row
  int pos, pj;       // the point / swap mutation's gene positions
  float mu2, a, b;   // point mutation's value; the score's sums so far
  int fire;          // the mutation fires
  uint32_t w[4];     // the crossover words of the current 128-gene tile
};

// The gene slabs of a row of L genes: SG genes each from gene 0, the last one
// shorter; a last slab under SG / 2 genes is merged into the one before where
// both lie in one 128-gene tile. SG divides 128, so no slab crosses a tile.
struct SlabPlan {
  int SG, n, last;  // slab width, slab count, width of the last slab
  __host__ __device__ int base(int s) const { return s * SG; }
  __host__ __device__ int len(int s) const { return s == n - 1 ? last : SG; }
  __host__ __device__ int widest() const { return n == 1 || last > SG ? last : SG; }
};

__host__ __device__ inline SlabPlan slab_plan(int L, int SG) {
  SlabPlan p{SG, (L + SG - 1) / SG, 0};
  p.last = L - (p.n - 1) * SG;
  if (p.n > 1 && 2 * p.last < SG && ((p.n - 2) * SG) / 128 == (L - 1) / 128) {
    p.n -= 1;
    p.last += SG;
  }
  return p;
}

// Byte offsets of the dynamic shared memory: the two slab buffers (K rows of
// row_bytes each) from 0, the two staged rank rows, row_of_rank, the children.
struct PipeLayout {
  size_t ranks, ror, kids, total;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline PipeLayout pipe_layout(int K, int row_bytes) {
  PipeLayout y;
  y.ranks = 2 * (size_t)K * row_bytes;
  y.ror = y.ranks + round16(2 * (size_t)K * 4);
  y.kids = y.ror + round16((size_t)K * 4);
  y.total = y.kids + (size_t)K * sizeof(PipeChild);
  return y;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issues the copies of slab s of deme g's K parent rows into `buf` (row k at
// k * row_bytes), `cw` bytes a copy (0: plain 2-byte copies), and for slab 0
// the deme's K ranks into `rk`.
template <class Gene>
__device__ __forceinline__ void pipe_stage(const Gene* gin, const int* ranks, const Geometry& geo,
                                           const SlabPlan& plan, int g, int s, unsigned char* buf,
                                           int row_bytes, int* rk, int cw) {
  const int K = geo.K, tid = threadIdx.x, nthr = blockDim.x;
  const size_t row_len = (size_t)geo.L * sizeof(Gene);
  const int off = plan.base(s) * (int)sizeof(Gene), bytes = plan.len(s) * (int)sizeof(Gene);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(gin) + off;
  const int unit = cw ? cw : 2, per_row = bytes / unit;
  for (int x = tid; x < K * per_row; x += nthr) {
    const int k = x / per_row, c = (x - k * per_row) * unit;
    const unsigned char* from = src + (size_t)read_row(geo, g, k) * row_len + c;
    unsigned char* to = buf + (size_t)k * row_bytes + c;
    if (cw) {
      cp_async(to, from, cw);
    } else {
      *reinterpret_cast<unsigned short*>(to) = *reinterpret_cast<const unsigned short*>(from);
    }
  }
  if (s == 0)
    for (int x = tid; x < K / 4; x += nthr) cp_async(rk + 4 * x, ranks + (size_t)g * K + 4 * x, 16);
}

template <class Gene>
__global__ void __launch_bounds__(PIPE_THREADS) deme_pipelined_kernel(
    const Gene* __restrict__ gin, Gene* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr0, Geometry geo,
    Selection sel, int mutate, int obj, SlabPlan plan, int row_bytes, int cw) {
  extern __shared__ __align__(16) unsigned char pipe_smem[];
  __shared__ int s_alive[32];
  const int K = geo.K, L = geo.L, G = geo.G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  gin = island_slice(gin, (size_t)geo.Pp * L);
  gout = island_slice(gout, (size_t)geo.Pp * L);
  sout = island_slice(sout, (size_t)geo.Pp);
  ranks = island_slice(ranks, (size_t)G * K);
  const Draws dr = island_draws(dr0, geo, 1);
  const BreedCtx cx = breed_ctx(dr, mparams, geo, mutate, obj);
  const PipeLayout lay = pipe_layout(K, row_bytes);
  int* rks = reinterpret_cast<int*>(pipe_smem + lay.ranks);
  int* row_of_rank = reinterpret_cast<int*>(pipe_smem + lay.ror);
  PipeChild* kids = reinterpret_cast<PipeChild*>(pipe_smem + lay.kids);
  const size_t buf_bytes = (size_t)K * row_bytes;

  const int g0 = (int)((long long)blockIdx.x * G / gridDim.x);
  const int g1 = (int)((long long)(blockIdx.x + 1) * G / gridDim.x);
  const int items = (g1 - g0) * plan.n;
  auto stage = [&](int n) {
    const int d = n / plan.n;
    pipe_stage(gin, ranks, geo, plan, g0 + d, n - d * plan.n, pipe_smem + (n & 1) * buf_bytes,
               row_bytes, rks + (d & 1) * K, cw);
  };
  if (items > 0) stage(0);
  cp_async_commit();
  float V = 1.0f;
  for (int n = 0; n < items; ++n) {
    if (n + 1 < items) stage(n + 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int d = n / plan.n, s = n - d * plan.n, g = g0 + d;
    const unsigned char* buf = pipe_smem + (n & 1) * buf_bytes;
    if (s == 0) {
      // The deme's ranks inverted, and its alive rows counted.
      const int* rk = rks + (d & 1) * K;
      int alive = 0;
      for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const int r = rk[k];
        if (r >= 0 && r < K) row_of_rank[r] = k;
        alive += read_row(geo, g, k) < geo.P;
      }
      alive = warp_sum(alive);
      if (lane == 0) s_alive[warp] = alive;
      __syncthreads();
      int v = 0;
      for (int w = 0; w < nwarps; ++w) v += s_alive[w];
      V = (float)max(v, 1);
    }
    const int base = plan.base(s), len = plan.len(s);
    const bool last = s == plan.n - 1, tile_start = (base & 127) == 0;
    // PIPE_GROUPS children a warp at once, PIPE_LANES lanes each: lane group h
    // breeds child k, its sub-lane j0 the slab's genes j0, j0 + PIPE_LANES, ...
    const int h = lane / PIPE_LANES, j0 = lane % PIPE_LANES, lead = h * PIPE_LANES;
    for (int k0 = warp * PIPE_GROUPS; k0 < K; k0 += nwarps * PIPE_GROUPS) {
      const int k = k0 + h;
      PipeChild& st = kids[k];
      const size_t child = (size_t)g * K + k;
      int s1, s2, orow, pos, pj;
      float mu2, a0 = 0.0f, b0 = 0.0f;
      bool fire;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (s == 0) {
        // child_rand's draws for the group's child: sub-lane c computes
        // Philox call c (0 selection, 1 mutation, 2 the first crossover tile).
        float su0, su1, mu0, mu1;
        if (cx.philox_mode) {
          if (j0 < 3) w = philox(cx.k0, cx.k1, make_uint4(k, g, j0, 0u));
          su0 = to_uniform(__shfl_sync(FULL, w.x, lead));
          su1 = to_uniform(__shfl_sync(FULL, w.y, lead));
          mu0 = to_uniform(__shfl_sync(FULL, w.x, lead + 1));
          mu1 = to_uniform(__shfl_sync(FULL, w.y, lead + 1));
          mu2 = to_uniform(__shfl_sync(FULL, w.z, lead + 1));
          w = make_uint4(__shfl_sync(FULL, w.x, lead + STREAM_CROSS),
                         __shfl_sync(FULL, w.y, lead + STREAM_CROSS),
                         __shfl_sync(FULL, w.z, lead + STREAM_CROSS),
                         __shfl_sync(FULL, w.w, lead + STREAM_CROSS));
        } else {
          su0 = dr.sel_u[child * 2];
          su1 = dr.sel_u[child * 2 + 1];
          mu0 = dr.mut_u[child * 4];
          mu1 = dr.mut_u[child * 4 + 1];
          mu2 = dr.mut_u[child * 4 + 2];
        }
        const int r1 = winner_rank(winner_fraction(sel, su0), V);
        const int r2 = winner_rank(winner_fraction(sel, su1), V);
        s1 = min(max(row_of_rank[r1], 0), K - 1);
        s2 = min(max(row_of_rank[r2], 0), K - 1);
        orow = write_row(geo, g, k);
        pos = (int)floorf(mu0 * (float)L);
        pj = (int)floorf(mu1 * (float)L);
        fire = mutate == MUT_SWAP ? mu2 < cx.rate : mu1 < cx.rate;
      } else {
        s1 = st.s1;
        s2 = st.s2;
        orow = st.orow;
        pos = st.pos;
        pj = st.pj;
        mu2 = st.mu2;
        fire = st.fire != 0;
        a0 = st.a;
        if (obj == OBJ_ACKLEY) b0 = st.b;
        if (cx.philox_mode)
          w = tile_start ? philox(cx.k0, cx.k1, make_uint4(k, g, STREAM_CROSS + (base >> 7), 0u))
                         : make_uint4(st.w[0], st.w[1], st.w[2], st.w[3]);
      }

      // Cross, mutate, round, store and sum this slab's genes of child k.
      const Gene* p1 = reinterpret_cast<const Gene*>(buf + (size_t)s1 * row_bytes);
      const Gene* p2 = reinterpret_cast<const Gene*>(buf + (size_t)s2 * row_bytes);
      Gene* out = gout + (size_t)orow * L;
      float a = 0.0f, b = 0.0f;
      for (int j = j0; j < len; j += PIPE_LANES) {
        const int l = base + j;
        uint32_t bit;
        if (cx.philox_mode) {
          const int wi = (l >> 5) & 3;
          bit = ((wi == 0 ? w.x : wi == 1 ? w.y : wi == 2 ? w.z : w.w) >> (l & 31)) & 1u;
        } else {
          bit = dr.cross[child * L + l];
        }
        float c = load_gene<false>((bit ? p2 : p1) + j);
        if (mutate == MUT_POINT) {
          if (fire && l == pos) c = mu2;
        } else if (mutate == MUT_GAUSSIAN) {
          c = gauss_mutate(cx, dr, c, k, g, 0u, l, child, true);
        }
        c = round_gene<Gene>(c);
        store_gene(out + l, c);
        obj_add(obj, c, a, b);
      }
      if (obj != OBJ_NONE) a = a0 + group_sum(a);
      if (obj == OBJ_ACKLEY) b = b0 + group_sum(b);  // its cosine sum; no other has a second
      if (!last) {
        if (j0 == 0) {
          if (s == 0) {
            st.s1 = s1;
            st.s2 = s2;
            st.orow = orow;
            st.pos = pos;
            st.pj = pj;
            st.mu2 = mu2;
            st.fire = fire;
          }
          st.a = a;
          if (obj == OBJ_ACKLEY) st.b = b;
          if (s == 0 || tile_start) {
            st.w[0] = w.x;
            st.w[1] = w.y;
            st.w[2] = w.z;
            st.w[3] = w.w;
          }
        }
        continue;
      }
      if (mutate == MUT_SWAP) {
        const bool swap = fire && pos < L && pj < L;
        __syncwarp();
        if (swap && j0 == 0) {
          const Gene x = out[pos], y = out[pj];
          out[pos] = y;
          out[pj] = x;
        }
        __syncwarp();
        if (obj != OBJ_NONE) {
          // The score is of the child as written: sum again after the swap.
          float a2 = 0.0f, b2 = 0.0f;
          if (swap)
            for (int l = j0; l < L; l += PIPE_LANES) obj_add(obj, load_gene<false>(out + l), a2, b2);
          a2 = group_sum(a2);
          if (obj == OBJ_ACKLEY) b2 = group_sum(b2);
          if (swap) {
            a = a2;
            b = b2;
          }
        }
      }
      if (obj != OBJ_NONE && j0 == 0)
        sout[orow] = orow < geo.P ? obj_finish(obj, a, b, L) : -INFINITY;
    }
    __syncthreads();
  }
}


// The ABLATE cases each kernel is built in, beside 0 (production). A launch
// with another mask fails with cudaErrorInvalidValue; ops/kernels.py keeps the
// same lists (ABLATE_DEME_MASKS, ABLATE_ORDER_MASKS, ABLATE_MULTIGEN_MASKS) and
// refuses first.
constexpr unsigned ABL_FLOOR = ABL_STAGES;  // every stage off: the harness's floor

template <class F>
int dispatch_deme_ablate(unsigned ablate, F launch) {
  switch (ablate) {
    case 0u: return launch(std::integral_constant<unsigned, 0u>{});
    case ABL_COPY: return launch(std::integral_constant<unsigned, ABL_COPY>{});
    case ABL_SEL_CONST: return launch(std::integral_constant<unsigned, ABL_SEL_CONST>{});
    case ABL_NO_GATHER: return launch(std::integral_constant<unsigned, ABL_NO_GATHER>{});
    case ABL_NO_CROSS: return launch(std::integral_constant<unsigned, ABL_NO_CROSS>{});
    case ABL_NO_MUT: return launch(std::integral_constant<unsigned, ABL_NO_MUT>{});
    case ABL_FLOOR: return launch(std::integral_constant<unsigned, ABL_FLOOR>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class F>
int dispatch_order_ablate(unsigned ablate, F launch) {
  switch (ablate) {
    case 0u: return launch(std::integral_constant<unsigned, 0u>{});
    case ABL_SEL_CONST: return launch(std::integral_constant<unsigned, ABL_SEL_CONST>{});
    case ABL_NO_GATHER: return launch(std::integral_constant<unsigned, ABL_NO_GATHER>{});
    case ABL_NO_CROSS: return launch(std::integral_constant<unsigned, ABL_NO_CROSS>{});
    case ABL_NO_MUT: return launch(std::integral_constant<unsigned, ABL_NO_MUT>{});
    case ABL_FLOOR: return launch(std::integral_constant<unsigned, ABL_FLOOR>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class F>
int dispatch_multigen_ablate(unsigned ablate, F launch) {
  switch (ablate) {
    case 0u: return launch(std::integral_constant<unsigned, 0u>{});
    case ABL_NO_FREEZE: return launch(std::integral_constant<unsigned, ABL_NO_FREEZE>{});
    case ABL_NO_RANK_CUBE: return launch(std::integral_constant<unsigned, ABL_NO_RANK_CUBE>{});
    case ABL_SEL_CONST: return launch(std::integral_constant<unsigned, ABL_SEL_CONST>{});
    case ABL_NO_GATHER: return launch(std::integral_constant<unsigned, ABL_NO_GATHER>{});
    case ABL_NO_CROSS: return launch(std::integral_constant<unsigned, ABL_NO_CROSS>{});
    case ABL_NO_MUT: return launch(std::integral_constant<unsigned, ABL_NO_MUT>{});
    case ABL_FLOOR: return launch(std::integral_constant<unsigned, ABL_FLOOR>{});
    default: return (int)cudaErrorInvalidValue;
  }
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

// The slab plan, staged row bytes and dynamic shared memory of a pipelined
// launch: the widest slab of 128, 64, 32, 16 or 8 genes whose layout fits a
// block. Returns the shared-memory bytes, 0 where none fits.
inline size_t pipe_plan(int K, int L, int gene_bytes, SlabPlan& plan, int& row_bytes) {
  for (int sg = 128; sg >= 8; sg >>= 1) {
    plan = slab_plan(L, sg);
    row_bytes = (int)round16((size_t)plan.widest() * gene_bytes);
    const size_t smem = pipe_layout(K, row_bytes).total;
    if (smem <= PIPE_SMEM_LIMIT) return smem;
  }
  return 0;
}

template <class Gene>
int pipelined_launch(const void* gin, void* gout, float* sout, const int* ranks,
                     const float* mparams, const Draws& dr, const Geometry& geo,
                     const Selection& sel, int mutate, int obj, int islands, cudaStream_t stream) {
  SlabPlan plan;
  int row_bytes;
  const size_t smem = pipe_plan(geo.K, geo.L, sizeof(Gene), plan, row_bytes);
  if (!smem) return (int)cudaErrorInvalidValue;
  const int rb = geo.L * (int)sizeof(Gene);
  const int cw = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : rb % 4 == 0 ? 4 : 0;
  auto kernel = deme_pipelined_kernel<Gene>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PIPE_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int fill = per_sm * sms / islands;
  const int blocks = fill < 1 ? 1 : fill < geo.G ? fill : geo.G;
  kernel<<<dim3(blocks, islands), PIPE_THREADS, smem, stream>>>(
      static_cast<const Gene*>(gin), static_cast<Gene*>(gout), sout, ranks, mparams, dr, geo, sel,
      mutate, obj, plan, row_bytes, cw);
  return (int)cudaGetLastError();
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
// launches it where the ping-pong sub-block depth B is above 1). K must be a
// multiple of 4, and gin and ranks 16-byte aligned (the staging's copies).
extern "C" int deme_pipelined_launch(
    const void* gin, void* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const unsigned char* cross, const float* mut_u, const float* gauss,
    const long long* seed, int P, int Pp, int L, int K, int G, int mode, int S, int D, int q,
    int B, int sel_kind, int tk, float sel_param, int mutate, int obj, int islands,
    int gene_dtype, void* stream) {
  if (K % 4 || B < 1 || islands < 1 || islands > 65535) return (int)cudaErrorInvalidValue;
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q, B};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed};
  const cudaStream_t st = (cudaStream_t)stream;
  if (gene_dtype == GENE_BF16)
    return pipelined_launch<__nv_bfloat16>(gin, gout, sout, ranks, mparams, dr, geo, sel, mutate,
                                           obj, islands, st);
  if (gene_dtype == GENE_F32)
    return pipelined_launch<float>(gin, gout, sout, ranks, mparams, dr, geo, sel, mutate, obj,
                                   islands, st);
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
    int obj, int elitism, int draw_steps, int islands, int gene_dtype, unsigned ablate,
    void* stream) {
  if (D < 1 || D > MG_MAX_D || (cross_kind && D != 1)) return (int)cudaErrorInvalidValue;
  if ((gene_dtype != GENE_F32 && gene_dtype != GENE_BF16) || (cross_kind && gene_dtype != GENE_F32))
    return (int)cudaErrorInvalidValue;
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q, 1};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed, tie, fill};
  // Keys, scores, row_of_rank and alive flags of the group's D*K rows, then
  // (order crossover) the walkers' visited bitmasks.
  const int W = D * K;
  if (gene_dtype == GENE_BF16) {
    using B = __nv_bfloat16;
    const MultigenIO<B> io{static_cast<const B*>(gin), sin, static_cast<B*>(gout), sout,
                           static_cast<B*>(work0), static_cast<B*>(work1), steps, target};
    return dispatch_multigen_ablate(ablate, [&](auto tag) {
      return launch_with_smem(multigen_breed_kernel<false, B, decltype(tag)::value>,
                              dim3(S, islands), MG_THREADS, (size_t)W * MG_ROW_BYTES,
                              (cudaStream_t)stream, io, mparams, dr, geo, sel, mutate, obj,
                              elitism, draw_steps);
    });
  }
  const MultigenIO<float> io{static_cast<const float*>(gin), sin, static_cast<float*>(gout),
                             sout, static_cast<float*>(work0), static_cast<float*>(work1),
                             steps, target};
  if (cross_kind)
    return dispatch_multigen_ablate(ablate, [&](auto tag) {
      return launch_with_smem(multigen_breed_kernel<true, float, decltype(tag)::value>,
                              dim3(S, islands), MG_THREADS,
                              mg_rows_bytes(W) + mg_walk_bytes(W, L, MG_THREADS),
                              (cudaStream_t)stream, io, mparams, dr, geo, sel, mutate, obj,
                              elitism, draw_steps);
    });
  return dispatch_multigen_ablate(ablate, [&](auto tag) {
    return launch_with_smem(multigen_breed_kernel<false, float, decltype(tag)::value>,
                            dim3(S, islands), MG_THREADS, (size_t)W * MG_ROW_BYTES,
                            (cudaStream_t)stream, io, mparams, dr, geo, sel, mutate, obj,
                            elitism, draw_steps);
  });
}
