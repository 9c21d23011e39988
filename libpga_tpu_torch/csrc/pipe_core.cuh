// pipe_core.cuh: what the pipelined breeds share (the sub-block pipeline's
// deme_pipelined_kernel of deme_breed.cu and the expression breed's
// expr_pipelined_kernel of expr_breed.cu): the lane layout (8 lanes a
// child, four children a warp, 16 warps a block), the score sums in
// warp_sum's order, the out-of-line gaussian mutation and objective terms,
// the 16- and 8-byte gene loads and stores, a deme's row maps in closed
// form, the TMA staging of a deme, the deme loop of a block (pipe_demes)
// and the launch of a persistent grid of clusters (pipe_launch).
// deme_breed.cu ("deme_pipelined_kernel") describes the schedule and why.

#pragma once

#include <cooperative_groups.h>

#include "breed_core.cuh"
#include "pipe_plan.cuh"

namespace {

constexpr int PIPE_LANES = 8;   // lanes a child
constexpr int PIPE_WARPS = 16;  // warps a block: 128 registers a thread, none spilled
constexpr int PIPE_THREADS = 32 * PIPE_WARPS;
constexpr int PIPE_KIDS = 32 / PIPE_LANES;  // children a warp breeds at once
constexpr int PIPE_LOADS = 4;               // genes a lane has in flight

// warp_sum of a child's terms from its lane group's partials, one gene a lane:
// v[m] is the sum of warp-lane position j + 8*m (j the sub-lane). The
// butterfly's steps 16 and 8 pair partials inside the lane, 4, 2 and 1 the
// group's lanes; every lane of the group gets the sum.
__device__ __forceinline__ float pipe_sum(const float (&v)[4]) {
  float s = (v[0] + v[2]) + (v[1] + v[3]);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// The same, four genes a lane: on the group's first eight lanes v[i] is the
// sum of warp-lane position 4*j + i (j the sub-lane). Steps 16, 8 and 4 pair
// those lanes (j ^ 4, j ^ 2, j ^ 1), steps 2 and 1 pair the lane's own
// partials. The sum is on the group's first eight lanes.
__device__ __forceinline__ float pipe_sum4(const float (&v)[4]) {
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = v[i];
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) x[i] = x[i] + __shfl_xor_sync(FULL, x[i], o);
  }
  return (x[0] + x[2]) + (x[1] + x[3]);
}

// Out of the breed's loop, so that its registers stay the point mutation's
// and onemax's: gaussian mutation of gene l (gauss_mutate), and a gene's
// terms of the other objectives, (a's, b's), which obj_add adds.
__device__ __noinline__ float pipe_gauss(BreedCtx cx, Draws dr, float x, int k, int g, int l,
                                         size_t child) {
  return gauss_mutate(cx, dr, x, k, g, 0u, l, child, true);
}

// The same in sub-generation t, for the children of the multi-generation
// cluster schedule (deme_breed.cu's builtin child, expr_breed.cu's
// expr_child8, which also breeds expr_pipelined_kernel's children at t = 0).
__device__ __noinline__ float mg_gauss(BreedCtx cx, Draws dr, float x, int k, int g, uint32_t t,
                                       int l, size_t child) {
  return gauss_mutate(cx, dr, x, k, g, t, l, child, true);
}

__device__ __noinline__ float2 pipe_terms(int obj, float c) {
  float a = 0.0f, b = 0.0f;
  if (obj == OBJ_ONEMAX_BITS) {
    a = c >= 0.5f ? 1.0f : 0.0f;
  } else if (obj == OBJ_SPHERE) {
    const float x = -5.12f + c * 10.24f;
    a = x * x;
  } else if (obj == OBJ_RASTRIGIN) {
    const float x = -5.12f + c * 10.24f;
    a = x * x - 10.0f * cosf(TWO_PI * x);
  } else if (obj == OBJ_ACKLEY) {
    const float x = -32.768f + c * 65.536f;
    a = x * x;
    b = cosf(TWO_PI * x);
  } else {
    a = c;
  }
  return make_float2(a, b);
}

// Four consecutive genes as float, from a 16-byte (float) or 8-byte (bf16)
// aligned address; and four genes, already rounded to the gene type, stored
// there.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2((__float_as_uint(x[0]) >> 16) | (__float_as_uint(x[1]) & 0xffff0000u),
                 (__float_as_uint(x[2]) >> 16) | (__float_as_uint(x[3]) & 0xffff0000u));
}

// A deme's row map in closed form (read_row / write_row of breed_core.cuh
// for one deme, with the quantum q = 2^shift a power of two): slot or child
// k's physical row is base + (k >> shift) * stride + (k & mask). Ping-pong
// moves runs of q rows; the riffle and the contiguous map single rows.
struct RowMap {
  int base, stride, shift, mask;
  __device__ __forceinline__ int operator()(int k) const {
    return base + (k >> shift) * stride + (k & mask);
  }
};

// The rows deme g reads (read_row): consecutive, but at parity 1 runs of q
// at stride S*q.
__device__ __forceinline__ RowMap read_map(const Geometry& geo, int g, int qs) {
  if (geo.mode != MODE_PP1) return RowMap{g * geo.K, 1, 0, 0};
  const int BD = geo.B * geo.D;
  return RowMap{(g % BD) * (geo.K >> qs) * geo.S * geo.q + (g / BD) * geo.q, geo.S * geo.q, qs,
                geo.q - 1};
}

// The rows deme g's children are written to (write_row).
__device__ __forceinline__ RowMap write_map(const Geometry& geo, int g, int qs) {
  if (geo.mode == MODE_RIFFLE) return RowMap{g, geo.G, 0, 0};
  if (geo.mode == MODE_CONTIG) return RowMap{g * geo.K, 1, 0, 0};
  const int BD = geo.B * geo.D, i = g / BD, b = (g % BD) / geo.D, d = (g % BD) % geo.D;
  if (geo.mode == MODE_PP0)
    return RowMap{i * BD * geo.K + b * geo.D * geo.K + d * geo.q, geo.D * geo.q, qs, geo.q - 1};
  return RowMap{(b * geo.D * (geo.K >> qs) + d) * geo.S * geo.q + i * geo.q,
                geo.D * geo.S * geo.q, qs, geo.q - 1};
}

// Warp 0 stages slots [c*R, (c+1)*R) of deme g (rows `rd`) and the deme's K
// ranks into buffer b: one bulk copy a run of contiguous rows (the whole
// slot range, or at parity 1 runs of q, one a lane) and one for the ranks,
// all completing on the buffer's barrier.
template <class Gene>
__device__ __forceinline__ void stage_deme(const Gene* gin, const int* ranks, const Geometry& geo,
                                           const PipePlan& plan, unsigned char* smem,
                                           uint64_t* full, const RowMap& rd, int g, int b, int c,
                                           int lane) {
  const int R = plan.rows, run = rd.shift ? rd.mask + 1 : R;
  const size_t row_bytes = (size_t)geo.L * sizeof(Gene), kb = (plan.ror - plan.ranks) / 2;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(gin);
  unsigned char* buf = smem + b * plan.buf;
  if (lane == 0) mbar_expect(&full[b], (unsigned)(R * row_bytes + (size_t)geo.K * 4));
  __syncwarp();
  for (int u = lane * run; u < R; u += 32 * run)
    bulk_load(buf + u * row_bytes, src + (size_t)rd(c * R + u) * row_bytes,
              (unsigned)(run * row_bytes), &full[b]);
  if (lane == 0)
    bulk_load(smem + plan.ranks + b * kb, ranks + (size_t)g * geo.K, (unsigned)(geo.K * 4),
              &full[b]);
}

static_assert(PIPE_WARPS * PIPE_KIDS == PIPE_CHILDREN, "pipe_plan.cuh's children in flight");

// The schedule of a pipelined breed (deme_pipelined_kernel's): block c of a
// cluster of plan.C stages slots [c*R, (c+1)*R) of each deme of its
// cluster's run of the G demes, the next deme by TMA while this one breeds;
// it inverts the deme's K ranks into row_of_rank and counts the deme's alive
// rows, and after one cluster barrier a deme calls breed(g, staged,
// row_of_rank, V, wr): deme g's slots of this block at staged (row s % R is
// slot s of block s / R of the cluster), V its valid count, wr its write
// map. gin and ranks are the island's. `smem` holds plan.smem bytes
// (pipe_plan.cuh's layout). Ends with a cluster barrier: no block leaves
// while a peer may still read its buffers.
template <class Gene, class Breed>
__device__ __forceinline__ void pipe_demes(const Gene* gin, const int* ranks, const Geometry& geo,
                                           const PipePlan& plan, unsigned char* smem,
                                           Breed& breed) {
  namespace cg = cooperative_groups;
  __shared__ int s_alive[2][PIPE_WARPS];
  const cg::cluster_group cluster = cg::this_cluster();
  const int K = geo.K, G = geo.G, C = plan.C;
  const int c = (int)cluster.block_rank();
  const int qs = __ffs(geo.q) - 1;  // a power of two (pipe_plan)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t kb = (plan.ror - plan.ranks) / 2;  // a rank row's (or row_of_rank's) bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bars);
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
    stage_deme(gin, ranks, geo, plan, smem, full, read_map(geo, g0, qs), g0, 0, c, lane);
  for (int n = 0; n < nd; ++n) {
    const int g = g0 + n, b = n & 1;
    mbar_wait(&full[b], (n >> 1) & 1);
    const int* rk = reinterpret_cast<const int*>(smem + plan.ranks + b * kb);
    int* row_of_rank = reinterpret_cast<int*>(smem + plan.ror + b * kb);
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
      stage_deme(gin, ranks, geo, plan, smem, full, read_map(geo, g + 1, qs), g + 1, b ^ 1, c,
                 lane);
    int v = 0;
    for (int w = 0; w < PIPE_WARPS; ++w) v += s_alive[b][w];
    breed(g, reinterpret_cast<const Gene*>(smem + b * plan.buf), row_of_rank, (float)max(v, 1),
          wr);
  }
  cluster.sync();
}

// Launches a pipelined breed `kernel` (PIPE_THREADS threads a block, `smem`
// bytes of dynamic shared memory) in clusters of C blocks, as many as the
// card holds at once (cluster_setup) and at most G an island, with
// blockIdx.y the island.
template <class... Params, class... Args>
int pipe_launch(void (*kernel)(Params...), int C, size_t smem, int G, int islands,
                cudaStream_t stream, Args... args) {
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(PIPE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int held = 0;
  cudaError_t e = cluster_setup(kernel, cfg, C, &held);
  if (e != cudaSuccess) return (int)e;
  if (held < 1) return (int)cudaErrorInvalidConfiguration;
  const int per = held / islands;
  const int nc = per < 1 ? 1 : per < G ? per : G;
  cfg.gridDim = dim3(nc * C, islands, 1);
  if ((e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...)) != cudaSuccess)
    return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
