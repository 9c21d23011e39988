// deme_breed.cu: one generation of the fused deme breed on Hopper, in two
// kernels: deme_breed_kernel (uniform crossover) and, at the end of this
// file, order_breed_kernel (order crossover and the fused TSP score).
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
// mutation, and for onemax / onemax_bits the child's score. Each child is
// written to the physical row its row map names:
//   mode 0/1 ping-pong parity 0/1: child chunk u of deme d of a group
//            lands at group chunk u*D + d (pingpong_child_rows);
//   mode 2   riffle: child k of deme g lands at row k*G + g.
// A deme's valid count V is the number of its read rows below P (the
// ping-pong alive-mask sum; the riffle's positional count). Pad rows
// rank last, so a rank < V never selects one; pad children score -inf.
//
// Randomness. Production mode: Philox4x32-10, key = the launch seed (one
// int64 on the card, drawn from the engine's torch.Generator), counter =
// (child k, deme g, stream, 0); stream 0 = selection, 1 = mutation,
// 2+t = crossover bits of genes [128t, 128t+128), 0x40000000+l = gaussian
// draws of gene l. Uniforms are (bits >> 8) * 2^-24. Injected mode reads
// the draw tensors the plain version consumes (seed == nullptr).
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
// around the run loop, several generations per launch) is later work.
//
// Built with --fmad=false so the float32 selection arithmetic is not
// contracted into multiply-adds and rounds as the torch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum { MODE_PP0 = 0, MODE_PP1 = 1, MODE_RIFFLE = 2 };
enum { SEL_TOURNAMENT = 0, SEL_TRUNCATION = 1, SEL_LINEAR_RANK = 2 };
enum { MUT_POINT = 0, MUT_GAUSSIAN = 1, MUT_SWAP = 2 };
enum { OBJ_NONE = 0, OBJ_ONEMAX = 1, OBJ_ONEMAX_BITS = 2, OBJ_TSP = 3 };

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t STREAM_SEL = 0u;
constexpr uint32_t STREAM_MUT = 1u;
constexpr uint32_t STREAM_CROSS = 2u;
constexpr uint32_t STREAM_FILL = 0x20000000u;
constexpr uint32_t STREAM_GAUSS = 0x40000000u;

struct Geometry {
  int P, Pp, L, K, G, mode, S, D, q;
};

struct Selection {
  int kind, tk;
  float param;
};

struct Draws {
  const float* sel_u;      // (G, K, 2)
  const uint8_t* cross;    // (G, K, L)
  const float* mut_u;      // (G, K, 4)
  const float* gauss;      // (3, G, K, L)
  const long long* seed;   // production mode when non-null
};

__device__ __forceinline__ uint4 philox(uint32_t k0, uint32_t k1, uint4 c) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return (float)(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// Physical row of read cohort slot k of deme g.
__device__ __forceinline__ int read_row(const Geometry& geo, int g, int k) {
  if (geo.mode != MODE_PP1) return g * geo.K + k;
  const int i = g / geo.D;
  const int x = (g % geo.D) * geo.K + k;
  return (x / geo.q) * geo.S * geo.q + i * geo.q + x % geo.q;
}

// Physical row child k of deme g is written to.
__device__ __forceinline__ int write_row(const Geometry& geo, int g, int k) {
  if (geo.mode == MODE_RIFFLE) return k * geo.G + g;
  const int i = g / geo.D, d = g % geo.D;
  const int x = ((k / geo.q) * geo.D + d) * geo.q + k % geo.q;
  if (geo.mode == MODE_PP0) return i * geo.D * geo.K + x;
  return (x / geo.q) * geo.S * geo.q + i * geo.q + x % geo.q;
}

// Winner rank fraction in [0, 1) (ops/select.py::winner_fraction).
__device__ __forceinline__ float winner_fraction(const Selection& sel, float u) {
  if (sel.kind == SEL_TRUNCATION) return u * sel.param;
  if (sel.kind == SEL_LINEAR_RANK) {
    const float s = sel.param;
    const float x =
        (s - sqrtf(fmaxf(s * s - 4.0f * (s - 1.0f) * u, 0.0f))) / (2.0f * (s - 1.0f));
    return fminf(fmaxf(x, 0.0f), 0.99999994f);  // 1 - 2^-24
  }
  if (sel.tk == 1) return u;
  if ((sel.tk & (sel.tk - 1)) == 0) {
    float t = 1.0f - u;
    for (int k = sel.tk; k > 1; k >>= 1) t = sqrtf(t);
    return 1.0f - t;
  }
  return 1.0f - expf(logf(1.0f - u) * (float)(1.0 / sel.tk));
}

__device__ __forceinline__ int winner_rank(float x, float V) {
  const float r = fminf(fmaxf(floorf(x * V), 0.0f), V - 1.0f);
  return (int)r;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS) deme_breed_kernel(
    const float* __restrict__ gin, float* __restrict__ gout, float* __restrict__ sout,
    const int* __restrict__ ranks, const float* __restrict__ mparams, Draws dr,
    Geometry geo, Selection sel, int mutate, int obj) {
  extern __shared__ int row_of_rank[];
  __shared__ int s_valid;
  const int g = blockIdx.x, K = geo.K, L = geo.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  const float rate = mparams[0], sigma = mparams[1];
  const bool philox_mode = dr.seed != nullptr;
  uint32_t k0 = 0, k1 = 0;
  if (philox_mode) {
    const unsigned long long s = (unsigned long long)dr.seed[0];
    k0 = (uint32_t)s;
    k1 = (uint32_t)(s >> 32);
  }
  const int ntiles = (L + 127) / 128;
  const int ncalls = 2 + ntiles;  // Philox calls per child
  const size_t plane = (size_t)geo.G * K * L;
  const float two_pi = 2.0f * 3.14159265358979323846f;
  const float u1_hi = (float)(1.0 - 1e-7);

  for (int k = warp; k < K; k += blockDim.x >> 5) {
    const size_t child = (size_t)g * K + k;
    // Round 0 of Philox calls: lane c computes call c (0 = selection,
    // 1 = mutation, 2+t = crossover tile t).
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (philox_mode && lane < ncalls) w = philox(k0, k1, make_uint4(k, g, lane, 0u));
    float su0, su1, mu0, mu1, mu2;
    if (philox_mode) {
      su0 = to_uniform(__shfl_sync(FULL, w.x, 0));
      su1 = to_uniform(__shfl_sync(FULL, w.y, 0));
      mu0 = to_uniform(__shfl_sync(FULL, w.x, 1));
      mu1 = to_uniform(__shfl_sync(FULL, w.y, 1));
      mu2 = to_uniform(__shfl_sync(FULL, w.z, 1));
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
    const float* p1 = gin + (size_t)read_row(geo, g, s1) * L;
    const float* p2 = gin + (size_t)read_row(geo, g, s2) * L;
    const int orow = write_row(geo, g, k);
    float* out = gout + (size_t)orow * L;

    // point: gene pos takes mu2 when mu1 < rate; swap: genes pi, pj
    // exchange when mu2 < rate.
    const int pos = (int)floorf(mu0 * (float)L);
    const int pj = (int)floorf(mu1 * (float)L);
    const bool fire = mutate == MUT_SWAP ? mu2 < rate : mu1 < rate;
    float acc = 0.0f;

    auto gene = [&](int l, uint32_t bit) {
      if (l >= L) return;
      float c = bit ? __ldg(p2 + l) : __ldg(p1 + l);
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
        u1 = fminf(fmaxf(u1, 1e-7f), u1_hi);
        const float normal = sqrtf(-2.0f * logf(u1)) * cosf(two_pi * u2);
        const float m = fminf(fmaxf(c + sigma * normal, 0.0f), u1_hi);
        if (gate < rate) c = m;
      }
      out[l] = c;
      acc += obj == OBJ_ONEMAX_BITS ? (c >= 0.5f ? 1.0f : 0.0f) : c;
    };

    if (philox_mode) {
      for (int base = 0; base < ncalls; base += 32) {
        if (base) {
          const uint32_t c = base + lane;
          w = c < (uint32_t)ncalls ? philox(k0, k1, make_uint4(k, g, c, 0u))
                                   : make_uint4(0u, 0u, 0u, 0u);
        }
        const int t_hi = min(base + 30, ntiles);
        for (int t = max(base - 2, 0); t < t_hi; ++t) {
          const int src = t + (int)STREAM_CROSS - base;
          const uint32_t b0 = __shfl_sync(FULL, w.x, src);
          const uint32_t b1 = __shfl_sync(FULL, w.y, src);
          const uint32_t b2 = __shfl_sync(FULL, w.z, src);
          const uint32_t b3 = __shfl_sync(FULL, w.w, src);
          gene(128 * t + lane, (b0 >> lane) & 1u);
          gene(128 * t + 32 + lane, (b1 >> lane) & 1u);
          gene(128 * t + 64 + lane, (b2 >> lane) & 1u);
          gene(128 * t + 96 + lane, (b3 >> lane) & 1u);
        }
      }
    } else {
      for (int l = lane; l < L; l += 32) gene(l, dr.cross[child * L + l]);
    }

    if (mutate == MUT_SWAP) {
      __syncwarp();
      if (lane == 0 && fire && pos < L && pj < L) {
        const float a = out[pos], b = out[pj];
        out[pos] = b;
        out[pj] = a;
      }
    }
    if (obj != OBJ_NONE) {
      acc = warp_sum(acc);
      if (lane == 0) sout[orow] = orow < geo.P ? acc : -INFINITY;
    }
  }
}


// ---------------------------------------------------------------------------
// order_breed_kernel: the TSP path's generation (B5).
//
// Replaces, in libpga_tpu/ops/pallas_step.py, _breed_kernel's order-crossover
// case: the order branch of _deme_child (:653-732; scratch _order_scratch_shapes,
// :403), its point / gaussian / swap mutation (:764-813), and the gene-major
// fused TSP scorer _tsp_eval_gene_major (:819-943), or a fused onemax /
// onemax_bits. Riffle row map only (order crossover pins D = 1 and is
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
// clamped to C-1; onemax / onemax_bits sum the child in l order.
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
// in shared memory as float2 and gathered exactly. Parent reads and child
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

constexpr int ORDER_THREADS = 64;  // children per block

struct OrderDraws {
  const float* sel_u;     // (G, K, 2)
  const float* fill;      // (G, K, L)
  const float* mut_u;     // (G, K, 4)
  const float* gauss;     // (3, G, K, L)
  const long long* seed;  // production mode when non-null
};

__device__ __forceinline__ int decode_city(float g, int L) {
  const int c = (int)floorf(g * (float)L);
  return min(max(c, 0), L - 1);
}

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
  const float two_pi = 2.0f * 3.14159265358979323846f;
  const float u1_hi = (float)(1.0 - 1e-7);

  for (int w = 0; w < W; ++w) vis[w * ORDER_THREADS] = 0u;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    const float a = __ldg(p1 + l), b = __ldg(p2 + l);
    const int c1 = decode_city(a, L), c2 = decode_city(b, L);
    unsigned* w1 = vis + (c1 >> 5) * ORDER_THREADS;
    unsigned* w2 = vis + (c2 >> 5) * ORDER_THREADS;
    const unsigned m1 = 1u << (c1 & 31), m2 = 1u << (c2 & 31);
    float c;
    if (!(*w1 & m1)) {
      c = a;
      *w1 |= m1;
    } else if (!(*w2 & m2)) {
      c = b;
      *w2 |= m2;
    } else if (philox_mode) {
      const uint4 z = philox(k0, k1, make_uint4(k, g, STREAM_FILL + (l >> 2), 0u));
      const int j = l & 3;
      c = to_uniform(j == 0 ? z.x : j == 1 ? z.y : j == 2 ? z.z : z.w);
    } else {
      c = dr.fill[child * L + l];
    }
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
      u1 = fminf(fmaxf(u1, 1e-7f), u1_hi);
      const float normal = sqrtf(-2.0f * logf(u1)) * cosf(two_pi * u2);
      const float m = fminf(fmaxf(c + sigma * normal, 0.0f), u1_hi);
      if (gate < rate) c = m;
    }
    out[l] = c;
  }
  if (mutate == MUT_SWAP && fire) {
    const float a = out[pos], b = out[pj];
    out[pos] = b;
    out[pj] = a;
  }
  if (obj == OBJ_NONE) return;

  float score = 0.0f;
  if (obj == OBJ_TSP) {
    for (int w = 0; w < W; ++w) vis[w * ORDER_THREADS] = 0u;
    float xp = 0.0f, yp = 0.0f, total = 0.0f, dups = 0.0f;
#pragma unroll 4
    for (int l = 0; l < L; ++l) {
      const int c = decode_city(out[l], L);
      const float2 p = xy[min(c, C - 1)];
      if (l > 0) {
        const float dx = p.x - xp, dy = p.y - yp;
        total += sqrtf(dx * dx + dy * dy + 1e-12f);
      }
      unsigned* w = vis + (c >> 5) * ORDER_THREADS;
      const unsigned m = 1u << (c & 31);
      if (*w & m) dups += 1.0f;
      *w |= m;
      xp = p.x;
      yp = p.y;
    }
    score = -(total + penalty * dups);
  } else {
    for (int l = 0; l < L; ++l) {
      const float c = out[l];
      score += obj == OBJ_ONEMAX_BITS ? (c >= 0.5f ? 1.0f : 0.0f) : c;
    }
  }
  sout[orow] = orow < geo.P ? score : -INFINITY;
}

}  // namespace

extern "C" int deme_breed_launch(
    const float* gin, float* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const unsigned char* cross, const float* mut_u, const float* gauss,
    const long long* seed, int P, int Pp, int L, int K, int G, int mode, int S, int D, int q,
    int sel_kind, int tk, float sel_param, int mutate, int obj, void* stream) {
  const Geometry geo{P, Pp, L, K, G, mode, S, D, q};
  const Selection sel{sel_kind, tk, sel_param};
  const Draws dr{sel_u, cross, mut_u, gauss, seed};
  deme_breed_kernel<<<G, THREADS, K * sizeof(int), (cudaStream_t)stream>>>(
      gin, gout, sout, ranks, mparams, dr, geo, sel, mutate, obj);
  return (int)cudaGetLastError();
}

extern "C" const char* deme_breed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int order_breed_launch(
    const float* gin, float* gout, float* sout, const int* ranks, const float* mparams,
    const float* sel_u, const float* fill, const float* mut_u, const float* gauss,
    const long long* seed, const float* coords, int C, float penalty, int P, int Pp, int L,
    int K, int G, int sel_kind, int tk, float sel_param, int mutate, int obj, void* stream) {
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
  order_breed_kernel<<<G * (K / ORDER_THREADS), ORDER_THREADS, smem, (cudaStream_t)stream>>>(
      gin, gout, sout, ranks, mparams, dr, coords, C, penalty, geo, sel, mutate, obj);
  return (int)cudaGetLastError();
}
