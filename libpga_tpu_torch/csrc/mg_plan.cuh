// mg_plan.cuh: the launch plan of the multi-generation kernel's cluster
// schedule (multigen_breed_kernel<false> in deme_breed.cu, over
// multigen_cluster in breed_core.cuh; with expression hooks
// expr_multigen_kernel<false> of expr_breed.cu, whose plan expr_mg_plan in
// expr_plan.cuh adds its children's rows). Plain C++ with no CUDA in it, so the
// host compiler builds it too: tests/test_torch_multigen_plan.py pins it,
// and Python reads it only through multigen_cluster_plan below, from the
// built deme_breed.cu unit.
//
// A cluster of C blocks holds a group of W = D*K rows of L genes in shared
// memory for a whole launch: block c keeps slots [c*R, (c+1)*R), R = W/C, in
// two copies (a sub-generation's parents and its children), with its rows'
// scores and alive flags; beside them the N = max(R, K) keys of the demes it
// breeds, which it ranks (double-buffered: the blocks of a deme write its
// keys into one another's), their row_of_rank and the staging barrier. The
// plan takes the least C of 1, 2, 4, 8 whose layout fits a block, with R a
// multiple of the ping-pong quantum q (a staged run at parity 1 is q rows).
// W, K and q are powers of two (the geometry's), so R and K divide one
// another. C = 0: no cluster holds the group, and the caller breeds it on
// the one-block schedule (multigen_group).

#pragma once

#include <stddef.h>

constexpr int MG_MAX_CLUSTER = 8;                // the portable cluster size
constexpr size_t MG_SMEM_LIMIT = 232448 - 1024;  // a block's, beside its static arrays
constexpr size_t MG_ALIGN = 128;                 // each region's size, rounded
constexpr int MGC_THREADS = 512;                 // a block of multigen_breed_kernel<false>

struct MgPlan {
  int C;        // blocks a cluster; 0: no cluster of at most MG_MAX_CLUSTER holds the group
  int rows;     // R = W / C: the group's slots a block holds
  int sort;     // N = max(R, K): the keys a block sorts (its demes', whole)
  size_t copy;  // bytes of one copy of a block's rows, to MG_ALIGN
  // Byte offsets, after the two copies: the keys (2 x N x 8), row_of_rank
  // (N x 4), scores (R x 4), alive flags (R), the barrier.
  size_t sorted, ror, score, alive, bar;
  size_t smem;  // the dynamic shared memory a block takes
};

inline size_t mg_round(size_t n) { return (n + MG_ALIGN - 1) / MG_ALIGN * MG_ALIGN; }

inline bool mg_pow2(long n) { return n > 0 && (n & (n - 1)) == 0; }

// The plan for D demes of K rows of L genes of gene_bytes each, ping-pong
// quantum q, with `extra` more bytes a block after the barrier (the
// expression kernel's rows of its children in flight, expr_plan.cuh).
inline MgPlan mg_plan_with(int D, int K, int L, int gene_bytes, int q, size_t extra) {
  const long W = (long)D * K;
  if (!mg_pow2(W) || !mg_pow2(K) || !mg_pow2(q) || K < 32 || K > 1024 || L < 1)
    return MgPlan{0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int C = 1; C <= MG_MAX_CLUSTER; C *= 2) {
    const long R = W / C;
    const long N = R > K ? R : K;
    if (R < q) continue;
    MgPlan p;
    p.C = C;
    p.rows = (int)R;
    p.sort = (int)N;
    p.copy = mg_round((size_t)R * L * gene_bytes);
    p.sorted = 2 * p.copy;
    p.ror = p.sorted + mg_round((size_t)N * 16);
    p.score = p.ror + mg_round((size_t)N * 4);
    p.alive = p.score + mg_round((size_t)R * 4);
    p.bar = p.alive + mg_round((size_t)R);
    p.smem = p.bar + MG_ALIGN + mg_round(extra);  // one 8-byte barrier
    if (p.smem <= MG_SMEM_LIMIT) return p;
  }
  return MgPlan{0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
}

inline MgPlan mg_plan(int D, int K, int L, int gene_bytes, int q) {
  return mg_plan_with(D, K, L, gene_bytes, q, 0);
}

// The plan's C entry, for Python (ops/kernels.py, ctypes): out[0..3] = C, the
// rows a block holds, the keys it sorts and its dynamic shared bytes.
// Returns C (0: no cluster holds the group, which then breeds on the
// one-block schedule).
extern "C" int multigen_cluster_plan(int D, int K, int L, int gene_bytes, int q, long long* out) {
  const MgPlan p = mg_plan(D, K, L, gene_bytes, q);
  out[0] = p.C;
  out[1] = p.rows;
  out[2] = p.sort;
  out[3] = (long long)p.smem;
  return p.C;
}
