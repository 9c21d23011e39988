// pipe_plan.cuh: the launch plan of deme_pipelined_kernel (deme_breed.cu), the
// sub-block pipeline's breed. Plain C++ with no CUDA in it, so the host
// compiler builds it too: tests/test_torch_pipelined_plan.py holds its
// Python mirror (ops/kernels.py, pipelined_plan) against it.
//
// A cluster of C blocks shares a deme of K parent rows of L genes: block c
// stages slots [c*K/C, (c+1)*K/C) in two buffers (the deme it breeds and the
// next one), with the deme's K ranks (each block inverts all of them) and
// row_of_rank, both also twice. The plan takes the least C of 1, 2, 4, 8 for
// which that fits a block's shared memory and K/C is a multiple of the
// ping-pong quantum q, so that every staged chunk (q rows at parity 1, the
// block's whole run at parity 0) is 32*L bytes times a whole number: a TMA
// bulk copy takes any multiple of 16 bytes at a 16-byte-aligned address.
// q and K/C are powers of two (the kernel maps rows and slots by shifts).
// C = 0: no cluster holds the deme, and the caller breeds it with
// deme_breed_kernel.
//
// The expression breed's plan (expr_pipe_plan, for expr_pipelined_kernel of
// expr_breed.cu) is the same layout with, after it, `child_rows` rows of L
// floats for each of the PIPE_CHILDREN children a block breeds at once: the
// child itself where the objective hook reads it back (through roll, or in a
// stage after its first, or re-scored after a swap), then the objective's
// EXPR_OBJ_ROWS materialised rows, a child's rows one float more apart than
// they fill (an odd stride: the four children of a warp, each lane at gene
// 4*j + i of its own child's row, then read 32 distinct banks; at a stride
// that is a multiple of 4 they read 8, four times each). Its C is the least
// that holds all of it.
// It breeds four genes a lane, so a genome length that is not a multiple of
// 4 gets C = 0 and breeds in expr_breed_kernel.

#pragma once

#include <stddef.h>

constexpr int PIPE_MAX_CLUSTER = 8;                // the portable cluster size
constexpr size_t PIPE_SMEM_LIMIT = 232448 - 1024;  // a block's, beside its static arrays
constexpr size_t PIPE_ALIGN = 128;                 // each region's size, rounded
constexpr int PIPE_CHILDREN = 64;                  // children a block breeds at once

struct PipePlan {
  int C;       // blocks a cluster; 0: none of at most PIPE_MAX_CLUSTER holds the deme
  int rows;    // parent rows a block stages, K / C
  size_t buf;  // bytes a parent buffer: rows * L * gene bytes, to PIPE_ALIGN
  // Byte offsets of the two staged rank rows, the two row_of_rank arrays
  // and the two full barriers, after the two parent buffers.
  size_t ranks, ror, bars;
  size_t smem;  // the dynamic shared memory a block takes
};

inline size_t pipe_round(size_t n) { return (n + PIPE_ALIGN - 1) / PIPE_ALIGN * PIPE_ALIGN; }

inline bool pipe_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// The least C whose layout, with `extra` more bytes after the barriers,
// fits a block.
inline PipePlan pipe_plan_with(int K, int L, int gene_bytes, int q, size_t extra) {
  for (int C = 1; C <= PIPE_MAX_CLUSTER && pipe_pow2(q); C *= 2) {
    if (K % C || (K / C) % q || !pipe_pow2(K / C)) continue;
    PipePlan p;
    p.C = C;
    p.rows = K / C;
    p.buf = pipe_round((size_t)p.rows * L * gene_bytes);
    p.ranks = 2 * p.buf;
    p.ror = p.ranks + 2 * pipe_round((size_t)K * 4);
    p.bars = p.ror + 2 * pipe_round((size_t)K * 4);
    p.smem = p.bars + PIPE_ALIGN + pipe_round(extra);  // two 8-byte barriers
    if (p.smem <= PIPE_SMEM_LIMIT) return p;
  }
  return PipePlan{0, 0, 0, 0, 0, 0, 0};
}

inline PipePlan pipe_plan(int K, int L, int gene_bytes, int q) {
  return pipe_plan_with(K, L, gene_bytes, q, 0);
}

struct ExprPipePlan {
  PipePlan pipe;   // pipe.C = 0: expr_breed_kernel breeds the shape
  int child_rows;  // rows of L floats a child in flight
  int stride;      // floats from one child's rows to the next: child_rows * L + 1, or 0
  size_t rows_at;  // their byte offset: child j's at rows_at + j * stride * 4
};

inline ExprPipePlan expr_pipe_plan(int K, int L, int gene_bytes, int q, int child_rows) {
  ExprPipePlan e{PipePlan{0, 0, 0, 0, 0, 0, 0}, child_rows, child_rows ? child_rows * L + 1 : 0,
                 0};
  if (L % 4) return e;  // four genes a lane
  e.pipe = pipe_plan_with(K, L, gene_bytes, q, (size_t)PIPE_CHILDREN * e.stride * 4);
  if (e.pipe.C) e.rows_at = e.pipe.bars + PIPE_ALIGN;
  return e;
}
