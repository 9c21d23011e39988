// expr_plan.cuh: the launch plans of expr_pipelined_kernel and of
// expr_multigen_kernel<false>'s cluster schedule (expr_breed.cu) for a
// generated unit. Plain C++ with no CUDA in it, but it reads the
// generated macros (EXPR_OBJ, EXPR_MUT, EXPR_OBJ_CHILD, EXPR_OBJ_ROWS), so it
// is included after the hooks: at the end of expr_breed.cu, and by
// tests/test_torch_expr_pipelined_plan.py after a unit's hooks, built with the
// host compiler. Python reads it only through expr_pipelined_plan and
// expr_multigen_cluster_plan below, from the built unit (ops/kernels.py).
//
// A child in flight keeps in shared memory, beside pipe_plan.cuh's staged
// deme: its own row where the objective hook reads the child back (through
// roll or in a stage after its first: EXPR_OBJ_CHILD; or after a builtin swap
// mutation, which re-scores the swapped child), then the objective's
// EXPR_OBJ_ROWS materialised rows; a builtin objective keeps none.
//
// The multi-generation kernel's cluster schedule (expr_multigen_kernel<false>,
// over multigen_cluster) takes expr_mg_plan below: mg_plan.cuh's layout of a
// group held in a cluster's shared memory and, after it, the same rows for
// each of the PIPE_CHILDREN children a block breeds at once; a float child is
// read back from its row in the group's copy, so only a bf16 child the
// objective reads back keeps a float row of its own. Order crossover, a
// genome length that is not a multiple of 4 (four genes a lane) and a group
// no cluster holds breed on the one-block schedule (C = 0).

#pragma once

#include "mg_plan.cuh"
#include "pipe_plan.cuh"

constexpr int EXPR_PLAN_SWAP = 2;  // breed_core.cuh's MUT_SWAP, the launchers' mutate id

// Rows of L floats a child in flight keeps, for the builtin mutate id
// `mutate` (unread where a mutation hook replaces the builtin kind).
inline int expr_child_rows(int mutate) {
  if (!EXPR_OBJ) return 0;
  const int own = EXPR_OBJ_CHILD || (!EXPR_MUT && mutate == EXPR_PLAN_SWAP);
  return own + EXPR_OBJ_ROWS;
}

// The plan's C entry, for Python (ctypes): out[0..3] = C, the parent rows a
// block stages, the rows of L floats a child in flight keeps, and the block's
// dynamic shared bytes. Returns C (0: expr_breed_kernel breeds the shape).
extern "C" int expr_pipelined_plan(int K, int L, int gene_bytes, int q, int mutate,
                                   long long* out) {
  const ExprPipePlan p = expr_pipe_plan(K, L, gene_bytes, q, expr_child_rows(mutate));
  out[0] = p.pipe.C;
  out[1] = p.pipe.rows;
  out[2] = p.child_rows;
  out[3] = (long long)p.pipe.smem;
  return p.pipe.C;
}

// Rows of L floats a child in flight keeps on the cluster schedule of the
// multi-generation kernel, for genes of gene_bytes and the builtin mutate id
// `mutate`: a float child is read back from the group's copy, a bf16 one
// from a float row of its own.
inline int expr_mg_child_rows(int mutate, int gene_bytes) {
  return gene_bytes == 4 ? (EXPR_OBJ ? EXPR_OBJ_ROWS : 0) : expr_child_rows(mutate);
}

struct ExprMgPlan {
  MgPlan mg;       // mg.C = 0: the one-block schedule breeds the group
  int child_rows;  // rows of L floats a child in flight
  int stride;      // floats from one child's rows to the next: child_rows * L + 1, or 0
  size_t rows_at;  // their byte offset: child j's at rows_at + j * stride * 4
};

inline ExprMgPlan expr_mg_plan(int D, int K, int L, int gene_bytes, int q, int mutate) {
  const int rows = expr_mg_child_rows(mutate, gene_bytes);
  ExprMgPlan e{MgPlan{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}, rows, rows ? rows * L + 1 : 0, 0};
  if (L % 4) return e;  // four genes a lane
  e.mg = mg_plan_with(D, K, L, gene_bytes, q, (size_t)PIPE_CHILDREN * e.stride * 4);
  if (e.mg.C) e.rows_at = e.mg.bar + MG_ALIGN;
  return e;
}

// The cluster plan's C entry, for Python (ctypes): out[0..4] = C, the group's
// rows a block holds, the keys it sorts, the rows of L floats a child in
// flight keeps and the block's dynamic shared bytes. Returns C (0: the
// one-block schedule breeds the group).
extern "C" int expr_multigen_cluster_plan(int D, int K, int L, int gene_bytes, int q, int mutate,
                                          long long* out) {
  const ExprMgPlan p = expr_mg_plan(D, K, L, gene_bytes, q, mutate);
  out[0] = p.mg.C;
  out[1] = p.mg.rows;
  out[2] = p.mg.sort;
  out[3] = p.child_rows;
  out[4] = (long long)p.mg.smem;
  return p.mg.C;
}
