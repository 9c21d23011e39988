// expr_plan.cuh: the launch plan of expr_pipelined_kernel (expr_breed.cu)
// for a generated unit. Plain C++ with no CUDA in it, but it reads the
// generated macros (EXPR_OBJ, EXPR_MUT, EXPR_OBJ_CHILD, EXPR_OBJ_ROWS), so it
// is included after the hooks: at the end of expr_breed.cu, and by
// tests/test_torch_expr_pipelined_plan.py after a unit's hooks, built with the
// host compiler. Python reads it only through expr_pipelined_plan below, from
// the built unit (ops/kernels.py).
//
// A child in flight keeps in shared memory, beside pipe_plan.cuh's staged
// deme: its own row where the objective hook reads the child back (through
// roll or in a stage after its first: EXPR_OBJ_CHILD; or after a builtin swap
// mutation, which re-scores the swapped child), then the objective's
// EXPR_OBJ_ROWS materialised rows; a builtin objective keeps none.

#pragma once

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
