// order_plan.cuh: the shared-memory layouts of the order walk on
// shared-memory tiles (breed_core.cuh, "The order walk on shared-memory
// tiles"): order_plan, a block of the one-generation order kernels,
// order_breed_kernel (deme_breed.cu) and expr_order_kernel (expr_breed.cu);
// mg_order_plan, the walk of the multi-generation kernels' order case
// (multigen_group<true>, in multigen_breed_kernel<true> and
// expr_multigen_kernel<true>). Plain C++ with no CUDA in it but the
// qualifier that lets a kernel call mg_order_plan too, so the host compiler
// builds it: tests/test_torch_order_plan.py holds order_plan's Python mirror
// (ops/kernels.py, order_plan) against it at every order shape the card
// runs, and pins mg_order_plan, which Python reads only through the built
// units (kernels.multigen_order_plan).
//
// A block breeds ORDER_THREADS children of one deme, one thread a child, and
// walks them in step, a tile of ORDER_TILE genes at a time. Its dynamic
// shared memory, each region rounded up to 16 bytes:
//   ORDER_STAGES tile buffers (a ring: ORDER_STAGES - 1 tiles in flight
//     while the block walks one) of ORDER_ROWS rows of ORDER_STRIDE floats:
//     row r holds
//     child r's parent 1 (the walk writes the child over it), row
//     ORDER_THREADS + r its parent 2; a row is 16-byte aligned, and the 8
//     rows a quarter-warp reads as float4 at one offset fall in 8 distinct
//     bank quads (a stride of 20 words: 20*r mod 32 is 8 distinct
//     multiples of 4); expr_order_kernel's child and objective rows of each
//     warp (`warp_bytes`) share these bytes: its phases that use the two
//     are apart, a block barrier between them, and a block small enough
//     for several on an SM keeps that kernel's hooks in flight;
//   the first Cs = min(C, L) cities' coordinates as float2 (the TSP score);
//   the walk's visited bitmasks, ceil(L/32) words a child laid out
//     [word][child] (a warp's lanes in 32 distinct banks), and, where the
//     walk also counts the child's distinct cities (`seen`), as many again;
//   row_of_rank (K ints) and the population row of each staged row
//     (ORDER_ROWS ints).
// Every order shape the deme geometry admits (fused_step.resolve_geometry:
// L <= 2,304, K <= 1,024) fits a block without warp rows; with them, a
// launch whose layout passes ORDER_SMEM_LIMIT is refused from the shape
// before it is made (kernels.expr_warps).

#pragma once

#include <stddef.h>

#if defined(__CUDACC__)
#define ORDER_PLAN_FN __host__ __device__ inline
#else
#define ORDER_PLAN_FN inline
#endif

constexpr int ORDER_THREADS = 64;                   // children a block, one thread each
constexpr int ORDER_TILE = 16;                      // genes a tile
constexpr int ORDER_STRIDE = ORDER_TILE + 4;        // floats a staged row
constexpr int ORDER_ROWS = 2 * ORDER_THREADS;       // staged rows: parent 1s, then parent 2s
// Tile buffers in the ring. Four (measured on the card at 8,192x1,000) made
// no walking case faster, where a tile's walk outlasts the next tile's copy,
// and cost expr_order_kernel half its blocks on an SM at 65,536x200.
constexpr int ORDER_STAGES = 2;
constexpr size_t ORDER_SMEM_LIMIT = 232448 - 1024;  // a block's, beside its static arrays

struct OrderPlan {
  // Byte offsets after the tile buffers and the warps' rows (both at 0):
  // the coordinates, the visited and seen bitmasks, row_of_rank, the staged
  // rows' population rows.
  size_t xy, vis, seen, ror, srow;
  size_t smem;  // the dynamic shared memory a block takes
};

inline size_t order_round(size_t n) { return (n + 15) / 16 * 16; }

// The layout for a deme of K rows of L genes, Cs staged cities, `seen`
// bitmasks or none, and `warp_bytes` of warp rows.
inline OrderPlan order_plan(int K, int L, int Cs, bool seen, size_t warp_bytes) {
  const size_t mask = order_round((size_t)((L + 31) / 32) * ORDER_THREADS * 4);
  const size_t tiles = (size_t)ORDER_STAGES * ORDER_ROWS * ORDER_STRIDE * 4;
  OrderPlan p;
  p.xy = order_round(tiles > warp_bytes ? tiles : warp_bytes);
  p.vis = p.xy + order_round((size_t)Cs * 8);
  p.seen = p.vis + mask;
  p.ror = p.seen + (seen ? mask : 0);
  p.srow = p.ror + order_round((size_t)K * 4);
  p.smem = p.srow + (size_t)ORDER_ROWS * 4;
  return p;
}

// The multi-generation walk. A block of `threads` threads breeds a group of
// W children a sub-generation (multigen_group<true>): after the ranks it
// walks them in passes of P children, one thread a child, in step on tiles as
// the one-generation kernels do (order_tiles), straight into the children's
// rows; then `warps` of its warps breed the walked children, a warp a child.
// Its dynamic shared memory, after the `base` bytes of multigen_group's own
// arrays (mg_rows_bytes), each region rounded up to 16 bytes:
//   the ring: ORDER_STAGES tile buffers of 2P staged rows of ORDER_STRIDE
//     floats, row r child r's parent 1 (the walk writes the child over it),
//     row P + r its parent 2; the warps' rows (`warp_bytes` each: the
//     expression kernel's child and objective rows) share these bytes, since
//     the walk and the warps are apart, a block barrier between them;
//   the walkers' visited bitmasks, ceil(L/32) words a walker laid out
//     [word][walker] (a warp's lanes in 32 distinct banks);
//   the population row of each staged row (2P ints) and of each walked
//     child (P ints), so that no copy computes a row.
// P is a multiple of MG_WALK_GRAIN: the least that covers W (one pass) where
// that fits, else the largest that does (ceil(W/P) passes), with at least
// one warp's rows; then as many warps as fit, up to threads / 32 (all of
// them where warp_bytes is 0: the builtin kernel keeps no rows). P = 0: no
// layout holds, and the launch is refused from the shape before it is made.
constexpr int MG_WALK_GRAIN = 64;

struct MgOrderPlan {
  int P;      // children a pass walks (0: no layout holds)
  int warps;  // warps that breed the walked children
  // Byte offsets: the ring (and the warps' rows), the visited bitmasks, the
  // staged rows' and the children's population rows.
  size_t ring, vis, srow;
  size_t smem;  // the dynamic shared memory a block takes
};

ORDER_PLAN_FN size_t mg_order_round(size_t n) { return (n + 15) / 16 * 16; }

ORDER_PLAN_FN MgOrderPlan mg_order_plan(int W, int L, size_t base, int threads,
                                        size_t warp_bytes) {
  const size_t words = (size_t)((L + 31) / 32);
  int P = (W + MG_WALK_GRAIN - 1) / MG_WALK_GRAIN * MG_WALK_GRAIN;
  if (P > threads) P = threads / MG_WALK_GRAIN * MG_WALK_GRAIN;
  for (; W > 0 && L > 0 && P > 0; P -= MG_WALK_GRAIN) {
    const size_t ring = (size_t)ORDER_STAGES * 2 * P * ORDER_STRIDE * 4;
    const size_t vis = mg_order_round(words * P * 4), srow = mg_order_round((size_t)3 * P * 4);
    const size_t fixed = base + vis + srow;
    if (fixed + ring > ORDER_SMEM_LIMIT) continue;
    const size_t room = ORDER_SMEM_LIMIT - fixed;  // for the ring and the warps' rows
    int warps = threads / 32;
    while (warps > 0 && mg_order_round((size_t)warps * warp_bytes) > room) --warps;
    if (warps < 1) continue;
    const size_t rows = mg_order_round((size_t)warps * warp_bytes);
    MgOrderPlan p;
    p.P = P;
    p.warps = warps;
    p.ring = base;
    p.vis = base + (ring > rows ? ring : rows);
    p.srow = p.vis + vis;
    p.smem = p.srow + srow;
    return p;
  }
  return MgOrderPlan{0, 0, 0, 0, 0, 0};
}
