// gp_eval.cu: the GP symbolic-regression evaluator on Hopper.
//
// Replaces, in libpga_tpu/ops/gp_eval.py (make_gp_eval):
//   kernel_opt (:334), the stack machine over compacted programs
//              (gp/optimize.py EvalProgram: opcodes over the extended
//              table with LIT = n_ops, operands, live lengths), and
//   kernel     (:309), the same over raw genomes with static max_nodes
//              trips (GPConfig.optimize=False, and parsimony scoring).
// The plain PyTorch versions are libpga_tpu_torch/gp/interpreter.py::
// stack_predict_program (B2) and ::stack_predict (B2'), scored by
// make_eval_rows; this kernel computes the same function.
//
// What it computes. For program p and sample s the postfix program runs
// on a value stack: a token executes when op != pad, sp >= arity and
// sp - arity < S (the skip rule); var pushes X[floor(arg*n_vars)][s],
// const pushes consts[floor(arg*n_consts)], LIT pushes arg, functions
// pop their operands (binary: right then left) and push the result
// (protected div, sqrt, log). The prediction is the top of the stack
// (0.0 when empty); the score is -sqrt(mean_s (pred - y)^2), and a
// non-finite score (overflow, NaN) is written as -inf.
//
// Bound. Operations: one per function token that executes and sample (a
// push is a load, not an operation) plus three per sample for the
// squared error, sum_p(fn_p)*B + 3*P*B. A random population of 65,536
// programs at T=32 executes 13.3 tokens each after compaction, 8.6 of
// them functions; over 1,024 samples that is 7.8e8 float32 operations,
// 11.6 us at 67 TFLOP/s. Bytes: the live tokens once (raw genomes whole
// in static mode), the samples once, the scores once, 7.5 MB, 2.2 us at
// 3.35 TB/s. So the bound is the operations (ops/gp_eval.py::
// gp_plan_cost counts both from the run's own programs). In practice
// the kernel is bound by its instruction issue: a token-sample is one
// operation but costs the SM many instructions (the dispatch, the
// stack's shared-memory traffic, the libm-accurate sinf/cosf/expf/logf).
// On the H100 at the main shape it takes 0.60 ms (0.74 in static mode),
// about 51x the bound: some 23 thread instructions a token-sample at the
// 1,980 MHz read under its load, if issue sets the pace. On programs of
// the arithmetic set (no libm call; chip_smoke.py's gp_bit_exact) it
// still takes about 17, so the libm functions are about a quarter of the
// issue; the rest (the dispatch, the stack's shared-memory traffic, the
// sample loads, protected division, NaN-propagating min and max) is not
// split further.
//
// Design: keep the decode and the stack out of the per-sample work.
// - Which tokens execute, the stack pointer at each, each variable's row
//   and each constant's value follow from the tokens alone, so a program
//   is resolved ONCE (resolve): the decode (static mode's clip(floor(g *
//   n_ops)), compacted mode's out-of-range op -> pad, the length clamp),
//   the function-id lookup and the skip rule run one token a lane, the
//   stack pointer by a warp-uniform scan, and the executed tokens go to
//   a list in shared memory: (function, stack slot) and the operand (a
//   variable's row offset, a constant's or literal's value). The scan
//   also yields the program's greatest depth D. In static mode the
//   samples then run the executed tokens only, not T trips.
// - The resolve runs on one warp a program behind a barrier, not on
//   every warp of a program: by count of its instructions (a 32-step
//   scan of shuffles) it is about half of one warp's walk at the main
//   shape, which resolving in each of a program's eight warps would add
//   to every one of them. A block's W warps
//   resolve a ROUND of W programs at once (every warp busy), then its
//   program slots (ppb of tpp threads) walk the round, ppb at a time.
// - Each sample keeps its top of stack in a register: a leaf spills the
//   old top to the stack's shared memory (when there is one) and becomes
//   the top, a unary function rewrites the top, a binary one reads one
//   slot and rewrites the top, so a token costs one shared-memory access
//   a sample. A thread walks V of its samples (lane + j*tpp, consecutive
//   j) in one pass over the list: each entry is read and dispatched once
//   for V samples. A program of depth D needs D - 1 slots a sample in a
//   thread's T floats, so it takes the largest V in {4, 2, 1} with
//   V*(D - 1) <= T and V no more than the samples a thread owns; V is a
//   template parameter picked per program by a switch uniform over its
//   warps. Each warp has T*32 floats of its own, [slot][32] V-float
//   vectors (consecutive lanes on consecutive banks): a warp's layout
//   follows its own program's V, and the warps of a program slot may be
//   on different programs of a round, since nothing waits between them.
// - A variable leaf reads its sample through the read-only path (__ldg):
//   the main shape's 12 KB of samples and targets are L1 hits. Staging
//   them in shared memory cost blocks an SM and measured slower at both
//   shapes timed, and a persistent grid striding over the rounds measured
//   14-16% slower than one block a round (PERF.md §5); neither is kept.
//
// The sum is the one the plain helper ops/gp_eval.py::kernel_order_scores
// repeats: thread lane adds its samples' e*e in j order (skipping s >=
// B), a __shfl_down_sync tree over the warp's 32 lanes, then one thread
// adds the program's warps in warp order and takes -sqrtf(sq / B).
//
// Built with --fmad=false and without --use_fast_math: sinf, cosf,
// expf, logf and sqrtf round as the plain version's.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// Function ids; ops/gp_eval.py::FUNCTION_IDS is the same table.
enum {
  F_PAD = 0, F_VAR = 1, F_CONST = 2, F_LIT = 3,
  F_NEG = 4, F_SIN = 5, F_COS = 6, F_SQRT = 7, F_ABS = 8, F_EXP = 9, F_LOG = 10,
  F_ADD = 11, F_SUB = 12, F_MUL = 13, F_DIV = 14, F_MIN = 15, F_MAX = 16,
};

constexpr int MAX_FIDS = 32;
constexpr int MAX_CONSTS = 64;
constexpr float DIV_EPS = 1e-6f;
constexpr float LOG_EPS = 1e-9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NEVER = 1 << 20;  // the arity of a pad: no stack pointer reaches it

__device__ __forceinline__ int arity_of(int f) {
  return f >= F_ADD ? 2 : (f >= F_NEG ? 1 : 0);
}

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf do not.
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

struct Args {
  const float* genomes;  // static mode: (P, 2T) genes; else nullptr
  const int* ops;        // compacted mode: (P, T) opcodes
  const float* args;     //                 (P, T) operands
  const int* length;     //                 (P,) live lengths
  const float* xt;       // (n_vars, B) samples, variable-major
  const float* y;        // (B,) targets
  const float* consts;   // (n_consts,)
  const int* fids;       // (n_ops + 1,) function id of each opcode
  float* out;            // (P,) scores
  int* v_out;            // (P,) each program's samples a pass, or nullptr
  int P, T, B, n_vars, n_consts, n_ops, S, tpp, ppb;
};

// The block's shared memory: the value stack [W][T][32] floats, the
// round's lists [W][T] of int2, the opcode and constant tables, the
// round's (count, depth) [W] and the warps' sums [W][tpp / 32].
// ops/gp_eval.py::gp_eval_plan computes the same bytes.
size_t smem_bytes_for(int T, int tpp, int ppb) {
  const size_t W = (size_t)tpp * ppb / 32;
  return 4 * (W * T * 32) + 8 * W * T + 4 * (MAX_FIDS + MAX_CONSTS) + 8 * W + 4 * W * (tpp / 32);
}

// One executed token: x = function id | (slot + 1) << 8, where slot is the
// stack slot the token touches (a leaf: the old top's, -1 when the stack is
// empty; a binary function: the second operand's); y = the operand: a
// variable's row offset v * B (an int), or a constant's or literal's value
// (a float; a constant is listed as a literal).
//
// Resolves program q on one warp into `list`; returns (tokens listed, the
// greatest depth). A program q >= P lists nothing.
__device__ int2 resolve(const Args& a, long long q, int2* list, const int* s_fid,
                        const float* s_const, int lane) {
  const int T = a.T;
  int trips = 0;
  if (q < a.P) {
    trips = T;
    if (a.genomes == nullptr) {
      const int len = a.length[q];
      trips = len < 0 ? 0 : (len > T ? T : len);
    }
  }
  int sp = 0, n = 0, depth = 0;
  for (int t0 = 0; t0 < trips; t0 += 32) {
    const int t = t0 + lane;
    int f = F_PAD;
    float arg = 0.0f;
    if (t < trips) {
      int op;
      if (a.genomes != nullptr) {
        const float* row = a.genomes + q * 2 * T;
        const int o = (int)floorf(row[2 * t] * (float)a.n_ops);
        op = o < 0 ? 0 : (o > a.n_ops - 1 ? a.n_ops - 1 : o);
        arg = row[2 * t + 1];
      } else {
        op = a.ops[q * T + t];
        arg = a.args[q * T + t];
      }
      f = (op >= 0 && op <= a.n_ops) ? s_fid[op] : F_PAD;
    }
    const int ar = f == F_PAD ? NEVER : arity_of(f);
    // The skip rule, token by token: the stack pointer is warp-uniform.
    int my_sp = 0;
    bool my_ex = false;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int ak = __shfl_sync(FULL, ar, k);
      const bool ex = sp >= ak && sp - ak < a.S;
      if (lane == k) {
        my_sp = sp;
        my_ex = ex;
      }
      sp = ex ? sp - ak + 1 : sp;
      depth = sp > depth ? sp : depth;
    }
    const unsigned live = __ballot_sync(FULL, my_ex);
    if (my_ex) {
      const int slot = ar == 0 ? my_sp - 1 : (ar == 2 ? my_sp - 2 : 0);
      int kind = f, operand = 0;
      if (f == F_VAR) {
        int v = (int)floorf(arg * (float)a.n_vars);
        v = v < 0 ? 0 : (v > a.n_vars - 1 ? a.n_vars - 1 : v);
        operand = v * a.B;
      } else if (f == F_CONST) {
        int c = (int)floorf(arg * (float)a.n_consts);
        c = c < 0 ? 0 : (c > a.n_consts - 1 ? a.n_consts - 1 : c);
        kind = F_LIT;
        operand = __float_as_int(s_const[c]);
      } else if (f == F_LIT) {
        operand = __float_as_int(arg);
      }
      list[n + __popc(live & ((1u << lane) - 1))] = make_int2(kind | ((slot + 1) << 8), operand);
    }
    n += __popc(live);
  }
  return make_int2(n, depth);
}

// The stack's V-float vector at index i of a warp's region.
template <int V>
__device__ __forceinline__ void put(float* region, int i, const float (&x)[V]) {
  if constexpr (V == 4) {
    reinterpret_cast<float4*>(region)[i] = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    reinterpret_cast<float2*>(region)[i] = make_float2(x[0], x[1]);
  } else {
    region[i] = x[0];
  }
}

template <int V>
__device__ __forceinline__ void get(const float* region, int i, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = reinterpret_cast<const float4*>(region)[i];
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = reinterpret_cast<const float2*>(region)[i];
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = region[i];
  }
}

// The largest V in {4, 2, 1} whose V * (depth - 1) stack slots fit a
// thread's T floats, and no more than the J samples a thread owns.
__device__ __forceinline__ int samples_per_pass(int depth, int T, int J) {
  if (J >= 4 && 4 * (depth - 1) <= T) return 4;
  if (J >= 2 && 2 * (depth - 1) <= T) return 2;
  return 1;
}

// Walks the n listed tokens over the thread's samples lane + j * tpp, V at a
// time, on its warp's stack region (lane32: its lane there), and adds each
// sample's squared error to sq in j order.
template <int V>
__device__ __forceinline__ float walk(const int2* list, int n, const float* xs, const float* ys,
                                      float* region, int lane32, int lane, int tpp, int B, int J,
                                      float sq) {
#define GP_UNARY(expr)                                    \
  _Pragma("unroll") for (int v = 0; v < V; ++v) {         \
    const float x = top[v];                               \
    top[v] = (expr);                                      \
  }                                                       \
  break
#define GP_BINARY(expr)                                   \
  {                                                       \
    float sec[V];                                         \
    get<V>(region, at, sec);                              \
    _Pragma("unroll") for (int v = 0; v < V; ++v) {       \
      const float l = sec[v], r = top[v];                 \
      top[v] = (expr);                                    \
    }                                                     \
  }                                                       \
  break
  for (int j0 = 0; j0 < J; j0 += V) {
    int sv[V];
    float top[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int s = lane + (j0 + v) * tpp;
      sv[v] = s < B ? s : B - 1;  // a sample past B is walked on a real one and not summed
      top[v] = 0.0f;              // the prediction of an empty program
    }
    for (int i = 0; i < n; ++i) {
      const int2 e = list[i];
      const int slot1 = e.x >> 8;
      const int at = (slot1 - 1) * 32 + lane32;
      switch (e.x & 0xff) {
        case F_VAR:
          if (slot1 > 0) put<V>(region, at, top);
#pragma unroll
          for (int v = 0; v < V; ++v) top[v] = __ldg(xs + e.y + sv[v]);
          break;
        case F_LIT:
          if (slot1 > 0) put<V>(region, at, top);
#pragma unroll
          for (int v = 0; v < V; ++v) top[v] = __int_as_float(e.y);
          break;
        case F_NEG: GP_UNARY(-x);
        case F_SIN: GP_UNARY(sinf(x));
        case F_COS: GP_UNARY(cosf(x));
        case F_SQRT: GP_UNARY(sqrtf(fabsf(x)));
        case F_ABS: GP_UNARY(fabsf(x));
        case F_EXP: GP_UNARY(expf(x));
        case F_LOG: GP_UNARY(logf(fabsf(x) + LOG_EPS));
        case F_ADD: GP_BINARY(l + r);
        case F_SUB: GP_BINARY(l - r);
        case F_MUL: GP_BINARY(l * r);
        case F_DIV: GP_BINARY(fabsf(r) < DIV_EPS ? 1.0f : l / r);
        case F_MIN: GP_BINARY(nan_min(l, r));
        default: GP_BINARY(nan_max(l, r));  // F_MAX
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (lane + (j0 + v) * tpp < B) {
        const float e = top[v] - __ldg(ys + sv[v]);
        sq += e * e;
      }
    }
  }
#undef GP_UNARY
#undef GP_BINARY
  return sq;
}

__global__ void gp_eval_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, tpp = a.tpp, ppb = a.ppb;
  const int W = blockDim.x / 32;  // the block's warps: the programs of a round
  const int wpp = tpp / 32;       // a program's warps
  float* stack = smem;                                                 // [W][T][32]
  int2* list = reinterpret_cast<int2*>(stack + (size_t)W * T * 32);     // [W][T]
  int* s_fid = reinterpret_cast<int*>(list + W * T);                   // [MAX_FIDS]
  float* s_const = reinterpret_cast<float*>(s_fid + MAX_FIDS);         // [MAX_CONSTS]
  int2* s_meta = reinterpret_cast<int2*>(s_const + MAX_CONSTS);        // [W]
  float* s_red = reinterpret_cast<float*>(s_meta + W);                 // [W][wpp]

  for (int i = threadIdx.x; i < MAX_FIDS; i += blockDim.x)
    s_fid[i] = i <= a.n_ops ? a.fids[i] : F_PAD;
  for (int i = threadIdx.x; i < a.n_consts; i += blockDim.x) s_const[i] = a.consts[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane32 = threadIdx.x % 32;
  const int slot = threadIdx.x / tpp, lane = threadIdx.x % tpp;
  float* region = stack + (size_t)warp * T * 32;
  const int J = (a.B + tpp - 1) / tpp;
  const long long p0 = (long long)blockIdx.x * W;  // the block's round
  const int2 m = resolve(a, p0 + warp, list + warp * T, s_fid, s_const, lane32);
  if (lane32 == 0) s_meta[warp] = m;
  __syncthreads();
  for (int i = slot; i < W; i += ppb) {  // wpp steps, the same in every slot
    float sq = 0.0f;
    if (p0 + i < a.P) {
      const int2 mi = s_meta[i];
      const int2* li = list + i * T;
      const int v = samples_per_pass(mi.y, T, J);
      if (a.v_out != nullptr && lane == 0) a.v_out[p0 + i] = v;
#define GP_WALK(V) walk<V>(li, mi.x, a.xt, a.y, region, lane32, lane, tpp, a.B, J, sq)
      switch (v) {
        case 4: sq = GP_WALK(4); break;
        case 2: sq = GP_WALK(2); break;
        default: sq = GP_WALK(1); break;
      }
#undef GP_WALK
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_down_sync(FULL, sq, o);
    if (lane32 == 0) s_red[i * wpp + lane / 32] = sq;
  }
  __syncthreads();
  // One thread a program adds its warps' sums in warp order.
  if (threadIdx.x < W && p0 + threadIdx.x < a.P) {
    const float* red = s_red + threadIdx.x * wpp;
    float sq = red[0];
    for (int w = 1; w < wpp; ++w) sq += red[w];
    float score = -sqrtf(sq / (float)a.B);
    if (!isfinite(score)) score = -INFINITY;
    a.out[p0 + threadIdx.x] = score;
  }
}

}  // namespace

// Launch on `stream`, one block a round of tpp * ppb / 32 programs; returns
// the cudaError_t of the launch (0 = ok). genomes != nullptr selects static
// mode (ops, args, length unused). v_out, if not nullptr, receives each
// program's samples a pass (4, 2 or 1).
extern "C" int gp_eval_launch(
    const float* genomes, const int* ops, const float* args, const int* length,
    const float* xt, const float* y, const float* consts, const int* fids, float* out,
    int P, int T, int B, int n_vars, int n_consts, int n_ops, int S,
    int tpp, int ppb, int smem_bytes, int* v_out, void* stream) {
  if (tpp < 32 || tpp % 32 || tpp * ppb > 1024 || n_ops + 1 > MAX_FIDS ||
      n_consts > MAX_CONSTS || n_consts < 1 || P < 1 || B < 1 || T < 1 ||
      (long long)n_vars * B > INT_MAX || (size_t)smem_bytes < smem_bytes_for(T, tpp, ppb))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gp_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const Args a{genomes, ops, args, length, xt, y, consts, fids, out, v_out,
               P, T, B, n_vars, n_consts, n_ops, S, tpp, ppb};
  const int W = tpp * ppb / 32;
  gp_eval_kernel<<<(unsigned)((P + W - 1) / W), tpp * ppb, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* gp_eval_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
