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
// Design. The TPU kernel reads the stack through iota-compare masks and
// runs every function of the table on every token, over length-sorted
// row blocks, because Mosaic has no gathers and no per-row control
// flow. Here all threads of one warp walk ONE program, so the stack
// pointer and the opcode switch are warp-uniform: no divergence, and
// only the token's own function runs. Each thread owns samples (s =
// lane, lane + tpp, ...) and its own column of a [T][tpp] value stack
// in shared memory (consecutive lanes on consecutive banks). A program
// of compacted form stops at its own live length; no sort and no
// inverse permutation are needed, and the scores come out in input
// order. Several programs share a block when the samples are few
// (tpp = threads per program, ppb = programs per block; the wrapper
// picks both, see ops/gp_eval.py::gp_eval_plan). In static mode the
// opcodes are decoded from the genes in the kernel:
// clip(floor(g * n_ops), 0, n_ops - 1).
//
// Bound. Operations: one per function token that executes and sample (a
// push is a load, not an operation) plus three per sample for the
// squared error, sum_p(fn_p)*B + 3*P*B. A random population of 65,536
// programs at T=32 executes 13.3 tokens each after compaction, 8.6 of
// them functions; over 1,024 samples that is 7.8e8 float32 operations,
// 11.6 us at 67 TFLOP/s. Bytes: the live tokens once (raw genomes whole
// in static mode), the samples once, the scores once, 7.5 MB, 2.2 us at
// 3.35 TB/s. So the bound is the operations (ops/gp_eval.py::
// gp_plan_cost counts both from the run's own programs); the kernel pays
// for its instructions per token (shared memory reads and writes of the
// stack, the opcode dispatch, and the libm-accurate sinf/cosf), which a
// later PR can cut by keeping the stack top in registers.
//
// Built with --fmad=false and without --use_fast_math: sinf, cosf,
// expf, logf and sqrtf round as the plain version's.

#include <cuda_runtime.h>
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
  int P, T, B, n_vars, n_consts, n_ops, S, tpp, ppb;
};

__global__ void gp_eval_kernel(const Args a) {
  extern __shared__ float smem[];
  const int T = a.T, tpp = a.tpp, ppb = a.ppb;
  float* stack = smem;                                   // [ppb][T][tpp]
  int* s_ops = reinterpret_cast<int*>(stack + ppb * T * tpp);  // [ppb][T]
  float* s_args = reinterpret_cast<float*>(s_ops + ppb * T);   // [ppb][T]
  int* s_fid = reinterpret_cast<int*>(s_args + ppb * T);       // [MAX_FIDS]
  float* s_const = reinterpret_cast<float*>(s_fid + MAX_FIDS); // [MAX_CONSTS]
  float* s_red = s_const + MAX_CONSTS;                         // [ppb][tpp/32]

  const int slot = threadIdx.x / tpp;
  const int lane = threadIdx.x % tpp;
  const long long p0 = (long long)blockIdx.x * ppb;
  const long long p = p0 + slot;
  const bool real = p < a.P;

  for (int i = threadIdx.x; i < ppb * T; i += blockDim.x) {
    const long long q = p0 + i / T;
    const int t = i % T;
    int op = 0;
    float arg = 0.5f;
    if (q < a.P) {
      if (a.genomes != nullptr) {
        const float g = a.genomes[q * 2 * T + 2 * t];
        int o = (int)floorf(g * (float)a.n_ops);
        op = o < 0 ? 0 : (o > a.n_ops - 1 ? a.n_ops - 1 : o);
        arg = a.genomes[q * 2 * T + 2 * t + 1];
      } else {
        op = a.ops[q * T + t];
        arg = a.args[q * T + t];
      }
    }
    s_ops[i] = op;
    s_args[i] = arg;
  }
  for (int i = threadIdx.x; i <= a.n_ops; i += blockDim.x) s_fid[i] = a.fids[i];
  for (int i = threadIdx.x; i < a.n_consts; i += blockDim.x) s_const[i] = a.consts[i];
  __syncthreads();

  int trips = 0;
  if (real) {
    trips = T;
    if (a.genomes == nullptr) {
      const int len = a.length[p];
      trips = len < 0 ? 0 : (len > T ? T : len);
    }
  }
  const int* my_ops = s_ops + slot * T;
  const float* my_args = s_args + slot * T;
  float* col = stack + (size_t)slot * T * tpp + lane;  // col[d * tpp] = slot d

  float sq = 0.0f;
  for (int s = lane; real && s < a.B; s += tpp) {
    int sp = 0;
    for (int t = 0; t < trips; ++t) {
      const int op = my_ops[t];
      const int f = (op >= 0 && op <= a.n_ops) ? s_fid[op] : F_PAD;
      const int ar = arity_of(f);
      if (f == F_PAD || sp < ar || sp - ar >= a.S) continue;
      const float arg = my_args[t];
      float r;
      if (ar == 0) {
        if (f == F_VAR) {
          int v = (int)floorf(arg * (float)a.n_vars);
          v = v < 0 ? 0 : (v > a.n_vars - 1 ? a.n_vars - 1 : v);
          r = a.xt[(size_t)v * a.B + s];
        } else if (f == F_CONST) {
          int c = (int)floorf(arg * (float)a.n_consts);
          c = c < 0 ? 0 : (c > a.n_consts - 1 ? a.n_consts - 1 : c);
          r = s_const[c];
        } else {  // F_LIT
          r = arg;
        }
      } else {
        const float top = col[(sp - 1) * tpp];
        if (ar == 1) {
          switch (f) {
            case F_NEG: r = -top; break;
            case F_SIN: r = sinf(top); break;
            case F_COS: r = cosf(top); break;
            case F_SQRT: r = sqrtf(fabsf(top)); break;
            case F_ABS: r = fabsf(top); break;
            case F_EXP: r = expf(top); break;
            default: r = logf(fabsf(top) + LOG_EPS); break;  // F_LOG
          }
        } else {
          const float sec = col[(sp - 2) * tpp];
          switch (f) {
            case F_ADD: r = sec + top; break;
            case F_SUB: r = sec - top; break;
            case F_MUL: r = sec * top; break;
            case F_DIV: r = fabsf(top) < DIV_EPS ? 1.0f : sec / top; break;
            case F_MIN: r = nan_min(sec, top); break;
            default: r = nan_max(sec, top); break;  // F_MAX
          }
        }
      }
      sp = sp - ar + 1;
      col[(sp - 1) * tpp] = r;
    }
    const float pred = sp > 0 ? col[(sp - 1) * tpp] : 0.0f;
    const float e = pred - a.y[s];
    sq += e * e;
  }

  // Sum the squared errors over the program's tpp threads.
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_down_sync(FULL, sq, o);
  const int warps = tpp / 32;
  if (warps > 1) {
    if ((lane & 31) == 0) s_red[slot * warps + lane / 32] = sq;
    __syncthreads();
    if (lane == 0) {
      sq = 0.0f;
      for (int w = 0; w < warps; ++w) sq += s_red[slot * warps + w];
    }
  }
  if (lane == 0 && real) {
    float score = -sqrtf(sq / (float)a.B);
    if (!isfinite(score)) score = -INFINITY;
    a.out[p] = score;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
// genomes != nullptr selects static mode (ops, args, length unused).
extern "C" int gp_eval_launch(
    const float* genomes, const int* ops, const float* args, const int* length,
    const float* xt, const float* y, const float* consts, const int* fids, float* out,
    int P, int T, int B, int n_vars, int n_consts, int n_ops, int S,
    int tpp, int ppb, int smem_bytes, void* stream) {
  if (tpp < 32 || tpp % 32 || tpp * ppb > 1024 || n_ops + 1 > MAX_FIDS ||
      n_consts > MAX_CONSTS || n_consts < 1 || P < 1 || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gp_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const Args a{genomes, ops, args, length, xt, y, consts, fids, out,
               P, T, B, n_vars, n_consts, n_ops, S, tpp, ppb};
  const int grid = (P + ppb - 1) / ppb;
  gp_eval_kernel<<<grid, tpp * ppb, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* gp_eval_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
