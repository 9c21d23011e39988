"""The GP evaluator: its launch plan, its bound on the card, and the
scorer that launches ``csrc/gp_eval.cu`` (the torch counterpart of
``libpga_tpu/ops/gp_eval.py``).

:func:`make_gp_eval` returns ``fn(genomes | EvalProgram) -> (P,)``
``-RMSE`` scores. On CUDA tensors it launches the kernel: compacted
programs (``GPConfig.optimize``, the default) take B2's mode, raw
genomes with static trips B2′'s. On CPU tensors it runs the plain
versions in ``gp/interpreter.py``. Nothing else.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from libpga_tpu_torch.gp.encoding import (
    DISPATCH_KINDS,
    GPConfig,
    arity_table,
    decode_ops,
    program_structure,
)
from libpga_tpu_torch.gp.interpreter import DeviceData, gp_eval_reference, samples, sanitize
from libpga_tpu_torch.gp.optimize import EvalProgram, optimize_for_eval
from libpga_tpu_torch.ops import kernels

#: Function ids of ``csrc/gp_eval.cu`` (its enum is the same table).
FUNCTION_IDS = {
    "pad": 0, "var": 1, "const": 2, "lit": 3,
    "neg": 4, "sin": 5, "cos": 6, "sqrt": 7, "abs": 8, "exp": 9, "log": 10,
    "add": 11, "sub": 12, "mul": 13, "div": 14, "min": 15, "max": 16,
}
MAX_FIDS = 32  # opcode table entries the kernel holds (LIT included)
MAX_CONSTS = 64
BLOCK_THREADS = 256
STACK_SMEM_LIMIT = 64 * 1024  # value-stack bytes per block the plan aims under
SMEM_LIMIT = 227 * 1024  # shared memory a block can use on the H100

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def gp_eval_plan(
    pop: int,
    gp: GPConfig,
    n_samples: int,
    *,
    stack_depth: Optional[int] = None,
    opcode_block: Optional[int] = None,
    dispatch: Optional[str] = None,
) -> Optional[dict]:
    """Launch geometry of the CUDA evaluator for ``pop`` programs over
    ``n_samples`` samples. None for an empty population or dataset;
    ``ValueError`` for a stack depth below ``required_stack()``, an
    ``opcode_block`` that does not divide ``max_nodes``, an unknown
    dispatch, or a table or program the kernel cannot hold. Unlike the
    TPU plan it never declines a population size: the grid covers any P.

    Threads per program (``tpp``) cover the samples up to 256, in whole
    warps; programs per block (``ppb``) fill a 256-thread block when the
    samples are few. The value stack takes ``ppb * T * tpp`` floats of
    shared memory; both shrink until it fits 64 KB. A block resolves a
    round of ``programs_per_round`` programs (one a warp) and walks them
    ``ppb`` at a time, one block a round; a thread owns
    ``samples_per_thread`` samples. ``smem_bytes`` is the kernel's
    ``smem_bytes_for``: the value stack, ``T * 32`` floats a warp, a
    round's executed-token lists of 8 bytes a token, the opcode and
    constant tables, each round program's count and depth and the warps'
    partial sums. ``grid`` is the count of program slots,
    ``ceil(pop / ppb)``."""
    if pop < 1 or n_samples < 1:
        return None
    required = gp.required_stack()
    S = int(stack_depth or gp.stack_depth or required)
    if S < required:
        raise ValueError(
            f"gp_stack_depth {S} < required bound {required} (a "
            f"well-formed {gp.max_nodes}-token program can hold "
            f"{required} values)"
        )
    B = int(opcode_block or gp.opcode_block or 1)
    if B < 1 or gp.max_nodes % B:
        raise ValueError(
            f"gp_opcode_block {B} does not divide max_nodes {gp.max_nodes}"
        )
    D = dispatch if dispatch is not None else (gp.dispatch or "dense")
    if D not in DISPATCH_KINDS:
        raise ValueError(
            f"gp_dispatch {D!r} not in {tuple(k for k in DISPATCH_KINDS if k)}"
        )
    if gp.n_ops + 1 > MAX_FIDS or max(len(gp.consts), 1) > MAX_CONSTS:
        raise ValueError(
            f"the kernel holds {MAX_FIDS} opcodes and {MAX_CONSTS} constants"
        )
    T = gp.max_nodes
    tpp = min(BLOCK_THREADS, 32 * math.ceil(n_samples / 32))
    ppb = max(1, BLOCK_THREADS // tpp)
    while ppb > 1 and ppb * T * tpp * 4 > STACK_SMEM_LIMIT:
        ppb //= 2
    while tpp > 32 and T * tpp * 4 > STACK_SMEM_LIMIT:
        tpp //= 2
    W = tpp * ppb // 32
    smem = 4 * (W * T * 32) + 8 * W * T + 4 * (MAX_FIDS + MAX_CONSTS) + 8 * W + 4 * W * (tpp // 32)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"max_nodes {T} needs {smem} bytes of shared memory per block"
        )
    return {
        "stack_depth": S,
        "opcode_block": B,
        "dispatch": D,
        "optimize": bool(gp.optimize),
        "pop": int(pop),
        "samples": int(n_samples),
        "max_nodes": T,
        "threads_per_program": tpp,
        "programs_per_block": ppb,
        "block_threads": tpp * ppb,
        "grid": -(-pop // ppb),
        "programs_per_round": tpp * ppb // 32,
        "samples_per_thread": -(-n_samples // tpp),
        "smem_bytes": smem,
        "path": "cuda",
    }


def kernel_order_scores(preds: torch.Tensor, y: torch.Tensor, threads_per_program: int) -> torch.Tensor:
    """``-RMSE`` of ``(P, B)`` predictions summed in the kernel's order:
    thread ``lane`` adds the squared errors of samples ``lane + j * tpp``
    in j order, each warp folds its 32 lanes by the ``__shfl_down_sync``
    tree (offsets 16, 8, 4, 2, 1), the warps' sums are added in warp
    order, then ``-sqrt(sq / B)``, non-finite as ``-inf``. Only tests
    and ``chip_smoke.py`` call it: it pins the kernel's sum bit for bit
    where the predictions are exact."""
    P, B = preds.shape
    tpp = int(threads_per_program)
    J = -(-B // tpp)
    err = preds.float() - y.float()[None, :]
    sq = torch.zeros((P, J * tpp), dtype=torch.float32, device=preds.device)
    sq[:, :B] = err * err  # a sample past B adds +0.0, which leaves every sum as it is
    acc = sq[:, :tpp]
    for j in range(1, J):
        acc = acc + sq[:, j * tpp:(j + 1) * tpp]
    acc = acc.reshape(P, tpp // 32, 32)
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o:2 * o]
    total = acc[:, 0, 0]
    for w in range(1, tpp // 32):
        total = total + acc[:, w, 0]
    # A division by a full tensor: on CUDA, torch divides by a scalar as a
    # product with its reciprocal, which is not sq / B rounded once.
    return sanitize(-torch.sqrt(total / torch.full_like(total, float(B))))


def gp_plan_cost(
    plan: dict,
    pop: int,
    gp: GPConfig,
    n_samples: int,
    *,
    live_tokens: float,
    function_tokens: float,
    optimize: Optional[bool] = None,
) -> dict:
    """The least time one evaluation could take on an H100: the larger
    of its bytes over 3.35 TB/s and its float32 operations over
    67 TFLOP/s, counted from these inputs (:func:`token_counts`).
    Bytes: the live tokens of compacted programs (opcode and operand)
    and their lengths, or every gene of raw genomes (the skip rule needs
    them all), the samples and targets, each read once, and the scores
    written once. Operations: one per function token that executes and
    sample (a push is a load, not an operation), plus three per sample
    (difference, square, sum)."""
    B = n_samples
    opt = bool(plan["optimize"] if optimize is None else optimize)
    tokens = float(live_tokens) * (4 + 4) + pop * 4 if opt else pop * gp.genome_len * 4
    nbytes = tokens + gp.n_vars * B * 4 + B * 4 + pop * 4
    ops = float(function_tokens) * B + 3.0 * pop * B
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return {
        "bytes": int(nbytes),
        "operations": ops,
        "bound_s": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "tokens_per_program": float(live_tokens) / pop,
    }


def token_counts(m, gp: GPConfig) -> dict:
    """The tokens one evaluation of ``m`` executes: ``live`` (every
    executed token) and ``functions`` (those of arity >= 1), summed over
    the programs. An ``EvalProgram`` executes its first ``length``
    tokens (LIT is a leaf); raw genomes the skip rule's live tokens."""
    if isinstance(m, EvalProgram):
        T = gp.max_nodes
        live = torch.arange(T, device=m.ops.device)[None, :] < m.length[:, None]
        ops = m.ops
    else:
        st = program_structure(m, gp)
        live, ops = st.live, decode_ops(m, gp)
    # The extended table: LIT (= n_ops) is a leaf.
    arity = arity_table(gp, ops.device)
    arity = torch.cat([arity, arity.new_zeros(1)])
    fn = live & (arity[ops.long().clamp(0, gp.n_ops)] >= 1)
    return {"live": int(live.sum()), "functions": int(fn.sum())}


def function_ids(gp: GPConfig) -> list:
    """The kernel's function id of every opcode, LIT last."""
    return [FUNCTION_IDS[n] for n in gp.op_names()] + [FUNCTION_IDS["lit"]]


def make_gp_eval(
    gp: GPConfig,
    X,
    y,
    *,
    pop: Optional[int] = None,
    stack_depth: Optional[int] = None,
    opcode_block: Optional[int] = None,
    dispatch: Optional[str] = None,
    optimize: Optional[bool] = None,
) -> Callable:
    """Build the evaluator: ``fn(genomes (P, 2T) | EvalProgram) -> (P,)``
    float32 ``-RMSE`` scores, non-finite as ``-inf``. With
    ``optimize`` (None = ``gp.optimize``) raw genomes are compacted
    first (``gp/optimize.optimize_for_eval``) and an ``EvalProgram`` is
    accepted as it is; without, raw genomes run all ``max_nodes``
    tokens. ``pop`` only checks the knobs early; the plan follows each
    call's P. ``fn.plan(P)`` is the plan of a P-row call."""
    xt_np, y_np = samples(X, y, gp.n_vars)
    n_samples = y_np.shape[0]
    knobs = dict(stack_depth=stack_depth, opcode_block=opcode_block, dispatch=dispatch)
    gp_eval_plan(pop or 1, gp, n_samples, **knobs)
    opt_on = bool(gp.optimize if optimize is None else optimize)
    consts = list(gp.consts or (0.0,))
    data = DeviceData(xt_np, y_np)
    tables = DeviceData(
        torch.tensor(consts, dtype=torch.float32).numpy(),
        torch.tensor(function_ids(gp), dtype=torch.int32).numpy(),
    )
    plans: dict = {}

    def plan(P: int) -> dict:
        if P not in plans:
            p = gp_eval_plan(P, gp, n_samples, **knobs)
            plans[P] = p and {**p, "optimize": opt_on}
        return plans[P]

    def fn(m):
        is_prog = isinstance(m, EvalProgram)
        if is_prog and not opt_on:
            raise ValueError("this evaluator scores raw genomes (optimize=False)")
        if opt_on and not is_prog:
            m = optimize_for_eval(m, gp)
        first = m.ops if opt_on else m
        xt, ya = data.on(first.device)
        if first.is_cuda:
            c, fids = tables.on(first.device)
            return kernels.gp_eval_cuda(
                xt=xt, y=ya, consts=c, fids=fids, plan=plan(first.shape[0]),
                max_nodes=gp.max_nodes, n_ops=gp.n_ops,
                **({"prog": m} if opt_on else {"genomes": m.contiguous()}),
            )
        return gp_eval_reference(m, xt, ya, gp, **knobs)

    fn.plan = plan
    fn.optimize = opt_on
    return fn
