"""Batched stack-machine interpreter for postfix GP genomes: the plain
PyTorch versions of the CUDA evaluator (``csrc/gp_eval.cu``) and the
torch counterpart of ``libpga_tpu/gp/interpreter.py``.

- :func:`stack_predict` runs the static ``max_nodes`` trips over raw
  genomes: the plain version of B2′ (``ops/gp_eval.py:309`` ``kernel``).
- :func:`stack_predict_program` runs a compacted
  :class:`~libpga_tpu_torch.gp.optimize.EvalProgram`, sorted by live
  length in segments that each stop at their own longest program: the
  plain version of B2 (``ops/gp_eval.py:334`` ``kernel_opt``).
- :func:`gp_eval_reference` turns either into ``-RMSE`` scores (the one
  plain scorer); :func:`make_eval_rows` wraps it with the dataset, the
  optimizer and the parsimony term (:func:`with_parsimony`).

The value stack is an ``(S, P, B)`` tensor and the per-row stack pointer
a ``(P,)`` vector. JAX reads and writes the stack through iota-compare
masks (the only form a TPU kernel lowers); here it is a gather and a
scatter along the stack axis, which read and write the same values.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from libpga_tpu_torch.gp.encoding import (
    DIV_EPS,
    LOG_EPS,
    PAD_OP,
    GPConfig,
    decode_args,
    decode_ops,
)
from libpga_tpu_torch.gp.optimize import EvalProgram, optimize_for_eval


def _div(a, b):
    small = torch.abs(b) < DIV_EPS
    return torch.where(small, 1.0, a / torch.where(small, 1.0, b))


_UNARY_FNS = {
    "neg": lambda a: -a,
    "sin": torch.sin,
    "cos": torch.cos,
    "sqrt": lambda a: torch.sqrt(torch.abs(a)),
    "abs": torch.abs,
    "exp": torch.exp,
    "log": lambda a: torch.log(torch.abs(a) + LOG_EPS),
}

_BINARY_FNS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": _div,
    "min": torch.minimum,
    "max": torch.maximum,
}

#: Rows per length-sorted segment of the live-length path.
SEG_ROWS = 128


def _check_knobs(gp: GPConfig, stack_depth, opcode_block) -> int:
    S = int(stack_depth or gp.required_stack())
    block = int(opcode_block or 1)
    T = gp.max_nodes
    if S < gp.required_stack():
        raise ValueError(
            f"stack_depth {S} < required bound {gp.required_stack()} "
            f"(a well-formed {T}-token program can hold {T} values)"
        )
    if T % block:
        raise ValueError(f"opcode_block {block} does not divide {T}")
    return S


def make_token_step(
    gp: GPConfig, *, dispatch: Optional[str] = None, lit: bool = False
) -> Callable:
    """``step(stack (S, P, B), sp (P,) int32, op (P,) int32, arg (P,),
    xt (n_vars, B), consts (n_consts,)) -> (stack, sp)``; updates
    ``stack`` in place.

    A token executes when ``op != PAD``, ``sp >= a`` and ``sp - a < S``
    (the skip rule). ``dispatch`` "dense" selects among every function
    applied to the operands; "blocked" selects within each arity class,
    then by arity, and computes sub as ``sec + (-top)``. Both give the
    same IEEE results. ``lit=True`` adds the optimizer's LIT opcode
    (``n_ops``, arity 0, value = operand)."""
    names = gp.op_names()
    const_op = names.index("const") if gp.consts else -1
    unary_ids = [(names.index(n), _UNARY_FNS[n]) for n in gp.unary]
    binary_ids = [(names.index(n), _BINARY_FNS[n]) for n in gp.binary]
    n_vars = gp.n_vars
    n_consts = len(gp.consts)
    mode = dispatch or gp.dispatch or "dense"
    if mode not in ("dense", "blocked"):
        raise ValueError(
            f"gp_dispatch must be 'dense' or 'blocked'; got {mode!r}"
        )
    arities = list(gp.op_arities()) + ([0] if lit else [])
    lit_id = gp.n_ops if lit else None
    tables = {}

    def step(stack, sp, op, arg, xt, consts):
        S, P, B = stack.shape
        dev = stack.device
        if dev not in tables:
            tables[dev] = torch.tensor(arities, dtype=torch.int32, device=dev)
        a_of = tables[dev][op.long()]
        top_i = torch.clamp(sp - 1, 0, S - 1).long()
        sec_i = torch.clamp(sp - 2, 0, S - 1).long()
        top = torch.gather(stack, 0, top_i[None, :, None].expand(1, P, B))[0]
        sec = torch.gather(stack, 0, sec_i[None, :, None].expand(1, P, B))[0]

        opb = op[:, None]
        argb = arg[:, None]
        vidx = torch.clamp(
            torch.floor(arg * n_vars).to(torch.int64), 0, n_vars - 1
        )
        leaf = xt[vidx]
        if const_op >= 0:
            cidx = torch.clamp(
                torch.floor(arg * n_consts).to(torch.int64), 0, n_consts - 1
            )
            leaf = torch.where(opb == const_op, consts[cidx][:, None], leaf)
        if lit_id is not None:
            leaf = torch.where(opb == lit_id, argb, leaf)

        if mode == "dense":
            res = leaf
            for k, fn in unary_ids:
                res = torch.where(opb == k, fn(top), res)
            for k, fn in binary_ids:
                res = torch.where(opb == k, fn(sec, top), res)
        else:
            abm = a_of[:, None]
            res = leaf
            if unary_ids:
                (_, f0), rest = unary_ids[0], unary_ids[1:]
                un = f0(top)
                for k, fn in rest:
                    un = torch.where(opb == k, fn(top), un)
                res = torch.where(abm == 1, un, res)
            if binary_ids:
                if "add" in gp.binary and "sub" in gp.binary:
                    sub_id = names.index("sub")
                    bi = sec + torch.where(opb == sub_id, -top, top)
                    rest = [
                        (names.index(n), _BINARY_FNS[n])
                        for n in gp.binary if n not in ("add", "sub")
                    ]
                else:
                    (_, f0), rest = binary_ids[0], binary_ids[1:]
                    bi = f0(sec, top)
                for k, fn in rest:
                    bi = torch.where(opb == k, fn(sec, top), bi)
                res = torch.where(abm == 2, bi, res)

        ex = (op != PAD_OP) & (sp >= a_of) & (sp - a_of < S)
        nsp = torch.where(ex, sp - a_of + 1, sp)
        w = torch.clamp(nsp - 1, 0, S - 1).long()[None, :, None].expand(1, P, B)
        cur = torch.gather(stack, 0, w)[0]
        stack.scatter_(0, w, torch.where(ex[:, None], res, cur)[None])
        return stack, nsp

    return step


def _top(stack: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """The value on top of each row's stack, 0.0 when it is empty."""
    S, P, B = stack.shape
    i = torch.clamp(sp - 1, 0, S - 1).long()[None, :, None].expand(1, P, B)
    return torch.where(sp[:, None] > 0, torch.gather(stack, 0, i)[0], 0.0)


def _consts(gp: GPConfig, device) -> torch.Tensor:
    return torch.tensor(gp.consts or (0.0,), dtype=torch.float32, device=device)


def stack_predict(
    genomes: torch.Tensor,
    xt: torch.Tensor,
    gp: GPConfig,
    *,
    stack_depth: Optional[int] = None,
    opcode_block: Optional[int] = None,
    dispatch: Optional[str] = None,
) -> torch.Tensor:
    """``(P, 2T)`` genomes x ``(n_vars, B)`` variable-major samples ->
    ``(P, B)`` predictions, over all ``max_nodes`` token positions."""
    S = _check_knobs(gp, stack_depth, opcode_block)
    P = genomes.shape[0]
    B = xt.shape[1]
    ops = decode_ops(genomes, gp)
    args = decode_args(genomes, gp)
    consts = _consts(gp, genomes.device)
    step = make_token_step(gp, dispatch=dispatch)
    stack = torch.zeros((S, P, B), dtype=torch.float32, device=genomes.device)
    sp = torch.zeros(P, dtype=torch.int32, device=genomes.device)
    for t in range(gp.max_nodes):
        stack, sp = step(stack, sp, ops[:, t], args[:, t], xt, consts)
    return _top(stack, sp)


def stack_predict_program(prog, xt, gp: GPConfig, **kw) -> torch.Tensor:
    """Run the stack machine over a compacted ``EvalProgram``: rows
    sorted by live length, each segment of ``seg_rows`` rows stopping
    at its own longest program. Returns ``(P, B)`` in input order."""
    preds, inv = _predict_program_sorted(prog, xt, gp, **kw)
    return preds[inv]


def _predict_program_sorted(
    prog,
    xt: torch.Tensor,
    gp: GPConfig,
    *,
    stack_depth: Optional[int] = None,
    opcode_block: Optional[int] = None,
    dispatch: Optional[str] = None,
    seg_rows: Optional[int] = None,
):
    """:func:`stack_predict_program` minus the final un-permute: returns
    ``(preds in live-length order, inv)``."""
    S = _check_knobs(gp, stack_depth, opcode_block)
    P = prog.ops.shape[0]
    B = xt.shape[1]
    dev = prog.ops.device
    consts = _consts(gp, dev)
    step = make_token_step(gp, dispatch=dispatch, lit=True)
    R = int(seg_rows or min(P, SEG_ROWS))
    order = torch.sort(prog.length, stable=True).indices
    inv = torch.argsort(order)
    ops_s, args_s = prog.ops[order], prog.args[order]
    seg_max = torch.zeros(-(-P // R), dtype=torch.int64, device=dev)
    seg_max.scatter_reduce_(
        0, torch.arange(P, device=dev) // R, prog.length[order].long(), "amax"
    )
    preds = []
    for g, maxlen in enumerate(seg_max.tolist()):
        o, a = ops_s[g * R:(g + 1) * R], args_s[g * R:(g + 1) * R]
        stack = torch.zeros((S, o.shape[0], B), dtype=torch.float32, device=dev)
        sp = torch.zeros(o.shape[0], dtype=torch.int32, device=dev)
        for t in range(min(maxlen, gp.max_nodes)):
            stack, sp = step(stack, sp, o[:, t], a[:, t], xt, consts)
        preds.append(_top(stack, sp))
    return torch.cat(preds), inv


def rmse_scores(preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``-sqrt(mean((preds - y)^2))`` per row."""
    err = preds - y[None, :]
    return -torch.sqrt(torch.mean(err * err, dim=1))


def sanitize(score: torch.Tensor) -> torch.Tensor:
    """Non-finite scores (overflow, NaN) read -inf."""
    return torch.where(torch.isfinite(score), score, -torch.inf).to(torch.float32)


def samples(X, y, n_vars: int):
    """Validate a dataset: ``(xt (n_vars, B), y (B,))`` float32 numpy."""
    Xa = np.asarray(X, np.float32)
    if Xa.ndim == 1:
        Xa = Xa[:, None]
    if Xa.shape[1] != n_vars:
        raise ValueError(f"X has {Xa.shape[1]} columns; GPConfig.n_vars is {n_vars}")
    ya = np.asarray(y, np.float32).reshape(-1)
    if ya.shape[0] != Xa.shape[0]:
        raise ValueError(f"X has {Xa.shape[0]} samples but y has {ya.shape[0]}")
    return np.ascontiguousarray(Xa.T), ya


class DeviceData:
    """Numpy arrays copied to each device on first use."""

    def __init__(self, *arrays):
        self.arrays = arrays
        self.cache = {}

    def on(self, device):
        if device not in self.cache:
            self.cache[device] = tuple(
                torch.from_numpy(np.array(a)).to(device) for a in self.arrays
            )
        return self.cache[device]


def gp_eval_reference(m, xt: torch.Tensor, y: torch.Tensor, gp: GPConfig, **knobs) -> torch.Tensor:
    """The plain version of the CUDA evaluator, on any device: an
    ``EvalProgram`` through the live-length path (B2), raw genomes
    through the static path (B2′), then ``-RMSE`` with non-finite scores
    as ``-inf``. ``knobs``: ``stack_depth``, ``opcode_block``,
    ``dispatch``, ``seg_rows`` (programs only)."""
    if isinstance(m, EvalProgram):
        preds, inv = _predict_program_sorted(m, xt, gp, **knobs)
        return sanitize(rmse_scores(preds, y)[inv])
    return sanitize(rmse_scores(stack_predict(m, xt, gp, **knobs), y))


def with_parsimony(score: Callable, gp: GPConfig, parsimony: float) -> Callable:
    """``rows(m) = score(m) - parsimony * nonpad_tokens(m)`` (a ``-inf``
    score stays ``-inf``). The penalty counts the stored genome's
    tokens, so with ``parsimony`` an ``EvalProgram`` is refused."""
    pfloat = float(parsimony)
    if not pfloat:
        return score

    def rows(m):
        if isinstance(m, EvalProgram):
            raise ValueError(
                "parsimony scoring counts the stored genome's tokens; "
                "pass the gene matrix, not an EvalProgram"
            )
        return score(m) - pfloat * nonpad_tokens(m, gp)

    return rows


def make_eval_rows(
    gp: GPConfig,
    X,
    y,
    *,
    stack_depth: Optional[int] = None,
    opcode_block: Optional[int] = None,
    parsimony: float = 0.0,
    optimize: Optional[bool] = None,
    dispatch: Optional[str] = None,
) -> Callable:
    """Whole-population symbolic-regression scorer in plain torch:
    ``rows(genomes | EvalProgram) -> (P,)`` float32 ``-RMSE`` by
    :func:`gp_eval_reference`, minus ``parsimony`` per non-pad token of
    the stored genome. ``optimize`` (None = ``gp.optimize``) compacts the
    genomes first and runs the live-length path; the reduction over
    samples runs in sorted order, then the rows are un-permuted, as in
    the JAX package."""
    xt_np, y_np = samples(X, y, gp.n_vars)
    data = DeviceData(xt_np, y_np)
    opt_on = bool(gp.optimize if optimize is None else optimize)
    knobs = dict(stack_depth=stack_depth, opcode_block=opcode_block, dispatch=dispatch)

    def score(m):
        if opt_on and not isinstance(m, EvalProgram):
            m = optimize_for_eval(m, gp)
        xt, ya = data.on((m.ops if isinstance(m, EvalProgram) else m).device)
        return gp_eval_reference(m, xt, ya, gp, **knobs)

    return with_parsimony(score, gp, parsimony)


def nonpad_tokens(genomes: torch.Tensor, gp: GPConfig) -> torch.Tensor:
    """(P,) float32 count of non-pad tokens (the parsimony measure)."""
    return (decode_ops(genomes, gp) != PAD_OP).to(torch.float32).sum(dim=1)
