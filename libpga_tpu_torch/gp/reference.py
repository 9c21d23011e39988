"""Pure-numpy reference interpreter: the GP semantics oracle (a copy of
``libpga_tpu/gp/reference.py`` over the port's encoding).

- tokens execute left to right; a ``pad`` token, or a token whose arity
  exceeds the current stack depth, is a no-op (the skip rule);
- binary operands pop right-then-left (postfix ``a b op`` is
  ``op(a, b)``);
- protected forms: ``div(a, b) = 1.0 where |b| < DIV_EPS``,
  ``sqrt(x) = sqrt(|x|)``, ``log(x) = log(|x| + LOG_EPS)``;
- the program's value is the top of the stack; an empty stack reads 0.
"""

from __future__ import annotations

import numpy as np

from libpga_tpu_torch.gp.encoding import (
    DIV_EPS,
    LOG_EPS,
    PAD_OP,
    GPConfig,
    program_length,
)


def _apply(name: str, a, b):
    """One function-table entry over numpy operands."""
    if name == "neg":
        return -a
    if name == "sin":
        return np.sin(a)
    if name == "cos":
        return np.cos(a)
    if name == "sqrt":
        return np.sqrt(np.abs(a))
    if name == "abs":
        return np.abs(a)
    if name == "exp":
        return np.exp(a)
    if name == "log":
        return np.log(np.abs(a) + np.float32(LOG_EPS))
    if name == "add":
        return a + b
    if name == "sub":
        return a - b
    if name == "mul":
        return a * b
    if name == "div":
        return np.where(np.abs(b) < DIV_EPS, np.float32(1.0), a / np.where(
            np.abs(b) < DIV_EPS, np.float32(1.0), b
        ))
    if name == "min":
        return np.minimum(a, b)
    if name == "max":
        return np.maximum(a, b)
    raise ValueError(f"unknown op {name!r}")


def reference_predict(
    genomes: np.ndarray, X: np.ndarray, gp: GPConfig
) -> np.ndarray:
    """``(P, 2 * max_nodes)`` genes (any values) and ``(B, n_vars)``
    samples -> ``(P, B)`` float32 predictions."""
    g = np.asarray(genomes, np.float32)
    X = np.asarray(X, np.float32)
    P = g.shape[0]
    B = X.shape[0]
    names = gp.op_names()
    arity = gp.op_arities()
    consts = np.asarray(gp.consts, np.float32)
    ops = np.clip(
        np.floor(g[:, 0::2] * gp.n_ops).astype(np.int64), 0, gp.n_ops - 1
    )
    args = g[:, 1::2]
    out = np.zeros((P, B), np.float32)
    with np.errstate(all="ignore"):
        for p in range(P):
            stack: list = []
            for t in range(gp.max_nodes):
                op = int(ops[p, t])
                name = names[op]
                a = arity[op]
                if op == PAD_OP or len(stack) < a:
                    continue
                if name == "var":
                    v = min(int(args[p, t] * gp.n_vars), gp.n_vars - 1)
                    stack.append(X[:, max(v, 0)].astype(np.float32))
                elif name == "const":
                    c = min(int(args[p, t] * len(consts)), len(consts) - 1)
                    stack.append(np.full(B, consts[max(c, 0)], np.float32))
                elif a == 1:
                    stack.append(
                        _apply(name, stack.pop(), None).astype(np.float32)
                    )
                else:
                    rhs = stack.pop()
                    lhs = stack.pop()
                    stack.append(_apply(name, lhs, rhs).astype(np.float32))
            if stack:
                out[p] = stack[-1]
    return out


def reference_scores(
    genomes: np.ndarray,
    X: np.ndarray,
    y: np.ndarray,
    gp: GPConfig,
    parsimony: float = 0.0,
) -> np.ndarray:
    """``-RMSE`` (higher is better) minus an optional per-live-token
    parsimony penalty; non-finite scores read ``-inf``."""
    preds = reference_predict(genomes, X, gp)
    y = np.asarray(y, np.float32)
    with np.errstate(all="ignore"):
        rmse = np.sqrt(np.mean((preds - y[None, :]) ** 2, axis=1))
        scores = -rmse
        if parsimony:
            lengths = np.asarray(
                [program_length(row, gp) for row in np.asarray(genomes)],
                np.float32,
            )
            scores = scores - np.float32(parsimony) * lengths
    return np.where(np.isfinite(scores), scores, -np.inf).astype(np.float32)
