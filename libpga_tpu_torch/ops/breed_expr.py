"""Crossover and mutation from expressions: the port's counterpart of
``libpga_tpu/ops/breed_expr.py``.

Variables (per gene, broadcasting; ``P`` rows by ``L`` genes):

- crossover: ``p1``, ``p2`` (the selected parents);
- mutation: ``g`` (the child) plus ``rate`` / ``sigma`` (the mutation's
  runtime parameters: the breed kernel reads them from ``mparams``, so
  operators that differ only in them share one build);
- both: ``r``, ``r2`` (two per-gene uniform [0, 1) streams), ``q``,
  ``q2`` (two per-row uniforms), ``i`` (gene index), ``L``, literals,
  ``pi``, ``e``, and registered scalar or length-L vector constants.

Breeding expressions are strictly per gene: reductions (``sum``,
``mean``, one-argument ``min``/``max``, ``dot``) and ``roll`` /
``gather`` are rejected when the operator is made. Results are clipped
into ``[0, 1 - 1e-7]`` (NaN stays NaN, as ``jnp.clip`` leaves it).

On the deme path the breed kernel evaluates the operator per gene:
``ops/expr_cuda.py`` lowers the syntax tree into a CUDA ``__device__``
function of ``csrc/expr_breed.cu`` (B6), fed by its own Philox streams.
``.batched`` is the panmictic path's form: the extra streams ``r2``,
``q``, ``q2`` are bit-mixed from the one ``(P, L)`` uniform block
(:func:`derived_streams`, the JAX package's mixing bit for bit).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from libpga_tpu_torch.objectives.expr import (
    ExpressionError,
    _emit,
    _Parser,
    const_tensors,
    gene_env,
    validate_const,
    walk_ast,
)
from libpga_tpu_torch.ops.mutate import _MASK32, _mul32

GENE_MAX = 1.0 - 1e-7  # the library-wide open-interval gene ceiling

CROSS_VARS = ("p1", "p2", "r", "r2", "q", "q2", "i", "L")
MUT_VARS = ("g", "r", "r2", "q", "q2", "i", "L", "rate", "sigma")
STREAMS = ("r", "r2", "q", "q2")


def _forbid_non_elementwise(node) -> None:
    kind = node[0]
    if kind in ("roll", "gather"):
        raise ExpressionError(
            f"{kind}() is not available in breeding expressions — they "
            f"are strictly per-gene (the kernel block is lane-padded)"
        )
    if kind == "call":
        fname, args = node[1], node[2]
        if fname in ("sum", "mean", "dot") or (
            fname in ("min", "max") and len(args) == 1
        ):
            raise ExpressionError(
                f"{fname}() reductions are not available in breeding "
                f"expressions — they are strictly per-gene (the kernel "
                f"block is lane-padded, so a reduction would include "
                f"pad lanes)"
            )


def _compile_breeding(role: str, expr: str, var_names, consts):
    """Parse and validate a breeding expression. Returns ``(ast,
    const_names, const_arrays, pinned_len, cache_key, used_vars)``; the
    cache key is the compiled semantics (role, source, constant values),
    not the mutation's rate and sigma."""
    const_vals: Dict[str, np.ndarray] = {
        name: validate_const(name, v, allow_2d=False, extra_reserved=var_names)
        for name, v in consts.items()
    }
    ast = _Parser(expr, set(const_vals), var_names=var_names).parse()
    used: set = set()
    used_vars: set = set()

    def visit(node):
        _forbid_non_elementwise(node)
        if node[0] == "const":
            used.add(node[1])
        elif node[0] == "var":
            used_vars.add(node[1])

    walk_ast(ast, visit)
    const_vals = {n: a for n, a in const_vals.items() if n in used}
    const_names = sorted(const_vals)
    vec_lens = {a.shape[0] for a in const_vals.values() if a.ndim == 1}
    if len(vec_lens) > 1:
        raise ExpressionError(
            f"vector constants disagree on genome length: {sorted(vec_lens)}"
        )
    pinned = vec_lens.pop() if vec_lens else None
    cache_key = (
        role, expr,
        tuple((n, const_vals[n].shape, const_vals[n].tobytes()) for n in const_names),
    )
    arrays = tuple(const_vals[n] for n in const_names)
    return ast, tuple(const_names), arrays, pinned, cache_key, used_vars


def derived_streams(r: torch.Tensor):
    """``(r2, q, q2)`` bit-mixed from the ``(P, L)`` uniform block ``r``
    (``_derived_streams`` of the JAX package, the same uint32 mixing): a
    second per-gene stream and two per-row (P, 1) uniforms from gene 0's
    bits."""
    bits = (r * float(2**24)).to(torch.int64) & _MASK32
    m1 = (_mul32(bits, 2654435761) + 0x9E3779B9) & _MASK32
    r2 = (m1 & 0xFFFFFF).to(torch.float32) / float(2**24)
    row = bits[:, 0:1]
    mq = (_mul32(row, 2246822519) + 0x85EBCA6B) & _MASK32
    q = (mq & 0xFFFFFF).to(torch.float32) / float(2**24)
    mq2 = (_mul32(mq, 2654435761) + 0x27220A95) & _MASK32
    q2 = (mq2 & 0xFFFFFF).to(torch.float32) / float(2**24)
    return r2, q, q2


def _probe(rows, n_gene_args: int, n_row_args: int, probe_len: int):
    """Run the rowwise form once on zeros: a shape error surfaces when
    the operator is made."""
    gene = torch.zeros((2, probe_len))
    row = torch.zeros((2, 1))
    try:
        rows(*([gene] * n_gene_args), *([row] * n_row_args))
    except ExpressionError:
        raise
    except Exception as exc:  # noqa: BLE001 — rewrap with the source
        raise ExpressionError(f"invalid expression: {exc}") from exc


def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, GENE_MAX)


def _annotate(op, role, consts_on, ast, const_names, arrays, pinned, cache_key, used_vars, expr):
    op.kernel_rows.uses = frozenset(used_vars & set(STREAMS))
    op.kernel_consts = consts_on("cpu")
    op.kernel_cache_key = cache_key
    op.expression = expr
    op.pinned_genome_len = pinned
    op.role = role
    op.ast = ast
    op.const_names = const_names
    op.const_arrays = arrays


def crossover_from_expression(expr: str, **consts) -> Callable:
    """A crossover ``(p1, p2, rand) -> child`` from an expression, with
    ``.batched`` (the panmictic form) and the breed kernel's hook:
    ``.kernel_rows(p1, p2, r, r2, q, q2, *consts, true_len=None)`` (its
    plain version; ``.kernel_rows.uses`` names the random streams it
    reads), ``.kernel_consts``, ``.kernel_cache_key``, ``.expression``,
    ``.pinned_genome_len``, and ``.ast`` / ``.const_names`` /
    ``.const_arrays`` for the code generator. See the module docstring
    for the variables."""
    compiled = _compile_breeding("crossover-expr", expr, CROSS_VARS, consts)
    ast, const_names, arrays = compiled[:3]
    consts_on = const_tensors(arrays)

    def rows(p1, p2, r, r2, q, q2, *cargs, true_len=None):
        env = gene_env(p1.shape, p1.device, true_len)
        env.update(
            p1=p1, p2=p2, r=r, r2=r2, q=q, q2=q2, table_kinds={},
            consts=dict(zip(const_names, cargs or consts_on(p1.device))),
        )
        return _clip(torch.broadcast_to(_emit(ast, env), p1.shape))

    def batched(p1, p2, rand):
        r = rand.to(torch.float32)
        r2, q, q2 = derived_streams(r)
        return rows(p1.to(torch.float32), p2.to(torch.float32), r, r2, q, q2).to(p1.dtype)

    def op(p1, p2, rand):
        return batched(p1[None, :], p2[None, :], rand[None, :])[0]

    op.batched = batched
    op.kernel_rows = rows
    _annotate(op, "crossover", consts_on, *compiled, expr)
    _probe(rows, 4, 2, op.pinned_genome_len or 8)
    op.__doc__ = f"Expression crossover: {expr}"
    return op


def mutate_from_expression(
    expr: str, rate: float = 0.01, sigma: float = 0.0, **consts
) -> Callable:
    """A mutation ``(genome, rand) -> genome`` from an expression, with
    ``.batched`` and the breed kernel's hook ``.kernel_rows(g, r, r2, q,
    q2, rate, sigma, *consts, true_len=None)``, the attributes of
    :func:`crossover_from_expression`, and ``.rate`` / ``.sigma``: the
    values the expression's ``rate`` and ``sigma`` take (the kernel's
    runtime ``mparams``, left out of ``.kernel_cache_key``)."""
    compiled = _compile_breeding("mutate-expr", expr, MUT_VARS, consts)
    ast, const_names, arrays = compiled[:3]
    consts_on = const_tensors(arrays)

    def rows(g, r, r2, q, q2, rate_v, sigma_v, *cargs, true_len=None):
        env = gene_env(g.shape, g.device, true_len)
        env.update(
            g=g, r=r, r2=r2, q=q, q2=q2, table_kinds={},
            rate=torch.as_tensor(rate_v, dtype=torch.float32),
            sigma=torch.as_tensor(sigma_v, dtype=torch.float32),
            consts=dict(zip(const_names, cargs or consts_on(g.device))),
        )
        return _clip(torch.broadcast_to(_emit(ast, env), g.shape))

    def batched(g, rand):
        r = rand.to(torch.float32)
        r2, q, q2 = derived_streams(r)
        return rows(g.to(torch.float32), r, r2, q, q2, rate, sigma).to(g.dtype)

    def op(genome, rand):
        return batched(genome[None, :], rand[None, :])[0]

    op.batched = batched
    op.kernel_rows = rows
    _annotate(op, "mutate", consts_on, *compiled, expr)
    _probe(lambda g, r, r2, q, q2: rows(g, r, r2, q, q2, 0.5, 0.1), 3, 2,
           op.pinned_genome_len or 8)
    op.rate = rate
    op.sigma = sigma
    op.__doc__ = f"Expression mutation: {expr}"
    return op
