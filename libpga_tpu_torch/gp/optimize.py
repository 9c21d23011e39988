"""Eval-time program optimizer: canonicalize, constant-fold, dead-code
eliminate, compact (the torch counterpart of ``libpga_tpu/gp/optimize.py``).

One forward walk over the token positions (the ``program_structure``
walk, carrying folded values and subtree heads beside the stack
pointer) classifies every token; one reverse walk propagates "needed"
from the final top down to the children; one stable sort compacts the
survivors:

- dead tokens (the skip rule's no-ops) are dropped;
- a maximal constant-headed subtree collapses to one ``LIT`` token
  (opcode ``n_ops``) whose operand is the value folded with the
  interpreter's own function table, on the genomes' device;
- a live subtree whose value is never consumed and is not the final top
  is deleted whole.

Stored genomes are never touched: the result is a transient
:class:`EvalProgram` that only the evaluators read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libpga_tpu_torch.gp.encoding import (
    PAD_OP,
    GPConfig,
    arity_table,
    decode_args,
    decode_ops,
    program_structure,
)


class EvalProgram(NamedTuple):
    """The compacted eval buffer: ``ops`` (P, max_nodes) int32 over the
    extended table (LIT = ``n_ops``), ``args`` (P, max_nodes) float32
    (for LIT the folded value), ``length`` (P,) int32 live tokens after
    fold and DCE; tokens at positions >= length are pads."""

    ops: torch.Tensor
    args: torch.Tensor
    length: torch.Tensor


def lit_op(gp: GPConfig) -> int:
    """The synthetic literal opcode: one past the config's table."""
    return gp.n_ops


def _at(stack: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(stack, 1, i.long()[:, None])[:, 0]


def optimize_for_eval(genomes: torch.Tensor, gp: GPConfig) -> EvalProgram:
    """Fold + DCE + compact one gene matrix into an :class:`EvalProgram`
    (total over arbitrary gene values)."""
    from libpga_tpu_torch.gp.interpreter import _BINARY_FNS, _UNARY_FNS

    P, L = genomes.shape
    T = gp.max_nodes
    if L != 2 * T:
        raise ValueError(
            f"genome_len {L} != 2 * max_nodes ({2 * T}) for this GPConfig"
        )
    dev = genomes.device
    ops = decode_ops(genomes, gp)
    args = decode_args(genomes, gp)
    arity = arity_table(gp, dev)
    names = gp.op_names()
    const_op = names.index("const") if gp.consts else -1
    consts = torch.tensor(gp.consts or (0.0,), dtype=torch.float32, device=dev)
    n_consts = max(len(gp.consts), 1)
    unary_ids = [(names.index(n), _UNARY_FNS[n]) for n in gp.unary]
    binary_ids = [(names.index(n), _BINARY_FNS[n]) for n in gp.binary]
    iota_t = torch.arange(T, device=dev)[None, :]

    sp = torch.zeros(P, dtype=torch.int32, device=dev)
    vstk = torch.zeros((P, T), dtype=torch.float32, device=dev)
    cstk = torch.zeros((P, T), dtype=torch.bool, device=dev)
    hstk = torch.zeros((P, T), dtype=torch.int32, device=dev)
    pconst = torch.zeros((P, T), dtype=torch.bool, device=dev)
    live_c, rc_c, val_c, ch1_c, ch2_c = [], [], [], [], []
    none = torch.full((P,), -1, dtype=torch.int32, device=dev)
    for t in range(T):
        op, arg = ops[:, t], args[:, t]
        a = arity[op.long()]
        ex = (op != PAD_OP) & (sp >= a)
        i1 = torch.clamp(sp - 1, 0, T - 1)
        i2 = torch.clamp(sp - 2, 0, T - 1)
        topv, toph = _at(vstk, i1), _at(hstk, i1)
        topc = _at(cstk, i1) & (sp >= 1)
        secv, sech = _at(vstk, i2), _at(hstk, i2)
        secc = _at(cstk, i2) & (sp >= 2)
        # Folded value and const-headed flag, with the interpreter's own
        # functions in the same operand order.
        val = torch.zeros_like(arg)
        if const_op >= 0:
            cidx = torch.clamp(
                torch.floor(arg * n_consts).to(torch.int64), 0, n_consts - 1
            )
            val = torch.where(op == const_op, consts[cidx], val)
            rc = op == const_op
        else:
            rc = torch.zeros_like(ex)
        for k, fn in unary_ids:
            val = torch.where(op == k, fn(topv), val)
            rc = torch.where(op == k, topc, rc)
        for k, fn in binary_ids:
            val = torch.where(op == k, fn(secv, topv), val)
            rc = torch.where(op == k, secc & topc, rc)
        # Popped operands take the PARENT's const flag: a const token
        # consumed by a const parent is fold interior; a const head with
        # a non-const parent (or none) is a fold root.
        m1 = ex & (a >= 1)
        m2 = ex & (a == 2)
        oh1 = (iota_t == toph[:, None]) & m1[:, None]
        oh2 = (iota_t == sech[:, None]) & m2[:, None]
        pconst = torch.where(oh1, rc[:, None], pconst)
        pconst = torch.where(oh2, rc[:, None], pconst)
        nsp = torch.where(ex, sp - a + 1, sp)
        ohw = (iota_t == torch.clamp(nsp - 1, 0, T - 1)[:, None]) & ex[:, None]
        vstk = torch.where(ohw, val[:, None], vstk)
        cstk = torch.where(ohw, (rc & ex)[:, None], cstk)
        hstk = torch.where(ohw, t, hstk)
        sp = nsp
        live_c.append(ex)
        rc_c.append(rc & ex)
        val_c.append(val)
        ch1_c.append(torch.where(m1, toph, none))
        ch2_c.append(torch.where(m2, sech, none))
    live, rcm, val = (torch.stack(c, dim=1) for c in (live_c, rc_c, val_c))

    # DCE: need propagates from the final top to the children, in one
    # reverse walk (a parent always follows its children in postfix).
    top_head = _at(hstk, torch.clamp(sp - 1, 0, T - 1))
    needed = (iota_t == top_head[:, None]) & (sp > 0)[:, None]
    for t in reversed(range(T)):
        nt = needed[:, t]
        o1 = (iota_t == ch1_c[t][:, None]) & nt[:, None]
        o2 = (iota_t == ch2_c[t][:, None]) & nt[:, None]
        needed = needed | o1 | o2

    keep_lit = live & needed & rcm & ~pconst
    keep = (live & needed & ~rcm) | keep_lit
    out_ops = torch.where(keep_lit, lit_op(gp), ops)
    out_args = torch.where(keep_lit, val, args)
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    ops_c = torch.gather(out_ops, 1, order)
    args_c = torch.gather(out_args, 1, order)
    length = keep.to(torch.int32).sum(dim=1, dtype=torch.int32)
    tail = iota_t >= length[:, None]
    ops_c = torch.where(tail, PAD_OP, ops_c).to(torch.int32)
    args_c = torch.where(tail, 0.5, args_c)
    return EvalProgram(ops=ops_c, args=args_c, length=length)


def live_lengths(genomes: torch.Tensor, gp: GPConfig) -> torch.Tensor:
    """``(P,)`` int32 post-optimization live lengths."""
    return optimize_for_eval(genomes, gp).length


def mean_live_length(genomes, gp: GPConfig) -> float:
    """Mean post-optimization live length (the token count the
    evaluator's bound prices)."""
    return float(live_lengths(genomes, gp).to(torch.float64).mean())


def compaction_stats(genomes, gp: GPConfig) -> dict:
    """Live token counts before (skip-rule live) and after (fold + DCE),
    and the fraction of live tokens removed."""
    before = program_structure(genomes, gp).length.cpu().numpy()
    after = live_lengths(genomes, gp).cpu().numpy()
    total_before = float(before.sum())
    return {
        "pop": int(before.shape[0]),
        "max_nodes": int(gp.max_nodes),
        "mean_live_before": float(before.mean()),
        "mean_live_after": float(after.mean()),
        "max_live_after": int(after.max()) if after.size else 0,
        "removed_frac": (
            float((before - after).sum() / total_before) if total_before else 0.0
        ),
    }

