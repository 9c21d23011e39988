"""Linear postfix tree encoding packed into fixed-width gene vectors: the
torch counterpart of ``libpga_tpu/gp/encoding.py``.

A program is ``max_nodes`` postfix tokens, each token TWO genes of the
ordinary ``(P, L)`` float population matrix (``L = 2 * max_nodes``):
gene ``2t`` is the opcode (``floor(g * n_ops)`` into the opcode table),
gene ``2t+1`` the operand (a variable column or constant-table row for
terminals; ignored by functions). Opcode 0 is ``pad``, then ``var``,
``const`` (when the constant table is non-empty), then the unary and
binary sets in declaration order.

The SKIP RULE makes every gene matrix a program: a pad token, or a token
whose arity exceeds the current stack depth, is a no-op. Every function
here keeps the JAX package's float32 arithmetic in the same order, so the
same uniform block gives the same genomes bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

#: Unary/binary function vocabulary. Protected forms keep every program
#: total: div guards |b| < DIV_EPS -> 1.0, sqrt takes |x|, log takes
#: log(|x| + LOG_EPS).
UNARY_NAMES: Tuple[str, ...] = ("neg", "sin", "cos", "sqrt", "abs", "exp", "log")
BINARY_NAMES: Tuple[str, ...] = ("add", "sub", "mul", "div", "min", "max")

DIV_EPS = 1e-6
LOG_EPS = 1e-9

PAD_OP = 0  #: opcode index 0 is always the pad token

#: Token-step dispatch strategies; ``None`` = auto (dense).
DISPATCH_KINDS: Tuple = (None, "dense", "blocked")


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Encoding of one GP search space (same fields, checks and
    ``cache_key`` as the JAX package's ``GPConfig``).

    Attributes:
      max_nodes: token capacity per program; genome length is
        ``2 * max_nodes``.
      n_vars: input-variable count.
      consts: constant table terminals may reference; empty drops the
        ``const`` opcode.
      unary / binary: enabled function names, in table order.
      min_nodes: ramped-init lower bound on program length.
      stack_depth: evaluator stack depth, None = ``max_nodes`` (the
        provable worst case); smaller values are rejected by
        ``ops/gp_eval.gp_eval_plan``.
      opcode_block: tokens per loop iteration of the TPU evaluator; must
        divide ``max_nodes``. The CUDA kernel reads it only to check it.
      optimize: compact programs before evaluation (``gp/optimize.py``).
      dispatch: token-step strategy of the plain version, "dense" or
        "blocked" (both score bit-identically).
    """

    max_nodes: int = 16
    n_vars: int = 1
    consts: Tuple[float, ...] = (0.5, 1.0, 2.0, 3.0, 5.0)
    unary: Tuple[str, ...] = ("neg", "sin", "cos")
    binary: Tuple[str, ...] = ("add", "sub", "mul", "div")
    min_nodes: int = 1
    stack_depth: Optional[int] = None
    opcode_block: Optional[int] = None
    optimize: bool = True
    dispatch: Optional[str] = None

    def __post_init__(self):
        if self.max_nodes < 2:
            raise ValueError("max_nodes must be >= 2")
        if self.n_vars < 1:
            raise ValueError("n_vars must be >= 1")
        bad = sorted(set(self.unary) - set(UNARY_NAMES))
        if bad:
            raise ValueError(
                f"unknown unary ops {bad}; available: {list(UNARY_NAMES)}"
            )
        bad = sorted(set(self.binary) - set(BINARY_NAMES))
        if bad:
            raise ValueError(
                f"unknown binary ops {bad}; available: {list(BINARY_NAMES)}"
            )
        if not (1 <= self.min_nodes <= self.max_nodes):
            raise ValueError("min_nodes must be in [1, max_nodes]")
        if self.stack_depth is not None and self.stack_depth < 1:
            raise ValueError("stack_depth must be >= 1 or None")
        if self.opcode_block is not None and (
            self.opcode_block < 1 or self.max_nodes % self.opcode_block
        ):
            raise ValueError(
                f"opcode_block must divide max_nodes ({self.max_nodes})"
            )
        if self.dispatch not in DISPATCH_KINDS:
            raise ValueError(
                f"dispatch must be one of {DISPATCH_KINDS}; "
                f"got {self.dispatch!r}"
            )

    @property
    def genome_len(self) -> int:
        return 2 * self.max_nodes

    def op_names(self) -> Tuple[str, ...]:
        """The opcode table: pad, terminals, then functions."""
        terms = ("pad", "var") + (("const",) if self.consts else ())
        return terms + tuple(self.unary) + tuple(self.binary)

    def op_arities(self) -> Tuple[int, ...]:
        arity = {"pad": 0, "var": 0, "const": 0}
        arity.update({n: 1 for n in self.unary})
        arity.update({n: 2 for n in self.binary})
        return tuple(arity[n] for n in self.op_names())

    @property
    def n_ops(self) -> int:
        return len(self.op_names())

    def op_index(self, name: str) -> int:
        return self.op_names().index(name)

    def opcode_gene(self, op: int) -> float:
        """Bucket-centered gene value encoding opcode ``op``."""
        return (op + 0.5) / self.n_ops

    def operand_gene(self, idx: int, domain: int) -> float:
        return (idx + 0.5) / max(domain, 1)

    @property
    def pad_gene(self) -> float:
        return self.opcode_gene(PAD_OP)

    def required_stack(self) -> int:
        """A well-formed program of ``max_nodes`` tokens holds at most
        ``max_nodes`` pending values."""
        return self.max_nodes

    def cache_key(self) -> tuple:
        return (
            "gp", self.max_nodes, self.n_vars, tuple(self.consts),
            tuple(self.unary), tuple(self.binary), self.min_nodes,
            self.optimize, self.dispatch,
        )


# ------------------------------------------------------------- decoding


def decode_ops(genomes: torch.Tensor, gp: GPConfig) -> torch.Tensor:
    """(P, max_nodes) int32 opcodes from the even gene columns (floored,
    clipped into the table: any float gene decodes)."""
    opg = genomes[:, 0::2].to(torch.float32)
    return torch.clamp(
        torch.floor(opg * gp.n_ops).to(torch.int32), 0, gp.n_ops - 1
    )


def decode_args(genomes: torch.Tensor, gp: GPConfig) -> torch.Tensor:
    """(P, max_nodes) float32 operands (the odd gene columns)."""
    return genomes[:, 1::2].to(torch.float32)


def arity_table(gp: GPConfig, device) -> torch.Tensor:
    return torch.tensor(gp.op_arities(), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Structure:
    """Per-token geometry under the skip rule (``(P, T)`` unless noted):
    ``live``, ``start`` (first token of the subtree it completes; its own
    index when dead), ``span``, ``length`` (P,) and ``final_depth`` (P,)."""

    live: torch.Tensor
    start: torch.Tensor
    span: torch.Tensor
    length: torch.Tensor
    final_depth: torch.Tensor


def program_structure(genomes: torch.Tensor, gp: GPConfig) -> Structure:
    """One forward stack walk, batched over rows, carrying subtree START
    positions: a leaf pushes its own index, an arity-``a`` function
    pushes the start of its deepest popped operand."""
    P, L = genomes.shape
    T = gp.max_nodes
    if L != 2 * T:
        raise ValueError(
            f"genome_len {L} != 2 * max_nodes ({2 * T}) for this GPConfig"
        )
    dev = genomes.device
    ops = decode_ops(genomes, gp)
    arity = arity_table(gp, dev)
    sp = torch.zeros(P, dtype=torch.int32, device=dev)
    sstack = torch.zeros((P, T), dtype=torch.int32, device=dev)
    live_cols, start_cols = [], []
    for t in range(T):
        op = ops[:, t]
        a = arity[op.long()]
        ex = (op != PAD_OP) & (sp >= a)
        idx = torch.clamp(sp - a, 0, T - 1).long()
        st_inner = torch.gather(sstack, 1, idx[:, None])[:, 0]
        st = torch.where(a == 0, torch.full_like(st_inner, t), st_inner)
        nsp = torch.where(ex, sp - a + 1, sp)
        wid = torch.clamp(nsp - 1, 0, T - 1).long()
        cur = torch.gather(sstack, 1, wid[:, None])[:, 0]
        sstack = sstack.scatter(
            1, wid[:, None], torch.where(ex, st, cur)[:, None]
        )
        sp = nsp
        live_cols.append(ex)
        start_cols.append(torch.where(ex, st, torch.full_like(st, t)))
    live = torch.stack(live_cols, dim=1)
    start = torch.stack(start_cols, dim=1)
    span = torch.arange(T, dtype=torch.int32, device=dev)[None, :] - start + 1
    return Structure(
        live=live, start=start, span=span,
        length=live.to(torch.int32).sum(dim=1, dtype=torch.int32),
        final_depth=sp,
    )


def token_gather(genomes: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Gather whole tokens (gene pairs) by token index ``src`` (P, T)."""
    src = src.long()
    gidx = torch.stack([2 * src, 2 * src + 1], dim=2).reshape(
        genomes.shape[0], -1
    )
    return torch.gather(genomes, 1, gidx)


def pad_row(gp: GPConfig, like: torch.Tensor) -> torch.Tensor:
    """(1, 2T) row of pad tokens (pad opcode gene, operand 0.5)."""
    pair = torch.tensor(
        [gp.pad_gene, 0.5], dtype=like.dtype, device=like.device
    )
    return pair.repeat(gp.max_nodes)[None, :]


def canonicalize(genomes: torch.Tensor, gp: GPConfig) -> torch.Tensor:
    """Live tokens compacted to the front in order (a stable live-first
    sort), pad tokens stamped behind. Idempotent; the program's value is
    unchanged."""
    st = program_structure(genomes, gp)
    T = gp.max_nodes
    order = torch.sort((~st.live).to(torch.int32), dim=1, stable=True).indices
    out = token_gather(genomes, order)
    iota = torch.arange(T, device=genomes.device)[None, :]
    tail = (iota >= st.length[:, None]).repeat_interleave(2, dim=1)
    return torch.where(tail, pad_row(gp, out), out)


# ----------------------------------------------------- random programs


def grow_rand_cols(gp: GPConfig) -> int:
    """Columns of the random-growth block: one length gene, then
    max_nodes opcode-choice genes, then max_nodes operand genes."""
    return 1 + 2 * gp.max_nodes


def random_program_genes(rand: torch.Tensor, gp: GPConfig) -> torch.Tensor:
    """Grow one strictly well-formed program per row from a uniform block
    ``(P, grow_rand_cols)``: ramped lengths in [min_nodes, max_nodes]
    (odd when there are no unary functions), then a left-to-right draw
    under the feasibility invariant ``depth - a <= remaining - 1``."""
    P = rand.shape[0]
    T = gp.max_nodes
    dev = rand.device
    rand = rand.to(torch.float32)
    arity = arity_table(gp, dev)
    n_ops = gp.n_ops
    lo, hi = gp.min_nodes, gp.max_nodes
    tlen = lo + torch.floor(rand[:, 0] * (hi - lo + 1)).to(torch.int32)
    tlen = torch.clamp(tlen, lo, hi)
    if not gp.unary:
        tlen = torch.clamp(tlen - (1 - tlen % 2), min=1)
    nonpad = (torch.arange(n_ops, device=dev) != PAD_OP)[None, :]
    # The JAX package runs this walk in a compiled scan, where XLA turns
    # the division by n_ops into a product with its float32 reciprocal;
    # the product keeps the genes bit-identical to it.
    inv_n = torch.tensor(1.0 / n_ops, dtype=torch.float32, device=dev)
    d = torch.zeros(P, dtype=torch.int32, device=dev)
    op_cols, arg_cols = [], []
    for t in range(T):
        r_op = rand[:, 1 + t]
        r_arg = rand[:, T + 1 + t]
        active = t < tlen
        remaining = tlen - t
        allowed = (
            (arity[None, :] <= d[:, None])
            & ((d[:, None] - arity[None, :]) <= remaining[:, None] - 1)
            & nonpad
            & active[:, None]
        )
        cnt = allowed.to(torch.int32).sum(dim=1, dtype=torch.int32)
        choice = torch.floor(r_op * cnt).to(torch.int32)
        cum = torch.cumsum(allowed.to(torch.int32), dim=1)
        sel = allowed & (cum == choice[:, None] + 1)
        op = torch.argmax(sel.to(torch.int32), dim=1)
        d = torch.where(active, d - arity[op] + 1, d)
        op_cols.append(torch.where(
            active, (op.to(torch.float32) + 0.5) * inv_n,
            torch.tensor(gp.pad_gene, dtype=torch.float32, device=dev),
        ))
        arg_cols.append(torch.where(
            active, r_arg, torch.tensor(0.5, dtype=torch.float32, device=dev)
        ))
    genes = torch.stack(
        [torch.stack(op_cols, dim=1), torch.stack(arg_cols, dim=1)], dim=2
    )
    return genes.reshape(P, 2 * T)


def random_population(
    generator: torch.Generator, size: int, gp: GPConfig, device=None
) -> torch.Tensor:
    """``(size, 2 * max_nodes)`` float32 matrix of strictly well-formed
    random programs from ``generator`` (install with
    ``PGA.install_population``)."""
    device = generator.device if device is None else device
    rand = torch.rand(
        (size, grow_rand_cols(gp)), generator=generator, device=device
    )
    return random_program_genes(rand, gp)


# --------------------------------------------------------- host helpers


def _host_ops(g: np.ndarray, gp: GPConfig) -> np.ndarray:
    return np.clip(
        np.floor(g[0::2] * gp.n_ops).astype(np.int64), 0, gp.n_ops - 1
    )


def encode_program(tokens: Sequence, gp: GPConfig) -> np.ndarray:
    """Encode an explicit token list into one genome. Tokens:
    ``("var", i)``, ``("const", i)``, or a function name."""
    T = gp.max_nodes
    if len(tokens) > T:
        raise ValueError(f"{len(tokens)} tokens exceed max_nodes {T}")
    names = gp.op_names()
    g = np.empty(2 * T, np.float32)
    g[0::2] = gp.pad_gene
    g[1::2] = 0.5
    for t, tok in enumerate(tokens):
        if isinstance(tok, tuple):
            kind, idx = tok
            if kind == "var":
                if not (0 <= idx < gp.n_vars):
                    raise ValueError(f"var index {idx} out of range")
                g[2 * t] = gp.opcode_gene(names.index("var"))
                g[2 * t + 1] = gp.operand_gene(idx, gp.n_vars)
            elif kind == "const":
                if not (0 <= idx < len(gp.consts)):
                    raise ValueError(f"const index {idx} out of range")
                g[2 * t] = gp.opcode_gene(names.index("const"))
                g[2 * t + 1] = gp.operand_gene(idx, len(gp.consts))
            else:
                raise ValueError(f"unknown terminal kind {kind!r}")
        else:
            if tok not in names or tok == "pad":
                raise ValueError(f"unknown op {tok!r}; table: {names}")
            g[2 * t] = gp.opcode_gene(names.index(tok))
    return g


def is_well_formed(genome: np.ndarray, gp: GPConfig) -> bool:
    """Strict well-formedness: non-pad tokens form one prefix, every one
    executes, and the final stack depth is exactly 1."""
    g = np.asarray(genome, np.float32)
    if g.shape != (2 * gp.max_nodes,):
        return False
    ops = _host_ops(g, gp)
    arity = np.asarray(gp.op_arities())
    nonpad = ops != PAD_OP
    length = int(nonpad.sum())
    if length == 0:
        return False
    if not np.all(nonpad[:length]) or np.any(nonpad[length:]):
        return False
    depth = 0
    for t in range(length):
        a = int(arity[ops[t]])
        if depth < a:
            return False
        depth += 1 - a
    return depth == 1


def decode_expression(genome: np.ndarray, gp: GPConfig) -> str:
    """Infix rendering of one genome's program under the skip rule;
    empty programs render ``"0"``."""
    g = np.asarray(genome, np.float32)
    ops = _host_ops(g, gp)
    args = g[1::2]
    names = gp.op_names()
    arity = np.asarray(gp.op_arities())
    infix = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
    stack: list = []
    for t in range(gp.max_nodes):
        name = names[ops[t]]
        a = int(arity[ops[t]])
        if name == "pad" or len(stack) < a:
            continue
        if name == "var":
            v = min(int(args[t] * gp.n_vars), gp.n_vars - 1)
            stack.append(f"x{v}")
        elif name == "const":
            c = min(int(args[t] * len(gp.consts)), len(gp.consts) - 1)
            stack.append(repr(float(gp.consts[c])))
        elif a == 1:
            x = stack.pop()
            stack.append(f"(-{x})" if name == "neg" else f"{name}({x})")
        else:
            rhs, lhs = stack.pop(), stack.pop()
            if name in infix:
                stack.append(f"({lhs} {infix[name]} {rhs})")
            else:
                stack.append(f"{name}({lhs}, {rhs})")
    return stack[-1] if stack else "0"


def program_length(genome: np.ndarray, gp: GPConfig) -> int:
    """Host-side live-token count (skip-rule semantics)."""
    g = np.asarray(genome, np.float32)
    ops = _host_ops(g, gp)
    arity = np.asarray(gp.op_arities())
    depth = 0
    n = 0
    for t in range(gp.max_nodes):
        a = int(arity[ops[t]])
        if ops[t] == PAD_OP or depth < a:
            continue
        depth += 1 - a
        n += 1
    return n
