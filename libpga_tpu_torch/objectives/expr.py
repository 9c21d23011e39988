"""Objectives from a small expression language: the port's copy of
``libpga_tpu/objectives/expr.py``.

The lexer, the parser, :func:`walk_ast`, :func:`validate_const` and the
error messages are the JAX module's, unchanged. What differs is the
evaluation: :func:`_emit` runs the syntax tree over torch tensors, and
the breed kernel does not trace it but compiles it, through
``ops/expr_cuda.py``, into CUDA source pasted into
``csrc/expr_breed.cu`` (B6).

The language:

- ``g``: the genome, ``L`` genes in [0, 1); ``i``: the gene index
  ``0..L-1``; ``L``: the genome length;
- literals (``1.5``, ``2e-3``), ``pi``, ``e``, and named constants
  registered with the expression (scalars, length-``L`` vectors
  broadcast elementwise, or ``gather`` tables);
- ``+ - * / % **`` (``%`` is Python's remainder, the sign of the
  divisor), unary ``-``, comparisons ``< <= > >= ==`` (0/1 valued),
  ``where(c, a, b)`` (``c != 0`` picks ``a``);
- elementwise ``sin cos tan tanh exp log sqrt abs floor round`` (round
  half to even), two-argument ``min``/``max`` (NaN propagates);
- reductions ``sum mean min max`` (one argument; NaN propagates) and
  ``dot(a, b)`` = ``sum(a*b)``; ``mean`` divides by L;
- ``name = expr;`` bindings before the final expression;
- ``roll(x, k)``, ``k`` an integer literal: ``roll(x, k)[i] =
  x[(i+k) mod L]``;
- ``gather(t, idx)``: ``t`` a registered constant; ``idx`` floored and
  clipped into the table; a 1-D ``t`` of n entries is shared by every
  locus (``t[idx[i]]``), a 2-D ``(n, L)`` ``t`` is per locus
  (``t[idx[i], i]``); the registered rank decides which. At most 512
  entries (the JAX kernel's masked accumulation caps it; the CUDA
  kernel loads the entry directly and keeps the cap).

The expression must reduce to one score per genome; higher is better.

Examples::

    from_expression("sum(g)")                          # OneMax
    from_expression(                                   # reference test2
        "where(dot(w, floor(g*2)) <= cap,"
        " dot(v, floor(g*2)), cap - dot(w, floor(g*2)))",
        w=weights, v=values, cap=100.0)
    from_expression(                                   # NK landscape
        "b = g >= 0.5;"
        "codes = b + 2*roll(b, 1) + 4*roll(b, 2) + 8*roll(b, 3);"
        "mean(gather(T, codes))",
        T=table_t)                                     # (2^(k+1), n)
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


class ExpressionError(ValueError):
    """Raised for any syntax, name, arity, or shape error — with a
    position and a human-readable explanation, so the C ABI can return
    -1 and print something actionable."""


_ELEMENTWISE = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "tanh": torch.tanh,
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt, "abs": torch.abs,
    "floor": torch.floor, "round": torch.round,
}
_CONSTANTS = {"pi": math.pi, "e": math.e}
_KEYWORDS = (
    ["g", "i", "L", "where", "dot", "sum", "mean", "min", "max",
     "roll", "gather"]
    + list(_ELEMENTWISE) + list(_CONSTANTS)
)

_GATHER_MAX_ENTRIES = 512


# ------------------------------------------------------------------ lexer

_TWO_CHAR = ("**", "<=", ">=", "==")
_ONE_CHAR = "+-*/%(),<>=;"


def _tokenize(src: str) -> List[Tuple[str, str, int]]:
    """(kind, text, pos) tokens; kinds: num, name, op, end."""
    out = []
    n, k = len(src), 0
    while k < n:
        c = src[k]
        if c.isspace():
            k += 1
            continue
        if src[k : k + 2] in _TWO_CHAR:
            out.append(("op", src[k : k + 2], k))
            k += 2
            continue
        if c in _ONE_CHAR:
            out.append(("op", c, k))
            k += 1
            continue
        if c.isdigit() or c == ".":
            j = k
            while j < n and (src[j].isdigit() or src[j] == "."):
                j += 1
            if j < n and src[j] in "eE":
                j += 1
                if j < n and src[j] in "+-":
                    j += 1
                while j < n and src[j].isdigit():
                    j += 1
            try:
                float(src[k:j])
            except ValueError:
                raise ExpressionError(
                    f"bad number {src[k:j]!r} at position {k}"
                ) from None
            out.append(("num", src[k:j], k))
            k = j
            continue
        if c.isalpha() or c == "_":
            j = k
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            out.append(("name", src[k:j], k))
            k = j
            continue
        raise ExpressionError(f"unexpected character {c!r} at position {k}")
    out.append(("end", "", n))
    return out


# ------------------------------------------------------------------ parser
#
# AST nodes are tuples: ("num", x), ("var", name), ("const", name),
# ("local", name), ("un", op, a), ("bin", op, a, b), ("call", fname,
# [args]), ("roll", k, a), ("gather", table, idx), and
# ("prog", [(name, ast), ...], final).


class _Parser:
    def __init__(self, src: str, const_names, var_names=("g", "i", "L")):
        self.src = src
        self.toks = _tokenize(src)
        self.k = 0
        self.const_names = const_names
        self.var_names = set(var_names)  # objectives see g/i/L, breeding
        # expressions their own sets (ops/breed_expr.py)
        self.locals: List[str] = []  # ``name = expr;`` bindings, in order

    def peek(self):
        return self.toks[self.k]

    def next(self):
        t = self.toks[self.k]
        self.k += 1
        return t

    def expect(self, text):
        kind, tok, pos = self.next()
        if tok != text:
            raise ExpressionError(
                f"expected {text!r} at position {pos}, got {tok or 'end'!r}"
            )

    def parse(self):
        """``name = expr; ... ; final_expr``: zero or more bindings, then
        the result expression (optionally semicolon-terminated). Returns
        ``("prog", [(name, ast), ...], final_ast)``, or the final AST
        when there are no bindings."""
        stmts = []
        while (
            self.peek()[0] == "name"
            and self.toks[self.k + 1][1] == "="
        ):
            _, name, pos = self.next()
            self.next()  # '='
            if name in _KEYWORDS or name in self.var_names:
                raise ExpressionError(
                    f"cannot bind {name!r} at position {pos}: it is a "
                    f"builtin name"
                )
            if name in self.const_names:
                raise ExpressionError(
                    f"cannot bind {name!r} at position {pos}: it is a "
                    f"registered constant"
                )
            if name in self.locals:
                raise ExpressionError(
                    f"{name!r} rebound at position {pos}; bindings are "
                    f"single-assignment"
                )
            rhs = self.comparison()
            self.expect(";")
            stmts.append((name, rhs))
            self.locals.append(name)
        node = self.comparison()
        if self.peek()[1] == ";":
            self.next()  # tolerate a trailing semicolon
        kind, tok, pos = self.peek()
        if kind != "end":
            raise ExpressionError(
                f"unexpected {tok!r} at position {pos}"
            )
        return ("prog", stmts, node) if stmts else node

    def comparison(self):
        node = self.addsub()
        kind, tok, _ = self.peek()
        if tok in ("<", "<=", ">", ">=", "=="):
            self.next()
            node = ("bin", tok, node, self.addsub())
        return node

    def addsub(self):
        node = self.muldiv()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = ("bin", op, node, self.muldiv())
        return node

    def muldiv(self):
        node = self.unary()
        while self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            node = ("bin", op, node, self.unary())
        return node

    def unary(self):
        kind, tok, _ = self.peek()
        if tok in ("+", "-"):
            self.next()
            return ("un", tok, self.unary())
        return self.power()

    def power(self):
        node = self.atom()
        if self.peek()[1] == "**":
            self.next()
            node = ("bin", "**", node, self.unary())  # right-assoc
        return node

    def atom(self):
        kind, tok, pos = self.next()
        if kind == "num":
            return ("num", float(tok))
        if tok == "(":
            node = self.comparison()
            self.expect(")")
            return node
        if kind == "name":
            if self.peek()[1] == "(":
                self.next()
                args = [self.comparison()]
                while self.peek()[1] == ",":
                    self.next()
                    args.append(self.comparison())
                self.expect(")")
                return self._call(tok, args, pos)
            if tok in self.var_names:
                return ("var", tok)
            if tok in _CONSTANTS:
                return ("num", _CONSTANTS[tok])
            if tok in self.const_names:
                return ("const", tok)
            if tok in self.locals:
                return ("local", tok)
            names = ", ".join(sorted(self.var_names))
            raise ExpressionError(
                f"unknown name {tok!r} at position {pos}; available: "
                f"{names}, pi, e" + (
                    f", constants {sorted(self.const_names)}"
                    if self.const_names else
                    " (no constants registered)"
                ) + (
                    f", locals {self.locals}" if self.locals else ""
                )
            )
        raise ExpressionError(
            f"unexpected {tok or 'end of expression'!r} at position {pos}"
        )

    def _call(self, fname, args, pos):
        def need(n):
            if len(args) != n:
                raise ExpressionError(
                    f"{fname}() takes {n} argument(s), got {len(args)} "
                    f"at position {pos}"
                )

        if fname in _ELEMENTWISE:
            need(1)
        elif fname == "where":
            need(3)
        elif fname == "dot":
            need(2)
        elif fname in ("sum", "mean"):
            need(1)
        elif fname in ("min", "max"):
            if len(args) not in (1, 2):
                raise ExpressionError(
                    f"{fname}() takes 1 (reduction) or 2 (elementwise) "
                    f"arguments, got {len(args)} at position {pos}"
                )
        elif fname == "roll":
            need(2)
            k = _static_number(args[1])
            if k is None or k != int(k):
                raise ExpressionError(
                    f"roll() shift must be an integer literal at position "
                    f"{pos} (it sets the static slice layout)"
                )
            return ("roll", int(k), args[0])
        elif fname == "gather":
            need(2)
            if args[0][0] != "const":
                raise ExpressionError(
                    f"gather()'s first argument at position {pos} must be "
                    f"a registered constant (the lookup table)"
                )
            return ("gather", args[0][1], args[1])
        else:
            raise ExpressionError(
                f"unknown function {fname!r} at position {pos}; available: "
                f"{sorted(set(_ELEMENTWISE) | {'sum', 'mean', 'min', 'max', 'where', 'dot', 'roll', 'gather'})}"
            )
        return ("call", fname, args)


def _static_number(node):
    """Fold a numeric-literal subtree (numbers under unary +/- and the
    four basic operators) to a Python float, or None if it references
    anything runtime."""
    if node[0] == "num":
        return node[1]
    if node[0] == "un":
        v = _static_number(node[2])
        return None if v is None else (-v if node[1] == "-" else v)
    if node[0] == "bin" and node[1] in ("+", "-", "*", "/"):
        a, b = _static_number(node[2]), _static_number(node[3])
        if a is None or b is None:
            return None
        if node[1] == "+":
            return a + b
        if node[1] == "-":
            return a - b
        if node[1] == "*":
            return a * b
        return a / b if b else None
    return None


# --------------------------------------------------------------- compiler


def walk_ast(node, visit) -> None:
    """Call ``visit(node)`` on every AST node, parents before children."""
    visit(node)
    kind = node[0]
    if kind in ("un", "roll", "gather"):
        walk_ast(node[2], visit)
    elif kind == "bin":
        walk_ast(node[2], visit)
        walk_ast(node[3], visit)
    elif kind == "call":
        for a in node[2]:
            walk_ast(a, visit)
    elif kind == "prog":
        for _, rhs in node[1]:
            walk_ast(rhs, visit)
        walk_ast(node[2], visit)


def validate_const(name: str, value, *, allow_2d: bool, extra_reserved=()):
    """Shared constant validation for every expression surface: name
    hygiene plus the rank contract. Returns the float32 array."""
    if name in _KEYWORDS or name in extra_reserved:
        raise ExpressionError(
            f"constant name {name!r} shadows a builtin name"
        )
    arr = np.asarray(value, dtype=np.float32)
    if arr.ndim > (2 if allow_2d else 1):
        kinds = (
            "a scalar, 1-D vector, or 2-D gather table" if allow_2d
            else "a scalar or 1-D vector in a breeding expression"
        )
        raise ExpressionError(
            f"constant {name!r} must be {kinds}, got shape {arr.shape}"
        )
    return arr


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


_COMPARE = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge, "==": torch.eq}
_REDUCE = {"sum": torch.sum, "mean": torch.mean, "min": torch.amin, "max": torch.amax}


def gather_codes(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Table rows of ``idx``: floored, clipped into ``[0, n-1]``; NaN
    reads row 0."""
    c = torch.clamp(torch.floor(idx), 0.0, float(n - 1))
    return torch.nan_to_num(c, nan=0.0).to(torch.int64)


def warp_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order a warp of the breed kernels
    sums a child's terms: lane ``i`` adds terms i, i+32, i+64, ... one by
    one from 0.0, then the 32 partials combine through the xor butterfly
    ``v = v + v[i ^ o]``, o = 16, 8, 4, 2, 1. Float32 results equal the
    kernels' bit for bit."""
    L = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, -L % 32)).reshape(*x.shape[:-1], -1, 32)
    v = torch.zeros_like(x[..., 0, :])
    for j in range(x.shape[-2]):
        v = v + x[..., j, :]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _emit(node, env) -> torch.Tensor:
    """Evaluate the AST over a (P, L) gene block ``env['g']``. Values
    broadcast: literals and scalar constants are 0-d, elementwise values
    (P, L) or (1, L), reductions (P, 1). With ``env['warp_order']`` the
    sums (``sum``, ``mean``, ``dot``) run in the breed kernels' order
    (:func:`warp_order_sum`) and ``mean`` divides elementwise by L, so
    the scores equal the kernels' bit for bit (``min``/``max`` are exact
    in any order)."""
    kind = node[0]
    if kind == "num":
        return _f32(node[1])
    if kind == "var":
        return env[node[1]]
    if kind == "const":
        return env["consts"][node[1]]
    if kind == "local":
        return env["locals"][node[1]]
    if kind == "prog":
        env = dict(env, locals=dict(env.get("locals", {})))
        for name, rhs in node[1]:
            env["locals"][name] = _emit(rhs, env)
        return _emit(node[2], env)
    if kind == "roll":
        x = torch.broadcast_to(_emit(node[2], env), env["shape"])
        k = node[1] % env["shape"][1]
        return x if k == 0 else torch.roll(x, -k, dims=1)
    if kind == "gather":
        # An exact indexed load; JAX's masked accumulation over the
        # entries selects the same single entry.
        t = env["consts"][node[1]]
        per_locus = env["table_kinds"][node[1]] == "per_locus"
        L = env["shape"][1]
        if per_locus and t.shape[1] != L:
            raise ExpressionError(
                f"per-locus gather table {node[1]!r} has width "
                f"{t.shape[1]} but the genome has {L} genes"
            )
        idx = torch.broadcast_to(_emit(node[2], env), env["shape"])
        n = t.shape[0] if per_locus else t.shape[1]
        codes = gather_codes(idx, n)
        if per_locus:
            return t[codes, torch.arange(L, device=t.device)]
        return t[0][codes]
    if kind == "un":
        v = _emit(node[2], env)
        return -v if node[1] == "-" else v
    if kind == "bin":
        op, a, b = node[1], _emit(node[2], env), _emit(node[3], env)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            # A 0-d CPU divisor of a card tensor would be applied as a
            # multiply by its reciprocal; on the card it divides, as the
            # kernels do.
            return a / (b.to(a.device) if b.device != a.device else b)
        if op == "%":
            return torch.remainder(a, b)
        if op == "**":
            return torch.pow(a, b)
        return _COMPARE[op](a, b).to(torch.float32)
    fname, args = node[1], node[2]
    vals = [_emit(a, env) for a in args]
    if fname in _ELEMENTWISE:
        return _ELEMENTWISE[fname](vals[0])
    if fname == "where":
        return torch.where(vals[0] != 0.0, vals[1], vals[2])
    if fname in ("min", "max") and len(vals) == 2:
        return (torch.minimum if fname == "min" else torch.maximum)(*vals)
    v = torch.broadcast_to(vals[0] * vals[1] if fname == "dot" else vals[0], env["shape"])
    if env.get("warp_order") and fname in ("sum", "mean", "dot"):
        s = warp_order_sum(v)[:, None]
        return s / torch.full_like(s, env["shape"][1]) if fname == "mean" else s
    return _REDUCE["sum" if fname == "dot" else fname](v, dim=1, keepdim=True)


def gene_env(shape, device, true_len=None) -> dict:
    """The variables every surface shares: ``i`` (1, L) float32 gene
    indices, ``L`` the genome length (``true_len`` when given)."""
    return {
        "i": torch.arange(shape[1], device=device, dtype=torch.float32)[None, :],
        "L": _f32(float(true_len or shape[1])),
        "shape": tuple(shape),
    }


def const_tensors(arrays):
    """``get(device)``: the float32 constants, 2-D (``atleast_2d``: a
    scalar (1, 1), a vector (1, n), a table (n, L)), on ``device``,
    copied there once."""
    host = tuple(torch.from_numpy(np.atleast_2d(a).astype(np.float32)) for a in arrays)
    copies = {}

    def get(device):
        key = str(device)
        if key not in copies:
            copies[key] = tuple(t.to(device) for t in host)
        return copies[key]

    return get


def from_expression(expr: str, **consts) -> Callable:
    """Compile an objective expression to a rowwise objective ``(P, L)
    -> (P,)`` that the breed kernel fuses: the generated kernel of
    ``csrc/expr_breed.cu`` scores each child in the breed, reading the
    named constants as kernel inputs (``kernel_rowwise_consts``).

    ``consts``: scalars, 1-D float arrays (broadcast elementwise against
    the genome, or ``gather`` tables), or 2-D ``(n, L)`` per-locus
    ``gather`` tables. Raises :class:`ExpressionError` with a position
    and an explanation for any syntax, name, arity or shape problem, and
    for an expression that does not reduce to one score per genome.

    The result carries ``.kernel_rowwise`` (itself: ``rows(m,
    *consts, warp_order=False)``; ``warp_order=True`` sums as the breed
    kernels do, bit for bit), ``.kernel_rowwise_consts`` (the referenced constants,
    2-D, in sorted name order), ``.expression``,
    ``.pinned_genome_len`` and, for the code generator, ``.ast``,
    ``.const_names``, ``.const_arrays`` (as registered) and
    ``.table_kinds``; ``.expr_fused`` is itself.
    """
    const_vals: Dict[str, np.ndarray] = {
        name: validate_const(name, v, allow_2d=True)
        for name, v in consts.items()
    }

    ast = _Parser(expr, set(const_vals)).parse()
    # Keep only the constants the expression references; gather tables
    # are validated here (registered, bounded, and the only legal use of
    # a 2-D constant).
    used: set = set()
    gather_tables: set = set()
    elementwise_consts: set = set()

    def visit(node):
        kind = node[0]
        if kind == "const":
            used.add(node[1])
            elementwise_consts.add(node[1])
            if const_vals[node[1]].ndim == 2:
                raise ExpressionError(
                    f"2-D constant {node[1]!r} may only be used as "
                    f"gather()'s table"
                )
        elif kind == "gather":
            used.add(node[1])
            gather_tables.add(node[1])

    walk_ast(ast, visit)
    table_kinds: Dict[str, str] = {}
    for name in gather_tables:
        t = const_vals[name]
        if t.ndim == 0:
            raise ExpressionError(
                f"gather table {name!r} is a scalar; register a vector "
                f"or (n, L) matrix"
            )
        n = t.shape[0]  # 1-D: table length; 2-D: entry rows (n, L)
        if n > _GATHER_MAX_ENTRIES:
            raise ExpressionError(
                f"gather table {name!r} has {n} entries; the masked-"
                f"accumulation lowering caps at {_GATHER_MAX_ENTRIES}"
            )
        table_kinds[name] = "per_locus" if t.ndim == 2 else "shared"
    const_vals = {n: a for n, a in const_vals.items() if n in used}
    const_names = sorted(const_vals)
    defaults = const_tensors([const_vals[n] for n in const_names])

    def rows(m: torch.Tensor, *cargs, warp_order: bool = False) -> torch.Tensor:
        m = m.to(torch.float32)
        env = gene_env(m.shape, m.device)
        env.update(
            g=m, table_kinds=table_kinds, warp_order=warp_order,
            consts=dict(zip(const_names, cargs or defaults(m.device))),
        )
        out = _emit(ast, env)
        if out.ndim == 2 and out.shape[-1] == 1:
            out = out[:, 0]
        elif out.ndim == 2:
            raise ExpressionError(
                "expression must reduce to one scalar per genome — wrap "
                "it in sum()/mean()/min()/max()"
            )
        return torch.broadcast_to(out, (m.shape[0],)).to(torch.float32)

    # Validate eagerly on a probe population, whose genome length
    # follows the constants that pair with the gene axis (elementwise
    # vectors and per-locus tables; a 1-D table's length is its index
    # domain, not L).
    vec_lens = {
        const_vals[n].shape[0]
        for n in elementwise_consts
        if n in const_vals and const_vals[n].ndim == 1
    }
    vec_lens |= {
        const_vals[n].shape[1]
        for n in gather_tables
        if n in const_vals and const_vals[n].ndim == 2
    }
    if len(vec_lens) > 1:
        raise ExpressionError(
            f"vector constants disagree on genome length: {sorted(vec_lens)}"
        )
    pinned_len = vec_lens.pop() if vec_lens else None
    try:
        rows(torch.zeros((2, pinned_len or 8)))
    except ExpressionError:
        raise
    except Exception as exc:  # noqa: BLE001 — rewrap with the source expr
        raise ExpressionError(f"invalid expression {expr!r}: {exc}") from exc

    rows.kernel_rowwise = rows
    rows.kernel_rowwise_consts = defaults("cpu")
    rows.expression = expr
    rows.pinned_genome_len = pinned_len
    rows.ast = ast
    rows.const_names = tuple(const_names)
    rows.const_arrays = tuple(const_vals[n] for n in const_names)
    rows.table_kinds = dict(table_kinds)
    rows.expr_fused = rows
    rows.__doc__ = f"Expression objective: {expr}"
    return rows
