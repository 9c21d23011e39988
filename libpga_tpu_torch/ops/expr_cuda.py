"""Lower expression syntax trees to CUDA C++ for the breed kernel of
``csrc/expr_breed.cu`` (B6).

JAX traces an expression's jnp ops into its Pallas breed kernel. Here
the syntax tree of ``objectives/expr.py`` / ``ops/breed_expr.py`` is
turned into ``__device__`` functions, pasted in front of the hand-written
template ``csrc/expr_breed.cu``, and the result is compiled with ``nvcc``
(``ops/kernels.py``), keyed by a hash of the text. The text depends only
on the expressions and the shapes of their constants, never on constant
values (they are read from one float buffer at run time), so it is
deterministic.

What is generated (:func:`generate`):

- ``expr_crossover(p1, p2, r, r2, q, q2, l, L, cb)`` and
  ``expr_mutate(g, r, r2, q, q2, l, L, rate, sigma, cb)``: one gene of a
  breeding expression, clipped into ``[0, 1 - 1e-7]`` (NaN stays);
- ``expr_objective(grow, erows, L, lane, cb)``: one warp's score of the
  child ``grow`` (L floats in shared memory). Per-gene values are
  evaluated lane-strided (``l = lane, lane + 32, ...``); a reduction is a
  per-lane partial combined by the ``warp_sum`` butterfly into a value
  every lane holds; a per-gene value that ``roll`` reads is first
  written to a per-warp row of ``erows`` (``EXPR_OBJ_ROWS`` rows of L
  floats), read at ``(l + k) mod L`` after ``__syncwarp()``. The loops
  are stages: stage s computes every reduction and materialised row
  whose operands are ready after stage s - 1;
- macros the template reads: ``EXPR_CROSS`` / ``EXPR_MUT`` /
  ``EXPR_OBJ`` (which hooks exist; a missing one is the builtin kind),
  ``EXPR_OBJ_ROWS``, and the random streams used: ``EXPR_GENE_STREAMS``
  (bit j: per-gene plane j = crossover r, crossover r2, mutation r,
  mutation r2) and ``EXPR_ROW_STREAMS`` (bit j: per-row word j =
  crossover q, q2, mutation q, q2).

Semantics kept from torch / jnp: ``%`` is the remainder with the sign of
the divisor (``fmodf`` then a correction), ``round`` is ``rintf`` (half
to even), two-argument ``min``/``max`` and the reductions propagate NaN
(``fminf``/``fmaxf`` would drop it), ``**`` is ``powf``, comparisons
give 0/1, ``where`` tests ``!= 0``, ``gather`` floors and clips its index
(NaN reads entry 0). Literals are float32 hex literals. The file is
built with ``--fmad=false``, so no multiply-add is contracted.

The prelude guards ``__device__`` / ``__forceinline__`` and the warp
primitives, so the hooks compile as plain C++ on the host (a warp of one
lane): :func:`host_source` adds ``extern "C"`` loops over rows for a
ctypes test of the lowering.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

PRELUDE = r"""// ---- expression prelude (generated by libpga_tpu_torch/ops/expr_cuda.py)
#include <math.h>
#ifdef __CUDACC__
#define EXPR_LANES 32
#define EXPR_LDG(p) __ldg(p)
#define EXPR_SYNCWARP() __syncwarp()
#define EXPR_SHFL_XOR(v, o) __shfl_xor_sync(0xffffffffu, (v), (o))
#define EXPR_G 1
#define EXPR_SYNCGROUP() __syncwarp()
#else
#define __device__
#define __forceinline__ inline
#define EXPR_LANES 1
#define EXPR_LDG(p) (*(p))
#define EXPR_SYNCWARP()
#define EXPR_SHFL_XOR(v, o) (v)
#define EXPR_G 8
#define EXPR_SYNCGROUP()
#endif

__device__ __forceinline__ float expr_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}
__device__ __forceinline__ float expr_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float expr_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float expr_clip(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 0.99999988079071044921875f);
}
__device__ __forceinline__ int expr_code(float x, int n) {
  // floor, clip into [0, n-1]; fmaxf maps NaN to 0
  return (int)fminf(fmaxf(floorf(x), 0.0f), (float)(n - 1));
}
__device__ __forceinline__ float expr_lanes_sum(float v) {
  if (EXPR_LANES > 1)
    for (int o = 16; o > 0; o >>= 1) v += EXPR_SHFL_XOR(v, o);
  return v;
}
__device__ __forceinline__ float expr_lanes_min(float v) {
  if (EXPR_LANES > 1)
    for (int o = 16; o > 0; o >>= 1) v = expr_min(v, EXPR_SHFL_XOR(v, o));
  return v;
}
__device__ __forceinline__ float expr_lanes_max(float v) {
  if (EXPR_LANES > 1)
    for (int o = 16; o > 0; o >>= 1) v = expr_max(v, EXPR_SHFL_XOR(v, o));
  return v;
}
// The eight-lane form's reductions: v[s][i] is the partial of warp-lane
// position 4*jl + i (jl the sub-lane: the lane itself on the card, where
// EXPR_G is 1; all eight, s = jl, on the host). OP 0 sums, 1 min, 2 max,
// each pair taken (own, partner) as the warp form's butterfly takes it:
// steps 16, 8 and 4 pair the group's lanes, 2 and 1 the lane's partials.
// Returns warp-lane position 0's value.
template <int OP>
__device__ __forceinline__ float expr_comb(float a, float b) {
  return OP == 0 ? a + b : OP == 1 ? expr_min(a, b) : expr_max(a, b);
}
template <int OP>
__device__ __forceinline__ float expr_group(float (&v)[EXPR_G][4]) {
#ifdef __CUDACC__
  float x[4];
  for (int i = 0; i < 4; ++i) {
    x[i] = v[0][i];
    for (int o = 4; o > 0; o >>= 1) x[i] = expr_comb<OP>(x[i], EXPR_SHFL_XOR(x[i], o));
  }
  return expr_comb<OP>(expr_comb<OP>(x[0], x[2]), expr_comb<OP>(x[1], x[3]));
#else
  float p[32], q[32];
  for (int n = 0; n < 32; ++n) p[n] = v[n / 4][n % 4];
  for (int o = 16; o > 0; o >>= 1) {
    for (int n = 0; n < 32; ++n) q[n] = expr_comb<OP>(p[n], p[n ^ o]);
    for (int n = 0; n < 32; ++n) p[n] = q[n];
  }
  return p[0];
#endif
}
"""

_FUNCS = {
    "sin": "sinf", "cos": "cosf", "tan": "tanf", "tanh": "tanhf", "exp": "expf",
    "log": "logf", "sqrt": "sqrtf", "abs": "fabsf", "floor": "floorf", "round": "rintf",
}
TRANSCENDENTAL = frozenset({"sin", "cos", "tan", "tanh", "exp", "log", "sqrt"})
_REDUCTIONS = ("sum", "mean", "dot")

GENE_PLANES = {("crossover", "r"): 0, ("crossover", "r2"): 1, ("mutate", "r"): 2, ("mutate", "r2"): 3}
ROW_WORDS = {("crossover", "q"): 0, ("crossover", "q2"): 1, ("mutate", "q"): 2, ("mutate", "q2"): 3}


def streams(crossover=None, mutate=None) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(planes, words)``: the per-gene planes and per-row words (indices
    of ``GENE_PLANES`` / ``ROW_WORDS``) that the expression operators
    ``crossover`` and ``mutate`` (or None) read, by their
    ``kernel_rows.uses``."""
    planes, words = set(), set()
    for role, op in (("crossover", crossover), ("mutate", mutate)):
        for v in op.kernel_rows.uses if op is not None else ():
            if (role, v) in GENE_PLANES:
                planes.add(GENE_PLANES[role, v])
            else:
                words.add(ROW_WORDS[role, v])
    return tuple(sorted(planes)), tuple(sorted(words))


def flit(x: float) -> str:
    """A float32 literal of exactly ``np.float32(x)``."""
    v = float(np.float32(x))
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    h = v.hex() + "f"
    return f"({h})" if v < 0 else h


@dataclasses.dataclass(frozen=True)
class ConstSlot:
    """Where a registered constant lives in the constant buffer:
    ``shape`` as registered (() scalar, (n,) vector or shared table,
    (n, L) per-locus table, row-major)."""

    offset: int
    shape: Tuple[int, ...]


class _Graph:
    """The syntax tree as a hash-consed DAG: ``let`` bindings and
    repeated subtrees become one node each."""

    def __init__(self):
        self.ids: Dict[tuple, int] = {}
        self.nodes: List[tuple] = []

    def add(self, key: tuple) -> int:
        if key not in self.ids:
            self.ids[key] = len(self.nodes)
            self.nodes.append(key)
        return self.ids[key]

    def build(self, node, local_ids: Optional[dict] = None) -> int:
        local_ids = local_ids or {}
        kind = node[0]
        if kind == "prog":
            scope = dict(local_ids)
            for name, rhs in node[1]:
                scope[name] = self.build(rhs, scope)
            return self.build(node[2], scope)
        if kind == "local":
            return local_ids[node[1]]
        if kind == "num":
            return self.add(("num", float(np.float32(node[1]))))
        if kind in ("var", "const"):
            return self.add((kind, node[1]))
        if kind == "un":
            a = self.build(node[2], local_ids)
            return a if node[1] == "+" else self.add(("un", "-", a))
        if kind == "bin":
            return self.add(("bin", node[1], self.build(node[2], local_ids),
                             self.build(node[3], local_ids)))
        if kind == "roll":
            return self.add(("roll", node[1], self.build(node[2], local_ids)))
        if kind == "gather":
            return self.add(("gather", node[1], self.build(node[2], local_ids)))
        fname, args = node[1], node[2]
        ids = tuple(self.build(a, local_ids) for a in args)
        if fname in ("min", "max") and len(ids) == 1:
            fname = f"{fname}1"
        return self.add(("call", fname) + ids)


def _children(key: tuple) -> tuple:
    kind = key[0]
    if kind in ("un", "roll", "gather"):
        return (key[2],)
    if kind in ("bin", "call"):
        return key[2:]
    return ()


class _Lowering:
    """One expression's nodes, classified per gene (``gene``) or per
    row (``row``: the same for every gene of a child), and C text."""

    def __init__(self, role: str, ast, consts: Dict[str, ConstSlot],
                 table_kinds: Optional[dict] = None):
        self.role = role
        self.consts = consts
        self.table_kinds = table_kinds or {}
        self.graph = _Graph()
        self.root = self.graph.build(ast)
        self.gene_vars = {
            "objective": {"g", "i"},
            "crossover": {"p1", "p2", "r", "r2", "i"},
            "mutate": {"g", "r", "r2", "i"},
        }[role]
        self.per_gene: Dict[int, bool] = {}
        for n, key in enumerate(self.graph.nodes):
            self.per_gene[n] = self._classify(key)

    def _classify(self, key) -> bool:
        kind = key[0]
        if kind == "num":
            return False
        if kind == "var":
            return key[1] in self.gene_vars
        if kind == "const":
            return len(self.consts[key[1]].shape) > 0
        if kind == "call" and key[1] in _REDUCTIONS + ("min1", "max1"):
            return False
        if kind == "gather" and self.table_kinds.get(key[1]) == "per_locus":
            return True
        return any(self.per_gene[c] for c in _children(key))

    def gene_ops(self) -> int:
        """float32 operations one gene costs: each per-gene operator node
        (arithmetic, comparison, negation, a function, ``where``) and, for
        each reduction, its combine (``dot``: a multiply and an add).
        Leaves (variables, constants, literals, roll and gather loads)
        cost none, and per-row nodes run once a row, not a gene."""
        ops = 0
        for n, key in enumerate(self.graph.nodes):
            if key[0] == "call" and key[1] in _REDUCTIONS + ("min1", "max1"):
                ops += 2 if key[1] == "dot" else 1
            elif key[0] in ("bin", "un", "call") and self.per_gene[n]:
                ops += 1
        return ops

    def uses_transcendental(self) -> bool:
        return any(
            (k[0] == "call" and k[1] in TRANSCENDENTAL) or (k[0] == "bin" and k[1] == "**")
            for k in self.graph.nodes
        )

    # -- C expressions of one node, given its operands' names -------------

    def expr(self, n: int, name, leaf) -> str:
        """C expression of node ``n``; ``name(c)`` gives an operand's
        variable, ``leaf(key)`` a variable, constant, roll or gather."""
        key = self.graph.nodes[n]
        kind = key[0]
        if kind == "num":
            return flit(key[1])
        if kind in ("var", "const", "roll", "gather"):
            return leaf(n, key)
        if kind == "un":
            return f"(-{name(key[2])})"
        if kind == "bin":
            op, a, b = key[1], name(key[2]), name(key[3])
            if op in ("+", "-", "*", "/"):
                return f"({a} {op} {b})"
            if op == "%":
                return f"expr_mod({a}, {b})"
            if op == "**":
                return f"powf({a}, {b})"
            return f"(({a} {op} {b}) ? 1.0f : 0.0f)"
        fname, args = key[1], [name(c) for c in key[2:]]
        if fname in _FUNCS:
            return f"{_FUNCS[fname]}({args[0]})"
        if fname == "where":
            return f"(({args[0]} != 0.0f) ? {args[1]} : {args[2]})"
        if fname in ("min", "max"):
            return f"expr_{fname}({args[0]}, {args[1]})"
        raise AssertionError(f"no elementwise form for {fname}")

    def const_leaf(self, cname: str, gene_index: str) -> str:
        slot = self.consts[cname]
        if not slot.shape:
            return f"EXPR_LDG(cb + {slot.offset})"
        return f"EXPR_LDG(cb + {slot.offset} + {gene_index})"


# ---------------------------------------------------------------------
# Breeding hooks: one gene, every node a statement
# ---------------------------------------------------------------------


def _breeding_hook(role: str, op, consts: Dict[str, ConstSlot]) -> Tuple[str, bool, int]:
    """(C text of ``expr_crossover`` / ``expr_mutate``, whether it calls
    a transcendental, ``sqrt`` or ``**``, its operations a gene)."""
    low = _Lowering(role, op.ast, consts)
    body: List[str] = []
    done: Dict[int, str] = {}

    def leaf(n, key):
        if key[0] == "var":
            return {"i": "(float)l", "L": "(float)L"}.get(key[1], key[1])
        return low.const_leaf(key[1], "l")

    def emit(n: int) -> str:
        if n not in done:
            for c in _children(low.graph.nodes[n]):
                emit(c)
            body.append(f"  const float t{n} = {low.expr(n, lambda c: done[c], leaf)};")
            done[n] = f"t{n}"
        return done[n]

    result = emit(low.root)
    if role == "crossover":
        fn = "expr_crossover"
        sig = ("float p1, float p2, float r, float r2, float q, float q2, int l, int L,"
               " const float* __restrict__ cb")
    else:
        fn = "expr_mutate"
        sig = ("float g, float r, float r2, float q, float q2, int l, int L, float rate,"
               " float sigma, const float* __restrict__ cb")
    text = "\n".join([
        f"// {role}: {op.expression}",
        f"__device__ __forceinline__ float {fn}({sig}) {{",
        *body,
        f"  return expr_clip({result});",
        "}",
    ])
    return text, low.uses_transcendental(), low.gene_ops()


# ---------------------------------------------------------------------
# Objective hook: staged lane-strided loops over one warp's child row
# ---------------------------------------------------------------------


@dataclasses.dataclass
class _ObjectiveStages:
    """An objective's nodes in stages: ``level[n]`` is the loop after
    which node n is ready (a reduction, or a ``roll`` of a per-gene value
    other than ``g``, ends a loop); ``materialised`` maps each per-gene
    node that ``roll`` reads to its row of ``erows``; ``reductions`` are
    the reduction nodes, each computed by loop ``stage_of(n)``; ``stages``
    the loops, in order."""

    low: _Lowering
    level: Dict[int, int]
    materialised: Dict[int, int]
    reductions: List[int]
    stages: List[int]

    def stage_of(self, n: int) -> int:  # the loop that computes a barrier's operand
        return max(self.level[c] for c in _children(self.low.graph.nodes[n]))


def _objective_stages(obj, consts: Dict[str, ConstSlot]) -> _ObjectiveStages:
    low = _Lowering("objective", obj.ast, consts, obj.table_kinds)
    nodes = low.graph.nodes
    level: Dict[int, int] = {}
    materialised: Dict[int, int] = {}  # node -> erows slot

    for n, key in enumerate(nodes):  # children precede parents
        kids = _children(key)
        lv = max((level[c] for c in kids), default=0)
        if key[0] == "call" and key[1] in _REDUCTIONS + ("min1", "max1"):
            lv += 1
        elif key[0] == "roll" and low.per_gene[key[2]]:
            src = nodes[key[2]]
            if src != ("var", "g"):
                materialised.setdefault(key[2], len(materialised))
                lv += 1
        level[n] = lv

    reductions = [n for n, k in enumerate(nodes)
                  if k[0] == "call" and k[1] in _REDUCTIONS + ("min1", "max1")]
    plan = _ObjectiveStages(low, level, materialised, reductions, [])
    plan.stages = sorted({plan.stage_of(n) for n in reductions}
                         | {level[n] for n in materialised})
    return plan


def _objective_hook(obj, consts: Dict[str, ConstSlot]) -> Tuple[str, int, int]:
    """(C text of ``expr_objective``, rows of ``erows`` it needs, its
    operations a gene)."""
    st = _objective_stages(obj, consts)
    low, level, materialised = st.low, st.level, st.materialised
    nodes = low.graph.nodes
    stage_of, reductions, stages = st.stage_of, st.reductions, st.stages
    out: List[str] = []
    uniform: Dict[int, str] = {}
    rolls: Dict[int, str] = {}

    def roll_shift(k: int) -> str:
        if k not in rolls:
            rolls[k] = f"sh{len(rolls)}"
            out.append(f"  const int {rolls[k]} = (({k} % L) + L) % L;")
        return rolls[k]

    def ensure_uniform(n: int) -> str:
        """Emit per-row node ``n`` at function scope (its operands are
        ready: the caller is past every stage it needs)."""
        if n in uniform:
            return uniform[n]
        key = nodes[n]
        for c in _children(key):
            if not low.per_gene[c]:
                ensure_uniform(c)
        if key[0] == "call" and key[1] in _REDUCTIONS + ("min1", "max1"):
            raise AssertionError("reductions are finished after their stage")
        if key[0] == "roll":
            uniform[n] = ensure_uniform(key[2])  # roll of a per-row value
            return uniform[n]

        def leaf(m, k):
            if k[0] == "var":
                return "(float)L"
            if k[0] == "const":
                return low.const_leaf(k[1], "0")
            # gather of a shared table at a per-row index
            slot = low.consts[k[1]]
            return (f"EXPR_LDG(cb + {slot.offset} + expr_code({uniform[k[2]]},"
                    f" {slot.shape[0]}))")

        out.append(f"  const float u{n} = {low.expr(n, lambda c: uniform[c], leaf)};")
        uniform[n] = f"u{n}"
        return uniform[n]

    def loop_body(targets_red, targets_row) -> List[str]:
        body: List[str] = []
        done: Dict[int, str] = {}

        def leaf(n, key):
            kind = key[0]
            if kind == "var":
                return {"g": "grow[l]", "i": "(float)l"}[key[1]]
            if kind == "const":
                return low.const_leaf(key[1], "l")
            if kind == "roll":
                src = key[2]
                sh = roll_shift(key[1])
                base = "grow" if nodes[src] == ("var", "g") else f"(erows + {materialised[src]} * L)"
                return f"{base}[(l + {sh}) < L ? (l + {sh}) : (l + {sh} - L)]"
            slot = low.consts[key[1]]
            idx = gene(key[2])
            n_entries = slot.shape[0]
            if low.table_kinds.get(key[1]) == "per_locus":
                return f"EXPR_LDG(cb + {slot.offset} + expr_code({idx}, {n_entries}) * L + l)"
            return f"EXPR_LDG(cb + {slot.offset} + expr_code({idx}, {n_entries}))"

        def gene(n: int) -> str:
            if not low.per_gene[n]:
                return ensure_uniform(n)
            if n in done:
                return done[n]
            key = nodes[n]
            if key[0] != "roll":
                for c in _children(key):
                    gene(c)
            body.append(f"    const float t{n} = {low.expr(n, gene, leaf)};")
            done[n] = f"t{n}"
            return done[n]

        for n in targets_row:
            body.append(f"    erows[{materialised[n]} * L + l] = {gene(n)};")
        for n in targets_red:
            key = nodes[n]
            if key[1] == "dot":
                a, b = gene(key[2]), gene(key[3])
                body.append(f"    acc{n} += {a} * {b};")
            elif key[1] in ("sum", "mean"):
                body.append(f"    acc{n} += {gene(key[2])};")
            else:
                body.append(f"    acc{n} = expr_{key[1][:3]}(acc{n}, {gene(key[2])});")
        return body

    for s in stages:
        reds = [n for n in reductions if stage_of(n) == s]
        mats = [n for n in materialised if level[n] == s]
        body = loop_body(reds, mats)  # per-row operands land in out first
        for n in reds:
            init = {"min1": "INFINITY", "max1": "-INFINITY"}.get(nodes[n][1], "0.0f")
            out.append(f"  float acc{n} = {init};")
        out.append("  for (int l = lane; l < L; l += EXPR_LANES) {")
        out.extend(body)
        out.append("  }")
        for n in reds:
            fname = nodes[n][1]
            comb = {"min1": "min", "max1": "max"}.get(fname, "sum")
            val = f"expr_lanes_{comb}(acc{n})"
            if fname == "mean":
                val = f"{val} / (float)L"
            out.append(f"  const float u{n} = {val};")
            uniform[n] = f"u{n}"
        if mats:
            out.append("  EXPR_SYNCWARP();")
    result = ensure_uniform(low.root) if not low.per_gene[low.root] else None
    if result is None:
        raise ValueError("an objective expression must reduce to one score per genome")
    text = "\n".join([
        f"// objective: {obj.expression}",
        "__device__ __forceinline__ float expr_objective(const float* __restrict__ grow,"
        " float* __restrict__ erows, int L, int lane, const float* __restrict__ cb) {",
        "  (void)erows; (void)lane; (void)cb;",
        *out,
        f"  return {result};",
        "}",
    ])
    return text, len(materialised), low.gene_ops()


# ---------------------------------------------------------------------
# Objective hook, eight lanes a child (expr_pipelined_kernel)
# ---------------------------------------------------------------------

_INIT = {"min1": "INFINITY", "max1": "-INFINITY"}
_GROUP_OP = {"min1": 1, "max1": 2}  # expr_group's combine; 0 the sum


def _objective_hook8(obj, consts: Dict[str, ConstSlot]) -> Tuple[str, bool]:
    """(C text of the objective's eight-lane form, whether it reads the
    child back from a row: ``EXPR_OBJ_CHILD``).

    A lane of the group holds genes ``4*jl + 32*m + 0..3`` (``jl`` its
    sub-lane). The first stage runs four genes at a time in
    ``expr_obj8_genes``, which the breed calls as it writes the child
    (fused) or ``expr_objective8<false>`` calls over the child's row; each
    reduction keeps a partial for each of the lane's warp-lane positions
    ``4*jl + i`` (``ExprAcc8``), combined in ``warp_sum``'s butterfly order
    (``expr_group``), so every score is the warp form's bit for bit. The
    later stages loop over the lane's genes in ``expr_objective8``; a
    materialised value is read back from its row, at its own gene too.
    The child is read back from ``crow`` where ``roll`` reads it or a
    later stage reads it directly (the text sets ``EXPR_OBJ_CHILD``);
    else the breed keeps no child row and fuses the first stage."""
    st = _objective_stages(obj, consts)
    low, level, materialised = st.low, st.level, st.materialised
    nodes = low.graph.nodes
    first = st.stages[0]
    child = any(k[0] == "roll" and nodes[k[2]] == ("var", "g") for k in nodes)

    def scope():
        return {"out": [], "uniform": {}, "rolls": {}}

    def roll_shift(sc, k: int) -> str:
        if k not in sc["rolls"]:
            sc["rolls"][k] = f"sh{len(sc['rolls'])}"
            sc["out"].append(f"  const int {sc['rolls'][k]} = (({k} % L) + L) % L;")
        return sc["rolls"][k]

    def ensure_uniform(sc, n: int) -> str:
        uniform = sc["uniform"]
        if n in uniform:
            return uniform[n]
        key = nodes[n]
        for c in _children(key):
            if not low.per_gene[c]:
                ensure_uniform(sc, c)
        if key[0] == "roll":
            uniform[n] = ensure_uniform(sc, key[2])
            return uniform[n]

        def leaf(m, k):
            if k[0] == "var":
                return "(float)L"
            if k[0] == "const":
                return low.const_leaf(k[1], "0")
            slot = low.consts[k[1]]
            return (f"EXPR_LDG(cb + {slot.offset} + expr_code({uniform[k[2]]},"
                    f" {slot.shape[0]}))")

        sc["out"].append(f"  const float u{n} = {low.expr(n, lambda c: uniform[c], leaf)};")
        uniform[n] = f"u{n}"
        return uniform[n]

    def body(sc, s: int, reds, mats, g_expr: str, acc) -> List[str]:
        nonlocal child
        lines: List[str] = []
        done: Dict[int, str] = {}

        def leaf(n, key):
            nonlocal child
            kind = key[0]
            if kind == "var":
                if key[1] == "i":
                    return "(float)l"
                child |= g_expr == "crow[l]"
                return g_expr
            if kind == "const":
                return low.const_leaf(key[1], "l")
            if kind == "roll":
                src = key[2]
                sh = roll_shift(sc, key[1])
                base = "crow" if nodes[src] == ("var", "g") else f"(erows + {materialised[src]} * L)"
                return f"{base}[(l + {sh}) < L ? (l + {sh}) : (l + {sh} - L)]"
            slot = low.consts[key[1]]
            idx = gene(key[2])
            if low.table_kinds.get(key[1]) == "per_locus":
                return f"EXPR_LDG(cb + {slot.offset} + expr_code({idx}, {slot.shape[0]}) * L + l)"
            return f"EXPR_LDG(cb + {slot.offset} + expr_code({idx}, {slot.shape[0]}))"

        def gene(n: int) -> str:
            if not low.per_gene[n]:
                return ensure_uniform(sc, n)
            if n in done:
                return done[n]
            if n in materialised and level[n] < s:  # written by an earlier loop
                done[n] = f"erows[{materialised[n]} * L + l]"
                return done[n]
            key = nodes[n]
            if key[0] != "roll":
                for c in _children(key):
                    gene(c)
            lines.append(f"const float t{n} = {low.expr(n, gene, leaf)};")
            done[n] = f"t{n}"
            return done[n]

        for n in mats:
            lines.append(f"erows[{materialised[n]} * L + l] = {gene(n)};")
        for n in reds:
            key = nodes[n]
            if key[1] == "dot":
                lines.append(f"{acc(n)} += {gene(key[2])} * {gene(key[3])};")
            elif key[1] in ("sum", "mean"):
                lines.append(f"{acc(n)} += {gene(key[2])};")
            else:
                lines.append(f"{acc(n)} = expr_{key[1][:3]}({acc(n)}, {gene(key[2])});")
        return lines

    def combined(n: int, parts: str) -> str:
        val = f"expr_group<{_GROUP_OP.get(nodes[n][1], 0)}>({parts})"
        return f"{val} / (float)L" if nodes[n][1] == "mean" else val

    def stage_nodes(s):
        return ([n for n in st.reductions if st.stage_of(n) == s],
                [n for n in materialised if level[n] == s])

    reds0, mats0 = stage_nodes(first)
    sc0 = scope()
    genes = body(sc0, first, reds0, mats0, "x[i]", lambda n: f"A.a{n}[i]")
    sc = scope()
    out = sc["out"]
    for n in reds0:
        out += [f"  float v{n}[EXPR_G][4];",
                "  for (int s = 0; s < EXPR_G; ++s)",
                f"    for (int i = 0; i < 4; ++i) v{n}[s][i] = A[s].a{n}[i];",
                f"  const float u{n} = {combined(n, f'v{n}')};"]
        sc["uniform"][n] = f"u{n}"
    if mats0:
        out.append("  EXPR_SYNCGROUP();")
    for s in st.stages[1:]:
        reds, mats = stage_nodes(s)
        loop = body(sc, s, reds, mats, "crow[l]", lambda n: f"acc{n}[s][i]")
        out.extend(f"  float acc{n}[EXPR_G][4];" for n in reds)
        out.extend(["  for (int s = 0; s < EXPR_G; ++s) {",
                    "    const int sj = EXPR_G > 1 ? s : jl;"])
        out.extend(f"    for (int i = 0; i < 4; ++i) acc{n}[s][i] ="
                   f" {_INIT.get(nodes[n][1], '0.0f')};" for n in reds)
        out.extend(["    for (int l0 = 4 * sj; l0 < L; l0 += 32) {",
                    "      for (int i = 0; i < 4; ++i) {",
                    "        const int l = l0 + i;",
                    "        (void)l;",
                    *("        " + x for x in loop),
                    "      }",
                    "    }",
                    "  }"])
        for n in reds:
            out.append(f"  const float u{n} = {combined(n, f'acc{n}')};")
            sc["uniform"][n] = f"u{n}"
        if mats:
            out.append("  EXPR_SYNCGROUP();")
    result = ensure_uniform(sc, low.root)
    text = "\n".join([
        f"// objective, eight lanes a child: {obj.expression}",
        f"#define EXPR_OBJ_CHILD {int(child)}",
        "struct ExprAcc8 {",
        *(f"  float a{n}[4];" for n in reds0),
        "};",
        "__device__ __forceinline__ void expr_obj8_begin(ExprAcc8& A) {",
        "  (void)A;",
        *(f"  for (int i = 0; i < 4; ++i) A.a{n}[i] = {_INIT.get(nodes[n][1], '0.0f')};"
          for n in reds0),
        "}",
        "__device__ __forceinline__ void expr_obj8_genes(ExprAcc8& A, const float (&x)[4], int l0,"
        " int L, const float* __restrict__ crow, float* __restrict__ erows,"
        " const float* __restrict__ cb) {",
        "  (void)A; (void)x; (void)crow; (void)erows; (void)cb;",
        *sc0["out"],
        "  for (int i = 0; i < 4; ++i) {",
        "    const int l = l0 + i;",
        "    (void)l;",
        *("    " + x for x in genes),
        "  }",
        "}",
        "template <bool FUSED>",
        "__device__ __forceinline__ float expr_objective8(ExprAcc8 (&A)[EXPR_G],"
        " const float* __restrict__ crow, float* __restrict__ erows, int L, int jl,"
        " const float* __restrict__ cb) {",
        "  (void)crow; (void)erows; (void)jl; (void)cb;",
        "  if (!FUSED) {",
        "    for (int s = 0; s < EXPR_G; ++s) {",
        "      const int sj = EXPR_G > 1 ? s : jl;",
        "      expr_obj8_begin(A[s]);",
        "      for (int l0 = 4 * sj; l0 < L; l0 += 32) {",
        "        const float x[4] = {crow[l0], crow[l0 + 1], crow[l0 + 2], crow[l0 + 3]};",
        "        expr_obj8_genes(A[s], x, l0, L, crow, erows, cb);",
        "      }",
        "    }",
        "  }",
        *out,
        f"  return {result};",
        "}",
    ])
    return text, child


# ---------------------------------------------------------------------
# The whole generated unit
# ---------------------------------------------------------------------


@dataclasses.dataclass
class ExprProgram:
    """What the breed kernel needs from the expression hooks of one
    breed: ``source`` (prelude, macros and hooks; the template follows
    it), ``consts`` (the float32 constant buffer, objective then
    crossover then mutation constants, each flattened as registered),
    ``obj_rows`` (per-warp rows the objective materialises),
    ``obj_child`` (whether its eight-lane form reads the child back from
    a row, ``EXPR_OBJ_CHILD``), the random
    streams (``gene_planes``, ``row_words``: indices as in
    ``GENE_PLANES`` / ``ROW_WORDS``) and whether a breeding hook calls a
    transcendental, ``sqrt`` or ``**`` (``transcendental``: the genes it
    writes may then differ from torch's in the last ulps). ``gene_ops``
    is each hook's float32 operations a gene (``_Lowering.gene_ops``),
    by role ("objective", "crossover", "mutate"; 0 without that hook):
    what a bound on the breed counts."""

    source: str
    consts: np.ndarray
    obj_rows: int
    obj_child: bool
    gene_planes: Tuple[int, ...]
    row_words: Tuple[int, ...]
    has_crossover: bool
    has_mutate: bool
    has_objective: bool
    transcendental: bool
    gene_ops: Dict[str, int]
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def consts_on(self, device):
        """The constant buffer as a float32 tensor on ``device``, copied
        there once."""
        import torch

        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(self.consts).to(device)
        return self._on_device[key]


def _layout(parts) -> Tuple[Dict[str, Dict[str, ConstSlot]], np.ndarray]:
    """Offsets of every role's constants in one flat buffer."""
    slots: Dict[str, Dict[str, ConstSlot]] = {}
    chunks, offset = [], 0
    for role, op in parts:
        slots[role] = {}
        for name, arr in zip(op.const_names, op.const_arrays):
            a = np.asarray(arr, np.float32)
            slots[role][name] = ConstSlot(offset, tuple(a.shape))
            chunks.append(a.reshape(-1))
            offset += a.size
    buf = np.concatenate(chunks) if chunks else np.zeros(1, np.float32)
    return slots, buf.astype(np.float32)


def generate(crossover=None, mutate=None, objective=None) -> ExprProgram:
    """The generated unit for a breed whose crossover, mutation and
    objective are each an expression (``crossover_from_expression``,
    ``mutate_from_expression``, ``from_expression``) or None (a builtin
    kind the template handles)."""
    parts = [(r, op) for r, op in (("objective", objective), ("crossover", crossover),
                                   ("mutate", mutate)) if op is not None]
    slots, buf = _layout(parts)
    hooks, obj_rows, trans = [], 0, False
    gene_ops = {"objective": 0, "crossover": 0, "mutate": 0}
    obj_child = False
    for role, op in parts:
        if role == "objective":
            text, obj_rows, gene_ops[role] = _objective_hook(op, slots[role])
            text8, obj_child = _objective_hook8(op, slots[role])
            text = f"{text}\n{text8}"
        else:
            text, calls, gene_ops[role] = _breeding_hook(role, op, slots[role])
            trans |= calls
        hooks.append(text)
    planes, words = streams(crossover, mutate)
    macros = [
        f"#define EXPR_CROSS {int(crossover is not None)}",
        f"#define EXPR_MUT {int(mutate is not None)}",
        f"#define EXPR_OBJ {int(objective is not None)}",
        f"#define EXPR_OBJ_ROWS {obj_rows}",
        *([] if objective is not None else ["#define EXPR_OBJ_CHILD 0"]),
        f"#define EXPR_GENE_STREAMS {sum(1 << j for j in planes)}",
        f"#define EXPR_ROW_STREAMS {sum(1 << j for j in words)}",
    ]
    source = "\n".join([PRELUDE, *macros, "", *hooks, ""])
    return ExprProgram(
        source=source, consts=buf, obj_rows=obj_rows, obj_child=obj_child,
        gene_planes=planes, row_words=words,
        has_crossover=crossover is not None, has_mutate=mutate is not None,
        has_objective=objective is not None, transcendental=trans, gene_ops=gene_ops,
    )


def _op_key(op):
    """What decides an expression's generated text and constant values."""
    if op is None:
        return None
    arrays = tuple((np.shape(a), np.asarray(a, np.float32).tobytes()) for a in op.const_arrays)
    kinds = tuple(sorted(getattr(op, "table_kinds", {}).items()))
    return (getattr(op, "role", "objective"), op.expression, op.const_names, arrays, kinds)


_PROGRAMS: Dict[tuple, ExprProgram] = {}


def program_for(crossover=None, mutate=None, objective=None) -> ExprProgram:
    """:func:`generate`, cached by the expressions and their constant
    values (the mutation's rate and sigma are runtime inputs, not part
    of it)."""
    key = (_op_key(crossover), _op_key(mutate), _op_key(objective))
    if key not in _PROGRAMS:
        _PROGRAMS[key] = generate(crossover, mutate, objective)
    return _PROGRAMS[key]


HOST_HARNESS = r"""
#include <stdlib.h>
#if EXPR_CROSS
extern "C" void host_crossover(const float* p1, const float* p2, const float* r,
                               const float* r2, const float* q, const float* q2, int P,
                               int L, const float* cb, float* out) {
  for (int p = 0; p < P; ++p)
    for (int l = 0; l < L; ++l) {
      const size_t at = (size_t)p * L + l;
      out[at] = expr_crossover(p1[at], p2[at], r[at], r2[at], q[p], q2[p], l, L, cb);
    }
}
#endif
#if EXPR_MUT
extern "C" void host_mutate(const float* g, const float* r, const float* r2, const float* q,
                            const float* q2, int P, int L, float rate, float sigma,
                            const float* cb, float* out) {
  for (int p = 0; p < P; ++p)
    for (int l = 0; l < L; ++l) {
      const size_t at = (size_t)p * L + l;
      out[at] = expr_mutate(g[at], r[at], r2[at], q[p], q2[p], l, L, rate, sigma, cb);
    }
}
#endif
#if EXPR_OBJ
extern "C" void host_objective(const float* g, int P, int L, const float* cb, float* out) {
  float* rows = (float*)malloc(sizeof(float) * (size_t)(EXPR_OBJ_ROWS + 1) * L);
  for (int p = 0; p < P; ++p) out[p] = expr_objective(g + (size_t)p * L, rows, L, 0, cb);
  free(rows);
}
// The eight-lane form, the group's lanes run one after the other between
// its syncs: fused, as the breed calls it where it keeps no child row (each
// sub-lane s runs the first stage over its genes 4*s + 32*m + 0..3), or
// over the child's row.
extern "C" void host_objective8(const float* g, int P, int L, int fused, const float* cb,
                                float* out) {
  float* rows = (float*)malloc(sizeof(float) * (size_t)(EXPR_OBJ_ROWS + 1) * L);
  for (int p = 0; p < P; ++p) {
    const float* row = g + (size_t)p * L;
    ExprAcc8 A[EXPR_G];
    if (fused) {
      for (int s = 0; s < EXPR_G; ++s) {
        expr_obj8_begin(A[s]);
        for (int l0 = 4 * s; l0 < L; l0 += 32) {
          const float x[4] = {row[l0], row[l0 + 1], row[l0 + 2], row[l0 + 3]};
          expr_obj8_genes(A[s], x, l0, L, nullptr, rows, cb);
        }
      }
      out[p] = expr_objective8<true>(A, row, rows, L, 0, cb);
    } else {
      out[p] = expr_objective8<false>(A, row, rows, L, 0, cb);
    }
  }
  free(rows);
}
#endif
"""


def host_source(program: ExprProgram) -> str:
    """``program``'s hooks as plain C++ with ``extern "C"`` loops over
    rows (``host_crossover``, ``host_mutate``, ``host_objective``), for
    a host compiler: the lowering checked without a card."""
    return program.source + HOST_HARNESS
