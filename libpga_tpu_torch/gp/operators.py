"""GP variation operators: size-fair subtree crossover, subtree and point
mutation (the torch counterpart of ``libpga_tpu/gp/operators.py``).

Each factory returns a per-individual callable carrying the attributes
the breed step dispatches on (``ops/step.make_breed``): ``.batched``
(whole-population form), ``.rand_cols`` (uniform columns per
individual), ``.param_batched`` (rate as a runtime input) and
``.xla_only`` (no in-kernel form: these run as plain torch on the
panmictic path; the GP kernel is the evaluator). Every operator is a
function of its uniform block, so the same block gives the JAX
package's genomes bit for bit.

Both structural operators keep strict postfix well-formedness: a
complete subtree is a contiguous token slice with net stack effect +1,
so swapping one for another leaves every later token's depth unchanged;
the donor span is capped at ``min(2*span(A) + 1, span(A) + T - len)``,
so the child never exceeds ``max_nodes`` tokens. Point mutation keeps
the arity. Arbitrary inputs are canonicalized first.
"""

from __future__ import annotations

from typing import Callable

import torch

from libpga_tpu_torch.gp.encoding import (
    PAD_OP,
    GPConfig,
    arity_table,
    canonicalize,
    decode_ops,
    grow_rand_cols,
    pad_row,
    program_structure,
    random_program_genes,
    token_gather,
)


def _pick_nth(mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Index of the (n+1)-th True per row of ``mask`` (cumsum trick;
    0 where there is none)."""
    cum = torch.cumsum(mask.to(torch.int32), dim=1)
    sel = mask & (cum == n[:, None] + 1)
    return torch.argmax(sel.to(torch.int32), dim=1).to(torch.int32)


def _take(m: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(m, 1, i.long()[:, None])[:, 0]


def _floor_index(r: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``clip(floor(r * n), 0, max(n - 1, 0))`` in float32, as JAX
    computes it."""
    k = torch.floor(r * n).to(torch.int32)
    return torch.minimum(torch.clamp(k, min=0), torch.clamp(n - 1, min=0))


def _splice(p1c, p2c, r0, r1, gp: GPConfig) -> torch.Tensor:
    """Size-fair subtree replacement on canonical parents: a uniformly
    chosen subtree of ``p1c`` gives way to a size-capped subtree of
    ``p2c``."""
    T = gp.max_nodes
    st1 = program_structure(p1c, gp)
    st2 = program_structure(p2c, gp)
    len1, len2 = st1.length, st2.length
    i1 = _floor_index(r0, len1)
    spanA = _take(st1.span, i1)
    startA = i1 - spanA + 1
    limit = torch.minimum(spanA + (T - len1), 2 * spanA + 1)
    iota = torch.arange(T, dtype=torch.int32, device=p1c.device)[None, :]
    valid = (iota < len2[:, None]) & (st2.span <= limit[:, None])
    cnt = valid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    k2 = _floor_index(r1, cnt)
    j2 = _pick_nth(valid, k2)
    spanB = _take(st2.span, j2)
    startB = j2 - spanB + 1

    in_mid = (iota >= startA[:, None]) & (iota < (startA + spanB)[:, None])
    after = iota >= (startA + spanB)[:, None]
    src1 = torch.where(after, iota - spanB[:, None] + spanA[:, None], iota)
    src2 = startB[:, None] + (iota - startA[:, None])
    g1 = token_gather(p1c, torch.clamp(src1, 0, T - 1))
    g2 = token_gather(p2c, torch.clamp(src2, 0, T - 1))
    child = torch.where(in_mid.repeat_interleave(2, dim=1), g2, g1)
    newlen = len1 - spanA + spanB
    tail = (iota >= newlen[:, None]).repeat_interleave(2, dim=1)
    child = torch.where(tail, pad_row(gp, child), child)
    # An empty parent contributes nothing to splice.
    child = torch.where((len1 == 0)[:, None], p2c, child)
    return torch.where((len2 == 0)[:, None], p1c, child)


def _per_row(batched):
    def op(*rows):
        return batched(*(r[None, :] for r in rows))[0]
    return op


def make_subtree_crossover(gp: GPConfig) -> Callable:
    """Size-fair subtree crossover (named kind ``gp_subtree``)."""

    def batched(p1, p2, rand):
        return _splice(
            canonicalize(p1, gp), canonicalize(p2, gp), rand[:, 0], rand[:, 1], gp
        )

    op = _per_row(batched)
    op.batched = batched
    op.rand_cols = 2
    op.kernel_cache_key = f"gp_subtree_crossover/{gp.cache_key()}"
    op.xla_only = True
    op.gp_config = gp
    return op


def make_subtree_mutate(gp: GPConfig, rate: float = 0.3) -> Callable:
    """Subtree mutation (named kind ``gp_subtree``): with probability
    ``rate`` per individual, splice a freshly grown random subtree over
    a uniformly chosen one."""
    gc = grow_rand_cols(gp)

    def _mutate(genomes, rand, rate_val):
        donors = random_program_genes(rand[:, 3:], gp)
        mutated = _splice(canonicalize(genomes, gp), donors, rand[:, 1], rand[:, 2], gp)
        return torch.where((rand[:, 0] < rate_val)[:, None], mutated, genomes)

    def batched(genomes, rand):
        return _mutate(genomes, rand, rate)

    def param_batched(genomes, rand, rate_val, sigma):
        return _mutate(genomes, rand, rate_val)

    op = _per_row(batched)
    op.batched = batched
    op.param_batched = param_batched
    op.rand_cols = 3 + gc
    op.rate = rate
    op.kernel_cache_key = f"gp_subtree_mutate/{gp.cache_key()}"
    op.xla_only = True
    op.gp_config = gp
    return op


def make_gp_point_mutate(gp: GPConfig, rate: float = 0.2) -> Callable:
    """Point mutation (named kind ``gp_point``): with probability
    ``rate`` per individual, one uniformly chosen live token gets a
    random opcode of the same arity and a fresh operand gene."""
    n_ops = gp.n_ops

    def _mutate(genomes, rand, rate_val):
        P, L = genomes.shape
        dev = genomes.device
        arity = arity_table(gp, dev)
        nonpad = (torch.arange(n_ops, device=dev) != PAD_OP)[None, :]
        st = program_structure(genomes, gp)
        length = st.length
        pos = _pick_nth(st.live, _floor_index(rand[:, 1], length))
        op_i = _take(decode_ops(genomes, gp), pos)
        allowed = (arity[None, :] == arity[op_i.long()][:, None]) & nonpad
        cnt = allowed.to(torch.int32).sum(dim=1, dtype=torch.int32)
        new_op = _pick_nth(allowed, _floor_index(rand[:, 2], cnt))
        new_opg = (new_op.to(torch.float32) + 0.5) / n_ops
        fire = (rand[:, 0] < rate_val) & (length > 0)
        cols = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
        hit_op = (cols == (2 * pos)[:, None]) & fire[:, None]
        hit_arg = (cols == (2 * pos + 1)[:, None]) & fire[:, None]
        out = torch.where(hit_op, new_opg[:, None].to(genomes.dtype), genomes)
        return torch.where(hit_arg, rand[:, 3:4].to(genomes.dtype), out)

    def batched(genomes, rand):
        return _mutate(genomes, rand, rate)

    def param_batched(genomes, rand, rate_val, sigma):
        return _mutate(genomes, rand, rate_val)

    op = _per_row(batched)
    op.batched = batched
    op.param_batched = param_batched
    op.rand_cols = 4
    op.rate = rate
    op.kernel_cache_key = f"gp_point_mutate/{gp.cache_key()}"
    op.xla_only = True
    op.gp_config = gp
    return op


def make_gp_mutate(
    gp: GPConfig, subtree_rate: float = 0.4, point_rate: float = 0.6
) -> Callable:
    """The standard GP mutation (named kind ``gp_mutate``): subtree
    mutation chained with point mutation. For ``param_batched`` the rate
    drives the subtree rate and sigma the point rate."""
    sub = make_subtree_mutate(gp, rate=subtree_rate)
    pt = make_gp_point_mutate(gp, rate=point_rate)
    c1 = sub.rand_cols

    def batched(genomes, rand):
        return pt.batched(sub.batched(genomes, rand[:, :c1]), rand[:, c1:])

    def param_batched(genomes, rand, rate_val, sigma):
        mid = sub.param_batched(genomes, rand[:, :c1], rate_val, 0.0)
        return pt.param_batched(mid, rand[:, c1:], sigma, 0.0)

    op = _per_row(batched)
    op.batched = batched
    op.param_batched = param_batched
    op.rand_cols = c1 + pt.rand_cols
    op.rate = subtree_rate
    op.sigma = point_rate
    op.kernel_cache_key = f"gp_mutate/{subtree_rate}/{point_rate}/{gp.cache_key()}"
    op.xla_only = True
    op.gp_config = gp
    return op


#: Named operator registry.
CROSSOVER_KINDS = {"gp_subtree": make_subtree_crossover}
MUTATE_KINDS = {
    "gp_subtree": make_subtree_mutate,
    "gp_point": make_gp_point_mutate,
    "gp_mutate": make_gp_mutate,
}
