"""Parent selection (plain PyTorch): the rank-space formulas of the deme
kernel, and the panmictic strategies of the XLA path.

Copies of ``libpga_tpu.ops.select.resolve_selection`` and
``rank_fraction_icdf`` plus the tournament inverse CDF of the JAX deme
kernel (``libpga_tpu/ops/pallas_step.py::_deme_child``). Every formula
keeps the JAX package's float32 operation order, so the same uniform
draws give the same winner ranks; ``csrc/deme_breed.cu`` repeats them
operation for operation (built with ``--fmad=false`` so no multiply-add
is contracted).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

SELECTION_KINDS = ("tournament", "truncation", "linear_rank")


def resolve_selection(kind: str, param: float | None) -> float | None:
    """Default and validate a strategy's parameter: None for tournament,
    tau in (0, 1] for truncation (default 0.5), pressure s in (1, 2] for
    linear_rank (default 2.0). Raises ValueError otherwise."""
    if kind == "tournament":
        return None
    if kind == "truncation":
        param = 0.5 if param is None else param
        if not 0.0 < param <= 1.0:
            raise ValueError(f"truncation tau must be in (0, 1], got {param}")
        return param
    if kind == "linear_rank":
        param = 2.0 if param is None else param
        if not 1.0 < param <= 2.0:
            raise ValueError(
                f"linear ranking pressure must be in (1, 2], got {param}"
            )
        return param
    raise ValueError(
        f"unknown selection kind {kind!r}; one of {SELECTION_KINDS}"
    )


def rank_fraction_icdf(kind: str, param: float, u: torch.Tensor) -> torch.Tensor:
    """Uniform draws ``u`` (float32) -> winner rank fractions in [0, 1)
    for truncation and linear ranking."""
    if kind == "truncation":
        return u * torch.tensor(param, dtype=torch.float32)
    if kind == "linear_rank":
        s = torch.tensor(param, dtype=torch.float32)
        # The radicand can round fractionally negative for s near 2 and
        # u near 1; the clip keeps x in [0, 1) at both ends.
        x = (
            s - torch.sqrt(torch.clamp(s * s - 4.0 * (s - 1.0) * u, min=0.0))
        ) / (2.0 * (s - 1.0))
        return torch.clamp(x, 0.0, 1.0 - 2.0**-24)
    raise ValueError(f"no rank-fraction ICDF for selection kind {kind!r}")


def winner_fraction(
    kind: str, param: float | None, tournament_size: int, u: torch.Tensor
) -> torch.Tensor:
    """Rank fraction of the selected parent for each uniform draw.

    A k-way tournament's winner is the minimum of k uniform candidate
    ranks, with inverse CDF ``1 - (1-u)^(1/k)``: repeated square roots
    for power-of-two k, the exp/log form otherwise."""
    if kind != "tournament":
        return rank_fraction_icdf(kind, param, u)
    k = tournament_size
    if k == 1:
        return u
    if k & (k - 1) == 0:
        t = 1.0 - u
        for _ in range(k.bit_length() - 1):
            t = torch.sqrt(t)
        return 1.0 - t
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32)
    return 1.0 - torch.exp(torch.log(1.0 - u) * inv_k)


def winner_ranks(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rank fractions ``x`` -> integer winner ranks in [0, V-1].
    ``valid`` (float32, broadcastable) is the deme's real-row count V.
    Two-sided clamp: ``x*V`` can round up to V in float32."""
    r = torch.floor(x * valid)
    return torch.minimum(torch.clamp(r, min=0.0), valid - 1.0).to(torch.int64)


# ---------------------------------------------------------------------
# Panmictic selection (copies of libpga_tpu/ops/select.py:20-195). Each
# strategy takes its draws as tensors, or draws them from ``generator``.
# ---------------------------------------------------------------------


@dataclasses.dataclass
class SelectDraws:
    """The random numbers one selection of ``num`` winners consumes:
    ``idx`` (num, k) candidate rows for tournaments; ``tie`` (pop,)
    uint32 words held in int64 and ``u`` (num,) float32 uniforms for the
    rank strategies. A field left None is drawn from the generator."""

    idx: Optional[torch.Tensor] = None
    tie: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None


def tournament_select(
    scores: torch.Tensor,
    num: int,
    k: int = 2,
    *,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``num`` independent k-way tournaments over ``scores`` (higher is
    better); returns (num,) int64 winner rows. k=2 is the branchless
    pairwise form (ties and NaN go as ``>=`` says: to the first
    candidate unless it is NaN); other k take the first maximum
    (argmax, NaN counting as the largest)."""
    pop = scores.shape[0]
    if idx is None:
        idx = torch.randint(
            0, pop, (num, k), generator=generator, device=scores.device
        )
    idx = idx.long()
    if k == 2:
        i1, i2 = idx[:, 0], idx[:, 1]
        return torch.where(scores[i1] >= scores[i2], i1, i2)
    win = torch.argmax(scores[idx], dim=-1)
    return torch.gather(idx, 1, win[:, None])[:, 0]


def _score_order_key(scores: torch.Tensor) -> torch.Tensor:
    """int64 key ascending in ``-scores`` under JAX's float sort order:
    -0.0 equals +0.0, NaN sorts last (worst)."""
    ns = (-scores.to(torch.float32)) + 0.0
    bits = ns.view(torch.int32).to(torch.int64)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(ns), 0x7FFFFFFF, key)


def rank_order(scores: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """Rows best-first (rank r -> row): score descending, then the tie
    word ascending, then the row. One stable sort of a packed int64 key
    (as ``fused_step.compute_ranks`` does)."""
    packed = (_score_order_key(scores) << 32) | tie.to(torch.int64)
    return torch.sort(packed, stable=True).indices


def draw_ties(generator, n: int, device) -> torch.Tensor:
    """Fresh uint32 tie words (JAX: ``random.bits``), held in int64."""
    return torch.randint(
        0, 2**32, (n,), generator=generator, device=device, dtype=torch.int64
    )


def _rank_select(kind, scores, num, param, generator, tie, u):
    pop = scores.shape[0]
    param = resolve_selection(kind, param)
    if tie is None:
        tie = draw_ties(generator, pop, scores.device)
    if u is None:
        u = torch.rand((num,), generator=generator, device=scores.device)
    order = rank_order(scores, tie)
    x = rank_fraction_icdf(kind, param, u.to(torch.float32))
    r = torch.clamp((x * pop).to(torch.int32), 0, pop - 1)
    return order[r.long()]


def truncation_select(scores, num, tau, *, generator=None, tie=None, u=None):
    """``num`` parents uniform over the top ``ceil(tau * pop)`` ranks."""
    return _rank_select("truncation", scores, num, tau, generator, tie, u)


def linear_rank_select(scores, num, pressure, *, generator=None, tie=None, u=None):
    """Linear ranking with pressure ``s`` in (1, 2]: rank-fraction
    density ``s - 2(s-1)x``."""
    return _rank_select("linear_rank", scores, num, pressure, generator, tie, u)


def select_parent_pairs(
    scores: torch.Tensor,
    num_children: int,
    k: int = 2,
    kind: str = "tournament",
    param: Optional[float] = None,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[SelectDraws] = None,
):
    """Two selections per child -> ``(p1_idx, p2_idx)``, each
    (num_children,): ``2 * num_children`` winners, split in halves."""
    d = draws or SelectDraws()
    num = 2 * num_children
    if kind == "tournament":
        winners = tournament_select(scores, num, k, generator=generator, idx=d.idx)
    elif kind in ("truncation", "linear_rank"):
        winners = _rank_select(kind, scores, num, param, generator, d.tie, d.u)
    else:
        resolve_selection(kind, param)  # raises with the canonical message
        raise AssertionError("unreachable")
    return winners[:num_children], winners[num_children:]
