"""Rank-space parent selection (plain PyTorch).

Copies of ``libpga_tpu.ops.select.resolve_selection`` and
``rank_fraction_icdf`` plus the tournament inverse CDF of the JAX deme
kernel (``libpga_tpu/ops/pallas_step.py::_deme_child``). Every formula
keeps the JAX package's float32 operation order, so the same uniform
draws give the same winner ranks; ``csrc/deme_breed.cu`` repeats them
operation for operation (built with ``--fmad=false`` so no multiply-add
is contracted).
"""

from __future__ import annotations

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
