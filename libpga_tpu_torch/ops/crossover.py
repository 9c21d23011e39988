"""Crossover operators of the panmictic path (``libpga_tpu/ops/
crossover.py``: uniform, ``:20-31``; one-point and arithmetic,
``:34-58``; order-preserving, ``:61-132``). A crossover is ``(p1, p2,
rand) -> child``; ``.batched`` is its whole-population form over ``(P,
L)`` rows and a ``(P, rand_cols)`` uniform block (``rand_cols`` absent:
L). On the deme path the engine runs one-point and arithmetic crossover
as their expression equivalents (``engine.PGA.CROSSOVER_EXPRS``)."""

from __future__ import annotations

import torch

from libpga_tpu_torch.objectives.classic import tsp_cities


def uniform_crossover(p1: torch.Tensor, p2: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """Per-gene coin flip: ``rand > 0.5 ? p1 : p2`` (the reference's
    default crossover). Elementwise, so it is its own batched form."""
    return torch.where(rand > 0.5, p1, p2)


uniform_crossover.batched = uniform_crossover


def _one_point_batched(p1: torch.Tensor, p2: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    L = p1.shape[1]
    cut = torch.floor(rand[:, 0] * L).to(torch.int32)
    pos = torch.arange(L, dtype=torch.int32, device=p1.device)[None, :]
    return torch.where(pos < cut[:, None], p1, p2)


def one_point_crossover(p1: torch.Tensor, p2: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """One cut at ``floor(rand[0] * L)``: the prefix from p1, the suffix
    from p2."""
    return _one_point_batched(p1[None], p2[None], rand[None])[0]


one_point_crossover.batched = _one_point_batched
one_point_crossover.rand_cols = 1


def arithmetic_crossover(p1: torch.Tensor, p2: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """Per-gene convex blend ``a*p1 + (1-a)*p2`` with ``a = rand``
    (real-coded GAs). Elementwise, so it is its own batched form."""
    return rand * p1 + (1.0 - rand) * p2


arithmetic_crossover.batched = arithmetic_crossover


def order_walk(p1: torch.Tensor, p2: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """The order-preserving walk on ``(N, L)`` rows (the reference TSP
    driver's crossover, test3/test.cu:48-64): left to right, take p1's
    gene if its city (``tsp_cities``) is unvisited, else p2's if that
    city is unvisited, else ``fill``'s. A city is marked visited only
    when a parent's gene is taken, never by the fallback. An L-step loop
    carrying an (N, L) visited matrix; the plain version of the walk in
    ``csrc/deme_breed.cu``'s order kernel."""
    N, L = p1.shape
    c1, c2 = tsp_cities(p1), tsp_cities(p2)
    visited = torch.zeros((N, L), dtype=torch.bool, device=p1.device)
    child = torch.empty_like(p1)
    rows = torch.arange(N, device=p1.device)
    for l in range(L):
        a, b = c1[:, l], c2[:, l]
        take1 = ~visited[rows, a]
        take2 = ~take1 & ~visited[rows, b]
        child[:, l] = torch.where(
            take1, p1[:, l], torch.where(take2, p2[:, l], fill[:, l])
        )
        city = torch.where(take1, a, b)
        visited[rows, city] = visited[rows, city] | take1 | take2
    return child


def order_preserving_crossover(
    p1: torch.Tensor, p2: torch.Tensor, rand: torch.Tensor
) -> torch.Tensor:
    """Uniqueness-preserving crossover for permutation-coded genomes on
    ``(L,)`` rows: :func:`order_walk` with ``rand`` as the fallback
    genes. ``.batched`` is :func:`order_walk` itself."""
    return order_walk(p1[None], p2[None], rand[None])[0]


order_preserving_crossover.batched = order_walk
