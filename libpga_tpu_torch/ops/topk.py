"""Best and top-k extraction: the port's copy of
``libpga_tpu/ops/topk.py``, built on one helper, :func:`top_k`.

JAX's ``lax.top_k`` orders scores by the IEEE total order (a NaN with
its sign bit clear above +inf, a NaN with it set below -inf, +0.0 above
-0.0) and puts the lower index first among equal scores. ``torch.topk``
leaves the order of equal scores unspecified, so the elites and the best
rows of a population with tied scores (onemax_bits, the knapsack, the
trap, the TSP) would differ from JAX's. :func:`top_k` sorts the
total-order integer key of each score with a stable descending sort,
which gives ``lax.top_k``'s rows in ``lax.top_k``'s order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` best of ``scores`` (float32)
    along its last axis (one population's (P,), or islands' (I, S)),
    best first: ``lax.top_k``'s rows in its order. A negative ``k``
    raises ``lax.top_k``'s ValueError."""
    if k < 0:
        raise ValueError("k argument to top_k must be nonnegative")
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # monotone in the total order
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(scores, -1, idx), idx


def top_k_genomes(
    genomes: torch.Tensor, scores: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k individuals by score, best first: ``(k, L)`` genomes and
    ``(k,)`` scores."""
    values, idx = top_k(scores, k)
    return genomes[idx], values


def best_genome(genomes: torch.Tensor, scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(best genome, best score)``: the first row of
    :func:`top_k_genomes`, the row JAX's ``get_best_with_score`` takes."""
    g, s = top_k_genomes(genomes, scores, 1)
    return g[0], s[0]
