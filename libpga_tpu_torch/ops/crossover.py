"""Crossover operators of the panmictic path (the default of
``libpga_tpu/ops/crossover.py:20-31``). A crossover is ``(p1, p2, rand)
-> child``; ``.batched`` is its whole-population form over ``(P, L)``
rows and a ``(P, rand_cols)`` uniform block (``rand_cols`` absent: L)."""

from __future__ import annotations

import torch


def uniform_crossover(p1: torch.Tensor, p2: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """Per-gene coin flip: ``rand > 0.5 ? p1 : p2`` (the reference's
    default crossover). Elementwise, so it is its own batched form."""
    return torch.where(rand > 0.5, p1, p2)


uniform_crossover.batched = uniform_crossover
