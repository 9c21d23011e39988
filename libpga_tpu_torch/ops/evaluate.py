"""Fitness evaluation: the torch counterpart of
``libpga_tpu/ops/evaluate.py``. Objectives are rowwise, so evaluation
is one call over the whole ``(pop, genome_len)`` matrix."""

from __future__ import annotations

from typing import Callable

import torch


def evaluate(obj: Callable[[torch.Tensor], torch.Tensor], genomes: torch.Tensor) -> torch.Tensor:
    """Score every row of ``genomes``; returns ``(pop,)`` float32."""
    return obj(genomes.to(torch.float32)).to(torch.float32)
