"""Fitness evaluation: the torch counterpart of
``libpga_tpu/ops/evaluate.py``. Objectives are rowwise, so evaluation
is one call over the whole ``(pop, genome_len)`` matrix."""

from __future__ import annotations

from typing import Callable

import torch


def evaluate(obj: Callable[[torch.Tensor], torch.Tensor], genomes: torch.Tensor) -> torch.Tensor:
    """Score every row of ``genomes``; returns ``(pop,)`` float32.

    An objective with a whole-population ``.rows`` form is scored through
    it, after its ``.prepare_eval`` hook where it has one (the GP
    objective compacts programs into a transient ``EvalProgram`` there;
    the stored genomes are untouched)."""
    genomes = genomes.to(torch.float32)
    rows = getattr(obj, "rows", None)
    if rows is None:
        return obj(genomes).to(torch.float32)
    prep = getattr(obj, "prepare_eval", None)
    return rows(genomes if prep is None else prep(genomes)).to(torch.float32)
