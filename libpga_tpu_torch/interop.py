"""Carry a population across from the JAX package.

A GA's state is its population. ``state_from_numpy`` takes
``np.asarray(pga.population(h).genomes)`` (and optionally the scores)
from a ``libpga_tpu`` solver and returns the port's
:class:`~libpga_tpu_torch.population.Population`, which
``PGA.install_population`` accepts. Only numpy crosses the boundary.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from libpga_tpu_torch.population import Population


def state_from_numpy(
    genomes: np.ndarray, scores: Optional[np.ndarray] = None, device="cuda"
) -> Population:
    """``(size, genome_len)`` genomes and ``(size,)`` scores (None:
    -inf, unevaluated) as float32 tensors on ``device``."""
    g = np.asarray(genomes, dtype=np.float32)
    if g.ndim != 2:
        raise ValueError(f"genomes must be (size, genome_len); got {g.shape}")
    if scores is None:
        s = np.full(g.shape[0], -np.inf, np.float32)
    else:
        s = np.asarray(scores, dtype=np.float32)
        if s.shape != (g.shape[0],):
            raise ValueError(f"scores must be ({g.shape[0]},); got {s.shape}")
    return Population(
        genomes=torch.from_numpy(g.copy()).to(device),
        scores=torch.from_numpy(s.copy()).to(device),
    )
