"""C-shaped ``pga_*`` veneer over :class:`libpga_tpu_torch.engine.PGA`
(the subset of ``libpga_tpu/api.py`` this slice ports)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

from libpga_tpu_torch.config import PGAConfig
from libpga_tpu_torch.engine import PGA, PopulationHandle

RANDOM_POPULATION = "random"


def pga_init(seed: Optional[int] = None, config: Optional[PGAConfig] = None) -> PGA:
    """Create a solver instance (``pga.h:53``); on the card by default."""
    return PGA(seed=seed, config=config)


def pga_deinit(pga: PGA) -> None:
    """Release the instance's populations and compiled runs."""
    pga._populations.clear()
    pga._runs.clear()


def pga_create_population(
    pga: PGA, size: int, genome_len: int, type: str = RANDOM_POPULATION
) -> PopulationHandle:
    """Create a population (``pga.h:63``)."""
    return pga.create_population(size, genome_len, init=type)


def pga_set_objective_function(pga: PGA, fn: Union[Callable, str]) -> None:
    """Set the fitness function: a builtin name or a rowwise callable."""
    pga.set_objective(fn)


def pga_set_crossover_function(pga: PGA, fn: Optional[Callable]) -> None:
    """Set the crossover operator (``pga.h:85``); None restores the
    default uniform crossover."""
    pga.set_crossover(fn)


def pga_set_mutate_function(pga: PGA, fn: Optional[Callable]) -> None:
    """Set the mutation operator (``pga.h:78``); None restores the
    default point mutation."""
    pga.set_mutate(fn)


def pga_run(pga: PGA, n: int, target: Optional[float] = None) -> int:
    """Run the GA on the first population, stopping early at ``target``."""
    return pga.run(n, target=target)


def pga_get_best(pga: PGA, pop: PopulationHandle) -> np.ndarray:
    """Best genome of a population (``pga.h:90``)."""
    return pga.get_best(pop)
