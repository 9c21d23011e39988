"""C-shaped ``pga_*`` veneer over :class:`libpga_tpu_torch.engine.PGA`
(the subset of ``libpga_tpu/api.py`` ported so far: the step-by-step
``pga_evaluate`` / ``pga_crossover`` / ``pga_mutate`` family is not)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

from libpga_tpu_torch.config import PGAConfig
from libpga_tpu_torch.engine import PGA, PopulationHandle

RANDOM_POPULATION = "random"


def pga_init(seed: Optional[int] = None, config: Optional[PGAConfig] = None) -> PGA:
    """Create a solver instance (``pga.h:53``); on the card by default,
    genomes in ``config.gene_dtype`` (float32 or bfloat16). Without a
    config, at most 10 populations, as the reference (``pga.h:44``)."""
    return PGA(seed=seed, config=config or PGAConfig(max_populations=10))


def pga_deinit(pga: PGA) -> None:
    """Release the instance's populations and compiled runs."""
    pga._populations.clear()
    pga._forget_runs()


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
    """Best genome of a population (``pga.h:90``), float32 whatever the
    gene dtype (a bfloat16 gene widens exactly)."""
    return pga.get_best(pop)


def pga_get_best_top(pga: PGA, pop: PopulationHandle, length: int) -> np.ndarray:
    """Top-``length`` genomes of a population, best first (``pga.h:91``;
    a stub in the reference)."""
    return pga.get_best_top(pop, length)


def pga_get_best_all(pga: PGA) -> np.ndarray:
    """Best genome across all populations (``pga.h:92``; a stub in the
    reference)."""
    return pga.get_best_all()


def pga_get_best_top_all(pga: PGA, length: int) -> np.ndarray:
    """Global top-``length`` across populations (``pga.h:93``; a stub in
    the reference)."""
    return pga.get_best_top_all(length)


def pga_migrate(pga: PGA, pct: float) -> None:
    """Migrate the top ``pct`` between populations along a random ring
    (``pga.h:111``; an empty stub in the reference)."""
    pga.migrate(pct)


def pga_migrate_between(
    pga: PGA, src: PopulationHandle, dst: PopulationHandle, pct: float
) -> None:
    """Migrate the top ``pct`` of ``src`` over the worst of ``dst``
    (``pga.h:115``; an empty stub in the reference)."""
    pga.migrate_between(src, dst, pct)


def pga_run_islands(
    pga: PGA, n: int, m: int, pct: float, target: Optional[float] = None, mesh=None
) -> int:
    """Island GA over every population, migrating every ``m``
    generations (``pga.h:150``; an empty stub in the reference)."""
    return pga.run_islands(n, m, pct, target=target, mesh=mesh)
