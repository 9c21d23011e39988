"""The solver: the subset of ``libpga_tpu.engine.PGA`` that drives
``PGA.run`` on the fused deme path.

Every generation of ``run`` is one launch of the deme-breed kernel
(``ops/fused_step.py``) on the card, or its plain version when the
solver's device is the CPU. There is no fallback between the two: the
device is the config's, and a missing card is an error.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from libpga_tpu_torch.config import PGAConfig
from libpga_tpu_torch.ops.fused_step import make_fused_run
from libpga_tpu_torch.population import Population, create_population


@dataclasses.dataclass(frozen=True)
class PopulationHandle:
    """Opaque handle to a population owned by a :class:`PGA`."""

    index: int


class PGA:
    """A genetic-algorithm solver on one device.

    Example::

        pga = PGA(seed=0)
        pop = pga.create_population(40_000, 100)
        pga.set_objective("onemax")
        pga.run(100)
        best = pga.get_best(pop)

    ``launches`` counts the breed launches this solver issued (one per
    generation run).
    """

    def __init__(self, seed: Optional[int] = None, config: Optional[PGAConfig] = None):
        self.config = config or PGAConfig()
        if seed is None:
            seed = self.config.seed
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PGAConfig.device is 'cuda' but no CUDA device is available;"
                " pass PGAConfig(device='cpu') to run the plain version"
            )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._populations: list = []
        self._objective: Optional[Callable] = None
        self._runs: Dict[Tuple[int, int], Callable] = {}
        self.launches = 0

    # ----------------------------------------------------------- populations

    def create_population(
        self, size: int, genome_len: int, init: str = "random"
    ) -> PopulationHandle:
        """Uniform [0, 1) genomes from the solver's generator."""
        pop = create_population(
            self.generator, size, genome_len, init=init, device=self.device
        )
        self._populations.append(pop)
        return PopulationHandle(len(self._populations) - 1)

    def install_population(
        self, genomes: Union[Population, torch.Tensor, np.ndarray]
    ) -> PopulationHandle:
        """Install an explicit population: a :class:`Population` (e.g.
        from ``interop.state_from_numpy``) or a ``(size, genome_len)``
        matrix, whose scores read -inf until the first run."""
        if isinstance(genomes, Population):
            g, s = genomes.genomes, genomes.scores
        else:
            g = (
                genomes if isinstance(genomes, torch.Tensor)
                else torch.tensor(np.asarray(genomes), dtype=torch.float32)
            )
            s = torch.full((g.shape[0],), -torch.inf)
        if g.ndim != 2:
            raise ValueError(
                "install_population needs a (size, genome_len) matrix;"
                f" got shape {tuple(g.shape)}"
            )
        g = g.to(self.device, torch.float32).contiguous()
        s = s.to(self.device, torch.float32).contiguous()
        self._populations.append(Population(genomes=g, scores=s))
        return PopulationHandle(len(self._populations) - 1)

    def population(self, handle: PopulationHandle) -> Population:
        return self._populations[handle.index]

    # ------------------------------------------------------------- objective

    def set_objective(self, fn: Union[str, Callable]) -> None:
        """A rowwise callable ``(P, L) -> (P,)`` (higher is better) or
        the name of a builtin from :mod:`libpga_tpu_torch.objectives`."""
        if isinstance(fn, str):
            from libpga_tpu_torch import objectives

            fn = objectives.get(fn)
        self._objective = fn
        self._runs.clear()

    def _require_objective(self) -> Callable:
        if self._objective is None:
            raise RuntimeError(
                "no objective set — call set_objective() before run()"
            )
        return self._objective

    # ------------------------------------------------------------------- run

    def _run_fn(self, size: int, genome_len: int) -> Callable:
        key = (size, genome_len)
        if key not in self._runs:
            c = self.config
            self._runs[key] = make_fused_run(
                size, genome_len, self._require_objective(),
                deme_size=c.deme_size, tournament_size=c.tournament_size,
                selection=c.selection, selection_param=c.selection_param,
                mutation_rate=c.mutation_rate, elitism=c.elitism,
                device=self.device,
            )
        return self._runs[key]

    def run(
        self,
        n: int,
        target: Optional[float] = None,
        population: Optional[PopulationHandle] = None,
    ) -> int:
        """Run up to ``n`` generations on the first population (or
        ``population``). Stops as soon as a generation's best score
        reaches ``target``; that generation is the one kept. Returns the
        number of generations run."""
        self._require_objective()
        handle = population or PopulationHandle(0)
        pop = self._populations[handle.index]
        fn = self._run_fn(pop.size, pop.genome_len)
        genomes, scores, gens = fn(pop.genomes, int(n), target, self.generator)
        self._populations[handle.index] = Population(genomes=genomes, scores=scores)
        self.launches += gens
        return gens

    # -------------------------------------------------------- best extraction

    def get_best_with_score(self, handle: PopulationHandle) -> Tuple[np.ndarray, float]:
        pop = self._populations[handle.index]
        i = int(torch.argmax(pop.scores))
        return pop.genomes[i].cpu().numpy(), float(pop.scores[i])

    def get_best(self, handle: PopulationHandle) -> np.ndarray:
        """Best genome of one population."""
        return self.get_best_with_score(handle)[0]

    def get_best_top(self, handle: PopulationHandle, k: int) -> np.ndarray:
        """Top-k genomes, best first; ``k`` is clamped to the size."""
        pop = self._populations[handle.index]
        _, idx = torch.topk(pop.scores, min(k, pop.size))
        return pop.genomes[idx].cpu().numpy()
