"""Population container: the torch counterpart of
``libpga_tpu/population.py``. A population is one ``(size, genome_len)``
float32 genome matrix plus a ``(size,)`` score vector, on one device."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Population:
    """genomes: ``(size, genome_len)`` genes in [0, 1); scores:
    ``(size,)`` fitness, higher is better (``-inf`` until evaluated)."""

    genomes: torch.Tensor
    scores: torch.Tensor

    @property
    def size(self) -> int:
        return self.genomes.shape[0]

    @property
    def genome_len(self) -> int:
        return self.genomes.shape[1]


def create_population(
    generator: torch.Generator,
    size: int,
    genome_len: int,
    init: str = "random",
    device="cpu",
) -> Population:
    """"random": uniform [0, 1) genes from ``generator``; "zeros": all
    zero. ``genome_len >= 4`` is the reference's guard (its default
    mutation consumes three draws per genome)."""
    if genome_len < 4:
        raise ValueError("genome_len must be >= 4")
    if size < 1:
        raise ValueError("population size must be >= 1")
    if init == "random":
        genomes = torch.rand(
            (size, genome_len), generator=generator, device=device,
            dtype=torch.float32,
        )
    elif init == "zeros":
        genomes = torch.zeros((size, genome_len), device=device)
    else:
        raise ValueError(
            f"unknown population init {init!r}; have ['random', 'zeros']"
        )
    scores = torch.full((size,), -torch.inf, device=device)
    return Population(genomes=genomes, scores=scores)
