"""Population container: the torch counterpart of
``libpga_tpu/population.py``. A population is one ``(size, genome_len)``
genome matrix (float32 or bfloat16) plus a ``(size,)`` float32 score
vector, on one device."""

from __future__ import annotations

import dataclasses

import torch

# The dtypes genomes are stored in (the JAX package's float32 and
# bfloat16). Scores are float32 whatever the genes are.
GENE_DTYPES = (torch.float32, torch.bfloat16)


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
    dtype=torch.float32,
) -> Population:
    """"random": uniform [0, 1) genes from ``generator``; "zeros": all
    zero; genes of ``dtype`` (float32 or bfloat16). bfloat16 genes are
    drawn on the grid ``jax.random.uniform(dtype=bfloat16)`` draws: its 7
    mantissa bits give the 128 values k/128, k = 0..127, each equally
    likely (``torch.rand`` rounded to bfloat16 would reach 1.0).
    ``genome_len >= 4`` is the reference's guard (its default mutation
    consumes three draws per genome)."""
    if genome_len < 4:
        raise ValueError("genome_len must be >= 4")
    if size < 1:
        raise ValueError("population size must be >= 1")
    if dtype not in GENE_DTYPES:
        raise ValueError(f"gene dtype {dtype} is not one of {GENE_DTYPES}")
    if init == "random" and dtype == torch.bfloat16:
        k = torch.randint(0, 128, (size, genome_len), generator=generator, device=device)
        genomes = (k.to(torch.float32) / 128.0).to(torch.bfloat16)
    elif init == "random":
        genomes = torch.rand(
            (size, genome_len), generator=generator, device=device,
            dtype=torch.float32,
        )
    elif init == "zeros":
        genomes = torch.zeros((size, genome_len), device=device, dtype=dtype)
    else:
        raise ValueError(
            f"unknown population init {init!r}; have ['random', 'zeros']"
        )
    scores = torch.full((size,), -torch.inf, device=device)
    return Population(genomes=genomes, scores=scores)
