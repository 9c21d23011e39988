"""Mutation operators of the panmictic path (the default of
``libpga_tpu/ops/mutate.py:18-76``). A mutation is ``(genome, rand) ->
genome``; ``.batched`` is its whole-population form and ``.rand_cols``
the uniform columns it reads per individual."""

from __future__ import annotations

import torch


def point_mutate_batched(
    genomes: torch.Tensor, rand: torch.Tensor, rate: float = 0.01
) -> torch.Tensor:
    """With probability ``rate`` (``rand[:, 1] < rate``) set the gene at
    ``floor(rand[:, 0] * L)`` to ``rand[:, 2]``."""
    L = genomes.shape[1]
    pos = torch.clamp(torch.floor(rand[:, 0] * L).to(torch.int32), 0, L - 1)
    fire = rand[:, 1] < rate
    cols = torch.arange(L, dtype=torch.int32, device=genomes.device)[None, :]
    hit = (cols == pos[:, None]) & fire[:, None]
    return torch.where(hit, rand[:, 2:3].to(genomes.dtype), genomes)


def make_point_mutate(rate: float = 0.01):
    """Point mutation at ``rate``, with ``.batched`` and ``.rand_cols = 3``."""

    def batched(genomes, rand):
        return point_mutate_batched(genomes, rand, rate)

    def mut(genome, rand):
        return batched(genome[None, :], rand[None, :])[0]

    mut.batched = batched
    mut.rand_cols = 3
    mut.rate = rate
    return mut
