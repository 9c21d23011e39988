"""Mutation operators of the panmictic path (``libpga_tpu/ops/
mutate.py``: point ``:18-76``, gaussian ``:79-121``, swap ``:124-162``).
A mutation is ``(genome, rand) -> genome``; ``.batched`` is its whole-
population form and ``.rand_cols`` the uniform columns it reads per
individual (absent: L). ``.func`` names the operator's kind, which the
engine maps to the deme kernel's mutation (as the JAX engine does), and
``.rate`` / ``.sigma`` are its parameters."""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF


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


def point_mutate(genome: torch.Tensor, rand: torch.Tensor, rate: float = 0.01) -> torch.Tensor:
    """Point mutation of one ``(L,)`` genome."""
    return point_mutate_batched(genome[None, :], rand[None, :], rate)[0]


def make_point_mutate(rate: float = 0.01):
    """Point mutation at ``rate``, with ``.batched`` and ``.rand_cols = 3``."""

    def mut(genome, rand):
        return point_mutate(genome, rand, rate)

    mut.func = point_mutate
    mut.batched = lambda genomes, rand: point_mutate_batched(genomes, rand, rate)
    mut.rand_cols = 3
    mut.rate = rate
    return mut


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for uint32 values held in int64, in 16-bit
    halves of ``c`` so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def gaussian_mutate(
    genome: torch.Tensor, rand: torch.Tensor, rate: float = 0.1, sigma: float = 0.1
) -> torch.Tensor:
    """Per-gene Gaussian perturbation, elementwise on any shape: a gene
    fires when its ``rand`` is below ``rate`` and gets N(0, sigma^2)
    noise, clipped to [0, 1). The Box-Muller radius and angle come from
    integer bit mixing of the same uniform (the JAX operator's streams),
    so the operator reads one uniform per gene. ``sigma`` meets the
    genome as a value of its dtype, as JAX's weak-typed Python scalar
    does: on bfloat16 genes it is rounded to bfloat16 and the noise term
    is a bfloat16 product (torch would otherwise multiply by the float32
    ``sigma`` and round once, which differs from JAX in about 5% of the
    fired genes at sigma = 0.1)."""
    bits = (rand * float(2**24)).to(torch.int64)
    m1 = (_mul32(bits, 2654435761) + 0x9E3779B9) & _MASK32
    m2 = (_mul32(m1, 2246822519) + 0x85EBCA6B) & _MASK32
    u1 = (m1 & 0xFFFFFF).to(torch.float32) / float(2**24)
    u2 = (m2 & 0xFFFFFF).to(torch.float32) / float(2**24)
    u1 = torch.clamp(u1, 1e-7, 1.0 - 1e-7)
    normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    sigma = torch.tensor(sigma, dtype=genome.dtype, device=genome.device)
    out = torch.where(rand < rate, genome + sigma * normal.to(genome.dtype), genome)
    return torch.clamp(out, 0.0, 1.0 - 1e-7)


def make_gaussian_mutate(rate: float = 0.1, sigma: float = 0.1):
    """Gaussian mutation at ``rate`` and ``sigma``; elementwise, so its
    batched form is the same computation."""

    def mut(genome, rand):
        return gaussian_mutate(genome, rand, rate, sigma)

    mut.func = gaussian_mutate
    mut.batched = mut
    mut.rate = rate
    mut.sigma = sigma
    return mut


def swap_mutate_batched(
    genomes: torch.Tensor, rand: torch.Tensor, rate: float = 0.5
) -> torch.Tensor:
    """With probability ``rate`` (``rand[:, 2] < rate``) exchange the
    genes at ``floor(rand[:, 0] * L)`` and ``floor(rand[:, 1] * L)``
    (clamped to L - 1), for permutation GAs."""
    L = genomes.shape[1]
    i = torch.clamp(torch.floor(rand[:, 0] * L).to(torch.int64), 0, L - 1)
    j = torch.clamp(torch.floor(rand[:, 1] * L).to(torch.int64), 0, L - 1)
    fire = (rand[:, 2] < rate)[:, None]
    cols = torch.arange(L, device=genomes.device)[None, :]
    gi = torch.gather(genomes, 1, i[:, None])
    gj = torch.gather(genomes, 1, j[:, None])
    out = torch.where((cols == i[:, None]) & fire, gj, genomes)
    return torch.where((cols == j[:, None]) & fire, gi, out)


def swap_mutate(genome: torch.Tensor, rand: torch.Tensor, rate: float = 0.5) -> torch.Tensor:
    """Swap mutation of one ``(L,)`` genome."""
    return swap_mutate_batched(genome[None, :], rand[None, :], rate)[0]


def make_swap_mutate(rate: float = 0.5):
    """Swap mutation at ``rate``, with ``.batched`` and ``.rand_cols = 3``."""

    def mut(genome, rand):
        return swap_mutate(genome, rand, rate)

    mut.func = swap_mutate
    mut.batched = lambda genomes, rand: swap_mutate_batched(genomes, rand, rate)
    mut.rand_cols = 3
    mut.rate = rate
    return mut
