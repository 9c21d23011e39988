"""Classic GA objectives in rowwise form: ``(P, L) float32 -> (P,)``,
higher is better. Torch counterparts of the rowwise forms in
``libpga_tpu/objectives/classic.py``, with the same float32 constants
and operation order.

``fused_id`` marks the objectives the deme-breed kernel scores inside
the breed (``csrc/deme_breed.cu``: 1 = onemax, 2 = onemax_bits); the
others are scored by their rowwise form after an unfused breed.
"""

from __future__ import annotations

import math

import torch

FUSED_NONE, FUSED_ONEMAX, FUSED_ONEMAX_BITS = 0, 1, 2


def _objective(rows_fn, fused_id=FUSED_NONE):
    rows_fn.fused_id = fused_id
    return rows_fn


def _onemax(m: torch.Tensor) -> torch.Tensor:
    """Continuous OneMax: sum of genes. Optimum = genome_len."""
    return torch.sum(m, dim=1)


def _onemax_bits(m: torch.Tensor) -> torch.Tensor:
    """Bitstring OneMax: count of genes >= 0.5. Optimum = genome_len."""
    return torch.sum((m >= 0.5).to(torch.float32), dim=1)


def _to_box(m: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + m * (hi - lo)


def _sphere(m: torch.Tensor) -> torch.Tensor:
    """Negated sphere on [-5.12, 5.12]^L. Optimum 0."""
    x = _to_box(m, -5.12, 5.12)
    return -torch.sum(x * x, dim=1)


def _rastrigin(m: torch.Tensor) -> torch.Tensor:
    """Negated Rastrigin on [-5.12, 5.12]^L. Optimum 0."""
    x = _to_box(m, -5.12, 5.12)
    return -(
        10.0 * m.shape[1]
        + torch.sum(x * x - 10.0 * torch.cos(2.0 * math.pi * x), dim=1)
    )


def _ackley(m: torch.Tensor) -> torch.Tensor:
    """Negated Ackley on [-32.768, 32.768]^L. Optimum 0."""
    x = _to_box(m, -32.768, 32.768)
    n = m.shape[1]
    a, b, c = 20.0, 0.2, 2.0 * math.pi
    s1 = torch.sqrt(torch.sum(x * x, dim=1) / n)
    s2 = torch.sum(torch.cos(c * x), dim=1) / n
    return -(-a * torch.exp(-b * s1) - torch.exp(s2) + a + math.e)


onemax = _objective(_onemax, FUSED_ONEMAX)
onemax_bits = _objective(_onemax_bits, FUSED_ONEMAX_BITS)
sphere = _objective(_sphere)
rastrigin = _objective(_rastrigin)
ackley = _objective(_ackley)
