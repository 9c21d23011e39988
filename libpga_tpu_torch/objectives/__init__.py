"""Builtin objective registry of the port (names as in
``libpga_tpu.objectives``). Every objective is a rowwise callable
``(P, L) -> (P,)``, higher is better."""

from libpga_tpu_torch.objectives.classic import (
    ackley,
    default_knapsack,
    make_deceptive_trap,
    make_knapsack,
    make_nk_landscape,
    make_tsp,
    make_tsp_coords,
    onemax,
    onemax_bits,
    random_tsp_coords,
    random_tsp_matrix,
    rastrigin,
    sphere,
)
from libpga_tpu_torch.objectives.expr import ExpressionError, from_expression

_REGISTRY = {
    "onemax": onemax,
    "onemax_bits": onemax_bits,
    "sphere": sphere,
    "rastrigin": rastrigin,
    "ackley": ackley,
    "knapsack": default_knapsack,
}


def register(name: str, fn):
    """Register a rowwise objective under ``name``."""
    _REGISTRY[name] = fn
    return fn


def get(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown objective {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names():
    return sorted(_REGISTRY)


__all__ = [
    "register", "get", "names", "from_expression", "ExpressionError",
    "onemax", "onemax_bits", "sphere", "rastrigin", "ackley",
    "make_knapsack", "default_knapsack", "make_nk_landscape", "make_deceptive_trap",
    "make_tsp", "make_tsp_coords", "random_tsp_coords", "random_tsp_matrix",
]
