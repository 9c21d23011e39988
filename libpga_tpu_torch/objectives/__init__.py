"""Builtin objective registry of the port (names as in
``libpga_tpu.objectives``). Every objective is a rowwise callable
``(P, L) -> (P,)``, higher is better."""

from libpga_tpu_torch.objectives.classic import (
    ackley,
    make_tsp,
    make_tsp_coords,
    onemax,
    onemax_bits,
    random_tsp_coords,
    random_tsp_matrix,
    rastrigin,
    sphere,
)

_REGISTRY = {
    "onemax": onemax,
    "onemax_bits": onemax_bits,
    "sphere": sphere,
    "rastrigin": rastrigin,
    "ackley": ackley,
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
    "register", "get", "names",
    "onemax", "onemax_bits", "sphere", "rastrigin", "ackley",
    "make_tsp", "make_tsp_coords", "random_tsp_coords", "random_tsp_matrix",
]
