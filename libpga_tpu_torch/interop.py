"""Carry state across from the JAX package.

A GA has no weights: its state is its population (genomes and scores)
and, for GP, the encoding and the dataset. ``state_from_numpy`` takes
``np.asarray(pga.population(h).genomes)`` (and optionally the scores)
from a ``libpga_tpu`` solver and returns the port's
:class:`~libpga_tpu_torch.population.Population`, which
``PGA.install_population`` accepts; ``gp_config_from_fields`` rebuilds a
``GPConfig`` from any object with its fields; ``eval_program_from_numpy``
takes a compacted program as three arrays; ``pga_config_from_fields``
rebuilds a solver configuration under the port's field names;
``expression_objective_from_jax`` rebuilds an expression objective from
its source and constants. Only numpy and plain Python values cross the
boundary.
"""

from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch

from libpga_tpu_torch.config import PGAConfig
from libpga_tpu_torch.gp.encoding import GPConfig
from libpga_tpu_torch.gp.optimize import EvalProgram
from libpga_tpu_torch.objectives.expr import _CONSTANTS, _KEYWORDS, _tokenize, from_expression
from libpga_tpu_torch.population import GENE_DTYPES, Population

GP_FIELDS = (
    "max_nodes", "n_vars", "consts", "unary", "binary", "min_nodes",
    "stack_depth", "opcode_block", "optimize", "dispatch",
)

# The port's PGAConfig field <- the JAX package's.
PGA_FIELDS = {
    "tournament_size": "tournament_size",
    "selection": "selection",
    "selection_param": "selection_param",
    "mutation_rate": "mutation_rate",
    "elitism": "elitism",
    "max_populations": "max_populations",
    "migration_topology": "migration_topology",
    "seed": "seed",
    "deme_size": "pallas_deme_size",
    "generations_per_launch": "pallas_generations_per_launch",
    "layout": "pallas_layout",
    "subblock": "pallas_subblock",
}
# JAX fields carried under another form: use_pallas -> use_deme_kernel,
# gene_dtype by its name.
CONVERTED_FIELDS = ("use_pallas", "gene_dtype")
# JAX fields accepted whatever their value, and why.
ACCEPTED_FIELDS = {
    "donate_buffers": "no port meaning: the run loops breed into the other of two"
                      " buffers, so there is no buffer to donate",
    "fallback": "the port has no fallback path: a failed kernel build or launch always"
                " raises, which is JAX's 'raise'; JAX's default 'xla' degrade has no"
                " counterpart (a degrade policy belongs to ROADMAP Queue A item 3,"
                " robustness)",
}
# JAX fields the port lacks: (the values that mean "off", the ROADMAP item
# that ports them). Any other value raises NotImplementedError.
UNPORTED_FIELDS = {
    "pop_shards": ((1,), "ROADMAP Queue A item 6 (sharding)"),
    "telemetry": ((None,), "ROADMAP Queue A item 3 (run state: telemetry)"),
    "validate": ((False,), "ROADMAP Queue A item 3 (run state: validation)"),
}


def pga_config_from_fields(obj, device: str = "cuda") -> PGAConfig:
    """The port's :class:`PGAConfig` with the field values of ``obj``
    (for example the JAX package's ``PGAConfig``): ``pallas_deme_size``,
    ``pallas_generations_per_launch``, ``pallas_layout`` and
    ``pallas_subblock`` lose their prefix, ``use_pallas`` (None = auto)
    becomes ``use_deme_kernel`` (True unless False), and ``gene_dtype``
    maps by its name ("float32", "bfloat16"; float32 where ``obj`` has
    none). ``ACCEPTED_FIELDS`` are
    read past with the reason given there; a field of
    ``UNPORTED_FIELDS`` set to anything but "off" raises
    ``NotImplementedError`` naming the ROADMAP item that ports it."""
    for name, (off, item) in UNPORTED_FIELDS.items():
        value = getattr(obj, name, off[0])
        if not any(value is v or value == v for v in off):
            raise NotImplementedError(f"{name}={value!r} is not ported yet: {item}")
    kw = {ours: getattr(obj, theirs) for ours, theirs in PGA_FIELDS.items()}
    dt = getattr(obj, "gene_dtype", "float32")
    return PGAConfig(
        use_deme_kernel=getattr(obj, "use_pallas", None) is not False,
        gene_dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[
            getattr(dt, "__name__", str(dt))],
        device=device, **kw,
    )


def state_from_numpy(
    genomes: np.ndarray, scores: Optional[np.ndarray] = None, device="cuda",
    gene_dtype=torch.float32,
) -> Population:
    """``(size, genome_len)`` genomes as ``gene_dtype`` (torch.float32
    or torch.bfloat16) and ``(size,)`` scores (None: -inf,
    unevaluated) as float32, on ``device``. ``np.asarray`` of a JAX
    bfloat16 array widens exactly to float32, and the narrowing back to
    bfloat16 is exact too, so a bfloat16 population crosses unchanged."""
    if gene_dtype not in GENE_DTYPES:
        raise ValueError(f"gene_dtype {gene_dtype} is not one of {GENE_DTYPES}")
    g = np.asarray(genomes, dtype=np.float32)
    if g.ndim != 2:
        raise ValueError(f"genomes must be (size, genome_len); got {g.shape}")
    if scores is None:
        s = np.full(g.shape[0], -np.inf, np.float32)
    else:
        s = np.asarray(scores, dtype=np.float32)
        if s.shape != (g.shape[0],):
            raise ValueError(f"scores must be ({g.shape[0]},); got {s.shape}")
    return Population(
        genomes=torch.from_numpy(g.copy()).to(device, gene_dtype),
        scores=torch.from_numpy(s.copy()).to(device),
    )


def gp_config_from_fields(obj) -> GPConfig:
    """The port's :class:`GPConfig` with the field values of ``obj`` (for
    example the JAX package's ``GPConfig``)."""
    kw = {f: getattr(obj, f) for f in GP_FIELDS}
    for f in ("consts", "unary", "binary"):
        kw[f] = tuple(kw[f])
    return GPConfig(**kw)


def eval_program_from_numpy(ops, args, length, device="cuda") -> EvalProgram:
    """A compacted program from its three arrays: ``ops`` (P, T) int32
    over the extended table, ``args`` (P, T) float32, ``length`` (P,)."""
    return EvalProgram(
        ops=torch.from_numpy(np.array(ops, np.int32)).to(device),
        args=torch.from_numpy(np.array(args, np.float32)).to(device),
        length=torch.from_numpy(np.array(length, np.int32)).to(device),
    )


def expression_objective_from_jax(fn):
    """The port's ``from_expression`` objective for a JAX
    ``from_expression`` objective ``fn``: its ``.expression`` and its
    ``kernel_rowwise_consts``, which hold the referenced constants in
    sorted name order, each ``atleast_2d``. The names are the
    expression's names that are neither builtins nor ``name = ...``
    bindings; a constant is restored to its registered rank (a scalar,
    a vector, or an (n, L) table) from its shape and, for a (1, n)
    ``gather`` table, from the registered kind JAX's rowwise form keeps
    (``table_kinds``)."""
    toks = _tokenize(fn.expression)
    bound = {toks[k][1] for k in range(len(toks) - 1)
             if toks[k][0] == "name" and toks[k + 1][1] == "="}
    names = sorted({t for kind, t, _ in toks if kind == "name"}
                   - set(_KEYWORDS) - set(_CONSTANTS) - bound)
    arrays = [np.asarray(c, np.float32) for c in fn.kernel_rowwise_consts]
    if len(names) != len(arrays):
        raise ValueError(
            f"{fn.expression!r} names constants {names} but carries {len(arrays)}"
        )
    closure = inspect.getclosurevars(fn.kernel_rowwise).nonlocals
    kinds = closure.get("table_kinds", {})
    consts = {}
    for name, a in zip(names, arrays):
        if a.shape == (1, 1):
            consts[name] = a.reshape(())
        elif a.shape[0] == 1 and kinds.get(name) != "per_locus":
            consts[name] = a.reshape(-1)
        else:
            consts[name] = a
    return from_expression(fn.expression, **consts)
