"""Symbolic-regression objective family (the torch counterpart of
``libpga_tpu/gp/sr.py``).

``symbolic_regression(X, y, gp=...)`` returns a per-genome callable
whose whole-population ``.rows`` form the engine's ``evaluate`` calls
(``ops/evaluate.py``), scoring ``-RMSE`` of each genome's program over
the ``(B, n_vars)`` / ``(B,)`` dataset (higher is better; non-finite
scores read ``-inf``). Evaluation goes through ``ops/gp_eval.make_gp_eval``:
the CUDA kernel for tensors on the card, its plain version for tensors on
the CPU. A kernel build or launch failure raises; there is no fallback.

Evaluator knobs resolve as explicit argument, else the built-in
default. (The JAX package also consults an installed tuning database
between the two; the port has none yet.)
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from libpga_tpu_torch.gp.encoding import GPConfig
from libpga_tpu_torch.gp.interpreter import samples, with_parsimony
from libpga_tpu_torch.gp.optimize import optimize_for_eval
from libpga_tpu_torch.ops.gp_eval import make_gp_eval


def symbolic_regression(
    X,
    y,
    *,
    gp: Optional[GPConfig] = None,
    stack_depth: Optional[int] = None,
    opcode_block: Optional[int] = None,
    dispatch: Optional[str] = None,
    parsimony: float = 0.0,
) -> Callable:
    """A symbolic-regression objective over an ``(B, n_vars)`` dataset.

    With ``gp.optimize`` (the default) and no parsimony the objective
    carries the ``prepare_eval`` hook: the engine compacts the
    population once per generation and ``rows`` scores the
    ``EvalProgram`` through the kernel's compacted mode. ``parsimony``
    subtracts that many score units per non-pad token of the stored
    genome: the kernel scores the raw genomes with static trips, and the
    penalty is taken off its score (a non-finite score stays ``-inf``)."""
    gp = gp or GPConfig()
    xt, ya = samples(X, y, gp.n_vars)
    Xa = np.ascontiguousarray(xt.T)
    pfloat = float(parsimony)
    opt_on = bool(gp.optimize) and pfloat == 0.0
    # make_gp_eval checks the knobs now, not at the first evaluation.
    evaluator = make_gp_eval(
        gp, Xa, ya, optimize=opt_on,
        stack_depth=stack_depth, opcode_block=opcode_block, dispatch=dispatch,
    )

    rows = with_parsimony(evaluator, gp, pfloat)

    def per_genome(genome):
        return rows(genome[None, :])[0]

    per_genome.rows = rows
    per_genome.gp_config = gp
    per_genome.parsimony = pfloat
    if opt_on:
        def prepare_eval(genomes):
            """Compact the population for evaluation; the stored genomes
            are untouched."""
            return optimize_for_eval(genomes, gp)

        per_genome.prepare_eval = prepare_eval
    per_genome.__doc__ = (
        f"Symbolic-regression objective ({Xa.shape[0]} samples, "
        f"{gp.n_vars} vars, {gp.max_nodes}-token programs): -RMSE."
    )
    return per_genome


def make_dataset(
    fn: Callable,
    n_samples: int = 64,
    n_vars: int = 1,
    lo: float = -1.0,
    hi: float = 1.0,
    seed: int = 0,
):
    """Sample ``(X, y)`` from a ground-truth function at uniform random
    points (numpy, so both packages get the same dataset)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(lo, hi, size=(n_samples, n_vars)).astype(np.float32)
    y = np.asarray(fn(*[X[:, v] for v in range(n_vars)]), np.float32).reshape(-1)
    return X, y
