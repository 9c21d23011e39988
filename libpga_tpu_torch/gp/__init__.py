"""Tree-based genetic programming on the port.

Programs are postfix-encoded trees packed into ordinary fixed-width gene
vectors (``encoding.py``), bred by size-fair subtree crossover and
subtree/point mutation (``operators.py``), compacted before evaluation
(``optimize.py``), and scored by a stack machine: the CUDA kernel
``csrc/gp_eval.cu`` on the card, its plain versions (``interpreter.py``)
on the CPU, and the numpy oracle (``reference.py``) behind both. The
symbolic-regression objective (``sr.py``) ties them to ``PGA.run``.
"""

from libpga_tpu_torch.gp.encoding import (
    DISPATCH_KINDS,
    GPConfig,
    canonicalize,
    decode_expression,
    encode_program,
    is_well_formed,
    program_length,
    program_structure,
    random_population,
    random_program_genes,
)
from libpga_tpu_torch.gp.operators import (
    CROSSOVER_KINDS,
    MUTATE_KINDS,
    make_gp_mutate,
    make_gp_point_mutate,
    make_subtree_crossover,
    make_subtree_mutate,
)
from libpga_tpu_torch.gp.optimize import (
    EvalProgram,
    compaction_stats,
    live_lengths,
    mean_live_length,
    optimize_for_eval,
)
from libpga_tpu_torch.gp.reference import reference_predict, reference_scores
from libpga_tpu_torch.gp.sr import make_dataset, symbolic_regression

__all__ = [
    "CROSSOVER_KINDS",
    "DISPATCH_KINDS",
    "EvalProgram",
    "GPConfig",
    "MUTATE_KINDS",
    "canonicalize",
    "compaction_stats",
    "decode_expression",
    "encode_program",
    "is_well_formed",
    "live_lengths",
    "make_dataset",
    "make_gp_mutate",
    "make_gp_point_mutate",
    "make_subtree_crossover",
    "make_subtree_mutate",
    "mean_live_length",
    "optimize_for_eval",
    "program_length",
    "program_structure",
    "random_population",
    "random_program_genes",
    "reference_predict",
    "reference_scores",
    "symbolic_regression",
]
