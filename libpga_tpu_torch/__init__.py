"""libpga_tpu_torch: the PyTorch / CUDA port of libpga_tpu for one
NVIDIA H100.

``PGA.run`` on float32 or bfloat16 genomes
(``PGAConfig(gene_dtype=...)``) launches one hand-written CUDA kernel per
generation (``csrc/deme_breed.cu``: uniform crossover, or order
crossover with the fused TSP score; with
``PGAConfig(generations_per_launch=T)`` one launch of the
multi-generation kernel per T generations; with an expression
crossover, mutation or objective, one launch of the expression breed,
``csrc/expr_breed.cu`` with hooks generated from the expressions), or
takes the panmictic path (whole-population selection and operators in
torch) for small populations and operators without a kernel form.
``PGA.run_islands`` evolves every population as an island with
migration (``parallel/islands.py``): on the deme path one launch of the
same kernels breeds every island, the islands a second grid axis. The
kernels have bfloat16 cases (order crossover excepted, as in JAX): each
child is bred in float32 and rounded once where it is stored. GP symbolic regression (``libpga_tpu_torch.gp``) runs on
the panmictic path and scores every generation with one launch of the
stack-machine kernel ``csrc/gp_eval.cu``. The JAX package ``libpga_tpu``
stays the reference; nothing here imports it or JAX.
"""

from libpga_tpu_torch.api import (
    pga_create_population,
    pga_deinit,
    pga_get_best,
    pga_get_best_all,
    pga_get_best_top,
    pga_get_best_top_all,
    pga_init,
    pga_migrate,
    pga_migrate_between,
    pga_run,
    pga_run_islands,
    pga_set_crossover_function,
    pga_set_mutate_function,
    pga_set_objective_function,
)
from libpga_tpu_torch.config import PGAConfig
from libpga_tpu_torch.engine import PGA, PopulationHandle
from libpga_tpu_torch.objectives import (
    ExpressionError,
    default_knapsack,
    from_expression,
    make_deceptive_trap,
    make_knapsack,
    make_nk_landscape,
)
from libpga_tpu_torch.ops.breed_expr import crossover_from_expression, mutate_from_expression
from libpga_tpu_torch.population import Population

__all__ = [
    "ExpressionError",
    "PGA",
    "PGAConfig",
    "Population",
    "PopulationHandle",
    "crossover_from_expression",
    "default_knapsack",
    "from_expression",
    "make_deceptive_trap",
    "make_knapsack",
    "make_nk_landscape",
    "mutate_from_expression",
    "pga_create_population",
    "pga_deinit",
    "pga_get_best",
    "pga_get_best_all",
    "pga_get_best_top",
    "pga_get_best_top_all",
    "pga_init",
    "pga_migrate",
    "pga_migrate_between",
    "pga_run",
    "pga_run_islands",
    "pga_set_crossover_function",
    "pga_set_mutate_function",
    "pga_set_objective_function",
]
