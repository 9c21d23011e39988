"""Runtime configuration of the PyTorch port.

The subset of ``libpga_tpu.config.PGAConfig`` that ``PGA.run`` and
``PGA.run_islands`` read, plus the device the solver runs on. Field names
match the JAX package except ``deme_size``, ``generations_per_launch``,
``layout`` and ``subblock``, which drop the JAX package's ``pallas_`` prefix
(``deme_size``: rows per selection deme; on the GPU it fixes which rows
form a cohort, not a VMEM block), and ``use_deme_kernel``, its
``use_pallas``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from libpga_tpu_torch.ops.select import resolve_selection
from libpga_tpu_torch.population import GENE_DTYPES


@dataclasses.dataclass(frozen=True)
class PGAConfig:
    """Configuration for a port ``PGA`` solver.

    Attributes:
      tournament_size: candidates per tournament, >= 1. The deme
        kernels sample the winner in rank space for k in 1..16 (the JAX
        kernel's contractual cap); a larger k takes the panmictic path,
        as JAX's takes its XLA path.
      selection: "tournament", "truncation" or "linear_rank".
      selection_param: truncation tau or linear-rank pressure s; None
        takes the strategy's default.
      mutation_rate: probability a child receives a point mutation.
      elitism: top individuals carried unchanged into rows 0..e-1.
      max_populations: cap on populations per solver (the reference fixes
        10, ``pga.h:44``; ``pga_init`` without a config sets 10); None is
        unlimited.
      migration_topology: the migration ring of ``PGA.run_islands``:
        "ring" (island i sends to i + 1) or "random" (a ring over a random
        island order, drawn anew at every migration).
      deme_size: preferred rows per deme (power of two in [128, 1024]);
        None picks the JAX package's measured default, so both packages
        group the same rows into the same cohorts.
      generations_per_launch: generations bred per launch of the deme
        path (JAX's ``pallas_generations_per_launch``). None (default)
        or 1: the one-generation kernels. T > 1: the multi-generation
        kernel, where it admits the run (a rowwise-fused objective,
        uniform crossover, ``elitism < K // 4``); the target is then
        checked once per launch, elitism is per deme, and demes regroup
        only between launches. Where it declines, ``PGA.run`` warns and
        breeds one generation per launch.
      layout: row map of the deme kernels (JAX's ``pallas_layout``):
        None (default) picks ping-pong where its mixing gate admits,
        else the riffle; "riffle" or "pingpong" forces one ("pingpong"
        raises where inadmissible).
      subblock: ping-pong sub-block depth B (JAX's ``pallas_subblock``):
        None (default) or 1 keeps today's groups; B > 1 groups B
        sub-blocks of D demes, which moves children to other rows (the
        write interleave is per sub-block) and may change D, exactly as
        JAX resolves it. Where it resolves to B > 1, the builtin breed
        launches the pipelined deme kernel (a deme no cluster of blocks
        holds: the deme kernel at the same geometry). The riffle, order
        crossover and several generations per launch take B = 1. Below 1
        raises.
      gene_dtype: torch.float32 (default) or torch.bfloat16, the dtype
        genomes are stored in. bfloat16 genomes breed in the kernels' bf16
        cases: each child is computed in float32 and rounded once where it
        is stored, and scored as stored (scores stay float32). Order
        crossover at bfloat16 takes the panmictic path, as JAX's does.
      pop_shards: shards S of ``PGA.run``'s population (JAX's
        ``pop_shards``): 1 (default) is the unsharded run; S > 1 splits
        the population into S shards of P/S rows, stacked on the
        solver's device, that breed apart and exchange a comb of P/S²
        rows a generation (``parallel/shard_pop.py``). S² must divide
        the population size; below 1 raises.
      seed: base seed of the solver's ``torch.Generator``; None draws
        one from OS entropy.
      device: "cuda" (default) or "cpu". There is no automatic CPU
        fallback: a missing card is an error, not a slower run.
      use_deme_kernel: True (default) lets ``PGA.run`` take the fused
        deme path where its geometry admits the shape and no operator is
        set; False always takes the panmictic path. This is the JAX
        package's ``use_pallas`` (its None, "auto", is True here).
    """

    tournament_size: int = 2
    selection: str = "tournament"
    selection_param: Optional[float] = None
    mutation_rate: float = 0.01
    elitism: int = 0
    max_populations: Optional[int] = None
    migration_topology: str = "ring"
    deme_size: Optional[int] = None
    generations_per_launch: Optional[int] = None
    layout: Optional[str] = None
    subblock: Optional[int] = None
    gene_dtype: torch.dtype = torch.float32
    pop_shards: int = 1
    seed: Optional[int] = None
    device: str = "cuda"
    use_deme_kernel: bool = True

    def __post_init__(self):
        if self.tournament_size < 1:
            raise ValueError("tournament_size must be >= 1")
        resolve_selection(self.selection, self.selection_param)
        if not 0.0 <= self.mutation_rate <= 1.0:
            raise ValueError("mutation_rate must be in [0, 1]")
        if self.elitism < 0:
            raise ValueError("elitism must be >= 0")
        if self.migration_topology not in ("ring", "random"):
            raise ValueError("migration_topology must be 'ring' or 'random'")
        if self.generations_per_launch is not None and self.generations_per_launch < 1:
            raise ValueError("generations_per_launch must be >= 1")
        if self.layout not in (None, "riffle", "pingpong"):
            raise ValueError("layout must be None, 'riffle' or 'pingpong'")
        if self.subblock is not None and self.subblock < 1:
            raise ValueError("subblock must be >= 1")
        if self.pop_shards < 1:
            raise ValueError("pop_shards must be >= 1")
        if self.gene_dtype not in GENE_DTYPES:
            raise ValueError(
                f"gene_dtype {self.gene_dtype} is not supported: use torch.float32"
                " or torch.bfloat16"
            )
        if torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
