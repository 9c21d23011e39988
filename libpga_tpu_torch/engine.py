"""The solver: the subset of ``libpga_tpu.engine.PGA`` that drives
``PGA.run``.

``run`` takes one of two loops, routed by operator kind as the JAX
package's ``_pallas_gate`` routes them (``engine.py:855-984``):

- the fused deme path (``ops/fused_step.py``): every generation is one
  launch of a breed kernel on the card (uniform crossover: the
  deme-breed kernel; order crossover: the order-breed kernel, which also
  scores the coordinate TSP), or its plain version when the solver's
  device is the CPU. With ``PGAConfig.generations_per_launch`` = T > 1
  one launch of the multi-generation kernel breeds up to T generations
  (``make_multigen_run``); where that declines, the run warns and
  breeds one generation per launch, as ``make_pallas_run`` does. It
  runs when both operators have a kernel kind:
  crossover ``uniform`` (none set, or ``uniform_crossover``), ``order``
  (``order_preserving_crossover``) or an expression operator
  (``crossover_from_expression``; ``one_point_crossover`` and
  ``arithmetic_crossover`` map to the cached expression equivalents of
  JAX's ``_CROSSOVER_EXPRS``); mutation ``point`` (none set: point at
  ``config.mutation_rate``), ``gaussian`` or ``swap`` (``make_*_mutate``,
  told apart by ``.func``) or an expression operator
  (``mutate_from_expression``), with their rate and sigma as the
  kernel's runtime parameters. An expression operator, or an objective
  with an expression form (``expr_fused``), runs the generated
  expression breed kernel (at T > 1 its multi-generation entry), order
  crossover included: a TSP written as a ``from_expression`` tour cost
  breeds in the expression order kernel, and the coordinate TSP with an
  expression mutation too. At T > 1 order crossover breeds in the
  multi-generation kernels with a rowwise-fused or expression objective;
  the coordinate TSP, whose fused score is gene-major, warns and breeds
  one generation per launch, as in JAX;
- the panmictic path (:func:`make_run_loop`, ``ops/step.py``): whole-
  population selection, then the crossover and mutation operators in
  plain torch, then the objective (for GP, the evaluator kernel). It
  runs when an operator has no kernel kind (the GP operators), when
  ``PGAConfig.use_deme_kernel`` is False (JAX's ``use_pallas=False``),
  or when the deme geometry declines the shape (under 128 rows, only
  degenerate padded fits, an order walk too long for any deme, or a
  tournament of more than 16). An operator without a kernel kind on a
  card warns once per cause, as JAX's ``_warn_xla_fallback`` does; the
  GP operators (``xla_only``) stay quiet.

``PGAConfig.pop_shards`` = S > 1 (JAX's ``_run_sharded``) splits
``run``'s population into S shards of P/S rows, stacked on the solver's
device, under the sharded loop of ``parallel/shard_pop.py`` (local
breed, comb mix, re-scoring, global elitism, rank-threshold sketch).
The shards breed in one launch of the island breed at elitism 0 where
JAX takes its fused per-shard kernel: the objective has a rowwise fused
or expression form, both operators have a kernel kind, the shard
geometry needs no pad rows and the genome length is a multiple of 128
(JAX's exact fit, :meth:`PGA.sharded_kernel_route`). Every other shape
breeds each shard with the panmictic breed and launches nothing.

``run_islands`` evolves every population as an island, migrating the
top ``pct`` every ``m`` generations (``parallel/islands.py``). Equal
islands routed to the deme path breed in one launch per generation for
all islands, with builtin or expression hooks (the islands are the
kernel's second grid axis; at ``generations_per_launch`` = T > 1,
ceil(m / T) launches per epoch); islands without a kernel kind, or
under 128 rows, take the panmictic epoch.
Unequal populations run epoch by epoch through ``run`` and ``migrate``.

Genomes are stored in ``PGAConfig.gene_dtype``, float32 or bfloat16. A
bfloat16 run launches the bf16 cases of the deme, multi-generation and
expression kernels (each child bred in float32, rounded once where it is
stored, scored as stored); order crossover at bfloat16 takes the
panmictic path, as JAX's gate declines it. Best genomes come back as
float32 numpy arrays holding the stored values.

``PGAConfig.subblock`` = B > 1 (JAX's ``pallas_subblock``) widens a
ping-pong group to B sub-blocks of D demes: ``run`` and ``run_islands``
then breed through the pipelined deme kernel (builtin hooks; the deme
kernel where no cluster of blocks holds a deme) or the
expression kernel with the B-aware row maps; the riffle, order
crossover and several generations per launch take B = 1, as in JAX.

There is no fallback between device and CPU: the device is the
config's, and a missing card is an error.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import warnings
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from libpga_tpu_torch.config import PGAConfig
from libpga_tpu_torch.objectives.classic import ROWWISE_FUSED
from libpga_tpu_torch.ops import mutate as _mutate_ops
from libpga_tpu_torch.ops.breed_expr import crossover_from_expression
from libpga_tpu_torch.ops.crossover import (
    arithmetic_crossover,
    one_point_crossover,
    order_preserving_crossover,
    uniform_crossover,
)
from libpga_tpu_torch.ops.evaluate import evaluate
from libpga_tpu_torch.ops.fused_step import (
    is_expression,
    make_fused_run,
    make_island_breed,
    make_island_multigen,
    make_multigen_run,
    resolve_geometry,
)
from libpga_tpu_torch.ops.mutate import make_point_mutate
from libpga_tpu_torch.ops.step import make_breed, run_generations
from libpga_tpu_torch.ops.topk import best_genome, top_k_genomes
from libpga_tpu_torch.parallel import shard_pop
from libpga_tpu_torch.parallel.islands import immigrate, run_islands_stacked
from libpga_tpu_torch.population import Population, create_population


def make_run_loop(obj: Callable, breed: Callable) -> Callable:
    """The panmictic run loop (``libpga_tpu/engine.py:191-207``): score
    generation 0, then breed and score, stopping at the first generation
    whose best reaches the target or is NaN. Returns ``run(genomes, n,
    target, generator) -> (genomes, scores, gens)``."""

    def run(genomes, n, target, generator):
        def step(g, s, gen):
            g2 = breed(g, s, generator)
            return g2, evaluate(obj, g2)

        return run_generations(step, genomes, evaluate(obj, genomes), n, target)

    return run


@dataclasses.dataclass(frozen=True)
class PopulationHandle:
    """Opaque handle to a population owned by a :class:`PGA`."""

    index: int


class PGA:
    """A genetic-algorithm solver on one device.

    Example::

        pga = PGA(seed=0)
        pop = pga.create_population(40_000, 100)
        pga.set_objective("onemax")
        pga.run(100)
        best = pga.get_best(pop)

    ``launches`` counts the breed launches of the runs this solver
    returned: on the deme path one per generation, or one per
    ``generations_per_launch`` generations (the last launch of a run
    may breed fewer); a sharded run's kernel route one per generation
    for all shards; an island run one per generation for all islands,
    or ceil(m / T) per epoch; the panmictic path launches none.
    """

    def __init__(self, seed: Optional[int] = None, config: Optional[PGAConfig] = None):
        self.config = config or PGAConfig()
        if seed is None:
            seed = self.config.seed
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PGAConfig.device is 'cuda' but no CUDA device is available;"
                " pass PGAConfig(device='cpu') to run the plain version"
            )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._populations: list = []
        self._objective: Optional[Callable] = None
        self._crossover: Optional[Callable] = None
        self._mutate: Optional[Callable] = None
        # shape -> (run function, generations per launch; 0 = panmictic)
        self._runs: Dict[Tuple[int, int], Tuple[Callable, int]] = {}
        self._compiled: Dict[str, Callable] = {}  # cached expression equivalents
        self._islands: dict = {}  # island breeds and runners
        self.launches = 0

    # ----------------------------------------------------------- populations

    def create_population(
        self, size: int, genome_len: int, init: str = "random"
    ) -> PopulationHandle:
        """Uniform [0, 1) genomes of the config's gene dtype from the
        solver's generator."""
        self._check_population_cap()
        pop = create_population(
            self.generator, size, genome_len, init=init, device=self.device,
            dtype=self.config.gene_dtype,
        )
        self._populations.append(pop)
        return PopulationHandle(len(self._populations) - 1)

    def install_population(
        self, genomes: Union[Population, torch.Tensor, np.ndarray]
    ) -> PopulationHandle:
        """Install an explicit population: a :class:`Population` (e.g.
        from ``interop.state_from_numpy``) or a ``(size, genome_len)``
        matrix, whose scores read -inf until the first run. The genes are
        stored in the config's gene dtype (rounded to nearest where that
        is bfloat16 and they are not)."""
        if isinstance(genomes, Population):
            g, s = genomes.genomes, genomes.scores
        else:
            g = (
                genomes if isinstance(genomes, torch.Tensor)
                else torch.tensor(np.asarray(genomes), dtype=torch.float32)
            )
            s = torch.full((g.shape[0],), -torch.inf)
        if g.ndim != 2:
            raise ValueError(
                "install_population needs a (size, genome_len) matrix;"
                f" got shape {tuple(g.shape)}"
            )
        g = g.to(self.device, self.config.gene_dtype).contiguous()
        s = s.to(self.device, torch.float32).contiguous()
        self._check_population_cap()
        self._populations.append(Population(genomes=g, scores=s))
        return PopulationHandle(len(self._populations) - 1)

    def _check_population_cap(self) -> None:
        limit = self.config.max_populations
        if limit is not None and len(self._populations) >= limit:
            raise RuntimeError(f"max_populations={limit} reached")

    def population(self, handle: PopulationHandle) -> Population:
        return self._populations[handle.index]

    def _handles(self) -> list:
        return [PopulationHandle(i) for i in range(len(self._populations))]

    def _forget_runs(self) -> None:
        """Drop the runs, island breeds and runners built for the previous
        objective or operators."""
        self._runs.clear()
        self._islands.clear()

    # ------------------------------------------------------------- objective

    def set_objective(self, fn: Union[str, Callable]) -> None:
        """A rowwise callable ``(P, L) -> (P,)`` (higher is better) or
        the name of a builtin from :mod:`libpga_tpu_torch.objectives`."""
        if isinstance(fn, str):
            from libpga_tpu_torch import objectives

            fn = objectives.get(fn)
        self._objective = fn
        self._forget_runs()

    def set_crossover(self, fn: Optional[Callable]) -> None:
        """Crossover ``(p1, p2, rand) -> child`` with ``.batched`` and
        ``.rand_cols`` (e.g. ``order_preserving_crossover`` or
        ``gp.make_subtree_crossover``); None restores the default uniform
        crossover. A builtin kind or an expression operator
        (``crossover_from_expression``, and ``one_point_crossover`` /
        ``arithmetic_crossover`` through their expression equivalents)
        keeps ``run`` on the deme path; any other operator routes it to
        the panmictic path."""
        self._crossover = fn
        self._forget_runs()

    def set_mutate(self, fn: Optional[Callable]) -> None:
        """Mutation ``(genome, rand) -> genome`` with ``.batched`` and
        ``.rand_cols`` (e.g. ``make_swap_mutate(0.5)`` or
        ``gp.make_gp_mutate``); None restores the default point mutation
        at ``config.mutation_rate``. A builtin kind or an expression
        operator (``mutate_from_expression``) keeps ``run`` on the deme
        path; any other operator routes it to the panmictic path."""
        self._mutate = fn
        self._forget_runs()

    # The deme path's expression equivalents of the builtin crossovers
    # without a kernel kind (JAX's ``_CROSSOVER_EXPRS``, the same source
    # strings): one-point draws its cut from the per-row stream q (the
    # builtin from rand[0]: another stream, the same distribution);
    # arithmetic blends with a per-gene uniform weight.
    CROSSOVER_EXPRS = {
        "one_point": "where(i < floor(q * L), p1, p2)",
        "arithmetic": "r * p1 + (1 - r) * p2",
    }

    def _crossover_expr_equivalent(self, name: str) -> Callable:
        if name not in self._compiled:
            self._compiled[name] = crossover_from_expression(self.CROSSOVER_EXPRS[name])
        return self._compiled[name]

    def _crossover_kind(self):
        """The deme kernels' crossover kind of the active operator:
        "uniform", "order", an expression operator (itself, or for
        ``one_point_crossover`` / ``arithmetic_crossover`` the cached
        expression equivalent), or None for one without a kernel form."""
        if self._crossover is None or self._crossover is uniform_crossover:
            return "uniform"
        if self._crossover is order_preserving_crossover:
            return "order"
        if self._crossover is one_point_crossover:
            return self._crossover_expr_equivalent("one_point")
        if self._crossover is arithmetic_crossover:
            return self._crossover_expr_equivalent("arithmetic")
        if is_expression(self._crossover):
            return self._crossover
        return None

    def _mutate_kind(self):
        """The deme kernels' mutation kind of the active operator
        ("point", "gaussian" or "swap", by its ``.func``; an expression
        operator is itself), or None."""
        if self._mutate is None:
            return "point"
        if is_expression(self._mutate):
            return self._mutate
        return {
            _mutate_ops.point_mutate: "point",
            _mutate_ops.gaussian_mutate: "gaussian",
            _mutate_ops.swap_mutate: "swap",
        }.get(getattr(self._mutate, "func", None))

    def _operator_param(self, name: str, default: float) -> float:
        """A parameter of the active mutation: its attribute, else a
        ``functools.partial``'s keyword, else its function's default,
        else ``default``."""
        v = getattr(self._mutate, name, None)
        if v is None:
            v = (getattr(self._mutate, "keywords", None) or {}).get(name)
        if v is None:
            func = getattr(self._mutate, "func", None)
            param = inspect.signature(func).parameters.get(name) if func else None
            if param is not None and param.default is not inspect.Parameter.empty:
                v = param.default
        return default if v is None else v

    def _mutate_params(self) -> Tuple[float, float]:
        """The mutation's [rate, sigma], the deme kernels' runtime
        parameters: gaussian defaults 0.1 / 0.1; an expression operator
        its ``.rate`` (the config's when none is set) and ``.sigma``
        (default 0); otherwise the operator's rate (the config's when
        none is set) and sigma 0."""
        kind = self._mutate_kind()
        if kind == "gaussian":
            return (self._operator_param("rate", 0.1), self._operator_param("sigma", 0.1))
        if is_expression(kind):
            return (self._operator_param("rate", self.config.mutation_rate),
                    self._operator_param("sigma", 0.0))
        return (self._operator_param("rate", self.config.mutation_rate), 0.0)

    def _require_objective(self) -> Callable:
        if self._objective is None:
            raise RuntimeError(
                "no objective set — call set_objective() before run()"
            )
        return self._objective

    # ------------------------------------------------------------------- run

    def uses_deme_kernel(self, size: int, genome_len: int) -> bool:
        """Whether ``run`` takes the deme path for this shape (else the
        panmictic path; see the module docstring)."""
        return (
            self._crossover_kind() is not None and self._mutate_kind() is not None
            and self.config.use_deme_kernel
            and self._deme_geometry(size, genome_len) is not None
        )

    def _deme_geometry(self, size: int, genome_len: int):
        """The deme geometry of a shape under the config and operators,
        or None where the deme path declines it."""
        c = self.config
        expr_obj = getattr(self._objective, "expr_fused", None)
        return resolve_geometry(
            size, genome_len, deme_size=c.deme_size,
            tournament_size=c.tournament_size, selection=c.selection,
            selection_param=c.selection_param, crossover=self._crossover_kind() or "uniform",
            const_carrying=bool(getattr(expr_obj, "kernel_rowwise_consts", ())),
            gene_dtype=c.gene_dtype, subblock=c.subblock,
        )

    def _deme_backend_ok(self) -> bool:
        """Whether the deme kernels can run: the solver's device is a
        card (JAX's ``_pallas_backend_ok``, a real TPU)."""
        return self.device.type == "cuda"

    def _warn_panmictic_fallback(self) -> None:
        """JAX's ``_warn_xla_fallback``: where the deme kernels could run
        (``use_deme_kernel`` on, a card) but the crossover or mutation
        has no kernel kind, say that the run takes the panmictic path.
        The GP operators (``xla_only``) have no kernel form by design and
        stay quiet. One warning per distinct cause (Python's default
        filter shows a message once per call site)."""
        if not (self.config.use_deme_kernel and self._deme_backend_ok()):
            return
        missing = [
            name
            for name, kind, op in (
                ("crossover", self._crossover_kind(), self._crossover),
                ("mutation", self._mutate_kind(), self._mutate),
            )
            if kind is None and not getattr(op, "xla_only", False)
        ]
        if missing:
            warnings.warn(
                f"custom {' and '.join(missing)} operator(s) have no in-kernel form"
                " — this run falls back to the panmictic operator path. Use a"
                " builtin operator, or compile the operator with"
                " ops.breed_expr.crossover_from_expression / mutate_from_expression"
                " to keep the fused deme path.",
                stacklevel=4,
            )

    def _deme_kw(self) -> dict:
        """The deme breeds' keywords from the config and the operators."""
        c = self.config
        return dict(
            deme_size=c.deme_size, tournament_size=c.tournament_size,
            selection=c.selection, selection_param=c.selection_param,
            crossover=self._crossover_kind(), mutate=self._mutate_kind(),
            mparams=self._mutate_params(), layout=c.layout, device=self.device,
            gene_dtype=c.gene_dtype, subblock=c.subblock,
        )

    def _panmictic_breed(self, elitism: Optional[int] = None) -> Callable:
        """``ops/step.make_breed`` of the active operators (uniform
        crossover and point mutation where none is set), carrying
        ``elitism`` elites (the config's where None)."""
        c = self.config
        return make_breed(
            self._crossover or uniform_crossover,
            self._mutate or make_point_mutate(c.mutation_rate),
            tournament_size=c.tournament_size,
            selection_kind=c.selection,
            selection_param=c.selection_param,
            elitism=c.elitism if elitism is None else elitism,
        )

    def _run_fn(self, size: int, genome_len: int) -> Tuple[Callable, int]:
        """The run function of a shape and its generations per launch
        (0 on the panmictic path)."""
        key = (size, genome_len)
        if key not in self._runs:
            c = self.config
            obj = self._require_objective()
            if self.uses_deme_kernel(size, genome_len):
                kw = dict(self._deme_kw(), elitism=c.elitism)
                per_launch = c.generations_per_launch or 1
                fn = None
                if per_launch > 1:
                    fn = make_multigen_run(size, genome_len, obj, per_launch, **kw)
                    if fn is None:
                        warnings.warn(
                            f"generations_per_launch={per_launch} requested but the"
                            " multi-generation kernel declined (objective without a"
                            " rowwise fused or expression form, elitism too large for the deme, or"
                            " no geometry): breeding one generation per launch",
                            stacklevel=3,
                        )
                        per_launch = 1
                if fn is None:
                    fn = make_fused_run(size, genome_len, obj, **kw)
            else:
                per_launch = 0
                self._warn_panmictic_fallback()
                fn = make_run_loop(obj, self._panmictic_breed())
            self._runs[key] = (fn, per_launch)
        return self._runs[key]

    def _check_elitism(self, size: int) -> None:
        """Elites are the top ``elitism`` rows of a population, so a run
        of ``size`` rows takes at most ``size`` of them (JAX's
        ``lax.top_k`` raises past that; ``elitism == size`` copies the
        population unchanged in both packages)."""
        if self.config.elitism > size:
            raise ValueError(
                f"elitism {self.config.elitism} exceeds the population size {size}"
            )

    # ------------------------------------------------------ sharded population

    def sharded_kernel_route(self, shard_size: int, genome_len: int) -> bool:
        """Whether a sharded run breeds its shards in the kernel (JAX's
        ``_sharded_local_step``, ``engine.py:1381-1465``): the deme path
        takes the shard shape, the objective has a rowwise fused or an
        expression form (JAX's ``kernel_rowwise``), and the geometry is
        an exact fit: no pad rows and ``genome_len % 128 == 0`` (JAX
        needs ``Pp == P/S`` and ``Lp == L``, and pads L to 128 lanes)."""
        obj = self._require_objective()
        return (
            (getattr(obj, "fused_id", None) in ROWWISE_FUSED
             or getattr(obj, "expr_fused", None) is not None)
            and genome_len % 128 == 0
            and self.uses_deme_kernel(shard_size, genome_len)
            and self._deme_geometry(shard_size, genome_len).Pp == shard_size
        )

    def _sharded_local_step(self, shard_size: int, genome_len: int) -> Tuple[Callable, int]:
        """The step that breeds every shard of a sharded run at once,
        ``(g (S, Ps, L), s (S, Ps), gen, generator) -> (g2, s2 | None)``,
        without elites (the loop applies global elitism), and its
        launches per generation. On the kernel route
        (:meth:`sharded_kernel_route`) one launch of the island breed
        over the S shards, its parity on ``gen & 1`` where the geometry
        is ping-pong (``step.breed`` is that breed, and its launches
        count as island launches in ``kernels.LAUNCHES``). Elsewhere the
        panmictic breed, shard by shard, and no launch."""
        S = self.config.pop_shards
        if self.sharded_kernel_route(shard_size, genome_len):
            breed = make_island_breed(shard_size, genome_len, self._objective, S,
                                      elitism=0, **self._deme_kw())

            def step(g, s, gen, generator):
                return breed(g, s, gen % breed.geom.parities, generator)

            step.breed = breed
            return step, 1
        breed0 = self._panmictic_breed(elitism=0)

        def step(g, s, gen, generator):
            return torch.stack([breed0(g[i], s[i], generator) for i in range(S)]), None

        return step, 0

    def _sharded_run(self, size: int, genome_len: int) -> Tuple[Callable, int]:
        """The sharded run loop of a shape (``shard_pop.make_sharded_run``
        over :meth:`_sharded_local_step`) and its launches per generation
        (1 on the kernel route, else 0), cached like :meth:`_run_fn`
        until the objective or an operator changes. An inadmissible
        shard count, or more elites than a shard's rows, raises
        ValueError before anything is built."""
        S = self.config.pop_shards
        key = ("shards", S, size, genome_len)
        if key not in self._runs:
            shard_pop.check_run(size, S, self.config.elitism)
            step, per_gen = self._sharded_local_step(size // S, genome_len)
            if not per_gen:
                self._warn_panmictic_fallback()
            fn = shard_pop.make_sharded_run(
                self._objective, step, size, genome_len, S, elitism=self.config.elitism)
            self._runs[key] = (fn, per_gen)
        return self._runs[key]

    def run(
        self,
        n: int,
        target: Optional[float] = None,
        population: Optional[PopulationHandle] = None,
    ) -> int:
        """Run up to ``n`` generations on the first population (or
        ``population``). Stops at the first generation whose best score
        reaches ``target`` or is NaN; that generation is the one kept.
        Returns the number of generations run: without a target exactly
        ``n``. With ``config.generations_per_launch`` = T > 1 the target
        is checked once per launch, so an early stop returns a multiple
        of T (up to T - 1 past the reaching generation); the individual
        that reached the target is kept, because its deme group stops
        breeding inside the launch. T > 1 breeds builtin and expression
        hooks alike (objectives with a rowwise fused or an expression
        form; uniform, order or expression crossover); any other
        objective (the coordinate TSP among them) warns and breeds one
        generation per launch.

        With ``config.pop_shards`` = S > 1 the population breeds as S
        shards (see the module docstring): an inadmissible S (S² must
        divide the size) raises ValueError naming the valid counts, and
        ``generations_per_launch`` is ignored, as JAX builds only its
        one-generation breed there. The bred population is installed as
        one (P, L) array; the target reads the global best."""
        self._require_objective()
        handle = population or PopulationHandle(0)
        pop = self._populations[handle.index]
        self._check_elitism(pop.size)
        sharded = self.config.pop_shards > 1
        fn, per_launch = (self._sharded_run if sharded else self._run_fn)(pop.size, pop.genome_len)
        genomes, scores, gens = fn(pop.genomes, int(n), target, self.generator)
        self._populations[handle.index] = Population(genomes=genomes, scores=scores)
        if per_launch:
            self.launches += -(-gens // per_launch)
        return gens

    # -------------------------------------------------------- best extraction

    def get_best_with_score(self, handle: PopulationHandle) -> Tuple[np.ndarray, float]:
        """Best genome and its score: the first row of
        :meth:`get_best_top` (``ops/topk.py``). Genomes come back as
        float32 numpy arrays (a bfloat16 gene widens exactly)."""
        pop = self._populations[handle.index]
        g, s = best_genome(pop.genomes, pop.scores)
        return g.float().cpu().numpy(), float(s)

    def get_best(self, handle: PopulationHandle) -> np.ndarray:
        """Best genome of one population."""
        return self.get_best_with_score(handle)[0]

    def get_best_top(self, handle: PopulationHandle, k: int) -> np.ndarray:
        """Top-k genomes, best first, in ``lax.top_k``'s order (the lower
        index first among equal scores); ``k`` is clamped to the size."""
        pop = self._populations[handle.index]
        g, _ = top_k_genomes(pop.genomes, pop.scores, min(k, pop.size))
        return g.float().cpu().numpy()

    def get_best_all(self) -> np.ndarray:
        """Best genome across all populations (``pga.h:92``; a stub in the
        reference): the first best of the first population that holds the
        highest score."""
        best_g, best_s = None, -float("inf")
        for h in self._handles():
            g, s = self.get_best_with_score(h)
            if s > best_s:
                best_g, best_s = g, s
        if best_g is None:
            raise RuntimeError("no populations")
        return best_g

    def get_best_top_all(self, k: int) -> np.ndarray:
        """Global top-k across all populations (``pga.h:93``; a stub in the
        reference): each population's top-k, then JAX's merge of the
        candidates (``np.argsort`` of the negated scores)."""
        cands_g, cands_s = [], []
        for pop in self._populations:
            g, s = top_k_genomes(pop.genomes, pop.scores, min(k, pop.size))
            cands_g.append(g.float().cpu().numpy())
            cands_s.append(s.cpu().numpy())
        if len({g.shape[1] for g in cands_g}) != 1:
            raise ValueError("get_best_top_all requires equal genome_len across populations")
        all_g = np.concatenate(cands_g)
        order = np.argsort(-np.concatenate(cands_s))[:k]
        return all_g[order]

    # ------------------------------------------------------------- migration

    def migrate(self, pct: float, order=None) -> None:
        """Migrate the top ``pct`` between populations (``pga.h:108-111``;
        an empty stub in the reference): a ring over a random population
        order, every population sending its top ``int(size * pct)`` to its
        successor, where they replace the worst. Emigrants are taken
        before any population receives, so an individual moves one hop.
        ``order`` is the ring's population order; None draws it with
        ``torch.randperm`` from the solver's generator."""
        if not 0.0 <= pct <= 1.0:
            raise ValueError("migration pct must be in [0, 1]")
        n = len(self._populations)
        if n < 2:
            return
        emigrants = {}
        for i, pop in enumerate(self._populations):
            count = int(pop.size * pct)
            if count > 0:
                emigrants[i] = top_k_genomes(pop.genomes, pop.scores, count)
        if order is None:
            order = torch.randperm(n, generator=self.generator, device=self.device)
        order = [int(x) for x in order]
        for i in range(n):
            src, dst = order[i], order[(i + 1) % n]
            if src in emigrants:
                self._immigrate_into(dst, *emigrants[src])

    def migrate_between(
        self, src: PopulationHandle, dst: PopulationHandle, pct: float
    ) -> None:
        """Copy the top ``pct`` of ``src`` over the worst of ``dst``
        (``pga.h:112-115``; an empty stub in the reference), ``int(pct *
        min(sizes))`` individuals (0: nothing). Both need scores."""
        if not 0.0 <= pct <= 1.0:
            raise ValueError("migration pct must be in [0, 1]")
        spop = self._populations[src.index]
        count = int(min(spop.size, self._populations[dst.index].size) * pct)
        if count == 0:
            return
        self._immigrate_into(dst.index, *top_k_genomes(spop.genomes, spop.scores, count))

    def _immigrate_into(self, dst_index: int, emigrants, escores) -> None:
        dpop = self._populations[dst_index]
        if emigrants.shape[1] != dpop.genome_len:
            raise ValueError("migration requires equal genome_len")
        g, s = immigrate(dpop.genomes[None].clone(), dpop.scores[None].clone(),
                         emigrants[None], escores[None])
        self._populations[dst_index] = Population(genomes=g[0], scores=s[0])

    # --------------------------------------------------------------- islands

    def _island_breed(self, island_size: int, genome_len: int, islands: int):
        """The island deme breed of ``islands`` equal populations (the
        counterpart of JAX's ``_pallas_island_breed``), or None where the
        deme path declines the island shape or the operators (the islands
        then take the panmictic epoch). At ``generations_per_launch`` = T
        > 1 the multi-generation island breed, where the objective has a
        rowwise fused or expression form and the kernel admits the shape;
        otherwise it warns, as JAX does, and breeds one generation per
        launch. Cached until the objective or an operator changes."""
        if not self.uses_deme_kernel(island_size, genome_len):
            return None
        key = (island_size, genome_len, islands)
        if key in self._islands:
            return self._islands[key]
        c, obj = self.config, self._require_objective()
        kw = self._deme_kw()
        T = c.generations_per_launch
        breed = None
        if T is not None and T > 1:
            if (getattr(obj, "fused_id", None) in ROWWISE_FUSED
                    or getattr(obj, "expr_fused", None) is not None):
                breed = make_island_multigen(island_size, genome_len, obj, islands, T,
                                             elitism=c.elitism, **kw)
                if breed is None:
                    warnings.warn(
                        f"generations_per_launch={T} requested but the island multi-generation"
                        " kernel declined — falling back to the one-generation island path",
                        stacklevel=3,
                    )
            else:
                warnings.warn(
                    f"generations_per_launch={T} requested but the objective has no in-kernel"
                    " (rowwise fused or expression) form — islands fall back to the"
                    " one-generation path",
                    stacklevel=3,
                )
        if breed is None:
            breed = make_island_breed(island_size, genome_len, obj, islands,
                                      elitism=c.elitism, **kw)
        self._islands[key] = breed
        return breed

    def run_islands(
        self, n: int, m: int, pct: float, target: Optional[float] = None, mesh=None,
    ) -> int:
        """Island GA over ALL populations (``pga.h:144-150``; an empty stub
        in the reference): ``n`` generations, the top ``pct`` of every
        island migrating every ``m`` generations along
        ``config.migration_topology``, stopping at the first epoch whose
        best reaches ``target`` (the target is checked once per epoch).
        Equal populations run stacked (``parallel/islands.py``): on the
        deme path one launch breeds every island, with builtin or
        expression hooks; unequal ones run epoch by
        epoch through :meth:`run` and :meth:`migrate`. Returns the
        generations run. ``mesh`` (sharded islands) is not ported yet."""
        if mesh is not None:
            raise NotImplementedError(
                "sharded islands (mesh=) are not ported yet: ROADMAP Queue A item 6 (sharding)"
            )
        if not self._populations:
            raise RuntimeError("no populations")
        obj = self._require_objective()
        self._check_elitism(min(p.size for p in self._populations))
        if len({(p.size, p.genome_len) for p in self._populations}) != 1:
            return self._run_islands_hetero(n, m, pct, target)
        stacked = torch.stack([p.genomes for p in self._populations])
        I, S, L = stacked.shape
        breed = self._island_breed(S, L, I)
        if breed is None:
            if "panmictic" not in self._islands:
                self._warn_panmictic_fallback()
                self._islands["panmictic"] = self._panmictic_breed()
            breed = self._islands["panmictic"]
        # The epoch-level elite carry: only for a deme breed whose kernel
        # does not score the children (the others apply elitism themselves).
        epoch_elitism = (
            self.config.elitism if hasattr(breed, "geom") and not breed.fused else 0
        )
        before = getattr(breed, "launches", 0)
        genomes, scores, gens = run_islands_stacked(
            breed, obj, stacked, self.generator, n=n, m=m, pct=pct, target=target,
            topology=self.config.migration_topology, runner_cache=self._islands,
            elitism=epoch_elitism,
        )
        for i in range(I):
            self._populations[i] = Population(genomes=genomes[i], scores=scores[i])
        self.launches += getattr(breed, "launches", 0) - before
        return gens

    def _run_islands_hetero(
        self, n: int, m: int, pct: float, target: Optional[float]
    ) -> int:
        """Unequal population shapes: epochs of :meth:`run` per
        population, then :meth:`migrate` (JAX's ``_run_islands_hetero``).
        Returns the most generations any population ran."""
        gens = 0
        while gens < n:
            chunk = min(m, n - gens)
            gens += max(self.run(chunk, target=target, population=h) for h in self._handles())
            if target is not None:
                if max(self.get_best_with_score(h)[1] for h in self._handles()) >= target:
                    break
            if gens < n:
                self.migrate(pct)
        return gens
