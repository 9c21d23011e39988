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
    make_multigen_run,
    resolve_geometry,
)
from libpga_tpu_torch.ops.mutate import make_point_mutate
from libpga_tpu_torch.ops.step import make_breed, run_generations
from libpga_tpu_torch.ops.topk import best_genome, top_k_genomes
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
    may breed fewer); the panmictic path launches none.
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
        self.launches = 0

    # ----------------------------------------------------------- populations

    def create_population(
        self, size: int, genome_len: int, init: str = "random"
    ) -> PopulationHandle:
        """Uniform [0, 1) genomes from the solver's generator."""
        pop = create_population(
            self.generator, size, genome_len, init=init, device=self.device
        )
        self._populations.append(pop)
        return PopulationHandle(len(self._populations) - 1)

    def install_population(
        self, genomes: Union[Population, torch.Tensor, np.ndarray]
    ) -> PopulationHandle:
        """Install an explicit population: a :class:`Population` (e.g.
        from ``interop.state_from_numpy``) or a ``(size, genome_len)``
        matrix, whose scores read -inf until the first run."""
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
        g = g.to(self.device, torch.float32).contiguous()
        s = s.to(self.device, torch.float32).contiguous()
        self._populations.append(Population(genomes=g, scores=s))
        return PopulationHandle(len(self._populations) - 1)

    def population(self, handle: PopulationHandle) -> Population:
        return self._populations[handle.index]

    # ------------------------------------------------------------- objective

    def set_objective(self, fn: Union[str, Callable]) -> None:
        """A rowwise callable ``(P, L) -> (P,)`` (higher is better) or
        the name of a builtin from :mod:`libpga_tpu_torch.objectives`."""
        if isinstance(fn, str):
            from libpga_tpu_torch import objectives

            fn = objectives.get(fn)
        self._objective = fn
        self._runs.clear()

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
        self._runs.clear()

    def set_mutate(self, fn: Optional[Callable]) -> None:
        """Mutation ``(genome, rand) -> genome`` with ``.batched`` and
        ``.rand_cols`` (e.g. ``make_swap_mutate(0.5)`` or
        ``gp.make_gp_mutate``); None restores the default point mutation
        at ``config.mutation_rate``. A builtin kind or an expression
        operator (``mutate_from_expression``) keeps ``run`` on the deme
        path; any other operator routes it to the panmictic path."""
        self._mutate = fn
        self._runs.clear()

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
        c = self.config
        cross = self._crossover_kind()
        expr_obj = getattr(self._objective, "expr_fused", None)
        return (
            cross is not None and self._mutate_kind() is not None
            and c.use_deme_kernel
            and resolve_geometry(
                size, genome_len, deme_size=c.deme_size,
                tournament_size=c.tournament_size, selection=c.selection,
                selection_param=c.selection_param, crossover=cross,
                const_carrying=bool(getattr(expr_obj, "kernel_rowwise_consts", ())),
            ) is not None
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

    def _run_fn(self, size: int, genome_len: int) -> Tuple[Callable, int]:
        """The run function of a shape and its generations per launch
        (0 on the panmictic path)."""
        key = (size, genome_len)
        if key not in self._runs:
            c = self.config
            obj = self._require_objective()
            if self.uses_deme_kernel(size, genome_len):
                kw = dict(
                    deme_size=c.deme_size, tournament_size=c.tournament_size,
                    selection=c.selection, selection_param=c.selection_param,
                    crossover=self._crossover_kind(), mutate=self._mutate_kind(),
                    mparams=self._mutate_params(), elitism=c.elitism,
                    layout=c.layout, device=self.device,
                )
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
                fn = make_run_loop(obj, make_breed(
                    self._crossover or uniform_crossover,
                    self._mutate or make_point_mutate(c.mutation_rate),
                    tournament_size=c.tournament_size,
                    selection_kind=c.selection,
                    selection_param=c.selection_param,
                    elitism=c.elitism,
                ))
            self._runs[key] = (fn, per_launch)
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
        generation per launch."""
        self._require_objective()
        handle = population or PopulationHandle(0)
        pop = self._populations[handle.index]
        fn, per_launch = self._run_fn(pop.size, pop.genome_len)
        genomes, scores, gens = fn(pop.genomes, int(n), target, self.generator)
        self._populations[handle.index] = Population(genomes=genomes, scores=scores)
        if per_launch:
            self.launches += -(-gens // per_launch)
        return gens

    # -------------------------------------------------------- best extraction

    def get_best_with_score(self, handle: PopulationHandle) -> Tuple[np.ndarray, float]:
        """Best genome and its score: the first row of
        :meth:`get_best_top` (``ops/topk.py``)."""
        pop = self._populations[handle.index]
        g, s = best_genome(pop.genomes, pop.scores)
        return g.cpu().numpy(), float(s)

    def get_best(self, handle: PopulationHandle) -> np.ndarray:
        """Best genome of one population."""
        return self.get_best_with_score(handle)[0]

    def get_best_top(self, handle: PopulationHandle, k: int) -> np.ndarray:
        """Top-k genomes, best first, in ``lax.top_k``'s order (the lower
        index first among equal scores); ``k`` is clamped to the size."""
        pop = self._populations[handle.index]
        g, _ = top_k_genomes(pop.genomes, pop.scores, min(k, pop.size))
        return g.cpu().numpy()
