"""The panmictic generation step (the torch counterpart of
``libpga_tpu/ops/step.py``) and the stop rule every run loop shares.

:func:`make_breed` selects over the whole population, then runs the
crossover and the mutation on ``(P, rand_cols)`` uniform blocks, and
carries the top ``elitism`` rows into slots ``0..e-1``. Its draws come
from the solver's ``torch.Generator``, or are injected (tests).

:func:`run_generations` is the loop: it checks the best score before
every breed, so the generation that reaches the target (or whose best
is NaN) is the one returned.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from libpga_tpu_torch.ops.select import SelectDraws, draw_ties, select_parent_pairs
from libpga_tpu_torch.ops.topk import top_k


@dataclasses.dataclass
class BreedDraws:
    """Every random number one panmictic breed consumes: the selection's,
    and the crossover's and mutation's uniform blocks."""

    select: SelectDraws
    cross: torch.Tensor
    mut: torch.Tensor


def _batched(fn: Callable) -> Callable:
    batched = getattr(fn, "batched", None)
    return batched if batched is not None else torch.vmap(fn)


def make_breed(
    crossover_fn: Callable,
    mutate_fn: Callable,
    *,
    tournament_size: int = 2,
    selection_kind: str = "tournament",
    selection_param: Optional[float] = None,
    elitism: int = 0,
) -> Callable:
    """``breed(genomes (P, L), scores (P,), generator=None, *, draws=None)
    -> next genomes``. Operators carry ``.batched`` (whole-population
    form, as the expression operators of ``ops/breed_expr.py`` and the
    builtins do; a plain per-row callable is vmapped) and ``.rand_cols``
    (uniforms per individual; absent: L). Without ``draws`` the breed
    takes the selection's draws, then the crossover's, then the
    mutation's from ``generator``."""
    cross = _batched(crossover_fn)
    mut = _batched(mutate_fn)
    cross_cols = getattr(crossover_fn, "rand_cols", None)
    mut_cols = getattr(mutate_fn, "rand_cols", None)

    def draw(P: int, L: int, generator, device) -> BreedDraws:
        num = 2 * P
        if selection_kind == "tournament":
            sel = SelectDraws(idx=torch.randint(
                0, P, (num, tournament_size), generator=generator, device=device
            ))
        else:
            sel = SelectDraws(
                tie=draw_ties(generator, P, device),
                u=torch.rand((num,), generator=generator, device=device),
            )
        rc = torch.rand((P, cross_cols or L), generator=generator, device=device)
        rm = torch.rand((P, mut_cols or L), generator=generator, device=device)
        return BreedDraws(select=sel, cross=rc, mut=rm)

    def breed(genomes, scores, generator=None, *, draws: Optional[BreedDraws] = None):
        P, L = genomes.shape
        if draws is None:
            draws = draw(P, L, generator, genomes.device)
        p1_idx, p2_idx = select_parent_pairs(
            scores, P, k=tournament_size, kind=selection_kind,
            param=selection_param, draws=draws.select,
        )
        children = cross(genomes[p1_idx], genomes[p2_idx], draws.cross)
        nxt = mut(children, draws.mut)
        if elitism > 0:
            elite = top_k(scores, elitism)[1]
            nxt = torch.cat([genomes[elite], nxt[elitism:]])
        return nxt.to(genomes.dtype)

    return breed


class _StopCheck:
    """``not (max(scores) < target)`` per generation. On the card the
    maximum is copied, without blocking the host, into one of two pinned
    host slots, each with its event; ``stop(slot)`` waits only for that
    slot's copy, then compares on the host. On the CPU it is read at
    once."""

    def __init__(self, target: float, device):
        self.target = target
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            self.host = torch.empty(2, dtype=torch.float32, pin_memory=True)
            self.view = self.host.numpy()
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
        else:
            self.best = [0.0, 0.0]

    def post(self, scores: torch.Tensor, slot: int) -> None:
        if self.cuda:
            self.host[slot].copy_(scores.max(), non_blocking=True)
            self.events[slot].record()
        else:
            self.best[slot] = float(scores.max())

    def stop(self, slot: int) -> bool:
        if self.cuda:
            self.events[slot].synchronize()
            best = self.view[slot]
        else:
            best = self.best[slot]
        return not best < self.target  # NaN compares false: stop


def run_generations(
    step: Callable, genomes, scores, n: int, target: Optional[float], stride: int = 1
):
    """Breed up to ``n`` generations with ``step(genomes, scores, gen) ->
    (genomes, scores)``, stopping at the first step whose best score
    reaches ``target`` or is NaN (without a target, ``max < inf`` is
    false only for NaN), as the JAX run loops' ``max(s) < target`` does.
    A step advances ``stride`` generations (the last one ``n - gen``:
    the count lands on ``n``); with ``stride`` > 1 a stop is therefore
    reported at a multiple of ``stride``. Returns ``(genomes, scores,
    gens)`` of the step kept.

    The stop flag of a step is read after the next step has been queued,
    so the host never waits on the device's current work; when it says
    stop, the next step's result is dropped. A ``step`` must therefore
    leave its inputs intact.

    A run that stops so pays for one step it throws away: its breed and
    scoring (about one step's wall time), one more launch of each of its
    kernels than the steps returned, and the generator has advanced past
    that step's draws. A run of all ``n`` generations wastes nothing,
    but pays for the per-step maximum and its copy to the host."""
    check = _StopCheck(math.inf if target is None else float(target), scores.device)
    check.post(scores, 0)
    gens = steps = 0
    while gens < n:
        g2, s2 = step(genomes, scores, gens)
        if check.stop(steps % 2):
            break
        gens = min(gens + stride, n)
        steps += 1
        check.post(s2, steps % 2)
        genomes, scores = g2, s2
    return genomes, scores, gens
