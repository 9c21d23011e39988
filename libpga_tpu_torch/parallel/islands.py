"""Island-model execution on one device: epochs of local evolution, then
migration. The torch counterpart of ``libpga_tpu/parallel/islands.py``
(its single-device runner).

``run_islands_stacked`` runs the contract of the reference's never-written
``pga_run_islands(pga, n, m, pct)`` (``include/pga.h:144-150``): ``n``
generations, the top ``pct`` of every island migrating every ``m``
generations.

- Each island evolves ``m`` generations (an epoch) by one of three epochs,
  chosen as JAX chooses them (:func:`_make_vepoch`): the stacked deme epoch
  (a fused deme breed: per generation one rank sort over every island's
  demes and ONE kernel launch that breeds every island, the islands a
  second grid axis of the launch, with builtin or expression hooks); the
  stacked multi-generation epoch (ceil(m / T) launches of the builtin or
  expression multi-generation kernel over every island);
  or :func:`make_island_epoch` (the panmictic breed island by island, or a
  deme breed whose kernel does not score the children, with the
  epoch-level elite carry).
- Migration takes each island's top ``count`` and ships them to the next
  island of a ring (``"ring"``: island i to i + 1; ``"random"``: a ring
  over a shuffled island order drawn from the solver's generator);
  immigrants replace the destination's worst ``count``, so an island's
  best always survives a migration. It acts on the real rows only: the
  epochs pad the islands to the kernels' Pp rows at entry and slice the
  pads away at exit, as JAX's do (``islands.py:184-186``, ``:245-247``),
  so a pad row's -inf score is never taken as an island's worst.
- The epoch loop checks ``max(scores) < target`` before every epoch, one
  host read per epoch, so the generation that reached the target is the
  one returned. With migration every ``m`` generations the target check
  has epoch granularity: a winner strictly inside an epoch is superseded
  by its offspring unless elitism keeps it (JAX's ``islands.py:17-21``).

Left out of this port so far (ROADMAP): the sharded runner, the batched
island loop of serving, island telemetry and fault injection. Every
island breed JAX runs in a Pallas kernel, expression hooks included,
runs here in one launch over all islands.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from libpga_tpu_torch.ops.evaluate import evaluate
from libpga_tpu_torch.ops.fused_step import carry_elites
from libpga_tpu_torch.ops.topk import top_k


def _pad(genomes: torch.Tensor, scores: torch.Tensor, Pp: int):
    """Islands (I, S, L) / (I, S) padded to Pp rows: zero genes, -inf
    scores (the inputs themselves where S == Pp)."""
    I, S, L = genomes.shape
    if Pp == S:
        return genomes, scores
    g = torch.zeros((I, Pp, L), device=genomes.device, dtype=genomes.dtype)
    g[:, :S] = genomes
    s = torch.full((I, Pp), -torch.inf, device=genomes.device)
    s[:, :S] = scores
    return g, s


def evaluate_islands(obj: Callable, genomes: torch.Tensor) -> torch.Tensor:
    """Scores (I, S) of islands (I, S, L) under a rowwise objective."""
    I, S, L = genomes.shape
    return evaluate(obj, genomes.reshape(I * S, L)).view(I, S)


# ------------------------------------------------------------------ epochs


def make_island_epoch(breed: Callable, obj: Callable, m: int, *, elitism: int = 0) -> Callable:
    """``epoch(genomes (I, S, L), scores (I, S), generator, draws=None)
    -> (genomes, scores)``: m generations of breed-then-evaluate on every
    island (``make_island_epoch``, ``islands.py:41``). It serves two
    breeds:

    - the panmictic breed (``ops/step.make_breed``), island by island
      each generation; ``draws(island)`` gives an island's draws where
      they are injected (tests replay JAX's own);
    - an island deme breed whose kernel does not score the children
      (``fused_step.make_island_breed`` with an unfused objective): one
      launch per generation over the islands padded once at entry (pad
      rows score -inf and are inert) and sliced once at exit, at parity 0
      as JAX's ``padded`` breed runs.

    ``elitism`` > 0 carries each island's top-e into its rows 0..e-1
    after the evaluation (JAX's ``:95-96``), for a breed that applies no
    elitism itself: the deme breed without fused scores (the panmictic
    breed applies its own, and the engine passes 0 for it)."""
    geom = getattr(breed, "geom", None)

    def epoch(genomes, scores, generator, draws=None):
        I, S, L = genomes.shape
        if geom is not None:
            g, s = _pad(genomes, scores, geom.Pp)
            bufs = [torch.empty_like(g), torch.empty_like(g)]
            for j in range(m):
                g2, s2 = breed(g, s, 0, generator, out=bufs[j % 2])
                if elitism:
                    carry_elites(g, s, g2, s2, elitism)
                g, s = g2, s2
            return g[:, :S], s[:, :S]
        g, s = genomes, scores
        for _ in range(m):
            g2 = torch.stack([
                breed(g[i], s[i], generator, draws=None if draws is None else draws(i))
                for i in range(I)
            ])
            s2 = evaluate_islands(obj, g2)
            if elitism:
                carry_elites(g, s, g2, s2, elitism)
            g, s = g2, s2
        return g, s

    return epoch


def make_stacked_deme_epoch(breed: Callable, m: int) -> Callable:
    """m generations over ALL islands at once for a fused island deme
    breed (``fused_step.make_island_breed``), the counterpart of
    ``make_stacked_pallas_epoch`` (``islands.py:110``): ``epoch(genomes
    (I, S, L), scores (I, S), generator) -> (genomes, scores)``.

    Each generation is one rank sort flattened over every island's demes
    and one island launch. Ping-pong breeds alternate their parity by
    generation (JAX scans parity pairs (0, 1) with an odd-m tail at
    parity 0: gens 0, 1, 2, ... at parities 0, 1, 0, ...); every epoch
    restarts at parity 0, as JAX's does (``:123-131``). The islands are
    padded once at entry and sliced at exit; the children alternate
    between two buffers, so the input is never written."""
    geom = breed.geom

    def epoch(genomes, scores, generator):
        S = genomes.shape[1]
        g, s = _pad(genomes, scores, geom.Pp)
        bufs = [torch.empty_like(g), torch.empty_like(g)]
        for j in range(m):
            g, s = breed(g, s, j % geom.parities, generator, out=bufs[j % 2])
        return g[:, :S], s[:, :S]

    return epoch


def make_multigen_stacked_epoch(bm: Callable, m: int) -> Callable:
    """m generations over ALL islands for a multi-generation island
    breed (``fused_step.make_island_multigen``), the counterpart of
    ``make_multigen_stacked_epoch`` (``islands.py:192``): ceil(m / T)
    island launches, each breeding up to T generations (T =
    ``bm.epoch_chunk``, else 8, JAX's ``epoch_chunk``, ``:207-217``)
    with ranks computed in the kernel. The launch parity alternates by
    launch (``:235``); no target freezes a group (JAX passes none,
    ``:240``: the target is +inf); elitism runs in the kernel, per
    deme."""
    geom = bm.geom
    T = getattr(bm, "epoch_chunk", None) or 8

    def epoch(genomes, scores, generator):
        S = genomes.shape[1]
        g, s = _pad(genomes, scores, geom.Pp)
        bufs = [torch.empty_like(g), torch.empty_like(g)]
        done = launch = 0
        while done < m:
            t = min(T, m - done)
            parity = launch % 2 if geom.parities > 1 else 0
            g, s = bm(g, s, parity, t, math.inf, generator, out=bufs[launch % 2])
            done += t
            launch += 1
        return g[:, :S], s[:, :S]

    return epoch


def _use_stacked_epoch(breed, elitism: int) -> bool:
    """Fused island deme breeds take the stacked epoch (their elitism
    runs in the breed, so the epoch-level carry must be 0)."""
    return getattr(breed, "fused", False) and hasattr(breed, "geom") and elitism == 0


def _make_vepoch(breed, obj, m: int, elitism: int) -> Callable:
    """The epoch run over stacked islands, chosen as JAX chooses it
    (``islands.py:263``): ``(g (I, S, L), s (I, S), generator) -> (g,
    s)``."""
    if getattr(breed, "multigen", False):
        return make_multigen_stacked_epoch(breed, m)
    if _use_stacked_epoch(breed, elitism):
        return make_stacked_deme_epoch(breed, m)
    return make_island_epoch(breed, obj, m, elitism=elitism)


# ---------------------------------------------------------------- migration


def select_emigrants(
    genomes: torch.Tensor, scores: torch.Tensor, count: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each island's top ``count`` (``_select_emigrants``, ``:278``):
    genomes (I, S, L), scores (I, S) -> emigrants (I, count, L), their
    scores (I, count), best first in ``lax.top_k``'s order
    (``ops/topk.py``)."""
    top_s, top_i = top_k(scores, count)
    return torch.take_along_dim(genomes, top_i[..., None], dim=1), top_s


def immigrate(genomes, scores, im_g, im_s):
    """Replace each island's worst ``count`` with the immigrants
    (``_immigrate``, ``:286``): genomes (I, S, L) and scores (I, S) are
    updated in place and returned; ``im_g`` (I, count, L), ``im_s`` (I,
    count). The worst are JAX's ``lax.top_k(-scores)`` rows, taken as
    :func:`top_k` of ``-scores``, so tied and NaN scores pick JAX's
    rows."""
    count = im_g.shape[1]
    _, worst = top_k(-scores, count)
    genomes.scatter_(1, worst[..., None].expand(-1, -1, genomes.shape[2]),
                     im_g.to(genomes.dtype))
    scores.scatter_(1, worst, im_s)
    return genomes, scores


def shuffled_ring_sources(order: torch.Tensor) -> torch.Tensor:
    """Source island of each destination for a ring over the island
    order ``order`` (a permutation): ``src[order[i+1]] = order[i]``
    (``_shuffled_ring_sources``, ``:300``; the caller draws ``order``)."""
    return torch.zeros_like(order).scatter_(0, order, torch.roll(order, 1))


def migrate_local(genomes, scores, count: int, topology: str, order=None):
    """One migration across the island axis (``_migrate_local``,
    ``:307``): every island's top ``count`` replaces the worst ``count``
    of the next island of the ring (``"ring"``), or of a ring over the
    permutation ``order`` (``"random"``). Emigrants are taken before any
    island receives, so one migration moves an individual one hop.
    Updates genomes and scores in place and returns them."""
    em_g, em_s = select_emigrants(genomes, scores, count)
    if topology == "ring":
        src = torch.roll(torch.arange(genomes.shape[0], device=genomes.device), 1)
    else:
        src = shuffled_ring_sources(order)
    return immigrate(genomes, scores, em_g[src], em_s[src])


# ------------------------------------------------------------------ runners


def build_local_runner(
    breed: Callable, obj: Callable, *, m: int, count: int, topology: str, elitism: int = 0,
) -> Callable:
    """The single-device epoch loop (``build_local_runner``, ``:358``;
    without its telemetry mode). Returns ``runner(genomes (I, S, L),
    generator, num_epochs, target=inf, draws=None) -> (genomes, scores
    (I, S), epochs_done)``: score the islands once, then while fewer than
    ``num_epochs`` epochs ran and ``max(scores) < target`` (one host read
    per epoch; a NaN best stops), run an epoch and, when ``count`` > 0,
    migrate (``"random"``: the island order is ``torch.randperm`` from
    ``generator``). ``elitism`` is the epoch-level elite carry of
    :func:`make_island_epoch`; ``draws`` goes to that epoch."""
    vepoch = _make_vepoch(breed, obj, m, elitism)

    def runner(genomes, generator, num_epochs: int, target: float = math.inf, draws=None):
        scores = evaluate_islands(obj, genomes)
        kw = {} if draws is None else {"draws": draws}
        done = 0
        while done < num_epochs and float(scores.max()) < target:
            genomes, scores = vepoch(genomes, scores, generator, **kw)
            if count > 0:
                order = None
                if topology == "random":
                    order = torch.randperm(genomes.shape[0], generator=generator,
                                           device=genomes.device)
                genomes, scores = migrate_local(genomes, scores, count, topology, order)
            done += 1
        return genomes, scores, done

    return runner


def run_islands_stacked(
    breed: Callable,
    obj: Callable,
    stacked: torch.Tensor,
    generator: torch.Generator,
    *,
    n: int,
    m: int,
    pct: float,
    target: Optional[float] = None,
    topology: str = "ring",
    mesh=None,
    runner_cache: Optional[dict] = None,
    elitism: int = 0,
    draws: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Run the island GA on a stacked ``(I, S, L)`` population
    (``run_islands_stacked``, ``:673``). ``breed`` is the panmictic
    ``ops/step.make_breed`` breed or an island breed of
    ``fused_step.make_island_breed`` / ``make_island_multigen``.
    ``int(S * pct)`` individuals migrate (0: none); ``divmod(n, m)``
    gives the epochs and the remainder generations, which run without a
    following migration and only when the epochs did not reach the
    target. ``runner_cache``, a dict, keeps the runners across calls.
    ``elitism`` is the epoch-level elite carry (:func:`make_island_epoch`).
    ``draws(stage, island)`` injects the panmictic breed's draws (stage
    "main" for the epochs, "rem" for the remainder).

    Returns ``(genomes (I, S, L), scores (I, S), generations run)``."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded islands (mesh=) are not ported yet: ROADMAP Queue A item 6 (sharding)"
        )
    I, S, L = stacked.shape
    if m < 1:
        raise ValueError("migration interval m must be >= 1")
    if not 0.0 <= pct <= 1.0:
        raise ValueError("migration pct must be in [0, 1]")
    count = int(S * pct)
    epochs, rem = divmod(int(n), int(m))
    tgt = math.inf if target is None else float(target)

    def cached(tag: str, mm: int, cc: int) -> Callable:
        def build():
            return build_local_runner(breed, obj, m=mm, count=cc, topology=topology,
                                      elitism=elitism)

        if runner_cache is None:
            return build()
        key = ("islands/" + tag, mm, cc, topology, breed, obj, elitism)
        if key not in runner_cache:
            runner_cache[key] = build()
        return runner_cache[key]

    def stage(name):
        return None if draws is None else (lambda i: draws(name, i))

    genomes, scores, done = cached("main", m, count)(stacked, generator, epochs, tgt,
                                                      draws=stage("main"))
    gens = done * m
    if rem > 0 and (target is None or float(scores.max()) < tgt):
        genomes, scores, _ = cached("rem", rem, 0)(genomes, generator, 1, draws=stage("rem"))
        gens += rem
    return genomes, scores, gens
