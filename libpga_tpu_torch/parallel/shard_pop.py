"""Population sharding: one run's population split into S shards that
breed apart and stay panmictic-equivalent. The torch counterpart of
``libpga_tpu/parallel/shard_pop.py``.

JAX places the S shards on S devices under ``shard_map``. Here they are
a stacked leading axis, ``(S, P/S, L)``, on the solver's one device, so
JAX's two collectives become tensor operations:

1. **Comb mix** (JAX: one ``ppermute``). Every generation, the P/S² rows
   of each shard at stride S (rows 0, S, 2S, ..., a comb that touches
   every deme group of the in-shard layout) hop one shard around the
   ring, landing cross-deme interleaved: comb slot ``d·C + u`` goes to
   slot ``u·D + d`` (:func:`comb_interleave_rows`). Both are one gather
   of the comb rows.
2. **Rank-threshold sketch** (JAX: one ``all_gather`` of S·k scalars).
   Each shard's top k = max(1, elitism) scores, sorted together: entry 0
   is the global best (the stop check reads it), entry e-1 the global
   elitism threshold.

One generation, in JAX's order: the local breed of every shard at once
(``local_step``), the mix, the re-scoring (every row, or only the comb
rows when the breed scored its children), global elitism (a shard's
parent survives into rows 0..e-1 where its score reaches the previous
sketch's entry e-1, so the global top e survive, ties keeping a few
more), then the sketch of the new scores.

The algebra (:func:`admissible_shards` to :func:`shard_mix_perm`) is
JAX's, under the same names. JAX caps S at the device count; the
stacked layout needs no cap, so S ranges up to ``isqrt(P)`` with
``S² | P``. JAX's ``ablate`` (its bench's A/B of the two collectives)
is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from libpga_tpu_torch.ops.evaluate import evaluate
from libpga_tpu_torch.ops.step import run_generations
from libpga_tpu_torch.ops.topk import top_k

# ------------------------------------------------------------ admissibility


def admissible_shards(pop_size: int):
    """Every shard count S with ``S² | pop_size`` (each shard holds P/S
    rows and the mix slab P/S² is a whole number of rows)."""
    return [s for s in range(1, math.isqrt(pop_size) + 1) if pop_size % (s * s) == 0]


def validate_shards(pop_size: int, shards: int) -> None:
    """Raise ValueError, naming the valid values, unless ``shards`` is
    admissible for this population: JAX's message without its device
    clause."""
    valid = admissible_shards(pop_size)
    if shards not in valid:
        raise ValueError(
            f"pop_shards={shards} is inadmissible for a population of "
            f"{pop_size} (need S^2 | pop so every shard holds pop/S rows "
            f"and the comb mix slab pop/S^2 is whole); valid shard counts: {valid}"
        )


def check_run(pop_size: int, shards: int, elitism: int) -> None:
    """Raise ValueError unless a sharded run of this shape can be built:
    ``shards`` admissible and ``elitism`` at most a shard's rows (JAX's
    checks in ``make_sharded_run``)."""
    validate_shards(pop_size, shards)
    Ps = pop_size // shards
    if not 0 <= elitism <= Ps:
        raise ValueError(f"elitism={elitism} must be in [0, per-shard rows {Ps}]")


def mix_rows(pop_size: int, shards: int) -> int:
    """Rows each shard ships a generation: ``P / S²``."""
    return (pop_size // shards) // shards


def comb_chunks(mix: int, cap: int = 8) -> int:
    """Sub-chunk count D of the migrating slab: the largest divisor of
    ``mix`` that is <= ``cap``; 1 when the slab is one row."""
    for d in range(min(cap, mix), 0, -1):
        if mix % d == 0:
            return d
    return 1


def comb_interleave_rows(mix: int, D: Optional[int] = None) -> np.ndarray:
    """Where received slab rows land, slab-locally: source row ``d·C +
    u`` (sub-chunk d of D, offset u of C = mix/D) lands at row ``u·D +
    d``. Returns ``dest[src_row] = dest_row``."""
    if D is None:
        D = comb_chunks(mix)
    C = mix // D
    d = np.arange(D, dtype=np.int64)[:, None]
    u = np.arange(C, dtype=np.int64)[None, :]
    dest = np.empty(mix, dtype=np.int64)
    dest[(d * C + u).reshape(-1)] = (u * D + d).reshape(-1)
    return dest


def shard_mix_perm(pop_size: int, shards: int) -> np.ndarray:
    """The global row permutation one generation's mix applies: row
    ``s·Ps + m·S`` (the stride-S comb) moves to shard ``(s+1) mod S`` at
    comb slot ``inv_interleave(m)``; the other rows stay."""
    S = shards
    Ps = pop_size // S
    mix = mix_rows(pop_size, S)
    inv = np.argsort(comb_interleave_rows(mix))
    dest = np.arange(pop_size, dtype=np.int64)
    m = np.arange(mix)
    for s in range(S):
        dest[s * Ps + m * S] = (s + 1) % S * Ps + inv[m] * S
    return dest


# ---------------------------------------------------------------- run loop


def make_sharded_run(
    obj: Callable,
    local_step: Callable,
    pop_size: int,
    genome_len: int,
    shards: int,
    *,
    elitism: int = 0,
) -> Callable:
    """The sharded run loop: ``runner(genomes (P, L), n, target,
    generator) -> (genomes (P, L), scores (P,), gens)``, the contract of
    the other run loops (``ops/step.run_generations``: the stop flag,
    here the sketch's entry 0, is read one generation late).

    ``local_step(g (S, Ps, L), s (S, Ps), gen, generator) -> (g2, s2 |
    None)`` breeds every shard at once and leaves its inputs intact: a
    fused breed returns its kernel's scores (only the migrated comb is
    re-scored), any other ``None`` (the loop scores every row). It must
    not carry elites: the loop applies global elitism.

    ``runner.shards``, ``runner.mix`` and ``runner.k_sync`` are S, the
    rows a shard ships and the sketch's entries per shard. JAX's
    ``history_gens`` (telemetry) is not ported: ROADMAP Queue A item 3."""
    check_run(pop_size, shards, elitism)
    S, L = shards, genome_len
    Ps = pop_size // S
    mix = mix_rows(pop_size, S)
    k_sync = max(1, elitism)
    # Comb slot k of shard s takes slot ileave[k] of shard s - 1: a source
    # row of the (S·mix) comb rows, per device.
    src = ((np.arange(S)[:, None] - 1) % S * mix + comb_interleave_rows(mix)).reshape(-1)
    src_on = {}

    def sync(s):
        """Each shard's top-k, sorted together (descending, NaN last, as
        JAX's ``-sort(-x)``): (S·k,)."""
        return -torch.sort(-top_k(s, k_sync)[0].reshape(-1)).values

    def mix_children(g2):
        """The stride-S comb of every shard one hop around the ring,
        landing at the interleaved slots, in place: row ``k·S`` of shard
        s is row ``k`` of the (S·mix, S, L) view's slot 0."""
        if g2.device not in src_on:
            src_on[g2.device] = torch.as_tensor(src, device=g2.device)
        rows = g2.view(S * mix, S, L)
        rows[:, 0] = rows[src_on[g2.device], 0]

    def apply_elitism(g, s, g2, s2, sketch):
        thr = sketch[elitism - 1]
        top_s, top_i = top_k(s, elitism)
        keep = top_s >= thr
        elites = torch.take_along_dim(g, top_i[..., None], dim=1).to(g2.dtype)
        g2[:, :elitism] = torch.where(keep[..., None], elites, g2[:, :elitism])
        s2[:, :elitism] = torch.where(keep, top_s, s2[:, :elitism])

    def generation(state, gen, generator):
        g, s, sketch = state
        g2, s2 = local_step(g, s, gen, generator)
        mix_children(g2)
        if s2 is None:
            s2 = evaluate(obj, g2.view(-1, L)).view(S, Ps)
        else:
            s2.view(S * mix, S)[:, 0] = evaluate(obj, g2.view(S * mix, S, L)[:, 0])
        if elitism:
            apply_elitism(g, s, g2, s2, sketch)
        sketch2 = sync(s2)
        return (g2, s2, sketch2), sketch2[:1]

    def runner(genomes, n, target, generator):
        g = genomes.reshape(S, Ps, L)
        s = evaluate(obj, genomes).view(S, Ps)
        sketch = sync(s)
        (g, s, _), _, gens = run_generations(
            lambda state, _, gen: generation(state, gen, generator),
            (g, s, sketch), sketch[:1], n, target,
        )
        return g.reshape(pop_size, L), s.reshape(pop_size), gens

    runner.shards = S
    runner.mix = mix
    runner.k_sync = k_sync
    return runner
