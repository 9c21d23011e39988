"""The fused deme breed: the torch counterpart of
``libpga_tpu/ops/pallas_step.py``.

One generation ranks every deme's scores (plain torch, outside the
kernel, as JAX does with ``lax.sort``), then breeds every deme in ONE
launch of a hand-written CUDA kernel of ``csrc/deme_breed.cu``, chosen
by the crossover kind the engine routes (``engine.PGA._crossover_kind``):

- **uniform** (``deme_breed_kernel``): rank-space selection, uniform
  crossover, point, gaussian or swap mutation, and for onemax /
  onemax_bits the child's score;
- **order** (``order_breed_kernel``, the TSP path): rank-space
  selection, the order-preserving walk (a parent's gene where its city
  is unvisited, else the ``fill`` draw), point, gaussian or swap
  mutation, and the fused score of onemax, onemax_bits or the coordinate
  TSP of ``make_tsp_coords(duplicate_mode="genes")``;
- **expression** (``expr_breed_kernel`` of ``csrc/expr_breed.cu``, B6;
  with order crossover its ``expr_order_kernel``): where the crossover
  or mutation is an expression operator (``ops/breed_expr.py``) or the
  objective has an expression form (``expr_fused``: ``from_expression``,
  knapsack, NK, the trap), the template kernel with generated hooks
  breeds and scores; a hook that is not an expression stays builtin
  (uniform or order crossover; point, gaussian or swap mutation; a
  builtin fused objective, or the coordinate TSP after order
  crossover).

The mutation's [rate, sigma] are runtime inputs. The score is written to
the child's physical row; an objective without a fused form is scored by
its rowwise form after the breed.

Two row maps come from the JAX package and are semantics, not launch
shapes: they decide which rows form a selection cohort and where each
child lands.

- **ping-pong** (the JAX default for fused objectives when its mixing
  gate admits, e.g. 1,048,576x100): parity 0 reads consecutive slabs,
  parity 1 strided combs; child chunk ``u`` of deme ``d`` lands at group
  chunk ``u*D + d`` (``pingpong_child_rows``). The parity alternates by
  generation.
- **riffle** (everything else, e.g. 40,000x100, whose 157 demes admit no
  ping-pong D, and every order-crossover breed): deme ``g`` reads rows
  ``[g*K, (g+1)*K)`` and its child ``k`` lands at row ``k*G + g``.

The geometry code below is copied from ``pallas_step.py`` with its VMEM
arithmetic unchanged (the order walk's scratch included), so the port
picks the same ``(layout, K, D, Pp)`` as ``make_pallas_breed``. On the
GPU the VMEM model decides nothing about the launch; it only fixes the
grouping, which has to match.

On the GPU one block per deme cannot write in place: a ping-pong group's
interleaved child rows belong to other blocks. The run loop therefore
ping-pongs between two ``(Pp, L)`` buffers (2 x 419 MB at 1,048,576x100).

**Several generations per launch** (``PGAConfig.generations_per_launch``
= T > 1, the counterpart of ``make_pallas_multigen`` and
``_multigen_run_loop``): ``multigen_breed_kernel`` breeds up to T
generations of every group of D demes in one launch, ranking each deme
inside the kernel (:func:`kernel_ranks`), with per-deme elitism, a
per-group target freeze and a runtime step count. Demes are fixed for a
launch; the row maps apply once, at its end. Its geometry
(``resolve_geometry(multigen=True)``) differs from the one-generation
one, and it needs a rowwise-fused or an expression objective. With an
expression crossover, mutation or objective ``expr_multigen_kernel`` of
the generated expression unit breeds (B6 x B4): the same loop, the
children of the expression breed. Both take order crossover too (one
riffle deme per group, as JAX): each sub-generation walks every child
before the mutation and the score.

**bfloat16 genomes** (``PGAConfig(gene_dtype=torch.bfloat16)``): the deme,
multi-generation and expression kernels have bf16 cases (order crossover
stays float32, as in JAX, whose factories decline it). A bf16 breed
computes each child in float32 from the widened parents, exactly as the
float32 breed does, and rounds it once to bfloat16 where it is stored;
its score is of the stored genes, and a multi-generation launch's next
sub-generation reads the rounded rows (JAX's ``child.astype(bf16)`` then
``child.astype(f32)``, ``pallas_step.py:1114-1125``). So one bf16
generation is the float32 generation of the widened genomes, rounded.
The geometry follows JAX's bf16 defaults: 2-byte genes in every fit, a
ping-pong quantum of 16 rows and the demes-per-step defaults of 4.

**Islands** (``PGA.run_islands``): I equal populations breed in ONE launch
of the kernel of the hooks (the deme, order or multi-generation kernel,
or with an expression hook the expression kernels), the islands a second
grid axis (:func:`make_island_breed`, :func:`make_island_multigen`). Genomes
carry a leading island axis (I, Pp, L), the ranks of every island come
from one sort over (I*G, K), each island has its own launch seed, and
injected draws a leading island axis. Each island computes exactly what a
single-population launch of its tensors and seed computes; the plain
versions breed the islands' demes as the demes of one population.

**The sub-block pipeline** (``PGAConfig.subblock`` = B > 1, JAX's
``pallas_subblock``, B8): a ping-pong group grows to ``B*D*K`` rows and
children interleave within each sub-block of D demes, so B changes the
row maps (and may change D) but not what a deme computes. Uniform
crossover with builtin hooks launches ``deme_pipelined_kernel`` at every
B, 1 included, and every row map: a persistent kernel whose thread-block
clusters stage a deme's parent rows whole in shared memory (TMA) while
they breed the one before; a deme no cluster holds, and the floor
harness's copy, go to ``deme_breed_kernel`` at the same geometry
(:func:`breed_launcher`). Expression hooks launch the expression breed
with the B-aware maps: at any B, ``expr_pipelined_kernel`` (the same
schedule with the hooks) where its plan holds the deme, else
``expr_breed_kernel`` (``kernels.expr_breed_cuda`` decides from the
shape). The riffle, order crossover and the multi-generation kernels
take B = 1.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from libpga_tpu_torch.objectives.classic import (
    FUSED_ACKLEY,
    FUSED_NONE,
    FUSED_ONEMAX,
    FUSED_ONEMAX_BITS,
    FUSED_RASTRIGIN,
    FUSED_SPHERE,
    FUSED_TSP,
    ROWWISE_FUSED,
    duplicate_genes,
    tour_edges,
    tsp_cities,
)
from libpga_tpu_torch.objectives.expr import warp_order_sum
from libpga_tpu_torch.ops import kernels
from libpga_tpu_torch.ops.crossover import order_walk
from libpga_tpu_torch.ops.expr_cuda import streams
from libpga_tpu_torch.ops.evaluate import evaluate
from libpga_tpu_torch.ops.step import run_generations
from libpga_tpu_torch.ops.select import (
    resolve_selection,
    winner_fraction,
    winner_ranks,
)
from libpga_tpu_torch.ops.topk import top_k
from libpga_tpu_torch.population import GENE_DTYPES

LANE = 128
CROSSOVER_KINDS = ("uniform", "order")
MUTATE_KINDS = ("point", "gaussian", "swap")


def is_expression(kind) -> bool:
    """Whether a crossover or mutation kind is an expression operator
    (``ops/breed_expr.py``: it carries ``.kernel_rows``), not a builtin
    kind name."""
    return callable(kind) and getattr(kind, "kernel_rows", None) is not None


def _expression_hooked(kw: dict) -> bool:
    """Whether a breed's keywords name an expression crossover, mutation
    or objective: the breed then launches the generated expression
    unit's kernel."""
    return (is_expression(kw.get("crossover")) or is_expression(kw.get("mutate"))
            or kw.get("objective") is not None)

# ---------------------------------------------------------------------
# The floor harness's ablation flags (copied from
# libpga_tpu/ops/pallas_step.py:83-117; csrc/deme_breed.cu, "The floor
# harness", gives each flag's meaning on the card)
# ---------------------------------------------------------------------

VALID_ABLATE = frozenset({
    "copy_only",       # pure-copy kernel (floor harness)
    "no_riffle",       # contiguous deme-major output layout
    "alias_io",        # in-place output over the input buffer
    "serial_grid",     # "arbitrary" grid dimension semantics
    "no_rank_sort",    # skip the host-side rank sort (copy variants)
    "no_score_t",      # skip the score transpose in padded_ranks
    "scatter_scores",  # pre-round-5 per-deme score stores
    "sel_const",       # identity selection (no sampling/one-hot build)
    "no_matmul",       # skip the parent-gather matmul
    "no_cross",        # skip crossover
    "no_mut",          # skip mutation
    "no_freeze",       # multigen: disable the target-freeze predicate
    "no_rank_cube",    # multigen: identity in-kernel ranks
})
# Flags that change the output layout: riffle instruments.
LAYOUT_ABLATE = frozenset({
    "copy_only", "no_riffle", "alias_io", "no_score_t", "scatter_scores",
})
STAGE_ABLATE = frozenset({"sel_const", "no_matmul", "no_cross", "no_mut"})
MULTIGEN_ABLATE = frozenset({"no_freeze", "no_rank_cube"})
# Flags without a meaning on the card, and why.
NO_CUDA_MEANING = {
    "serial_grid": "CUDA blocks have no grid dimension semantics to choose",
    "no_score_t": "each score is stored at its child's row, so there is no score"
                  " transpose to skip",
    "scatter_scores": "per-child score stores are already the production path",
}


def validate_ablate(ablate, multigen: bool = False) -> tuple:
    """``ablate`` as a tuple, checked: an unknown name raises ValueError
    naming the valid set (JAX's ``_validate_ablate``); so do a flag
    without a meaning on the card (``NO_CUDA_MEANING``), a
    multi-generation flag in a one-generation breed (``multigen``
    False) or a copy, row-map or host flag in a multi-generation one,
    and ``alias_io`` without ``copy_only`` and ``no_riffle`` (a breeding
    warp would overwrite a parent row another warp of its block still
    reads)."""
    ablate = tuple(ablate)
    flags = set(ablate)
    unknown = sorted(flags - VALID_ABLATE)
    if unknown:
        raise ValueError(
            f"unknown ablation flag(s) {unknown}; valid flags are {sorted(VALID_ABLATE)}"
        )
    for flag in sorted(flags & set(NO_CUDA_MEANING)):
        raise ValueError(f"ablation flag {flag!r} has no meaning on the card:"
                         f" {NO_CUDA_MEANING[flag]}")
    if multigen and flags - STAGE_ABLATE - MULTIGEN_ABLATE:
        raise ValueError(
            f"ablation flag(s) {sorted(flags - STAGE_ABLATE - MULTIGEN_ABLATE)} are"
            " one-generation only: the multi-generation kernel has no copy, row-map or"
            " host rank-sort case"
        )
    if not multigen and flags & MULTIGEN_ABLATE:
        raise ValueError(f"ablation flag(s) {sorted(flags & MULTIGEN_ABLATE)} are"
                         " the multi-generation kernel's")
    if "alias_io" in flags and not {"copy_only", "no_riffle"} <= flags:
        raise ValueError("alias_io requires copy_only and no_riffle: in place, a breeding"
                         " warp would overwrite a parent row another warp still reads, and"
                         " the riffle writes rows other blocks read")
    return ablate


# ---------------------------------------------------------------------
# Geometry (copied from libpga_tpu/ops/pallas_step.py:185-372, 1701-1932)
# ---------------------------------------------------------------------


def pingpong_quantum(gene_dtype=torch.float32) -> int:
    """Chunk granularity of the parity-1 comb (8 rows for float32)."""
    return 16 if gene_dtype == torch.bfloat16 else 8


def pingpong_admissible(W: int, Pp: int, q: int) -> bool:
    """True when the parity pair fully mixes: ``W/q >= Pp/W``."""
    if W <= 0 or W % q or Pp % W:
        return False
    return (W // q) >= (Pp // W)


def pingpong_group_rows(parity: int, i: int, *, W: int, S: int, q: int):
    """Physical rows group ``i`` reads and writes under ``parity``."""
    if parity == 0:
        return np.arange(i * W, (i + 1) * W, dtype=np.int64)
    A = W // q
    a = np.arange(A, dtype=np.int64)[:, None]
    o = np.arange(q, dtype=np.int64)[None, :]
    return (a * (S * q) + i * q + o).reshape(-1)


def pingpong_perm(parity: int, Pp: int, W: int, q: int):
    """READ map: entry ``g*W + x`` is the physical row of group ``g``'s
    local row ``x`` (read deme d = local rows [d*K, (d+1)*K))."""
    S = Pp // W
    return np.concatenate([
        pingpong_group_rows(parity, i, W=W, S=S, q=q) for i in range(S)
    ])


def pingpong_child_rows(
    parity: int, Pp: int, K: int, q: int, D: int, B: int = 1
):
    """WRITE map: entry ``g*W + dd*K + k`` is the physical row where
    group ``g``'s deme ``dd``'s child ``k`` lands (child chunk ``u`` of
    deme ``d`` at sub-block chunk ``u*D + d``)."""
    W = B * D * K
    S = Pp // W
    T = K // q
    rows = np.empty(Pp, np.int64)
    for g in range(S):
        grp = pingpong_group_rows(parity, g, W=W, S=S, q=q)
        for b in range(B):
            for d in range(D):
                dd = b * D + d
                u = np.arange(T)[:, None]
                o = np.arange(q)[None, :]
                m = b * D * T + u * D + d
                local = (m * q + o).reshape(-1)
                rows[g * W + dd * K : g * W + (dd + 1) * K] = grp[local]
    return rows


def _valid_deme(k: int) -> bool:
    return bool(k) and not (k & (k - 1)) and 128 <= k <= 1024


def _scoped_vmem_bytes(K: int, D: int, Lp: int, gene_bytes: int) -> int:
    blocks = 2 * D * K * Lp * gene_bytes
    cubes = K * K * (4 + 2 + 2)
    rows = K * Lp * (3 * 4 + 4 + (4 if gene_bytes == 4 else 0))
    return blocks + cubes + rows


_SCOPED_VMEM_LIMIT = 14_500_000
_BLOCK_BYTES_LIMIT = 8_650_000


def _blocks_fit(
    K: int, D: int, Lp: int, gene_bytes: int, extra_scoped: int = 0
) -> bool:
    return (
        4 * D * K * Lp * gene_bytes <= _BLOCK_BYTES_LIMIT
        and _scoped_vmem_bytes(K, D, Lp, gene_bytes) + extra_scoped
        <= _SCOPED_VMEM_LIMIT
    )


def _multigen_blocks_fit(
    K: int, D: int, Lp: int, gene_bytes: int, extra_scoped: int = 0
) -> bool:
    """The multi-generation kernel's VMEM gate: the one-generation model
    plus the genome and score scratch and the in-kernel rank cube."""
    scratch = D * K * Lp * gene_bytes + 4 * D * K
    return (
        4 * D * K * Lp * gene_bytes + scratch <= _BLOCK_BYTES_LIMIT
        and _scoped_vmem_bytes(K, D, Lp, gene_bytes)
        + scratch + 8 * K * K + extra_scoped
        <= _SCOPED_VMEM_LIMIT
    )


def _order_scratch_bytes(K: int, L: int, Lp: int) -> int:
    """The order walk's VMEM scratch (``_order_scratch_shapes``): five
    (Lp, K) 32-bit planes and the visited bitmask, ceil(L/32) words per
    column padded to a multiple of 8 sublanes (at least 8)."""
    Wp = max(8, math.ceil(math.ceil(L / 32) / 8) * 8)
    return (5 * Lp * K + Wp * K) * 4


def _pick_deme_size(
    pop_size: int, preferred: int, genome_lanes: int = LANE,
    gene_bytes: int = 4, fits: Optional[Callable[[int], bool]] = None,
):
    """Exact power-of-two divisors first, then the healthiest padded
    fit (tails under K/4 rows rejected; wastes up to 12.5% count as
    equal, then the preferred size, then the larger deme). None for
    populations under 128 rows or with only degenerate tails. ``fits``
    is the caller's VMEM admission test (default: the one-generation
    model at D=1)."""
    if fits is None:
        def fits(k: int) -> bool:
            return _blocks_fit(k, 1, genome_lanes, gene_bytes)

    if _valid_deme(preferred) and fits(preferred) and pop_size % preferred == 0:
        return preferred
    for k in (1024, 512, 256, 128):
        if fits(k) and pop_size % k == 0:
            return k
    if pop_size < 128:
        return None
    best = None
    for k in (1024, 512, 256, 128):
        if k > pop_size or not fits(k):
            continue
        g = -(-pop_size // k)
        tail = pop_size - (g - 1) * k
        if tail < max(k // 4, 2):
            continue
        waste = g * k - pop_size
        rank = (
            waste if waste > pop_size // 8 else 0,
            0 if k == preferred else 1,
            -k,
        )
        if best is None or rank < best[0]:
            best = (rank, k)
    return best[1] if best else None


def auto_deme_size(gene_dtype=torch.float32, const_carrying: bool = False) -> int:
    """The JAX package's deme default: 512, except 256 for float32
    objectives that carry kernel constants (``auto_deme_size``,
    ``pallas_step.py:372``)."""
    if const_carrying and gene_dtype != torch.bfloat16:
        return 256
    return 512


ONE_GEN_D_POOL = (32, 16, 8, 4, 2, 1)
MULTIGEN_D_POOL = (16, 8, 4, 2, 1)


def one_gen_d_default(gene_dtype=torch.float32, const_carrying: bool = False) -> int:
    """The one-generation demes-per-step default (``one_gen_d_default``,
    ``pallas_step.py:1930``): 4 for bf16, 16 for const-carrying float32
    objectives, else 8."""
    if gene_dtype == torch.bfloat16:
        return 4
    return 16 if const_carrying else 8


def multigen_d_default(gene_dtype=torch.float32) -> int:
    """The multi-generation demes-per-step default (``make_pallas_multigen``,
    ``pallas_step.py:2783``): 4 for bf16, else 8."""
    return 4 if gene_dtype == torch.bfloat16 else 8


@dataclasses.dataclass
class Geometry:
    """Resolved breed geometry. ``G`` demes of ``K`` rows over ``Pp``
    padded rows; ``D`` demes per group (ping-pong: ``S`` groups of
    ``W = B*D*K`` rows, parity-1 comb quantum ``q``). ``B`` is the
    ping-pong sub-block depth (JAX's ``subblock``): a group holds ``B``
    sub-blocks of ``D`` demes, and children interleave within each
    sub-block (:func:`pingpong_child_rows`); 1 everywhere else.
    ``layout`` is "pingpong", "riffle" or, for the floor harness's
    ``no_riffle``, "contig" (the riffle's cohorts, child k of deme g at
    row g*K + k)."""

    layout: str
    P: int
    L: int
    K: int
    G: int
    D: int
    Pp: int
    q: int
    B: int = 1
    _maps: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def S(self) -> int:
        return self.Pp // (self.B * self.D * self.K)

    @property
    def parities(self) -> int:
        return 2 if self.layout == "pingpong" else 1

    def mode(self, parity: int) -> int:
        """Row-map id the kernel takes: 0/1 ping-pong parity, 2 riffle, 3
        contiguous."""
        return {"riffle": 2, "contig": 3}.get(self.layout, parity)

    def row_maps(self, parity: int, device) -> tuple:
        """``(read, write)`` int64 tensors of shape (G, K): the physical
        row read for cohort slot (g, k), and the physical row child
        (g, k) is written to. Cached per parity and device."""
        key = (self.mode(parity), str(device))
        if key not in self._maps:
            K, G = self.K, self.G
            if self.layout == "contig":
                read = write = np.arange(self.Pp, dtype=np.int64)
            elif self.layout == "riffle":
                read = np.arange(self.Pp, dtype=np.int64)
                write = (
                    np.arange(K, dtype=np.int64)[None, :] * G
                    + np.arange(G, dtype=np.int64)[:, None]
                )
            else:
                W = self.B * self.D * K
                read = pingpong_perm(parity, self.Pp, W, self.q)
                write = pingpong_child_rows(parity, self.Pp, K, self.q, self.D, self.B)
            self._maps[key] = (
                torch.as_tensor(read.reshape(G, K), device=device),
                torch.as_tensor(write.reshape(G, K), device=device),
            )
        return self._maps[key]


def resolve_geometry(
    pop_size: int,
    genome_len: int,
    *,
    deme_size: Optional[int] = None,
    tournament_size: int = 2,
    selection: str = "tournament",
    selection_param: Optional[float] = None,
    fused: bool = True,
    layout: Optional[str] = None,
    crossover="uniform",
    multigen: bool = False,
    elitism: int = 0,
    demes_per_step: Optional[int] = None,
    const_carrying: bool = False,
    gene_dtype=torch.float32,
    ablate: Sequence[str] = (),
    subblock: Optional[int] = None,
) -> Optional[Geometry]:
    """What ``make_pallas_breed`` (or, with ``multigen``,
    ``make_pallas_multigen``) would build for ``gene_dtype`` genes
    (float32 or bfloat16: 2-byte genes in every fit, JAX's bf16 deme and
    demes-per-step defaults and a ping-pong quantum of 16), a builtin
    crossover kind and a builtin mutation: the ``_kernel_shape`` gates
    and fit, then ``_resolve_layout`` (fused breeds take ping-pong
    whenever a D admits it; ``layout`` forces one; an explicit
    ``demes_per_step`` is rounded down to a candidate and never bumped).
    Order crossover counts the walk's scratch in every fit (the deme
    pick included, so a long genome takes a smaller K), pins D to 1 and
    is riffle-only.

    ``multigen`` takes the multi-generation kernel's VMEM model, its D
    pool (16..1, default 8; order crossover: the walk's scratch counted,
    D pinned to 1, the riffle) and always counts as fused; it declines when
    ``elitism >= K // 4`` (per-deme elites would fill the deme), and
    per-deme elitism on a padded population stays on the riffle (a pad
    row could take a parity-1 cohort's elite slot). ``elitism`` is read
    only there: the one-generation path carries global elites outside
    the kernel.

    ``crossover`` may be an expression operator: it is shaped as uniform
    crossover is (JAX's ``_kernel_shape`` admits callable kinds).
    ``const_carrying`` (a fused objective with kernel constants: NK,
    knapsack) takes JAX's deme default of 256 rows and demes-per-step
    default of 16. A layout flag of the floor harness in ``ablate``
    (``LAYOUT_ABLATE``) pins the riffle, as ``_resolve_layout`` does
    (``layout="pingpong"`` then raises); with ``no_riffle`` the riffle's
    cohorts take the contiguous row map ("contig"), order crossover's
    too.

    ``subblock`` (JAX's ``pallas_subblock``; None is 1) is the ping-pong
    sub-block depth B: a D qualifies when ``G % (B*D) == 0`` and the
    mixing gate admits groups of ``B*D*K`` rows, so B can change D as
    well as the row maps. The riffle, order crossover, the layout
    ablation flags and ``multigen`` (JAX's multi-generation factory
    ignores it) give B = 1; below 1 raises.

    None where the JAX factory declines (tournament size outside 1..16,
    under 128 rows, only degenerate padded fits, no K whose order
    scratch fits, order crossover on bfloat16 genes, or the multigen
    elitism gate)."""
    if gene_dtype not in GENE_DTYPES:
        raise ValueError(f"gene_dtype {gene_dtype} is not one of {GENE_DTYPES}")
    B = 1 if multigen else int(subblock or 1)
    if B < 1:
        raise ValueError(f"subblock depth must be >= 1, got {subblock}")
    if not 1 <= tournament_size <= 16:
        return None
    if is_expression(crossover):
        crossover = "uniform"
    if crossover not in CROSSOVER_KINDS:
        raise ValueError(f"unknown crossover kind {crossover!r}; one of {CROSSOVER_KINDS}")
    resolve_selection(selection, selection_param)
    if layout not in (None, "riffle", "pingpong"):
        raise ValueError(
            f"unknown layout {layout!r}: expected 'riffle' or 'pingpong'"
        )
    order = crossover == "order"
    if order and layout == "pingpong":
        raise ValueError(
            "layout='pingpong' is not available here: order crossover is riffle-only"
        )
    if order and gene_dtype != torch.float32:
        return None
    if not deme_size:
        deme_size = auto_deme_size(gene_dtype, const_carrying)
    Lp = math.ceil(genome_len / LANE) * LANE
    gene_bytes = 2 if gene_dtype == torch.bfloat16 else 4
    blocks_fit = _multigen_blocks_fit if multigen else _blocks_fit
    d_pool = MULTIGEN_D_POOL if multigen else ONE_GEN_D_POOL
    d_default = (
        multigen_d_default(gene_dtype) if multigen
        else one_gen_d_default(gene_dtype, const_carrying)
    )

    def fit(k: int, d: int) -> bool:
        extra = _order_scratch_bytes(k, genome_len, Lp) if order else 0
        return blocks_fit(k, d, Lp, gene_bytes, extra)

    K = _pick_deme_size(
        pop_size, deme_size, genome_lanes=Lp, gene_bytes=gene_bytes,
        fits=lambda k: fit(k, 1),
    )
    if K is None:
        return None
    if multigen and elitism >= K // 4:
        return None
    G = math.ceil(pop_size / K)
    Pp = G * K
    q = pingpong_quantum(gene_dtype)
    if order:
        layout = "contig" if "no_riffle" in ablate else "riffle"
        return Geometry(layout, pop_size, genome_len, K, G, 1, Pp, q)
    d_candidates = [d for d in d_pool if G % d == 0 and fit(K, d)] or [1]
    D = next((d for d in d_candidates if d <= (demes_per_step or d_default)), 1)
    riffle = Geometry("riffle", pop_size, genome_len, K, G, D, Pp, q)
    explicit = layout == "pingpong"
    if set(ablate) & LAYOUT_ABLATE:
        if explicit:
            raise ValueError(
                "layout='pingpong' is not available here: layout ablation flags"
                f" {sorted(set(ablate) & LAYOUT_ABLATE)} are riffle instruments"
            )
        if "no_riffle" in ablate:
            return Geometry("contig", pop_size, genome_len, K, G, D, Pp, q)
        return riffle
    if layout == "riffle" or not (explicit or fused or multigen):
        return riffle
    if multigen and Pp != pop_size and elitism > 0:
        if explicit:
            raise ValueError(
                "layout='pingpong' is not available here: per-deme elitism on a"
                " padded population would write elites into pad rows under parity 1"
            )
        return riffle
    pool = [D] if demes_per_step else sorted(d for d in d_candidates if d >= D)
    for d2 in pool:
        if G % (B * d2) == 0 and pingpong_admissible(B * d2 * K, Pp, q):
            return Geometry("pingpong", pop_size, genome_len, K, G, d2, Pp, q, B)
    if explicit:
        raise ValueError(
            "layout='pingpong' requested but no demes-per-step"
            f" satisfies the mixing gate (K={K}, G={G}, subblock={B})"
        )
    return riffle


# ---------------------------------------------------------------------
# Ranks (plain torch, outside the kernel)
# ---------------------------------------------------------------------

PAD_TIE = 0xFFFFFFFF


def draw_tie_words(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """A fresh 31-bit tie word per cohort slot (JAX: ``bits >> 1``)."""
    return torch.randint(
        0, 2**31, (n,), generator=generator, device=device, dtype=torch.int64
    )


def _ranks_by_key(s: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """Ranks (0 = best) along the last axis of ``s`` (N, K) under the
    total order: score descending, then ``tie`` (int64, < 2^32)
    ascending. One stable sort on a packed int64 key (order-preserving
    bits of -s << 32 | tie). +0.0 canonicalises -0.0: the two zeros
    compare equal."""
    bits = (-(s + 0.0)).view(torch.int32).to(torch.int64)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    order = torch.sort((key << 32) | tie, dim=1, stable=True).indices
    iota = torch.arange(s.shape[1], device=s.device).expand(s.shape)
    return torch.empty_like(order).scatter_(1, order, iota).to(torch.int32)


def compute_ranks(
    scores: torch.Tensor, geom: Geometry, parity: int, tie: torch.Tensor
) -> torch.Tensor:
    """In-deme ranks (0 = best) of the parity's cohorts, ``(G, K)``
    int32. ``scores`` are (Pp,) in physical order; ``tie`` (Pp,) int64
    words in [0, 2^31) in cohort order. Total order: score descending
    with NaN as -inf, then tie word ascending; pad rows get the maximal
    word, so they rank after every real row.

    Islands: ``scores`` and ``tie`` (I, Pp) give ``(I*G, K)``, island i's
    demes in rows ``[i*G, (i+1)*G)``, from one sort over every island's
    demes (JAX's flattened sort, ``pallas_step.py:2280-2330``,
    ``:2578-2605``)."""
    read, _ = geom.row_maps(parity, scores.device)
    s = scores[..., read].reshape(-1, geom.K)
    s = torch.where(torch.isnan(s), -torch.inf, s)
    tie = torch.where(read >= geom.P, PAD_TIE, tie.reshape(-1, geom.G, geom.K))
    return _ranks_by_key(s, tie.reshape(-1, geom.K))


def kernel_ranks(
    scores: torch.Tensor, tie: torch.Tensor, alive: torch.Tensor
) -> torch.Tensor:
    """The ranks the multi-generation kernel computes inside a launch
    (the plain ``_kernel_ranks``), ``(N, K)`` int32 for N demes.
    ``scores`` (N, K) float32 in cohort order; ``tie`` (N, K) int64
    holding a fresh 32-bit random word per row; ``alive`` (N, K) bool,
    the real rows. Descending score with NaN and dead rows as -inf; ties
    by ``((word >> 2) & ~1023) | lane`` (the lane index in the low 10
    bits makes the order strict); dead rows are keyed ``0x7FFFFC00 |
    lane``, above every real key, so they rank at or after V.
    ``rank[j]`` is the number of rows strictly before row j."""
    lane = torch.arange(scores.shape[1], device=scores.device)
    s = torch.where(torch.isnan(scores) | ~alive, -torch.inf, scores)
    t = torch.where(alive, ((tie >> 2) & ~1023) | lane, 0x7FFFFC00 | lane)
    return _ranks_by_key(s, t)


# ---------------------------------------------------------------------
# Random draws: injected, or Philox4x32-10 as the kernel computes it
# ---------------------------------------------------------------------


@dataclasses.dataclass
class Draws:
    """Every random number one breed consumes, per deme ``g`` and child
    ``k``: ``sel_u`` (G, K, 2) parent draws; ``cross`` (G, K, L) uint8
    crossover bits (1 takes parent 2; uniform crossover, else None);
    ``mut_u`` (G, K, 4) point/swap draws; ``gauss`` (3, G, K, L)
    gate/u1/u2 planes for gaussian mutation (else None); ``fill``
    (G, K, L) the order walk's fallback genes (order crossover, else
    None: JAX prefills every child position with a uniform draw, and a
    position keeps it only where neither parent's city is unvisited);
    ``tie`` (G, K) int64 holding a 32-bit word per row, the in-kernel
    ranks' tie break (multigen, else None); the expression operators'
    streams (``ops/breed_expr.py``, else None): ``expr_gene`` (4, G, K,
    L) per-gene planes crossover ``r``, ``r2``, mutation ``r``, ``r2``,
    and ``expr_row`` (G, K, 4) per-row words crossover ``q``, ``q2``,
    mutation ``q``, ``q2`` (a plane no hook reads is zeros). The
    multigen launch takes the same tensors with a leading sub-generation
    axis; :meth:`at` gives one sub-generation's."""

    sel_u: torch.Tensor
    cross: Optional[torch.Tensor]
    mut_u: torch.Tensor
    gauss: Optional[torch.Tensor] = None
    fill: Optional[torch.Tensor] = None
    tie: Optional[torch.Tensor] = None
    expr_gene: Optional[torch.Tensor] = None
    expr_row: Optional[torch.Tensor] = None

    def _map(self, fn) -> "Draws":
        parts = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        return Draws(**{k: None if x is None else fn(k, x) for k, x in parts.items()})

    def at(self, t: int, axis: int = 0) -> "Draws":
        """Sub-generation ``t`` of draws with a sub-generation axis
        (``axis`` 1: after an island axis)."""
        return self._map(lambda _, x: x.select(axis, t))

    def island(self, i: int) -> "Draws":
        """Island ``i`` of draws with a leading island axis."""
        return self._map(lambda _, x: x[i])

    def flat(self) -> "Draws":
        """Draws with a leading island axis (I, ...) as the draws of one
        population of I*G demes: island i's deme g becomes deme i*G + g
        (the plane-first ``gauss`` and ``expr_gene``, (I, n, G, ...),
        become (n, I*G, ...))."""
        def merge(name, x):
            if name in ("gauss", "expr_gene"):
                x = x.transpose(0, 1)
                return x.reshape(x.shape[0], -1, *x.shape[3:])
            return x.reshape(-1, *x.shape[2:])

        return self._map(merge)


def stack_draws(draws: Sequence[Draws]) -> Draws:
    """One island's draws per entry, stacked on a leading island axis."""
    return Draws(**{
        f.name: None if getattr(draws[0], f.name) is None
        else torch.stack([getattr(d, f.name) for d in draws])
        for f in dataclasses.fields(Draws)
    })


def zero_draws(
    G: int, K: int, L: int, mutate="point", device="cpu",
    crossover="uniform", steps: Optional[int] = None,
) -> Draws:
    """All-zero draws: the JAX interpret-mode PRNG's output. ``steps``
    gives every tensor a leading axis of that many sub-generations and
    adds the tie words (the multigen launch's draws). An expression
    crossover or mutation adds the expression streams."""
    z = dict(device=device)
    order = crossover == "order"
    expr = is_expression(crossover) or is_expression(mutate)
    lead = () if steps is None else (steps,)
    return Draws(
        sel_u=torch.zeros(lead + (G, K, 2), **z),
        cross=None if order else torch.zeros(lead + (G, K, L), dtype=torch.uint8, **z),
        mut_u=torch.zeros(lead + (G, K, 4), **z),
        gauss=torch.zeros(lead + (3, G, K, L), **z) if mutate == "gaussian" else None,
        fill=torch.zeros(lead + (G, K, L), **z) if order else None,
        tie=None if steps is None else torch.zeros(lead + (G, K), dtype=torch.int64, **z),
        expr_gene=torch.zeros(lead + (4, G, K, L), **z) if expr else None,
        expr_row=torch.zeros(lead + (G, K, 4), **z) if expr else None,
    )


_MASK32 = 0xFFFFFFFF
STREAM_SEL, STREAM_MUT, STREAM_CROSS = 0, 1, 2
STREAM_FILL, STREAM_GAUSS, STREAM_TIE = 0x20000000, 0x40000000, 0x60000000
STREAM_EXPR_GENE, STREAM_EXPR_ROW = 0x70000000, 0x71000000


def _mulhilo(a: int, b: torch.Tensor):
    """32x32 -> (hi, lo) product of a constant and uint32 values held
    in int64, split into 16-bit halves so nothing overflows."""
    p_lo = b * (a & 0xFFFF)
    p_hi = b * (a >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(key: torch.Tensor, c0, c1, c2, c3):
    """Philox4x32-10 on int64 tensors holding uint32 values; ``key`` is
    the launch seed (int64 tensor of one element: low word, high word).
    Returns the four output words. ``csrc/deme_breed.cu`` computes the
    same function."""
    seed = key.reshape(())
    k0 = seed & _MASK32
    k1 = (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK32
            k1 = (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _to_uniform(word: torch.Tensor) -> torch.Tensor:
    return (word >> 8).to(torch.float32) * 2.0**-24


def philox_draws(
    seed: torch.Tensor, G: int, K: int, L: int, mutate="point",
    crossover="uniform", sub_generation: int = 0, tie: bool = False,
) -> Draws:
    """The draws the kernels' production mode generates for launch seed
    ``seed``: counter ``(k, g, stream, sub_generation)`` (the
    one-generation kernels always count sub-generation 0) with stream
    0 = selection, 1 = mutation, 2+t = crossover bits of genes [128t,
    128t+128) (gene ``128t + 32w + b`` takes bit ``b`` of word ``w``;
    uniform crossover only), ``0x20000000 + t`` = the order walk's
    fallback genes 4t..4t+3 (gene ``4t + j`` takes word ``j``; order
    crossover only), ``0x40000000 + l`` = gaussian gate/u1/u2 of gene
    ``l``, and with ``tie`` ``0x60000000`` = the rank tie word of row k
    (word 0; the multigen kernel). Expression operators (``crossover`` /
    ``mutate`` from ``ops/breed_expr.py``) add the streams they read
    (``expr_cuda.streams``): per-gene plane j of gene l is word ``l & 3``
    of call ``0x70000000 + (j << 22) + (l >> 2)``, and the per-row words
    are the four words of call ``0x71000000``; an unread plane is zeros.
    Uniforms are ``(bits >> 8) * 2^-24``."""
    dev = seed.device
    k = torch.arange(K, device=dev, dtype=torch.int64)[None, :].expand(G, K)
    g = torch.arange(G, device=dev, dtype=torch.int64)[:, None].expand(G, K)
    zero = torch.zeros((), device=dev, dtype=torch.int64)
    sub = zero + sub_generation

    def call(stream):
        return philox4x32(seed, k, g, zero + stream, sub)

    def per_gene(stream0, n):
        """The four words of calls ``stream0 + t``, t < n, each (G, K, n)."""
        t = torch.arange(n, device=dev, dtype=torch.int64)
        return philox4x32(seed, k[..., None], g[..., None], stream0 + t, sub)

    w = call(STREAM_SEL)
    sel_u = torch.stack([_to_uniform(w[0]), _to_uniform(w[1])], dim=-1)
    w = call(STREAM_MUT)
    mut_u = torch.stack([_to_uniform(x) for x in w], dim=-1)
    cross = fill = None
    if crossover == "order":
        words = torch.stack(per_gene(STREAM_FILL, -(-L // 4)), dim=-1)
        fill = _to_uniform(words.reshape(G, K, -1)[..., :L])
    elif crossover == "uniform":
        ntiles = -(-L // 128)
        shifts = torch.arange(32, device=dev, dtype=torch.int64)
        tiles = []
        for t in range(ntiles):
            words = torch.stack(call(STREAM_CROSS + t), dim=-1)  # (G, K, 4)
            tiles.append(((words[..., None] >> shifts) & 1).reshape(G, K, 128))
        cross = torch.cat(tiles, dim=-1)[..., :L].to(torch.uint8)
    gauss = None
    if mutate == "gaussian":
        gauss = torch.stack([_to_uniform(x) for x in per_gene(STREAM_GAUSS, L)[:3]])
    expr_gene = expr_row = None
    planes, words = streams(crossover if is_expression(crossover) else None,
                            mutate if is_expression(mutate) else None)
    if is_expression(crossover) or is_expression(mutate):
        expr_gene = torch.zeros((4, G, K, L), device=dev)
        for j in planes:
            w = torch.stack(per_gene(STREAM_EXPR_GENE + (j << 22), -(-L // 4)), dim=-1)
            expr_gene[j] = _to_uniform(w.reshape(G, K, -1)[..., :L])
        expr_row = torch.zeros((G, K, 4), device=dev)
        if words:
            expr_row = torch.stack([_to_uniform(x) for x in call(STREAM_EXPR_ROW)], dim=-1)
    return Draws(
        sel_u=sel_u, cross=cross, mut_u=mut_u, gauss=gauss, fill=fill,
        tie=call(STREAM_TIE)[0] if tie else None, expr_gene=expr_gene, expr_row=expr_row,
    )


def island_philox_draws(seeds: torch.Tensor, *args, **kw) -> Draws:
    """:func:`philox_draws` of an island launch: island i's draws from
    its seed ``seeds[i]`` (``seeds`` (I,) int64), on a leading island
    axis."""
    return stack_draws([philox_draws(seeds[i:i + 1], *args, **kw) for i in range(seeds.shape[0])])


# ---------------------------------------------------------------------
# The plain version of the kernel
# ---------------------------------------------------------------------


def breed_children(
    cohorts: torch.Tensor,
    ranks: torch.Tensor,
    valid: torch.Tensor,
    draws: Draws,
    *,
    tournament_size: int,
    selection: str,
    selection_param: Optional[float],
    mutate,
    mparams: torch.Tensor,
    elite_rows: int = 0,
    crossover="uniform",
    ablate: Sequence[str] = (),
) -> torch.Tensor:
    """Breed the K children of each of N demes: the torch counterpart of
    ``_deme_child`` (uniform, order or expression crossover; point,
    gaussian, swap or expression mutation: an expression operator's
    ``kernel_rows`` reads the ``expr_gene`` / ``expr_row`` draws). ``cohorts`` (N, K, L) float32 rows in cohort order;
    ``ranks`` (N, K) in-deme ranks (a permutation of 0..K-1, 0 = best);
    ``valid`` (N,) float32 real-row counts V; ``draws`` sized (N, K, .);
    ``mparams`` (2,) float32 [rate, sigma]. ``elite_rows`` > 0 makes
    children 0..e-1 verbatim copies of ranks 0..e-1 (the JAX core's
    per-deme elites; order crossover is not the identity on equal
    parents, so the elite child is set to parent 1 after the walk).
    Returns (N, K, L) float32: a bfloat16 breed widens its cohorts first
    and rounds the children where it stores them.

    ``ablate`` takes the floor harness's stage flags (JAX's ``_deme_child``
    branches), with any crossover and mutation: ``sel_const`` and
    ``no_matmul`` make child k's parents slot k's row, and then an elite
    child is bred like any other (crossed, not reset to parent 1; still
    unmutated), as JAX resets elites only without those flags;
    ``no_cross`` makes the child parent 1 (no walk, no crossover hook);
    ``no_mut`` mutates nothing."""
    N, K, L = cohorts.shape
    dev = cohorts.device
    rate, sigma = mparams[0], mparams[1]
    param = resolve_selection(selection, selection_param)
    x = winner_fraction(selection, param, tournament_size, draws.sel_u)
    V = valid.reshape(N, 1, 1)
    wr = winner_ranks(x, V)  # (N, K, 2)
    row = torch.arange(K, device=dev)
    if elite_rows:
        forced = torch.minimum(row.to(torch.float32)[None, :], V[:, :, 0] - 1.0)
        elite = (row < elite_rows)[None, :, None]
        wr = torch.where(elite, forced.to(torch.int64)[..., None], wr)
    row_of_rank = torch.empty_like(ranks, dtype=torch.int64).scatter_(
        1, ranks.to(torch.int64), row.expand(N, K)
    )
    n = torch.arange(N, device=dev)[:, None]
    if {"sel_const", "no_matmul"} & set(ablate):
        p1 = p2 = cohorts
    else:
        p1 = cohorts[n, torch.gather(row_of_rank, 1, wr[..., 0])]
        p2 = cohorts[n, torch.gather(row_of_rank, 1, wr[..., 1])]
    if "no_cross" in ablate:
        child = p1
    elif is_expression(crossover):
        r, r2, q, q2 = _expr_inputs(draws, 0, N * K, L)
        child = crossover.kernel_rows(
            p1.reshape(N * K, L), p2.reshape(N * K, L), r, r2, q, q2, true_len=L,
        ).reshape(N, K, L)
    elif crossover == "order":
        child = order_walk(
            p1.reshape(N * K, L), p2.reshape(N * K, L),
            draws.fill.reshape(N * K, L),
        ).reshape(N, K, L)
    elif crossover == "uniform":
        child = torch.where(draws.cross.bool(), p2, p1)
    else:
        raise ValueError(f"unknown crossover kind {crossover!r}; one of {CROSSOVER_KINDS}")
    may_mutate = torch.ones((N, K), dtype=torch.bool, device=dev)
    if elite_rows:
        if not {"sel_const", "no_matmul"} & set(ablate):
            child = torch.where(elite, p1, child)
        may_mutate = may_mutate & (row >= elite_rows)[None, :]
    if "no_mut" in ablate:
        return child
    cols = torch.arange(L, device=dev)
    u = draws.mut_u
    if is_expression(mutate):
        r, r2, q, q2 = _expr_inputs(draws, 2, N * K, L)
        mutated = mutate.kernel_rows(
            child.reshape(N * K, L), r, r2, q, q2, rate, sigma, true_len=L,
        ).reshape(N, K, L)
        child = torch.where(may_mutate[..., None], mutated, child)
    elif mutate == "point":
        pos = torch.floor(u[..., 0] * L).to(torch.int64)
        fire = (u[..., 1] < rate) & may_mutate
        hit = (cols == pos[..., None]) & fire[..., None]
        child = torch.where(hit, u[..., 2:3], child)
    elif mutate == "gaussian":
        gate, u1, u2 = draws.gauss
        u1 = torch.clamp(u1, 1e-7, 1.0 - 1e-7)
        two_pi = 2.0 * torch.tensor(math.pi, dtype=torch.float32)
        normal = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
        mutated = torch.clamp(child + sigma * normal, 0.0, 1.0 - 1e-7)
        fire = (gate < rate) & may_mutate[..., None]
        child = torch.where(fire, mutated, child)
    elif mutate == "swap":
        pi = torch.floor(u[..., 0] * L).to(torch.int64)
        pj = torch.floor(u[..., 1] * L).to(torch.int64)
        fire = ((u[..., 2] < rate) & may_mutate)[..., None]
        ohi = cols == pi[..., None]
        ohj = cols == pj[..., None]
        gi = torch.sum(torch.where(ohi, child, 0.0), dim=-1, keepdim=True)
        gj = torch.sum(torch.where(ohj, child, 0.0), dim=-1, keepdim=True)
        child = torch.where(ohi & fire, gj, child)
        child = torch.where(ohj & fire, gi, child)
    else:
        raise ValueError(f"unknown mutate kind {mutate!r}; one of {MUTATE_KINDS}")
    return child


def _expr_inputs(draws: Draws, first: int, rows: int, L: int):
    """``(r, r2, q, q2)`` of one expression operator, as ``kernel_rows``
    takes them: per-gene (rows, L), per-row (rows, 1); ``first`` is 0
    for the crossover's streams, 2 for the mutation's."""
    g, w = draws.expr_gene, draws.expr_row
    return (
        g[first].reshape(rows, L), g[first + 1].reshape(rows, L),
        w[..., first].reshape(rows, 1), w[..., first + 1].reshape(rows, 1),
    )


def tsp_scores(
    child: torch.Tensor, coords: torch.Tensor, penalty: float
) -> torch.Tensor:
    """The fused TSP score of ``child`` (..., L): -(open-path length +
    penalty x (L - distinct cities)), each edge ``sqrt(dx^2 + dy^2 +
    1e-12)`` with the coordinate lookup clamped to C-1, the edges summed
    one by one in l order as the kernel sums them (JAX's
    ``_tsp_eval_gene_major`` does too)."""
    L = child.shape[-1]
    cities = tsp_cities(child.reshape(-1, L))
    edge = tour_edges(cities, coords)
    total = torch.zeros(cities.shape[0], device=child.device)
    for l in range(L - 1):
        total = total + edge[:, l]
    dups = duplicate_genes(cities)
    return (-(total + penalty * dups)).reshape(child.shape[:-1])


def rowwise_scores(obj_id: int, child: torch.Tensor, warp_order: bool = False) -> torch.Tensor:
    """The score of a rowwise-fused objective over ``child`` (..., L),
    with the float32 constants and operation order of
    ``objectives/classic.py`` (the kernels' ``obj_add`` and
    ``obj_finish``). ``warp_order`` sums the per-gene terms as the
    breed kernels do (``objectives/expr.warp_order_sum``), so the result
    equals theirs exactly; otherwise ``torch.sum`` (within a few ulps)."""
    L = child.shape[-1]
    total = warp_order_sum if warp_order else (lambda x: torch.sum(x, dim=-1))
    if obj_id == FUSED_ONEMAX_BITS:
        return total((child >= 0.5).to(torch.float32))
    if obj_id == FUSED_SPHERE:
        x = -5.12 + child * 10.24
        return -total(x * x)
    if obj_id == FUSED_RASTRIGIN:
        x = -5.12 + child * 10.24
        return -(10.0 * L + total(x * x - 10.0 * torch.cos(2.0 * math.pi * x)))
    if obj_id == FUSED_ACKLEY:
        x = -32.768 + child * 65.536
        s1 = torch.sqrt(total(x * x) / L)
        s2 = total(torch.cos(2.0 * math.pi * x)) / L
        return -(-20.0 * torch.exp(-0.2 * s1) - torch.exp(s2) + 20.0 + math.e)
    return total(child)  # onemax


def fused_scores(
    obj_id: int, child: torch.Tensor, coords: Optional[torch.Tensor] = None,
    penalty: float = 0.0, objective: Optional[Callable] = None,
) -> torch.Tensor:
    """The scores the one-generation kernels compute for a fused
    objective id (``FUSED_TSP`` reads ``coords`` (C, 2) and
    ``penalty``) or an expression objective (``objective``, a
    ``from_expression`` objective: its ``kernel_rowwise`` in the
    kernels' lane order), up to the order of the builtin ids' float32
    sums."""
    if objective is not None:
        L = child.shape[-1]
        return objective.kernel_rowwise(child.reshape(-1, L), warp_order=True).reshape(
            child.shape[:-1])
    if obj_id in ROWWISE_FUSED:
        return rowwise_scores(obj_id, child)
    if obj_id == FUSED_TSP:
        return tsp_scores(child, coords, penalty)
    raise ValueError(f"objective id {obj_id} is not fused")


def deme_breed_reference(
    genomes: torch.Tensor,
    ranks: torch.Tensor,
    geom: Geometry,
    parity: int,
    draws: Draws,
    *,
    tournament_size: int = 2,
    selection: str = "tournament",
    selection_param: Optional[float] = None,
    mutate="point",
    mparams: torch.Tensor,
    obj_id: int = FUSED_NONE,
    out: Optional[torch.Tensor] = None,
    crossover="uniform",
    coords: Optional[torch.Tensor] = None,
    penalty: float = 0.0,
    objective: Optional[Callable] = None,
    ablate: Sequence[str] = (),
    demes_per_block: int = 1,
    warps_per_block: int = 0,
):
    """The plain version of the deme-breed kernels (uniform crossover:
    ``deme_breed_kernel`` and ``deme_pipelined_kernel``; order crossover: ``order_breed_kernel``; an
    expression crossover, mutation or ``objective``:
    ``expr_breed_kernel``, with order crossover ``expr_order_kernel``,
    which also takes the coordinate TSP after an expression mutation): one
    generation over all ``G`` demes of ``genomes`` (Pp, L), children
    placed by the parity's row map. A deme's valid count V is how many
    of its read rows are real (< P), at least 1: the ping-pong
    alive-mask sum and the riffle's positional ``max(min(K, P - g*K),
    1)`` are both this. ``coords``/``penalty`` serve ``FUSED_TSP``;
    ``objective`` (a ``from_expression`` objective) scores in place of
    ``obj_id``. Returns ``(children (Pp, L), scores (Pp,) or None)``; scores of pad
    rows (>= P) are -inf. bfloat16 ``genomes`` breed in float32 and the
    children are rounded once to bfloat16; the scores are of the rounded
    children.

    Islands: ``genomes`` (I, Pp, L), ``ranks`` (I*G, K) and ``draws``
    with a leading island axis breed every island's demes as the demes
    of one population (island i's deme g is deme i*G + g) and give
    ``(children (I, Pp, L), scores (I, Pp) or None)``: island i's rows
    are what the single-population breed of island i's tensors gives.

    ``ablate`` (the floor harness): with ``copy_only``, whatever the
    hooks, every cohort row is copied to its child's row, ``ranks`` holds the
    float32 score each copied row is handed (the scores themselves under
    ``no_rank_sort``) and ``draws`` is not read (``demes_per_block``
    and ``warps_per_block``, the kernel's block shape, change nothing
    here; ``out`` may be ``genomes``); the stage flags go to
    :func:`breed_children`."""
    del demes_per_block, warps_per_block
    read, write = geom.row_maps(parity, genomes.device)
    lead, Pp, L = genomes.shape[:-2], geom.Pp, geom.L
    n = genomes[..., 0, 0].numel()
    cohorts = genomes.reshape(n, Pp, L)[:, read].reshape(-1, geom.K, L)
    copy = "copy_only" in ablate
    if copy:
        child = cohorts
    else:
        valid = torch.clamp((read < geom.P).sum(dim=1), min=1).to(torch.float32).repeat(n)
        child = breed_children(
            cohorts.float(), ranks, valid, draws.flat() if lead else draws,
            tournament_size=tournament_size, selection=selection,
            selection_param=selection_param, mutate=mutate, mparams=mparams,
            crossover=crossover, ablate=ablate,
        ).to(genomes.dtype)
    if out is None:
        out = torch.empty_like(genomes)
    out.view(n, Pp, L)[:, write.reshape(-1)] = child.reshape(n, -1, L)
    if obj_id == FUSED_NONE and objective is None:
        return out, None
    if copy:
        s = ranks.reshape(n, geom.G, geom.K)
    else:
        s = fused_scores(obj_id, child.float(), coords, penalty, objective).reshape(
            n, geom.G, geom.K)
    s = torch.where(write >= geom.P, -torch.inf, s)
    scores = torch.empty(lead + (Pp,), device=genomes.device)
    scores.view(n, Pp)[:, write.reshape(-1)] = s.reshape(n, -1)
    return out, scores


def breed_launcher(geom: Geometry, gene_dtype, kw: dict) -> Callable:
    """The kernel wrapper a breed of CUDA genomes launches, chosen from the
    hooks in ``kw`` and the shape alone, before any launch: with an
    expression hook the expression breed (``kernels.expr_breed_cuda``,
    which picks ``expr_pipelined_kernel`` or ``expr_breed_kernel`` from
    the shape in the same way: ``kernels.expr_pipelined_holds``), with
    order crossover the order
    breed, else the deme breed, pipelined (``deme_pipelined_kernel``) at
    any sub-block depth B where a cluster of blocks holds a deme
    (``kernels.pipelined_holds``). A deme no cluster holds, and the floor
    harness's copy (``copy_only``, which pins the riffle), are bred by
    ``deme_breed_kernel`` at the same geometry, which computes the same
    function and counts under its own name."""
    if _expression_hooked(kw):
        return kernels.expr_breed_cuda
    if kw.get("crossover") == "order":
        return kernels.order_breed_cuda
    copy = "copy_only" in kw.get("ablate", ())
    return functools.partial(kernels.deme_breed_cuda,
                             pipelined=not copy and kernels.pipelined_holds(geom, gene_dtype))


def deme_breed(
    genomes: torch.Tensor,
    ranks: torch.Tensor,
    geom: Geometry,
    parity: int,
    *,
    seed: Optional[torch.Tensor] = None,
    draws: Optional[Draws] = None,
    out: Optional[torch.Tensor] = None,
    islands: Optional[int] = None,
    **kw,
):
    """One breed launch. On a CUDA tensor it launches the kernel of the
    hooks and the shape (:func:`breed_launcher`) and raises if that fails;
    on a CPU tensor it runs the plain version. Exactly one of
    ``seed`` (int64 tensor of one element: production Philox mode) or
    ``draws`` (injected mode) is given. ``islands`` = I breeds I
    populations in one launch of that kernel (see
    :func:`deme_breed_reference`; one seed per island, (I,)). The floor
    harness's copy (``kw["ablate"]`` with ``copy_only``, the builtin
    hooks: ``make_fused_breed`` routes every hook set's copy there) draws
    nothing and takes neither."""
    copy = "copy_only" in kw.get("ablate", ())
    if (seed is None) == (draws is None) and not copy:
        raise ValueError("pass exactly one of seed= or draws=")
    if genomes.is_cuda:
        return breed_launcher(geom, genomes.dtype, kw)(
            genomes, ranks, geom, parity, seed=seed, draws=draws, out=out, islands=islands,
            **kw,
        )
    if draws is None and not copy:
        draw = philox_draws if islands is None else island_philox_draws
        draws = draw(
            seed, geom.G, geom.K, geom.L, kw.get("mutate", "point"),
            kw.get("crossover", "uniform"),
        )
    return deme_breed_reference(
        genomes, ranks, geom, parity, draws, out=out, **kw
    )


def multigen_breed_reference(
    genomes: torch.Tensor,
    scores: torch.Tensor,
    geom: Geometry,
    parity: int,
    steps: int,
    target: float = math.inf,
    *,
    seed: Optional[torch.Tensor] = None,
    draws: Optional[Draws] = None,
    tournament_size: int = 2,
    selection: str = "tournament",
    selection_param: Optional[float] = None,
    mutate="point",
    mparams: torch.Tensor,
    obj_id: int = FUSED_NONE,
    elitism: int = 0,
    out: Optional[torch.Tensor] = None,
    crossover="uniform",
    objective: Optional[Callable] = None,
    ablate: Sequence[str] = (),
):
    """The plain version of the multi-generation kernels
    (``multigen_breed_kernel``; with an expression crossover, mutation
    or ``objective``, ``expr_multigen_kernel``) and of
    ``_multigen_kernel``: ``steps`` generations of every group of
    ``geom`` (``S`` groups of ``D`` demes), the demes fixed for the
    launch in the parity's cohort order. Order crossover walks each
    sub-generation's children as :func:`breed_children` does; an elite
    child is its parent verbatim, set after the walk as in JAX.

    ``genomes`` (Pp, L) and raw ``scores`` (Pp,) come in physical order
    (pad rows: any genes, -inf). A cohort slot is alive when its read
    row is below P; a deme's valid count V is its alive slots, at least
    1. Each sub-generation t: a group whose best alive score has reached
    ``target`` is frozen (a NaN among them compares false) and keeps its
    rows and scores; every other deme is ranked by
    :func:`kernel_ranks`, bred by :func:`breed_children` with
    ``elite_rows=elitism`` (children 0..e-1 copy ranks 0..e-1, no hook
    applied) and scored in the kernel's summation order: a builtin
    rowwise-fused ``obj_id``, or the expression ``objective`` (a
    ``from_expression`` objective) through its ``kernel_rowwise(...,
    warp_order=True)``. bfloat16 ``genomes`` breed each child in float32
    and store it rounded to bfloat16: its score, and the next
    sub-generation's parents, are the rounded genes. ``crossover`` /
    ``mutate`` are builtin kinds or
    expression operators (``ops/breed_expr.py``). The draws of
    sub-generation t are ``draws.at(t)`` (injected) or the Philox draws
    of ``seed`` with ``t`` as the fourth counter word, the same whether
    or not a group is frozen. At the end child k of deme g lands at the
    parity's write row, scores beside it, -inf on rows >= P. ``steps``
    0 is that permutation alone.

    Returns ``(genomes (Pp, L), scores (Pp,))``; rows go into ``out``
    when given.

    Islands: ``genomes`` (I, Pp, L) and ``scores`` (I, Pp), ``seed``
    (I,) one per island, or injected ``draws`` (I, T, ...): every
    island's groups breed as the groups of one population, and island
    i's rows are what the single-population launch of island i's
    tensors gives.

    ``ablate`` (the floor harness): ``no_freeze`` freezes no group,
    ``no_rank_cube`` ranks every deme in slot order (rank r is slot r),
    and the stage flags go to :func:`breed_children`."""
    if (seed is None) == (draws is None):
        raise ValueError("pass exactly one of seed= or draws=")
    if objective is None and obj_id not in ROWWISE_FUSED:
        raise ValueError(f"objective id {obj_id} has no rowwise fused form: multigen needs one")
    G, K, L, D, Pp = geom.G, geom.K, geom.L, geom.D, geom.Pp
    lead = genomes.shape[:-2]
    n = genomes[..., 0, 0].numel()
    read, write = geom.row_maps(parity, genomes.device)
    alive = (read < geom.P).repeat(n, 1)
    valid = torch.clamp(alive.sum(dim=1), min=1).to(torch.float32)
    g = genomes.reshape(n, Pp, L)[:, read].reshape(n * G, K, L)
    s = scores.reshape(n, Pp)[:, read].reshape(n * G, K)
    for t in range(int(steps)):
        best = torch.where(alive, s, -torch.inf).reshape(n * geom.S, D * K).amax(dim=1)
        frozen = (best >= target).repeat_interleave(D)[:, None]  # (n*G, 1); NaN: False
        if "no_freeze" in ablate:
            frozen = torch.zeros_like(frozen)
        if draws is not None:
            d = draws.at(t, axis=1).flat() if lead else draws.at(t)
        else:
            draw = philox_draws if not lead else island_philox_draws
            d = draw(seed, G, K, L, mutate, crossover, sub_generation=t, tie=True)
            d = d.flat() if lead else d
        if "no_rank_cube" in ablate:  # rank r is slot r
            ranks = torch.arange(K, device=s.device, dtype=torch.int32).repeat(n * G, 1)
        else:
            ranks = kernel_ranks(s, d.tie, alive)
        child = breed_children(
            g.float(), ranks, valid, d,
            tournament_size=tournament_size, selection=selection,
            selection_param=selection_param, mutate=mutate, mparams=mparams,
            elite_rows=elitism, crossover=crossover, ablate=ablate,
        ).to(g.dtype)
        stored = child.float()
        if objective is not None:
            cs = objective.kernel_rowwise(stored.reshape(-1, L), warp_order=True).reshape(n * G, K)
        else:
            cs = rowwise_scores(obj_id, stored, warp_order=True)
        s = torch.where(frozen, s, cs)
        g = torch.where(frozen[..., None], g, child)
    if out is None:
        out = torch.empty_like(genomes)
    out.view(n, Pp, L)[:, write.reshape(-1)] = g.reshape(n, -1, L)
    s_out = torch.empty(lead + (Pp,), device=genomes.device)
    s = torch.where(write >= geom.P, -torch.inf, s.reshape(n, G, K))
    s_out.view(n, Pp)[:, write.reshape(-1)] = s.reshape(n, -1)
    return out, s_out


def multigen_breed(
    genomes: torch.Tensor,
    scores: torch.Tensor,
    geom: Geometry,
    parity: int,
    steps: int,
    target: Optional[float] = None,
    *,
    out: Optional[torch.Tensor] = None,
    work=None,
    islands: Optional[int] = None,
    **kw,
):
    """One multi-generation launch: ``steps`` generations of every group
    (see :func:`multigen_breed_reference`). On a CUDA tensor it launches
    the kernel of the hooks (an expression crossover, mutation or
    ``kw["objective"]``: ``expr_multigen_kernel``; else
    ``multigen_breed_kernel``; each wrapper picks its schedule from the
    shape) and raises if that fails (``work``: the one-block schedule's
    scratch buffers, made by the wrapper where None; ``kw["cluster"]``
    names either kernel's schedule, for tests and comparisons); on a
    CPU tensor it runs the plain version. Exactly one of ``seed=``
    (production Philox mode) or ``draws=`` (injected mode, with a leading
    sub-generation axis) is given in ``kw``. ``islands`` = I breeds I
    populations in one launch of that kernel (one seed per island)."""
    target = math.inf if target is None else float(target)
    if genomes.is_cuda:
        launch = (kernels.expr_multigen_cuda if _expression_hooked(kw)
                  else kernels.multigen_breed_cuda)
        return launch(genomes, scores, geom, parity, steps, target, out=out, work=work,
                      islands=islands, **kw)
    kw.pop("cluster", None)
    return multigen_breed_reference(genomes, scores, geom, parity, steps, target, out=out, **kw)


def carry_elites(g_prev, s_prev, g2, s2, elitism: int) -> None:
    """Top-e of the previous generation into rows 0..e-1 of the new
    one, scores included (``_carry_elites``), in ``lax.top_k``'s order
    (``ops/topk.py``); with a leading island axis, per island. Pad rows
    carry -inf, so they are never elites. Updates ``g2``/``s2`` in
    place."""
    top_s, top_i = top_k(s_prev, elitism)
    g2[..., :elitism, :] = torch.take_along_dim(g_prev, top_i[..., None], dim=-2)
    s2[..., :elitism] = top_s


# ---------------------------------------------------------------------
# Breed and run loop
# ---------------------------------------------------------------------


def make_fused_breed(
    pop_size: int,
    genome_len: int,
    objective: Optional[Callable],
    *,
    deme_size: Optional[int] = None,
    tournament_size: int = 2,
    selection: str = "tournament",
    selection_param: Optional[float] = None,
    crossover="uniform",
    mutate="point",
    mparams: Sequence[float] = (0.01, 0.0),
    elitism: int = 0,
    layout: Optional[str] = None,
    device="cuda",
    gene_dtype=torch.float32,
    ablate: Sequence[str] = (),
    demes_per_block: int = 1,
    warps_per_block: int = 0,
    subblock: Optional[int] = None,
):
    """One generation of the deme path for a fixed shape and objective,
    the counterpart of ``make_pallas_breed``'s breed: ranks, one launch
    of the kernel of the hooks, unfused scoring where the objective has
    no fused form, elitism. ``crossover`` / ``mutate`` are builtin kind
    names or expression operators (``ops/breed_expr.py``); the objective
    fuses by its builtin ``fused_id`` or its expression form
    (``expr_fused``; one with kernel constants is const-carrying, which
    shapes the geometry as in JAX). ``mparams`` is the mutation's [rate,
    sigma]; ``layout`` forces a row map (JAX's ``pallas_layout``);
    ``gene_dtype`` (float32 or bfloat16) shapes the geometry and is the
    genomes' dtype; ``subblock`` (JAX's ``pallas_subblock``) is the
    ping-pong sub-block depth of :func:`resolve_geometry`; at any B the
    builtin hooks launch the pipelined deme breed where a cluster holds a
    deme (:func:`breed_launcher`). The fused TSP score pairs with order crossover only (with a builtin or
    an expression mutation): with uniform crossover that objective is
    scored by its rowwise form, as in JAX. Returns
    ``breed(genomes (Pp, L), scores (Pp,), parity, generator, out=None)
    -> (genomes, scores)``, both in physical row order; children go into
    ``out`` when given (never ``genomes`` itself). ``breed.geom`` is the
    geometry.

    The floor harness (``libpga_tpu_torch/tools/ablate_floor.py``,
    ``ablate_kernel.py``; JAX's ``make_pallas_breed(_ablate=...)``):
    ``objective`` None breeds without scoring (JAX's ``fused_obj=None``;
    the breed returns ``(children, None)``), and ``ablate`` (flags of
    ``VALID_ABLATE``, checked by :func:`validate_ablate`) launches an
    ablated case, with any crossover, mutation and objective.
    ``copy_only`` copies every row to its child's row whatever the hooks
    (the builtin copy, as JAX's copy branch returns before a hook runs;
    under order crossover at the order geometry), ``demes_per_block``
    demes and ``warps_per_block`` warps (0: the breed's 8) per block of
    the kernel, each copied row handed the deme ranks as its score (the
    scores under ``no_rank_sort``); ``no_riffle`` takes the contiguous
    row map and ``alias_io`` copies in place; ``no_rank_sort`` skips the
    rank sort (the breeding cases then get slot-order ranks); the stage
    flags, in any combination, remove parts of the breed
    (:func:`breed_children`), at any B: the builtin hooks launch the
    pipelined deme breed's case of the flags where a cluster holds the
    deme, and expression hooks the expression breed's, on the B-aware row
    maps."""
    ablate = validate_ablate(ablate)
    obj_id = getattr(objective, "fused_id", FUSED_NONE)
    expr_obj = getattr(objective, "expr_fused", None)
    if expr_obj is not None:
        obj_id = FUSED_NONE
    if obj_id == FUSED_TSP and crossover != "order":
        obj_id = FUSED_NONE
    for op in (crossover, mutate, expr_obj):
        pin = getattr(op, "pinned_genome_len", None)
        if pin and pin != genome_len:
            raise ValueError(
                f"expression {op.expression!r} uses length-{pin} vector constants but"
                f" the population genome length is {genome_len}"
            )
    copy = "copy_only" in ablate
    if (demes_per_block != 1 or warps_per_block) and not copy:
        raise ValueError("demes_per_block and warps_per_block are the copy's"
                         " (ablate copy_only)")
    if elitism and objective is None:
        raise ValueError("a breed without an objective scores nothing to carry elites by")
    geom = resolve_geometry(
        pop_size, genome_len, deme_size=deme_size,
        tournament_size=tournament_size, selection=selection,
        selection_param=selection_param,
        fused=obj_id != FUSED_NONE or expr_obj is not None,
        crossover=crossover, layout=layout,
        const_carrying=bool(getattr(expr_obj, "kernel_rowwise_consts", ())),
        gene_dtype=gene_dtype, ablate=ablate, subblock=subblock,
    )
    if geom is None:
        raise ValueError(
            f"no deme geometry for {pop_size}x{genome_len}: the deme path"
            " needs >= 128 rows, a padded tail of >= K/4 rows, tournament_size"
            " in 1..16 and, with order crossover, float32 genes and a K whose"
            " walk scratch fits (PGA.run takes the panmictic path there)"
        )
    kw = dict(
        tournament_size=tournament_size, selection=selection,
        selection_param=selection_param, mutate=mutate, obj_id=obj_id,
        mparams=torch.tensor(list(mparams), dtype=torch.float32, device=device),
        crossover=crossover,
    )
    if obj_id == FUSED_TSP:
        kw.update(coords=objective.coords.to(device), penalty=objective.penalty)
    if expr_obj is not None:
        kw.update(objective=expr_obj)
    if ablate:
        kw.update(ablate=ablate)
    if copy:
        # The builtin copy runs no hook: of the breed it replaces it keeps
        # only whether it is scored, which any rowwise objective id says.
        scored = obj_id != FUSED_NONE or expr_obj is not None
        kw = dict(mparams=kw["mparams"], obj_id=FUSED_ONEMAX if scored else FUSED_NONE,
                  ablate=ablate, demes_per_block=demes_per_block, warps_per_block=warps_per_block)
    slot_ranks = {}  # no_rank_sort's ranks of the breeding cases, per device

    def breed(genomes, scores, parity, generator, out=None):
        dev = genomes.device
        if "alias_io" in ablate:
            out = genomes
        if "no_rank_sort" not in ablate:
            ranks = compute_ranks(scores, geom, parity, draw_tie_words(generator, geom.Pp, dev))
            ranks = ranks.float() if copy else ranks
        elif copy:
            ranks = scores.view(geom.G, geom.K)
        else:
            if dev not in slot_ranks:
                slot_ranks[dev] = torch.arange(
                    geom.K, device=dev, dtype=torch.int32).repeat(geom.G, 1)
            ranks = slot_ranks[dev]
        seed = None if copy else torch.randint(
            0, 2**63 - 1, (1,), generator=generator, device=dev,
        )
        g2, s2 = deme_breed(genomes, ranks, geom, parity, seed=seed, out=out, **kw)
        if s2 is None and objective is not None:
            s2 = torch.full((geom.Pp,), -torch.inf, device=dev)
            s2[: geom.P] = evaluate(objective, g2[: geom.P])
        if elitism:
            carry_elites(genomes, scores, g2, s2, elitism)
        return g2, s2

    breed.geom = geom
    breed.kw = kw
    return breed


def make_fused_run(pop_size: int, genome_len: int, objective: Callable, **kw):
    """The run loop of ``make_pallas_run``: pad once to Pp, score the
    initial population, alternate the parity by generation, and stop at
    the first generation whose best score reaches the target or is NaN
    (``ops/step.run_generations``), which is the one returned. ``kw``
    goes to :func:`make_fused_breed`. Returns ``run(genomes (P, L), n,
    target, generator) -> (genomes (P, L), scores (P,), gens)``.

    The children of a generation go to the buffer that held the one
    before, so the previous generation is intact when its stop flag is
    read, one generation late."""
    breed = make_fused_breed(pop_size, genome_len, objective, **kw)
    geom = breed.geom

    def run(genomes, n, target, generator):
        P, Pp, L = geom.P, geom.Pp, geom.L
        g = torch.zeros((Pp, L), device=genomes.device, dtype=genomes.dtype)
        g[:P] = genomes
        s = torch.full((Pp,), -torch.inf, device=genomes.device)
        s[:P] = evaluate(objective, genomes)
        spare = [torch.empty_like(g)]

        def step(g, s, gen):
            g2, s2 = breed(g, s, gen % geom.parities, generator, out=spare[0])
            spare[0] = g
            return g2, s2

        g, s, gens = run_generations(step, g, s, n, target)
        return g[:P], s[:P], gens

    return run


def make_fused_multigen(
    pop_size: int,
    genome_len: int,
    objective: Callable,
    *,
    deme_size: Optional[int] = None,
    tournament_size: int = 2,
    selection: str = "tournament",
    selection_param: Optional[float] = None,
    crossover="uniform",
    mutate="point",
    mparams: Sequence[float] = (0.01, 0.0),
    elitism: int = 0,
    layout: Optional[str] = None,
    device="cuda",
    gene_dtype=torch.float32,
    ablate: Sequence[str] = (),
    subblock: Optional[int] = None,
):
    """The multi-generation breed for a fixed shape and objective, the
    counterpart of ``make_pallas_multigen`` (``gene_dtype``: the genomes'
    dtype, float32 or bfloat16, which shapes the geometry; ``subblock``
    is accepted and ignored, as JAX's factory ignores ``_subblock``: the
    sub-block pipeline is the one-generation kernel's). ``crossover`` / ``mutate``
    are builtin kind names or expression operators; the objective fuses
    by its builtin rowwise ``fused_id`` or its expression form
    (``expr_fused``; one with kernel constants is const-carrying, which
    shapes the geometry as in JAX). Returns ``launch(genomes (Pp, L),
    scores (Pp,), parity, steps, target, generator, out=None, work=None)
    -> (genomes, scores)`` in physical row order, with ``launch.geom``;
    ``elitism`` is per deme, inside the kernel.

    None where the JAX factory declines: the objective has neither a
    rowwise fused form nor an expression form (the coordinate TSP's
    fused score is gene-major, not rowwise), the geometry declines (for
    order crossover: no K whose walk scratch fits the multi-generation
    model), or ``elitism >= K // 4``.

    ``ablate`` (the floor harness; JAX's ``make_pallas_multigen(_ablate=
    ...)``, with any crossover, mutation and objective): ``no_freeze``,
    ``no_rank_cube`` and the stage flags, checked by
    :func:`validate_ablate`."""
    del subblock
    ablate = validate_ablate(ablate, multigen=True)
    expr_obj = getattr(objective, "expr_fused", None)
    obj_id = FUSED_NONE if expr_obj is not None else getattr(objective, "fused_id", FUSED_NONE)
    if expr_obj is None and obj_id not in ROWWISE_FUSED:
        return None
    for op in (crossover, mutate, expr_obj):
        pin = getattr(op, "pinned_genome_len", None)
        if pin and pin != genome_len:
            raise ValueError(
                f"expression {op.expression!r} uses length-{pin} vector constants but"
                f" the population genome length is {genome_len}"
            )
    geom = resolve_geometry(
        pop_size, genome_len, deme_size=deme_size,
        tournament_size=tournament_size, selection=selection,
        selection_param=selection_param, crossover=crossover, layout=layout,
        multigen=True, elitism=elitism,
        const_carrying=bool(getattr(expr_obj, "kernel_rowwise_consts", ())),
        gene_dtype=gene_dtype,
    )
    if geom is None:
        return None
    kw = dict(
        tournament_size=tournament_size, selection=selection,
        selection_param=selection_param, mutate=mutate, obj_id=obj_id,
        mparams=torch.tensor(list(mparams), dtype=torch.float32, device=device),
        elitism=elitism, crossover=crossover,
    )
    if expr_obj is not None:
        kw.update(objective=expr_obj)
    if ablate:
        kw.update(ablate=ablate)

    def launch(genomes, scores, parity, steps, target, generator, out=None, work=None):
        seed = torch.randint(
            0, 2**63 - 1, (1,), generator=generator, device=genomes.device,
        )
        return multigen_breed(
            genomes, scores, geom, parity, steps, target, seed=seed, out=out,
            work=work, **kw,
        )

    launch.geom = geom
    launch.kw = kw
    return launch


def make_multigen_run(
    pop_size: int, genome_len: int, objective: Callable, generations_per_launch: int, **kw
):
    """The run loop of ``_multigen_run_loop`` over :func:`make_fused_multigen`
    (``kw``), or None where that declines. Returns ``run(genomes (P, L),
    n, target, generator) -> (genomes (P, L), scores (P,), gens)``: pad
    once to Pp, score generation 0, then launch chunks of
    ``min(T, n - gens)`` generations, the parity alternating by launch,
    until ``n`` or the first launch whose best reaches the target or is
    NaN. The count lands exactly on ``n``; a target stop is reported at
    launch granularity (a multiple of T), its achiever kept by the
    kernel's group freeze.

    A launch's children go to the buffer that held the launch before,
    and the kernel's work buffers (the one-block schedule's alone, made
    by the wrapper at each launch: the cluster schedule keeps a group in
    shared memory) are neither, so the previous launch is intact when its
    stop flag is read one launch late
    (``ops/step.run_generations``)."""
    T = int(generations_per_launch)
    launch = make_fused_multigen(pop_size, genome_len, objective, **kw)
    if launch is None:
        return None
    geom = launch.geom

    def run(genomes, n, target, generator):
        P, Pp, L = geom.P, geom.Pp, geom.L
        g = torch.zeros((Pp, L), device=genomes.device, dtype=genomes.dtype)
        g[:P] = genomes
        s = torch.full((Pp,), -torch.inf, device=genomes.device)
        s[:P] = evaluate(objective, genomes)
        spare = [torch.empty_like(g)]

        def step(g, s, gen):
            g2, s2 = launch(
                g, s, (gen // T) % geom.parities, min(T, n - gen), target,
                generator, out=spare[0],
            )
            spare[0] = g
            return g2, s2

        g, s, gens = run_generations(step, g, s, n, target, stride=T)
        return g[:P], s[:P], gens

    run.geom = geom
    return run


# ---------------------------------------------------------------------
# Islands: every island's generation in one launch
# ---------------------------------------------------------------------


def make_island_breed(
    island_size: int, genome_len: int, objective: Callable, islands: int, *,
    elitism: int = 0, device="cuda", **kw,
):
    """One generation of I equal islands, the counterpart of the island
    path's use of ``make_pallas_breed`` (``engine._pallas_island_breed``
    and ``islands.make_stacked_pallas_epoch``): one rank sort over every
    island's demes (:func:`compute_ranks` on (I, Pp) scores), one seed
    per island, then ONE launch of the kernel of the hooks (the deme- or
    order-breed kernel, or with an expression crossover, mutation or
    objective the expression kernel) with the islands as a second grid
    axis. An objective without a fused form is
    scored by its rowwise form on the real rows. Where the kernel scores
    the children (``breed.fused``), ``elitism`` carries each island's
    top-e into its rows 0..e-1 after the breed; otherwise the breed
    carries none and the island epoch applies it after the scoring, as
    JAX's does. ``kw`` and the geometry are :func:`make_fused_breed`'s
    at the island size (which, unlike JAX's island path, also fuses the
    coordinate TSP's score with order crossover).

    Returns ``breed(genomes (I, Pp, L), scores (I, Pp), parity,
    generator, out=None) -> (genomes, scores)``, children into ``out``
    when given (never ``genomes`` itself). ``breed.geom`` is the island
    geometry, ``breed.fused`` whether the kernel scores the children,
    ``breed.launches`` the kernel launches it has made and ``breed.kw``
    the keywords of its launch (:func:`deme_breed`'s)."""
    single = make_fused_breed(island_size, genome_len, objective, device=device, **kw)
    geom, bkw = single.geom, single.kw
    fused = bkw["obj_id"] != FUSED_NONE or "objective" in bkw
    carry = elitism if fused else 0
    P, Pp, L = geom.P, geom.Pp, geom.L

    def breed(genomes, scores, parity, generator, out=None):
        dev = genomes.device
        tie = draw_tie_words(generator, islands * Pp, dev).view(islands, Pp)
        ranks = compute_ranks(scores, geom, parity, tie)
        seeds = torch.randint(0, 2**63 - 1, (islands,), generator=generator, device=dev)
        if out is None:
            out = torch.empty_like(genomes)
        _, s2 = deme_breed(genomes, ranks, geom, parity, seed=seeds, out=out,
                           islands=islands, **bkw)
        breed.launches += 1
        if s2 is None:
            s2 = torch.full((islands, Pp), -torch.inf, device=dev)
            s2[:, :P] = evaluate(objective, out[:, :P].reshape(-1, L)).view(islands, P)
        if carry:
            carry_elites(genomes, scores, out, s2, carry)
        return out, s2

    breed.geom = geom
    breed.kw = bkw
    breed.fused = fused
    breed.islands = islands
    breed.launches = 0
    return breed


def make_island_multigen(
    island_size: int, genome_len: int, objective: Callable, islands: int,
    generations_per_launch: int, **kw,
):
    """Several generations of I equal islands per launch, the
    counterpart of the island path's ``make_pallas_multigen``: ONE
    launch of the multi-generation kernel of the hooks (builtin or
    expression) with the islands as a second grid axis and one seed per
    island. ``kw`` and the geometry are :func:`make_fused_multigen`'s
    at the island size; None where it declines.

    Returns ``launch(genomes (I, Pp, L), scores (I, Pp), parity, steps,
    target, generator, out=None, work=None) -> (genomes, scores)`` with
    ``launch.geom``, ``launch.epoch_chunk`` (T, the generations a launch
    breeds at most), ``launch.multigen`` and ``launch.launches``."""
    single = make_fused_multigen(island_size, genome_len, objective, **kw)
    if single is None:
        return None
    geom, mkw = single.geom, single.kw

    def launch(genomes, scores, parity, steps, target, generator, out=None, work=None):
        seeds = torch.randint(0, 2**63 - 1, (islands,), generator=generator,
                              device=genomes.device)
        if out is None:
            out = torch.empty_like(genomes)
        _, s2 = multigen_breed(genomes, scores, geom, parity, steps, target, seed=seeds,
                               out=out, work=work, islands=islands, **mkw)
        launch.launches += 1
        return out, s2

    launch.geom = geom
    launch.epoch_chunk = int(generations_per_launch)
    launch.multigen = True
    launch.fused = True
    launch.launches = 0
    return launch
