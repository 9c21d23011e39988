"""Classic GA objectives in rowwise form: ``(P, L) float32 -> (P,)``,
higher is better. Torch counterparts of the rowwise forms in
``libpga_tpu/objectives/classic.py``, with the same float32 constants
and operation order.

``fused_id`` marks the objectives the deme-breed kernels score inside
the breed (``csrc/deme_breed.cu``): every builtin the JAX package gives a
``kernel_rowwise`` form (1 = onemax, 2 = onemax_bits, 4 = sphere,
5 = rastrigin, 6 = ackley: ``ROWWISE_FUSED``, which also admit several
generations per launch), and 3 = the coordinate TSP of
``make_tsp_coords(duplicate_mode="genes")``, fused only with order
crossover. An objective without an id is scored by its rowwise form
after an unfused breed, unless it carries ``expr_fused``: an equivalent
``from_expression`` objective that the expression breed kernel
(``csrc/expr_breed.cu``, generated hooks) scores inside the breed. The
knapsack, the NK landscape (``2**(k+1) <= 64``) and the deceptive trap
carry one; the knapsack and NK read their problem data as kernel
constants (const-carrying, which shapes the deme geometry as in JAX).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from libpga_tpu_torch.objectives.expr import from_expression

FUSED_NONE, FUSED_ONEMAX, FUSED_ONEMAX_BITS, FUSED_TSP = 0, 1, 2, 3
FUSED_SPHERE, FUSED_RASTRIGIN, FUSED_ACKLEY = 4, 5, 6
ROWWISE_FUSED = (
    FUSED_ONEMAX, FUSED_ONEMAX_BITS, FUSED_SPHERE, FUSED_RASTRIGIN, FUSED_ACKLEY,
)


def _objective(rows_fn, fused_id=FUSED_NONE):
    rows_fn.fused_id = fused_id
    return rows_fn


def _onemax(m: torch.Tensor) -> torch.Tensor:
    """Continuous OneMax: sum of genes. Optimum = genome_len."""
    return torch.sum(m, dim=1)


def _onemax_bits(m: torch.Tensor) -> torch.Tensor:
    """Bitstring OneMax: count of genes >= 0.5. Optimum = genome_len."""
    return torch.sum((m >= 0.5).to(torch.float32), dim=1)


def _to_box(m: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + m * (hi - lo)


def _sphere(m: torch.Tensor) -> torch.Tensor:
    """Negated sphere on [-5.12, 5.12]^L. Optimum 0."""
    x = _to_box(m, -5.12, 5.12)
    return -torch.sum(x * x, dim=1)


def _rastrigin(m: torch.Tensor) -> torch.Tensor:
    """Negated Rastrigin on [-5.12, 5.12]^L. Optimum 0."""
    x = _to_box(m, -5.12, 5.12)
    return -(
        10.0 * m.shape[1]
        + torch.sum(x * x - 10.0 * torch.cos(2.0 * math.pi * x), dim=1)
    )


def _ackley(m: torch.Tensor) -> torch.Tensor:
    """Negated Ackley on [-32.768, 32.768]^L. Optimum 0."""
    x = _to_box(m, -32.768, 32.768)
    n = m.shape[1]
    a, b, c = 20.0, 0.2, 2.0 * math.pi
    s1 = torch.sqrt(torch.sum(x * x, dim=1) / n)
    s2 = torch.sum(torch.cos(c * x), dim=1) / n
    return -(-a * torch.exp(-b * s1) - torch.exp(s2) + a + math.e)


def _per_device(t: torch.Tensor):
    """``get(device)``: ``t`` on ``device``, copied there once."""
    copies = {}

    def get(device):
        key = str(device)
        if key not in copies:
            copies[key] = t.to(device)
        return copies[key]

    return get


def _fused_by(rows_fn, expression: str, doc: str, **consts):
    """A rowwise objective whose fused form is ``from_expression(
    expression, **consts)``; its plain rowwise form stays ``rows_fn``."""
    rows_fn.expr_fused = from_expression(expression, **consts)
    rows_fn.__doc__ = doc
    return _objective(rows_fn)


onemax = _objective(_onemax, FUSED_ONEMAX)
onemax_bits = _objective(_onemax_bits, FUSED_ONEMAX_BITS)
sphere = _objective(_sphere, FUSED_SPHERE)
rastrigin = _objective(_rastrigin, FUSED_RASTRIGIN)
ackley = _objective(_ackley, FUSED_ACKLEY)


# ---------------------------------------------------------------------
# Knapsack (libpga_tpu/objectives/classic.py:103-149)
# ---------------------------------------------------------------------


def make_knapsack(values, weights, capacity: float, max_item_count: int = 2):
    """Bounded knapsack with an overweight penalty (the reference's
    second example, test2/test.cu:28-36): gene i decodes to the count
    ``floor(g[i] * max_item_count)``; a feasible genome scores its total
    value, an infeasible one ``capacity - weight``. The genome length is
    the item count. ``.kernel_rowwise_consts`` are the (1, n) values and
    weights; the fused form is the expression of ``expr.py``'s
    docstring."""
    values = np.asarray(values, dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    vals_on = _per_device(torch.from_numpy(values.reshape(1, -1)))
    wts_on = _per_device(torch.from_numpy(weights.reshape(1, -1)))

    def knapsack_rows(m: torch.Tensor, vals=None, wts=None) -> torch.Tensor:
        vals = vals_on(m.device) if vals is None else vals
        wts = wts_on(m.device) if wts is None else wts
        counts = torch.floor(m * max_item_count)
        total_value = torch.sum(vals * counts, dim=1)
        total_weight = torch.sum(wts * counts, dim=1)
        return torch.where(total_weight <= capacity, total_value, capacity - total_weight)

    cap, mic = repr(float(capacity)), repr(float(max_item_count))
    knapsack = _fused_by(
        knapsack_rows,
        f"counts = floor(g * {mic}); weight = dot(wts, counts);"
        f" where(weight <= {cap}, dot(vals, counts), {cap} - weight)",
        make_knapsack.__doc__, vals=values, wts=weights,
    )
    knapsack.kernel_rowwise = knapsack_rows
    knapsack.kernel_rowwise_consts = (vals_on("cpu"), wts_on("cpu"))
    return knapsack


# The instance the reference's test2/test.cu hardcodes (:22-26);
# its optimum is 285 (one of item 2 and one of item 3).
default_knapsack = make_knapsack(
    values=[75, 150, 250, 35, 10, 100],
    weights=[7, 8, 6, 4, 3, 9],
    capacity=10.0,
    max_item_count=2,
)


# ---------------------------------------------------------------------
# NK landscape and deceptive trap (libpga_tpu/objectives/classic.py:402-499)
# ---------------------------------------------------------------------


def make_nk_landscape(n: int, k: int, seed: int = 0):
    """NK fitness landscape on ``n`` loci: locus l's contribution is
    ``table[l, code]``, ``code`` the (k+1)-bit word of the bits (genes
    >= 0.5) at loci l, l+1, ..., l+k (circular); the score is the mean
    contribution. The (n, 2^(k+1)) table comes from
    ``np.random.default_rng(seed)`` exactly as the JAX package draws it.
    With ``2**(k+1) <= 64`` the breed kernel scores it (``expr_fused``,
    the NK expression of ``expr.py``'s docstring over the transposed
    table ``.kernel_rowwise_consts[0]``); a larger table stays unfused,
    as in JAX."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(0.0, 1.0, size=(n, 2 ** (k + 1))).astype(np.float32)
    table_t = np.ascontiguousarray(table.T)  # (2^(k+1), n)
    tab_on = _per_device(torch.from_numpy(table_t))

    def nk_rows(m: torch.Tensor, tab_t=None) -> torch.Tensor:
        tab_t = tab_on(m.device) if tab_t is None else tab_t
        bits = (m >= 0.5).to(torch.int64)
        codes = bits
        for j in range(1, k + 1):
            codes = codes + torch.roll(bits, -j, dims=1) * (2**j)
        contrib = tab_t[codes, torch.arange(m.shape[1], device=m.device)]
        return torch.mean(contrib, dim=1)

    if 2 ** (k + 1) > 64:
        nk_rows.__doc__ = make_nk_landscape.__doc__
        nk = _objective(nk_rows)
    else:
        terms = " + ".join(["b"] + [f"{2**j}*roll(b, {j})" for j in range(1, k + 1)])
        nk = _fused_by(
            nk_rows, f"b = g >= 0.5; codes = {terms}; mean(gather(T, codes))",
            make_nk_landscape.__doc__, T=table_t,
        )
    nk.kernel_rowwise = nk_rows
    nk.kernel_rowwise_consts = (tab_on("cpu"),)
    return nk


def make_deceptive_trap(trap_size: int = 5):
    """Concatenated deceptive trap: the genome splits into blocks of
    ``trap_size`` bits (a tail shorter than a block is ignored); a full
    block scores ``trap_size``, any other ``trap_size - 1 - ones``.
    Optimum: all ones. The fused form counts each block's ones at its
    first locus from ``roll`` and selects block starts with ``i %
    trap_size``; every value is a small integer, so it equals the direct
    form exactly."""
    t = int(trap_size)

    def trap_rows(m: torch.Tensor) -> torch.Tensor:
        P, L = m.shape
        nblocks = L // t
        bits = (m[:, : nblocks * t] >= 0.5).to(torch.float32)
        ones = bits.reshape(P, nblocks, t).sum(dim=2)
        block = torch.where(ones == t, float(t), t - 1.0 - ones)
        return torch.sum(block, dim=1)

    ones = " + ".join(["b"] + [f"roll(b, {j})" for j in range(1, t)])
    return _fused_by(
        trap_rows,
        f"b = g >= 0.5; ones = {ones};"
        f" sum(where((i % {t} == 0) * (i <= L - {t}),"
        f" where(ones == {t}, {t}, {t - 1} - ones), 0))",
        make_deceptive_trap.__doc__,
    )


# ---------------------------------------------------------------------
# TSP (libpga_tpu/objectives/classic.py:171-396)
# ---------------------------------------------------------------------


def tsp_cities(m: torch.Tensor) -> torch.Tensor:
    """City of every gene: ``clamp(floor(g * L), 0, L - 1)`` in float32,
    as int64 (the reference's ``int(g[i] * L)``, test3/test.cu:31-32)."""
    L = m.shape[1]
    return torch.clamp(torch.floor(m * L).to(torch.int64), 0, L - 1)


def _city_counts(cities: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(P, n_buckets) float32 occupancy counts of each city."""
    counts = torch.zeros(
        (cities.shape[0], n_buckets), dtype=torch.float32, device=cities.device
    )
    return counts.scatter_add_(1, cities, torch.ones_like(cities, dtype=torch.float32))


def duplicate_genes(cities: torch.Tensor) -> torch.Tensor:
    """(P,) float32 count of genes whose city an earlier gene holds:
    ``L - distinct cities``."""
    L = cities.shape[1]
    return L - torch.sum((_city_counts(cities, L) > 0).to(torch.float32), dim=1)


def tour_edges(cities: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(P, L-1) open-path edge lengths ``sqrt(dx^2 + dy^2 + 1e-12)``
    between consecutive cities, the lookup into ``xy`` (C, 2) clamped
    to C-1."""
    pts = xy[torch.clamp(cities, max=xy.shape[0] - 1)]  # (P, L, 2)
    d = pts[:, 1:] - pts[:, :-1]
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)


def make_tsp(city_matrix, duplicate_penalty: float = 10_000.0):
    """TSP over a distance matrix (the reference's third driver,
    test3/test.cu:26-46): fitness = -(path length + penalty per ordered
    duplicate pair, ``sum_c n_c^2 - L``). Cities decode in [0, L); the
    matrix lookup clamps to C-1 when L > C. Rowwise, with ``.rows``."""
    matrix = _per_device(torch.as_tensor(np.asarray(city_matrix, dtype=np.float32)))
    C = matrix("cpu").shape[0]

    def tsp_rows(m: torch.Tensor) -> torch.Tensor:
        L = m.shape[1]
        cities = tsp_cities(m)
        mat = matrix(m.device)
        hop = torch.clamp(cities, max=C - 1)
        length = torch.sum(mat[hop[:, :-1], hop[:, 1:]], dim=1)
        counts = _city_counts(cities, max(C, L))
        dups = torch.sum(counts * counts, dim=1) - L
        return -(length + duplicate_penalty * dups)

    tsp_rows.rows = tsp_rows
    return _objective(tsp_rows)


def make_tsp_coords(
    coords, duplicate_penalty: float = 10_000.0, duplicate_mode: str = "pairs"
):
    """Euclidean TSP over city coordinates ``(C, 2)``: fitness = -(open
    path length, each edge ``sqrt(dx^2 + dy^2 + 1e-12)``, + penalty x
    duplicates). ``duplicate_mode`` "pairs" counts ordered duplicate
    pairs (as :func:`make_tsp`); "genes" counts duplicate genes, ``L -
    distinct cities``, and marks the objective fused (``FUSED_TSP``):
    with order crossover the breed kernel scores each child, reading
    ``.coords`` (float32, exact; the TPU kernel's bf16 hi/lo table
    recovers them to ~1e-3) and ``.penalty``."""
    if duplicate_mode not in ("pairs", "genes"):
        raise ValueError(
            f"duplicate_mode must be 'pairs' or 'genes', got {duplicate_mode!r}"
        )
    xy = torch.as_tensor(np.asarray(coords, dtype=np.float32)).reshape(-1, 2)
    C = xy.shape[0]
    xy_on = _per_device(xy)

    def tsp_rows(m: torch.Tensor) -> torch.Tensor:
        L = m.shape[1]
        cities = tsp_cities(m)
        if duplicate_mode == "pairs":
            counts = _city_counts(cities, max(C, L))
            dups = torch.sum(counts * counts, dim=1) - L
        else:
            dups = duplicate_genes(cities)
        length = torch.sum(tour_edges(cities, xy_on(m.device)), dim=1)
        return -(length + duplicate_penalty * dups)

    tsp_rows.rows = tsp_rows
    if duplicate_mode == "genes":
        tsp_rows.coords = xy
        tsp_rows.penalty = float(duplicate_penalty)
        return _objective(tsp_rows, FUSED_TSP)
    return _objective(tsp_rows)


def random_tsp_coords(n_cities: int, seed: int = 0, scale: float = 1000.0):
    """Uniform-random city coordinates in a ``scale``-sized square."""
    rng = np.random.default_rng(seed)
    return (rng.random((n_cities, 2)) * scale).astype(np.float32)


def random_tsp_matrix(
    n_cities: int, seed: int = 0, low: float = 10.0, high: float = 1000.0
):
    """Random distance matrix with a planted cheap path ``i -> i+1`` of
    weight ``low`` (test3/gen.c:27-38): the tour 0, 1, ..., L-1 has
    length ``low * (L - 1)``."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(low, high, size=(n_cities, n_cities)).astype(np.float32)
    np.fill_diagonal(m, 0.0)
    idx = np.arange(n_cities - 1)
    m[idx, idx + 1] = low
    return m
