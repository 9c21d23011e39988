"""The port's floor harness (B7) against the JAX package's on the CPU:
the ablated cases of ``make_fused_breed`` / ``make_fused_multigen``
(``ops/fused_step.py``, their plain versions; ``csrc/deme_breed.cu``'s
``deme_breed_kernel<Gene, ABLATE>`` and ``multigen_breed_kernel<false,
Gene, ABLATE>`` compute the same functions) against
``make_pallas_breed`` / ``make_pallas_multigen(_ablate=...)`` in
interpret mode, at the toy shape of ``tests/test_ablate_floor.py``
(512x16, K=128, D=2); the flag checks; and the harness arithmetic of
``libpga_tpu_torch/tools/ablate_floor.py`` against
``tools/ablate_floor.py``'s.

Interpret mode's PRNG bits are all zero, so the port's breeding cases
take all-zero injected draws: every child copies its cohort's rank-0
row (sel_const and no_matmul: slot k's row) and point mutation sets
gene 0 to 0.0. Copies and the floor move rows verbatim, so they are
held bit for bit; the other stage cases within the gather tolerance
(JAX gathers parents with a bf16 hi/lo one-hot matmul, ~1e-5 a gene,
L * 1e-5 a fused score)."""

import importlib.util
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpga_tpu.objectives import onemax as jax_onemax
from libpga_tpu.ops import pallas_step as ps
from libpga_tpu_torch.objectives import onemax
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels
from libpga_tpu_torch.ops.breed_expr import mutate_from_expression
from libpga_tpu_torch.tools import ablate_floor as port_af
from libpga_tpu_torch.tools import ablate_kernel as port_ak

_SPEC = importlib.util.spec_from_file_location(
    "jax_ablate_floor",
    pathlib.Path(__file__).resolve().parent.parent / "tools" / "ablate_floor.py",
)
jax_af = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jax_af)

POP, L, K, D = 512, 16, 128, 2
GENE_ATOL = 1e-5
COPY = port_af.COPY
FLOOR = port_af.FLOOR_ABLATE


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _population(Pp, P, seed=1, decreasing=False):
    """Uniform genomes (Pp, L) and scores: onemax, or strictly
    decreasing by row (no ties, so the ranks need no tie words); -inf
    on pad rows."""
    rng = np.random.default_rng(seed)
    g = rng.random((Pp, L), dtype=np.float32)
    s = -np.arange(Pp, dtype=np.float32) if decreasing else g.sum(axis=1)
    s[P:] = -np.inf
    return g, s


def _jax_breed(ablate, fused, P=POP, dps=D, layout=None):
    with _interpret():
        return ps.make_pallas_breed(
            P, L, deme_size=K, fused_obj=jax_onemax.kernel_rowwise if fused else None,
            _demes_per_step=dps, _ablate=tuple(ablate), _layout=layout,
        )


def _jax_run(breed, g, s):
    with _interpret():
        out = breed.padded(jnp.asarray(np.pad(g, ((0, 0), (0, breed.Lp - L)))),
                           jnp.asarray(s), jax.random.key(0))
    if breed.fused:
        return np.asarray(out[0])[:, :L], np.asarray(out[1])
    return np.asarray(out)[:, :L], None


# ------------------------------------------------------------ the copies

COPY_CASES = [
    ("copy_riffle", COPY, False, POP),
    ("copy_contig", COPY + ("no_riffle",), False, POP),
    ("copy_alias", COPY + ("no_riffle", "alias_io"), False, POP),
    ("copy_riffle_score", COPY, True, POP),
    ("copy_riffle_score_padded", COPY, True, 600),
]


@pytest.mark.parametrize("name,ablate,fused,P", COPY_CASES)
def test_copy_equals_jax_bit_for_bit(name, ablate, fused, P):
    dps = D if P == POP else 1
    jb = _jax_breed(ablate, fused, P, dps)
    breed = fs.make_fused_breed(P, L, onemax if fused else None, deme_size=K, ablate=ablate,
                                demes_per_block=dps, device="cpu")
    geom = breed.geom
    assert (jb.layout, jb.K, jb.Pp) == ("riffle", geom.K, geom.Pp)
    assert geom.layout == ("contig" if "no_riffle" in ablate else "riffle")
    g, s = _population(geom.Pp, P)
    want_g, want_s = _jax_run(jb, g, s)
    gt = torch.from_numpy(g.copy())
    got_g, got_s = breed(gt, torch.from_numpy(s), 0, torch.Generator().manual_seed(0))
    assert (got_g is gt) == ("alias_io" in ablate)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    if fused:
        np.testing.assert_array_equal(got_s.numpy(), want_s)
        # A row copied from a pad slot carries the pad's -inf, in both.
        real = np.isfinite(got_s.numpy())
        gg, kk = np.meshgrid(np.arange(geom.G), np.arange(K), indexing="ij")
        assert real.sum() == ((gg * K + kk < P) & (kk * geom.G + gg < P)).sum()
        np.testing.assert_allclose(got_s.numpy()[real], got_g.numpy()[real].sum(1), rtol=1e-6)
    else:
        assert got_s is None and want_s is None


def test_copies_are_their_permutations():
    """copy_contig and copy_alias are the identity; copy_riffle puts row
    g*K + k at row k*G + g."""
    g, s = _population(POP, POP)
    G = POP // K
    for ablate, perm in ((COPY + ("no_riffle",), np.arange(POP)),
                         (COPY + ("no_riffle", "alias_io"), np.arange(POP)),
                         (COPY, (np.arange(K)[None, :] * G + np.arange(G)[:, None]).reshape(-1))):
        breed = fs.make_fused_breed(POP, L, None, deme_size=K, ablate=ablate, device="cpu")
        out, _ = breed(torch.from_numpy(g.copy()), torch.from_numpy(s), 0, None)
        want = np.empty_like(g)
        want[perm] = g
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("dc", [1, 2, 4])
def test_copy_demes_per_block_changes_nothing_in_the_plain_version(dc):
    g, s = _population(POP, POP)
    outs = []
    for d in (1, dc):
        breed = fs.make_fused_breed(POP, L, onemax, deme_size=K, ablate=COPY,
                                    demes_per_block=d, device="cpu")
        outs.append(breed(torch.from_numpy(g), torch.from_numpy(s), 0, None))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("wb", [1, 2, 8])
def test_copy_warps_per_block_changes_nothing_in_the_plain_version(wb):
    g, s = _population(POP, POP)
    outs = []
    for w in (0, wb):
        breed = fs.make_fused_breed(POP, L, onemax, deme_size=K, ablate=COPY,
                                    demes_per_block=2, warps_per_block=w, device="cpu")
        outs.append(breed(torch.from_numpy(g), torch.from_numpy(s), 0, None))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_bf16_copy_moves_the_stored_genes():
    g, s = _population(POP, POP)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    breed = fs.make_fused_breed(POP, L, None, deme_size=K, ablate=COPY + ("no_riffle",),
                                device="cpu", gene_dtype=torch.bfloat16)
    out, _ = breed(gb, torch.from_numpy(s), 0, None)
    assert out.dtype == torch.bfloat16 and torch.equal(out, gb)


# ------------------------------------------------------- the stage cases


def _port_stage(ablate, fused, parity=0, layout=None):
    """The port's plain breed of the stage case on zero draws, with the
    ranks of strictly decreasing scores, and JAX's interpret kernel."""
    jb = _jax_breed(ablate, fused, layout=layout)
    geom = fs.resolve_geometry(POP, L, deme_size=K, fused=fused, layout=layout,
                               demes_per_step=D, ablate=ablate)
    assert (jb.layout, jb.K, jb.D, jb.Pp) == (geom.layout, geom.K, geom.D, geom.Pp)
    g, s = _population(geom.Pp, POP, decreasing=True)
    ranks = fs.compute_ranks(torch.from_numpy(s), geom, parity, torch.zeros(geom.Pp,
                                                                            dtype=torch.int64))
    got = fs.deme_breed_reference(
        torch.from_numpy(g), ranks, geom, parity, fs.zero_draws(geom.G, geom.K, L),
        mparams=torch.tensor([0.01, 0.0]), obj_id=onemax.fused_id if fused else 0,
        ablate=ablate,
    )
    return g, _jax_run(jb, g, s), got


def test_floor_equals_jax_bit_for_bit():
    """Every stage off: the children are verbatim rows (the riffle of
    the input), in both packages."""
    g, (want_g, _), (got_g, got_s) = _port_stage(FLOOR, False)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    assert got_s is None
    G = POP // K
    np.testing.assert_array_equal(got_g.numpy()[3 * G + 1], g[1 * K + 3])


@pytest.mark.parametrize("flag", ["no_mut", "no_cross", "sel_const", "no_matmul"])
def test_stage_case_equals_jax_interpret(flag):
    g, (want_g, want_s), (got_g, got_s) = _port_stage((flag,), True, layout="riffle")
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=L * GENE_ATOL)
    mutated = (got_g.numpy()[:, 0] == 0.0).all()
    assert mutated == (flag != "no_mut")
    if flag in ("sel_const", "no_matmul"):  # child k is slot k's row
        G = POP // K
        np.testing.assert_array_equal(got_g.numpy()[5 * G + 2, 1:], g[2 * K + 5, 1:])


def test_stage_case_on_pingpong_equals_jax_interpret():
    """The stage flags do not pin the layout: the fused breed stays on
    ping-pong, as JAX's does."""
    _, (want_g, want_s), (got_g, got_s) = _port_stage(("no_mut",), True, parity=0)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=L * GENE_ATOL)


def test_production_breed_unchanged_by_empty_ablate():
    """ablate=() is the production breed, bit for bit, in both draw
    modes (Philox through the factory, injected through the plain
    version)."""
    g, s = _population(POP, POP)
    outs = []
    for kw in ({}, {"ablate": ()}):
        breed = fs.make_fused_breed(POP, L, onemax, deme_size=K, device="cpu", **kw)
        outs.append(breed(torch.from_numpy(g), torch.from_numpy(s), 1,
                          torch.Generator().manual_seed(4)))
        assert "ablate" not in breed.kw
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    geom = fs.resolve_geometry(POP, L, deme_size=K)
    ranks = fs.compute_ranks(torch.from_numpy(s), geom, 0, torch.arange(POP))
    gen = torch.Generator().manual_seed(5)
    draws = fs.Draws(sel_u=torch.rand((geom.G, K, 2), generator=gen),
                     cross=(torch.rand((geom.G, K, L), generator=gen) < 0.5).to(torch.uint8),
                     mut_u=torch.rand((geom.G, K, 4), generator=gen))
    kw = dict(mparams=torch.tensor([0.3, 0.0]), obj_id=onemax.fused_id)
    a = fs.deme_breed_reference(torch.from_numpy(g), ranks, geom, 0, draws, **kw)
    b = fs.deme_breed_reference(torch.from_numpy(g), ranks, geom, 0, draws, ablate=(), **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------------ multigen


def _multigen_both(ablate, steps=2, target=None):
    with _interpret():
        bm = ps.make_pallas_multigen(POP, L, deme_size=K, fused_obj=jax_onemax.kernel_rowwise,
                                     _demes_per_step=D, _ablate=tuple(ablate), _layout="riffle")
    geom = fs.resolve_geometry(POP, L, deme_size=K, multigen=True, demes_per_step=D,
                               layout="riffle")
    assert (bm.layout, bm.K, bm.D, bm.Pp) == (geom.layout, geom.K, geom.D, geom.Pp)
    g, s = _population(geom.Pp, POP, seed=3)
    with _interpret():
        gj, sj = bm.padded(jnp.asarray(np.pad(g, ((0, 0), (0, bm.Lp - L)))), jnp.asarray(s),
                           jax.random.key(0), steps, None, target, 0)
    got = fs.multigen_breed(
        torch.from_numpy(g), torch.from_numpy(s), geom, 0, steps, target,
        draws=fs.zero_draws(geom.G, geom.K, L, steps=steps),
        mparams=torch.tensor([0.01, 0.0]), obj_id=onemax.fused_id, ablate=ablate,
    )
    return geom, g, (np.asarray(gj)[:, :L], np.asarray(sj)), (got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("ablate,target", [
    (("no_freeze",), 0.0), (("no_rank_cube",), None), (("sel_const",), None),
    (("no_mut",), None),
])
def test_multigen_case_equals_jax_interpret(ablate, target):
    """At T = 2. no_freeze runs under a target every group has reached
    already, so its groups breed where the production kernel's freeze."""
    geom, g, (gj, sj), (gp, sp) = _multigen_both(ablate, target=target)
    np.testing.assert_allclose(gp, gj, rtol=0, atol=GENE_ATOL)
    np.testing.assert_allclose(sp, sj, rtol=0, atol=L * GENE_ATOL)
    assert (gp[:, 0] == 0.0).all() == (ablate != ("no_mut",))
    if ablate == ("sel_const",):  # child k is slot k's row
        np.testing.assert_array_equal(gp[5 * geom.G + 2, 1:], g[2 * K + 5, 1:])


def test_multigen_no_rank_cube_selects_slot_zero():
    """Identity ranks with zero draws: every child is its deme's slot-0
    row (gene 0 mutated to 0.0), where the production kernel takes the
    best row."""
    geom, g, (gj, _), (gp, _) = _multigen_both(("no_rank_cube",), steps=1)
    np.testing.assert_allclose(gp, gj, rtol=0, atol=GENE_ATOL)
    for k in (0, 1, K - 1):
        np.testing.assert_array_equal(gp[k * geom.G + 1, 1:], g[1 * K, 1:])


# ------------------------------------------------------ flags and refusals


def test_unknown_flag_raises_naming_the_valid_set():
    with pytest.raises(ValueError) as ei:
        fs.validate_ablate(("no_rifle",))
    assert "no_rifle" in str(ei.value) and "no_riffle" in str(ei.value)
    assert fs.VALID_ABLATE == ps._VALID_ABLATE
    assert fs.LAYOUT_ABLATE == ps._LAYOUT_ABLATE


@pytest.mark.parametrize("flag", ["serial_grid", "no_score_t", "scatter_scores"])
def test_flags_without_a_card_meaning_raise_with_the_reason(flag):
    with pytest.raises(ValueError, match="no meaning on the card"):
        fs.make_fused_breed(POP, L, onemax, deme_size=K, ablate=(flag,), device="cpu")


def test_alias_io_needs_copy_only_and_no_riffle():
    with pytest.raises(ValueError, match="alias_io requires"):
        fs.validate_ablate(("no_riffle", "alias_io"))
    with pytest.raises(ValueError, match="alias_io requires"):
        fs.validate_ablate(("copy_only", "alias_io"))
    with pytest.raises(ValueError, match="alias_io requires no_riffle"):
        _jax_breed(("copy_only", "no_rank_sort", "alias_io"), False)


@pytest.mark.parametrize("flag", ["copy_only", "no_riffle", "alias_io", "no_rank_sort"])
def test_one_generation_flags_raise_in_multigen(flag):
    with pytest.raises(ValueError, match="one-generation only"):
        fs.make_fused_multigen(POP, L, onemax, deme_size=K, ablate=(flag,), device="cpu")


@pytest.mark.parametrize("flag", ["no_freeze", "no_rank_cube"])
def test_multigen_flags_raise_in_the_one_generation_breed(flag):
    with pytest.raises(ValueError, match="multi-generation kernel's"):
        fs.make_fused_breed(POP, L, onemax, deme_size=K, ablate=(flag,), device="cpu")


def test_layout_flags_pin_the_riffle_as_jax_does():
    """Fused at 8,192x100 the production layout is ping-pong; a layout
    flag pins the riffle (no_riffle: its contiguous map), and an explicit
    ping-pong request raises, in both packages."""
    assert fs.resolve_geometry(8192, 100).layout == "pingpong"
    for ablate, layout in ((COPY, "riffle"), (COPY + ("no_riffle",), "contig"),
                           (("no_mut",), "pingpong")):
        assert fs.resolve_geometry(8192, 100, ablate=ablate).layout == layout
    with pytest.raises(ValueError, match="riffle instruments"):
        fs.resolve_geometry(8192, 100, layout="pingpong", ablate=COPY)
    with pytest.raises(ValueError):
        _jax_breed(COPY, True, P=8192, dps=None, layout="pingpong")


@pytest.mark.parametrize("mutate", ["point", "creep"])
def test_stage_flags_at_subblock_above_one_raise_naming_their_roadmap_item(mutate):
    """The stage flags at a sub-block depth B > 1 (B10) no longer raise:
    the factory builds at B = 2 with a builtin or an expression hook and
    breeds what the plain version breeds at that geometry from the same
    generator (ranks, seed, Philox draws); at 4,096 rows no D admits B = 2
    and the riffle breeds; a layout flag pins the riffle."""
    rate, sigma = 0.05, 0.1
    if mutate == "creep":
        mutate = mutate_from_expression("where(r < rate, g + sigma * (2*r2 - 1), g)", rate=rate,
                                        sigma=sigma)
    P, ablate = 16_384, ("no_cross",)
    breed = fs.make_fused_breed(P, L, onemax, mutate=mutate, mparams=(rate, sigma), ablate=ablate,
                                subblock=2, device="cpu")
    geom = breed.geom
    assert (geom.layout, geom.B) == ("pingpong", 2) and breed.kw["ablate"] == ablate
    g, s = _population(geom.Pp, P, seed=4)
    g, s = torch.from_numpy(g), torch.from_numpy(s)
    gen = torch.Generator().manual_seed(6)
    twin = torch.Generator().set_state(gen.get_state())
    got = breed(g, s, 1, gen)
    ranks = fs.compute_ranks(s, geom, 1, fs.draw_tie_words(twin, geom.Pp, "cpu"))
    seed = torch.randint(0, 2**63 - 1, (1,), generator=twin)
    want = fs.deme_breed_reference(g, ranks, geom, 1, fs.philox_draws(seed, geom.G, geom.K, L,
                                                                       mutate), **breed.kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    breed = fs.make_fused_breed(4096, L, onemax, mutate=mutate, ablate=ablate, subblock=2,
                                device="cpu")
    assert breed.geom.B == 1
    copy = fs.make_fused_breed(P, L, onemax, mutate=mutate, ablate=COPY, subblock=2,
                               device="cpu")
    assert copy.geom.B == 1  # a layout flag pins the riffle


def test_demes_per_block_is_the_copy_s():
    with pytest.raises(ValueError, match="demes_per_block"):
        fs.make_fused_breed(POP, L, onemax, deme_size=K, ablate=("no_mut",), demes_per_block=2,
                            device="cpu")


def test_warps_per_block_is_the_copy_s():
    with pytest.raises(ValueError, match="warps_per_block"):
        fs.make_fused_breed(POP, L, onemax, deme_size=K, ablate=("no_mut",), warps_per_block=2,
                            device="cpu")


def test_kernel_masks_cover_the_harness_and_refuse_the_rest():
    """Every set of flags JAX's harness takes resolves to a kernel
    bitmask and a deme_breed.cu unit: the harness's usual cases to the
    production unit (no macro line), the pipelined kernel's stage cases
    to its harness unit, every other combination to a unit of its own;
    copy_only with stage flags is the copy. The production unit's text
    is the source itself."""
    stage = ("sel_const", "no_matmul", "no_cross", "no_mut")
    bits = kernels.ABLATE_BITS
    for flags in (COPY + ("no_riffle", "alias_io"), ("copy_only", "no_mut"), COPY + stage):
        assert kernels.ablate_mask(flags) == 1 and kernels.deme_macro("deme", 1) == ""
    for label, ablate, _ in port_ak.STAGES:
        assert kernels.deme_macro("deme", kernels.ablate_mask(ablate)) == ""
        assert kernels.deme_macro("order", kernels.ablate_mask(ablate)) == ""
    assert kernels.ablate_mask(FLOOR) == kernels.ABLATE_FLOOR
    for r in range(len(stage) + 1):
        for flags in itertools.combinations(stage, r):
            mask = kernels.ablate_mask(flags + ("no_rank_sort",))
            assert mask == sum(bits[f] for f in flags)
            usual = r in (1, len(stage))
            for kernel in ("deme", "order"):
                assert kernels.deme_macro(kernel, mask) == (
                    "" if usual or r == 0 else f"#define DEME_ABLATE_EXTRA {mask}u\n")
            assert kernels.deme_macro("pipelined", mask) == (
                "" if r == 0 else "#define DEME_HARNESS 1\n" if usual
                else f"#define DEME_ABLATE_EXTRA {mask}u\n")
    multigen = stage + ("no_freeze", "no_rank_cube")
    with pytest.raises(ValueError, match="multi-generation"):
        kernels.ablate_mask(("no_freeze", "no_mut"))  # a one-generation kernel's
    units = set()
    for r in range(len(multigen) + 1):
        for flags in itertools.combinations(multigen, r):
            mask = kernels.ablate_mask(flags, multigen=True)
            macro = kernels.deme_macro("multigen", mask)
            assert (macro == "") == (mask in kernels.ABLATE_MULTIGEN_MASKS)
            units.add(macro)
    assert len(units) == 2 ** len(multigen) - len(kernels.ABLATE_MULTIGEN_MASKS) + 1
    source = (kernels.CSRC / "deme_breed.cu").read_text()
    assert kernels.deme_unit("") == source
    extra = kernels.deme_macro("deme", bits["sel_const"] | bits["no_cross"])
    assert kernels.deme_unit(extra) == "#define DEME_ABLATE_EXTRA 10u\n" + source


# ----------------------------------------------------- harness arithmetic

MS = {"floor": 4.33, "copy_riffle": 2.80, "copy_contig": 2.50, "copy_alias": 2.30,
      "rank_sort": 0.33}


@pytest.mark.parametrize("kw", [{}, {"steps_bench": 256, "dispatch_per_step": 0.004},
                                {"steps_bench": 2048, "dispatch_per_step": 0.01}])
@pytest.mark.parametrize("ms", [MS, {"floor": 4.0, "copy_riffle": 2.5, "rank_sort": 0.3}])
def test_partition_floor_equals_jax(ms, kw):
    assert port_af.partition_floor(dict(ms), **kw) == jax_af.partition_floor(dict(ms), **kw)


@pytest.mark.parametrize("sweep", [{d: 1.25 + 0.004 * (2048 / d) for d in (1, 2, 4, 8)},
                                   {1: 0.9, 2: 0.7, 4: 0.65, 8: float("nan"), 16: 0.6},
                                   {4: 2.0}])
def test_fit_dispatch_slope_equals_jax(sweep):
    assert port_af.fit_dispatch_slope(sweep, 2048) == jax_af.fit_dispatch_slope(sweep, 2048)


def test_measurement_constants_equal_jax():
    assert port_af.FLOOR_ABLATE == jax_af.FLOOR_ABLATE and port_af.COPY == jax_af.COPY


def test_tools_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (port_af, port_ak):
        with pytest.raises(SystemExit, match="CUDA"):
            tool.main([])


@pytest.mark.parametrize("name,kw", [
    ("full", {}), ("floor", dict(ablate=FLOOR, fused=False)),
    ("copy_alias", dict(ablate=COPY + ("no_riffle", "alias_io"), fused=False)),
    ("copy_riffle_score", dict(ablate=COPY)),
])
def test_harness_variants_run_at_the_toy_shape(name, kw):
    """The tool's loop (parity, buffers, in place under alias_io) on the
    plain versions: the aliased copy keeps its one buffer."""
    run = port_af.build_variant(name, torch.float32, K, POP, L, device="cpu", **kw)
    run(3)
    run_t = port_af.build_tsweep_variant(torch.float32, K, POP, L, 2, device="cpu")
    run_t(1)
    assert run.blocks == POP // K


def test_fixed_warps_sweep_variants_run_at_the_toy_shape():
    """The demes-per-block sweep at Dc warps a block builds every point
    dividing G, each launching G / Dc blocks."""
    G = POP // K
    for d in port_af.DSWEEP_FIXED_WARPS:
        if G % d:
            continue
        run = port_af.build_variant(f"w{d}", torch.float32, K, POP, L, ablate=COPY, fused=False,
                                    demes_per_block=d, warps_per_block=d, device="cpu")
        run(2)
        assert run.blocks == G // d


@pytest.mark.parametrize("dtype,scored", [(torch.float32, False), (torch.bfloat16, False),
                                          (torch.float32, True)])
def test_copy_bound_counts_the_copy_s_bytes(dtype, scored):
    """Rows read and written once and, scored, the handed scores read and
    the scores written, over the H100's memory rate: 0.2504 ms for
    1,048,576x100 float32 rows."""
    geom = fs.resolve_geometry(1 << 20, 100, deme_size=512, layout="riffle", ablate=COPY,
                               gene_dtype=dtype)
    gb = 2 if dtype == torch.bfloat16 else 4
    want = (2 * geom.Pp * 100 * gb + 8 * geom.Pp * scored) / 3.35e12 * 1e3
    assert port_af.copy_bound_ms(geom, gb, scored) == pytest.approx(want, rel=1e-12)
    if dtype == torch.float32 and not scored:
        assert round(port_af.copy_bound_ms(geom, gb), 4) == 0.2504


def test_subblock_variant_builds_with_the_reduced_grid():
    """The harness's ``subblock`` variant (JAX's ``tools/ablate_floor.py``
    variant: ping-pong at ``--subblock-b``, default 2) breeds B*D demes a
    group, so its grid (S groups) is half the ping-pong one's, as JAX's
    ``kernel_plan`` says; JAX's own
    ``test_subblock_variant_runs_with_reduced_grid`` fails under jax 0.9.0.
    At this file's 512 rows no demes-per-step admits B = 2 without pinning
    D (JAX's test pins D = 2; both resolvers refuse it unpinned), so the
    variant runs at 2,048x16."""
    pop = 2048
    assert "subblock" not in port_af.NOT_PORTED
    full = port_af.build_variant("full", torch.float32, K, pop, L, layout="pingpong", device="cpu")
    run = port_af.build_variant("subblock", torch.float32, K, pop, L, layout="pingpong",
                                subblock=2, device="cpu")
    plan = ps.kernel_plan(pop, L, deme_size=K, layout="pingpong", subblock=2)
    assert (run.geom.B, run.geom.S, run.geom.D) == (2, plan["grid_steps"], plan["demes_per_step"])
    assert run.geom.S * 2 == full.geom.S
    run(3)
