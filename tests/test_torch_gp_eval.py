"""The port's GP evaluator (libpga_tpu_torch/ops/gp_eval.py and the plain
versions in gp/interpreter.py) against the JAX package's: the fused
Pallas evaluator in interpret mode (it draws no random bits, so interpret
mode gives its real values), the XLA interpreter ``make_eval_rows`` and
the numpy oracle, on the same numpy populations and datasets.

Tolerance rtol = atol = 1e-5 (JAX's own, tests/test_gp.py): the sums over
samples run in another order. -inf must equal -inf."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from libpga_tpu.gp import encoding as jenc
from libpga_tpu.gp import optimize as jopt
from libpga_tpu.gp.interpreter import make_eval_rows as jax_eval_rows
from libpga_tpu.gp.reference import reference_scores as jax_reference_scores
from libpga_tpu.gp.sr import symbolic_regression as jax_sr
from libpga_tpu.ops import gp_eval as jge
from libpga_tpu_torch import interop
from libpga_tpu_torch.gp import encoding as enc
from libpga_tpu_torch.gp.interpreter import make_eval_rows, rmse_scores, sanitize
from libpga_tpu_torch.gp.optimize import optimize_for_eval
from libpga_tpu_torch.gp.reference import reference_scores
from libpga_tpu_torch.gp.sr import make_dataset, symbolic_regression
from libpga_tpu_torch.ops import gp_eval as ge
from libpga_tpu_torch.ops import kernels

TOL = dict(rtol=1e-5, atol=1e-5)
MAIN = dict(max_nodes=16, n_vars=2)
EXP = dict(max_nodes=8, n_vars=1, unary=("exp", "log", "sqrt"), binary=("mul", "add", "min", "max"))
KNOBS = [{}, {"stack_depth": 32, "opcode_block": 4}]


def _case(kind, n=64, seed=0):
    """(kwargs of GPConfig, genomes, X, y), all numpy."""
    rng = np.random.default_rng(seed)
    if kind == "overflow":
        kw = EXP
        X = rng.uniform(-60, 90, (40, 1)).astype(np.float32)
        g = rng.uniform(0, 1, (n, 16)).astype(np.float32)
        g[:8] = jenc.encode_program([("var", 0), "exp", "exp"], jenc.GPConfig(**kw))
    else:
        kw = MAIN
        X = rng.uniform(-1, 1, (48, 2)).astype(np.float32)
        if kind == "noise":
            g = rng.uniform(0, 1, (n, 32)).astype(np.float32)
        else:
            rand = rng.uniform(0, 1, (n, 33)).astype(np.float32)
            g = np.array(jenc.random_program_genes(jnp.asarray(rand), jenc.GPConfig(**kw)))
    y = (X[:, 0] * X[:, -1] + X[:, 0]).astype(np.float32)
    return kw, g, X, y


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("kind", ["well_formed", "noise", "overflow"])
@pytest.mark.parametrize("knobs", KNOBS, ids=["auto", "S32_block4"])
@pytest.mark.parametrize("dispatch", ["dense", "blocked"])
def test_plain_b2_and_b2prime_match_jax_fused_evaluator(kind, knobs, dispatch):
    """Both plain versions against JAX's Pallas B2 and B2' (interpret
    mode), the XLA interpreter and the numpy oracle."""
    kw, g, X, y = _case(kind)
    jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
    gt = torch.from_numpy(g)
    oracle = reference_scores(g, X, y, pgp)
    np.testing.assert_array_equal(oracle, jax_reference_scores(g, X, y, jgp))
    xla = np.asarray(jax_eval_rows(jgp, X, y, dispatch=dispatch, **knobs)(jnp.asarray(g)))
    if kind == "overflow":
        assert np.isneginf(oracle[:8]).all()
    for optimize in (True, False):
        with pltpu.force_tpu_interpret_mode():
            fused = np.asarray(jge.make_gp_eval(
                jgp, X, y, pop=g.shape[0], optimize=optimize, dispatch=dispatch, **knobs
            )(jnp.asarray(g)))
        got = ge.make_gp_eval(pgp, X, y, optimize=optimize, dispatch=dispatch, **knobs)(gt).numpy()
        for want in (fused, xla, oracle):
            _close(got, want)


@pytest.mark.parametrize("kind", ["well_formed", "noise", "overflow"])
def test_optimize_on_and_off_agree(kind):
    kw, g, X, y = _case(kind, n=200, seed=3)
    pgp = enc.GPConfig(**kw)
    gt = torch.from_numpy(g)
    on = ge.make_gp_eval(pgp, X, y, optimize=True)(gt)
    off = ge.make_gp_eval(pgp, X, y, optimize=False)(gt)
    _close(on, off)
    # dense and blocked dispatch score bit-identically
    for opt in (True, False):
        a = make_eval_rows(pgp, X, y, optimize=opt, dispatch="dense")(gt)
        b = make_eval_rows(pgp, X, y, optimize=opt, dispatch="blocked")(gt)
        assert torch.equal(a, b)


@pytest.mark.parametrize("parsimony", [0.0, 0.01])
def test_make_eval_rows_matches_jax(parsimony):
    kw, g, X, y = _case("well_formed", n=96, seed=4)
    jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
    want = np.asarray(jax_eval_rows(jgp, X, y, parsimony=parsimony)(jnp.asarray(g)))
    got = make_eval_rows(pgp, X, y, parsimony=parsimony)(torch.from_numpy(g))
    _close(got, want)


def test_symbolic_regression_objective_matches_jax():
    """The SR objective through its prepare_eval hook (compacted
    programs), and with parsimony (raw genomes minus the penalty)."""
    kw, g, X, y = _case("noise", n=64, seed=5)
    jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
    gt = torch.from_numpy(g)
    for parsimony in (0.0, 0.02):
        jobj = jax_sr(X, y, gp=jgp, parsimony=parsimony, fused=False)
        pobj = symbolic_regression(X, y, gp=pgp, parsimony=parsimony)
        jprep = getattr(jobj, "prepare_eval", None)
        want = np.asarray(jobj.rows(jprep(jnp.asarray(g)) if jprep else jnp.asarray(g)))
        assert hasattr(pobj, "prepare_eval") == (jprep is not None)
        m = pobj.prepare_eval(gt) if parsimony == 0.0 else gt
        _close(pobj.rows(m), want)
        assert pobj.gp_config == pgp and pobj.parsimony == parsimony
    with pytest.raises(ValueError, match="parsimony"):
        symbolic_regression(X, y, gp=pgp, parsimony=0.5).rows(optimize_for_eval(gt, pgp))


def test_eval_program_carried_from_jax_scores_the_same():
    kw, g, X, y = _case("noise", n=64, seed=6)
    jgp, pgp = jenc.GPConfig(**kw), enc.GPConfig(**kw)
    jprog = jopt.optimize_for_eval(jnp.asarray(g), jgp)
    prog = interop.eval_program_from_numpy(
        np.asarray(jprog.ops), np.asarray(jprog.args), np.asarray(jprog.length), device="cpu"
    )
    want = np.asarray(jax_eval_rows(jgp, X, y)(jprog))
    _close(ge.make_gp_eval(pgp, X, y)(prog), want)


def test_plan_errors_match_jax_and_never_decline_a_size():
    jgp, pgp = jenc.GPConfig(max_nodes=16, n_vars=2), enc.GPConfig(max_nodes=16, n_vars=2)
    for bad in (dict(stack_depth=8), dict(opcode_block=3), dict(dispatch="sparse")):
        with pytest.raises(ValueError):
            jge.gp_eval_plan(256, jgp, 48, **bad)
        with pytest.raises(ValueError):
            ge.gp_eval_plan(256, pgp, 48, **bad)
    assert jge.gp_eval_plan(100, jgp, 48)["path"] == "xla"
    plan = ge.gp_eval_plan(100, pgp, 48)
    assert plan["path"] == "cuda" and plan["grid"] * plan["programs_per_block"] >= 100
    assert ge.gp_eval_plan(0, pgp, 48) is None
    main = ge.gp_eval_plan(65_536, enc.GPConfig(max_nodes=32, n_vars=2), 1024)
    assert (main["threads_per_program"], main["programs_per_block"], main["grid"]) == (256, 1, 65_536)
    assert main["smem_bytes"] <= 48 * 1024
    bench = ge.gp_eval_plan(1024, pgp, 64)
    assert (bench["threads_per_program"], bench["programs_per_block"]) == (64, 4)


def test_bound_is_operations_at_the_main_shape():
    """Mean live length 13.35 of which 6.2 function tokens: operations
    (6.2 + 3) * P * B bound it; the bytes are the live tokens only."""
    gp = enc.GPConfig(max_nodes=32, n_vars=2)
    P, B = 65_536, 1024
    plan = ge.gp_eval_plan(P, gp, B)
    cost = ge.gp_plan_cost(plan, P, gp, B, live_tokens=13.35 * P, function_tokens=6.2 * P)
    assert cost["bound_by"] == "operations"
    assert cost["bound_s"] == pytest.approx(9.2 * P * B / 67e12, rel=1e-6)
    assert cost["bytes"] == int(13.35 * P * 8 + P * 4 + 2 * B * 4 + B * 4 + P * 4)
    static = ge.gp_plan_cost(plan, P, gp, B, live_tokens=16.5 * P, function_tokens=8.0 * P,
                             optimize=False)
    assert static["bytes"] == P * 64 * 4 + 2 * B * 4 + B * 4 + P * 4


@pytest.mark.parametrize("kind", ["well_formed", "noise"])
def test_token_counts_count_what_the_programs_execute(kind):
    """Live and function tokens of raw genomes (skip rule) and of their
    compacted programs, against a walk of the decoded opcodes."""
    kw, g, _, _ = _case(kind, n=48, seed=7)
    pgp = enc.GPConfig(**kw)
    arity = pgp.op_arities()
    ops = enc.decode_ops(torch.from_numpy(g), pgp).numpy()
    live = fns = 0
    for row in ops:
        sp = 0
        for op in row:
            a = arity[op]
            if op != enc.PAD_OP and sp >= a:
                sp += 1 - a
                live += 1
                fns += a >= 1
    gt = torch.from_numpy(g)
    assert ge.token_counts(gt, pgp) == {"live": live, "functions": fns}
    prog = optimize_for_eval(gt, pgp)
    n_ops = prog.ops.numpy()
    want_fns = sum(int(arity[o] >= 1) for r, n in zip(n_ops, prog.length.tolist())
                   for o in r[:n] if o < pgp.n_ops)
    got = ge.token_counts(prog, pgp)
    assert got == {"live": int(prog.length.sum()), "functions": want_fns}
    assert got["live"] <= live and got["functions"] <= fns


def test_cuda_wrapper_refuses_cpu_tensors():
    gp = enc.GPConfig(max_nodes=8, n_vars=1)
    X, y = make_dataset(lambda a: a, n_samples=8)
    plan = ge.gp_eval_plan(4, gp, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gp_eval_cuda(
            xt=torch.from_numpy(X.T.copy()), y=torch.from_numpy(y),
            consts=torch.ones(5), fids=torch.zeros(gp.n_ops + 1, dtype=torch.int32),
            plan=plan, genomes=torch.rand(4, 16), max_nodes=8, n_ops=gp.n_ops,
        )


def _lane_loop_scores(preds, y, tpp):
    """The kernel's sum written out one float32 add at a time: thread
    lane's samples in j order, the shuffle tree, the warps in order."""
    P, B = preds.shape
    out = []
    for p in range(P):
        lanes = []
        for lane in range(tpp):
            sq = np.float32(0)
            for s in range(lane, B, tpp):
                e = np.float32(preds[p, s] - y[s])
                sq = np.float32(sq + e * e)
            lanes.append(sq)
        warps = []
        for w in range(tpp // 32):
            a = lanes[32 * w:32 * (w + 1)]
            for o in (16, 8, 4, 2, 1):
                a = [np.float32(a[i] + a[i + o]) if i + o < 32 else a[i] for i in range(32)]
            warps.append(a[0])
        sq = warps[0]
        for w in warps[1:]:
            sq = np.float32(sq + w)
        s = np.float32(-np.sqrt(np.float32(sq / np.float32(B))))
        out.append(s if np.isfinite(s) else -np.inf)
    return np.array(out, np.float32)


def test_kernel_order_scores_reproduce_a_hand_summed_case():
    """B = 33 at 32 threads: thread 0 adds 2^24 and 1 (the 1 is lost),
    the tree adds the other lanes' ones in pairs, so the sum is
    16,777,246 where one sequential pass would give 2^24."""
    y = torch.zeros(33)
    preds = torch.ones(1, 33)
    preds[0, 0] = 4096.0
    got = ge.kernel_order_scores(preds, y, 32)
    want = np.float32(-np.sqrt(np.float32(16_777_246) / np.float32(33)))
    assert got.item() == want != np.float32(-np.sqrt(np.float32(2**24) / np.float32(33)))
    rng = np.random.default_rng(8)
    for B, tpp in ((130, 64), (70, 32), (1000, 256)):
        p = (rng.standard_normal((3, B)) * rng.choice([1.0, 1e4], (3, B))).astype(np.float32)
        t = rng.standard_normal(B).astype(np.float32)
        got = ge.kernel_order_scores(torch.from_numpy(p), torch.from_numpy(t), tpp).numpy()
        np.testing.assert_array_equal(got, _lane_loop_scores(p, t, tpp))


@pytest.mark.parametrize("shape", [(65_536, 32, 1024), (1024, 16, 64)], ids=["main", "bench"])
def test_kernel_order_scores_agree_with_rmse(shape):
    P, T, B = shape
    plan = ge.gp_eval_plan(P, enc.GPConfig(max_nodes=T, n_vars=2), B)
    rng = np.random.default_rng(B)
    preds = torch.from_numpy(rng.standard_normal((16, B)).astype(np.float32))
    preds[3, 5] = np.inf
    preds[4, 0] = np.nan
    y = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
    got = ge.kernel_order_scores(preds, y, plan["threads_per_program"])
    want = sanitize(rmse_scores(preds, y))
    _close(got, want)
    assert np.isneginf(got[3:5].numpy()).all()


@pytest.mark.parametrize("shape,want", [
    ((65_536, 32, 1024), (256, 1, 8, 4, 35_520)),
    ((1024, 16, 64), (64, 4, 8, 1, 17_920)),
    ((100, 32, 8192), (256, 1, 8, 32, 35_520)),
], ids=["main", "bench", "wide"])
def test_plan_rounds_and_shared_memory(shape, want):
    """tpp, ppb, a block's round of programs (one a warp), the samples a
    thread owns, and the kernel's shared-memory bytes (the stack, T * 32
    floats a warp; the round's token lists; the tables; the round's
    counts and depths; the warps' sums): under 48 KB at the main shape,
    so an SM holds as many blocks as before."""
    P, T, B = shape
    plan = ge.gp_eval_plan(P, enc.GPConfig(max_nodes=T, n_vars=2), B)
    got = (plan["threads_per_program"], plan["programs_per_block"], plan["programs_per_round"],
           plan["samples_per_thread"], plan["smem_bytes"])
    assert got == want
    assert plan["smem_bytes"] <= 48 * 1024 and plan["grid"] == -(-P // plan["programs_per_block"])
