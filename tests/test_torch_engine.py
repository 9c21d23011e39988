"""The port's solver (libpga_tpu_torch/engine.py, api.py, interop.py) on
the CPU, against the JAX package's ``PGA`` where the two can be
compared: a population carried across exactly, and whole runs
statistically (the two packages' random streams differ, and on the CPU
JAX's ``PGA.run`` takes its XLA panmictic path, not the deme kernel)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import libpga_tpu
import libpga_tpu_torch as port
from libpga_tpu_torch import interop
from libpga_tpu_torch.ops import kernels

CPU = port.PGAConfig(device="cpu")
ROOT = Path(__file__).resolve().parent.parent


def _port_onemax(seed, size=1024, genome_len=32, config=CPU):
    p = port.pga_init(seed, config)
    h = port.pga_create_population(p, size, genome_len)
    port.pga_set_objective_function(p, "onemax")
    return p, h


def test_pga_flow_on_cpu():
    p, h = _port_onemax(0)
    first = p.population(h).genomes.clone()
    assert first.shape == (1024, 32) and 0.0 <= first.min() and first.max() < 1.0
    assert port.pga_run(p, 25) == 25
    assert p.launches == 25
    best = port.pga_get_best(p, h)
    g, score = p.get_best_with_score(h)
    assert best.shape == (32,) and np.array_equal(best, g)
    assert score == pytest.approx(float(best.sum()), rel=1e-5)
    # initial OneMax best of 1024 rows of 32 genes is ~21; 25 generations
    # of selection push it well past that
    assert score > 26.0
    top = p.get_best_top(h, 5)
    assert top.shape == (5, 32) and np.array_equal(top[0], best)
    port.pga_deinit(p)
    assert not p._populations


def test_same_seed_same_run():
    runs = []
    for _ in range(2):
        p, h = _port_onemax(3, size=600, genome_len=20)
        p.run(6)
        runs.append(p.population(h).genomes)
    assert torch.equal(*runs)


@pytest.mark.parametrize("size", [1024, 2100])  # ping-pong; riffle, padded
def test_target_stops_at_the_exact_generation(size):
    """The run returns the first generation whose best reaches the
    target: one generation fewer stays below it."""
    target = 28.0
    p, h = _port_onemax(5, size=size)
    gens = p.run(1000, target=target)
    assert 0 < gens < 1000
    best = p.get_best_with_score(h)[1]
    assert best >= target
    before, h = _port_onemax(5, size=size)
    before.run(gens - 1)
    assert before.get_best_with_score(h)[1] < target
    again, h = _port_onemax(5, size=size)
    again.run(gens)
    assert again.get_best_with_score(h)[1] == best


def test_error_paths():
    p = port.pga_init(0, CPU)
    with pytest.raises(ValueError):
        port.pga_create_population(p, 100, 3)
    with pytest.raises(KeyError):
        port.pga_set_objective_function(p, "no_such_objective")
    port.pga_create_population(p, 256, 8)
    with pytest.raises(RuntimeError):
        port.pga_run(p, 1)
    with pytest.raises(ValueError, match="bfloat16"):
        port.PGAConfig(gene_dtype=torch.float16)
    assert port.PGAConfig(gene_dtype=torch.bfloat16).gene_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        port.PGAConfig(tournament_size=0)
    assert port.PGAConfig(tournament_size=17).tournament_size == 17  # panmictic, as in JAX


def test_cuda_default_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert port.PGAConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.pga_init(0)


def test_population_too_small_for_the_deme_path_raises():
    """Under 128 rows the deme geometry declines, as in JAX. The port
    then runs the panmictic path (JAX's XLA path) instead of raising."""
    p = port.pga_init(0, CPU)
    h = port.pga_create_population(p, 100, 8)
    port.pga_set_objective_function(p, "onemax")
    assert not p.uses_deme_kernel(100, 8)
    assert p.run(3) == 3 and p.launches == 0
    s = p.population(h).scores
    assert s.shape == (100,) and torch.isfinite(s).all()


def test_install_population_from_jax():
    jp = libpga_tpu.PGA(seed=0)
    jh = jp.create_population(1000, 20)
    jp.set_objective("onemax")
    jp.evaluate(jh)
    jpop = jp.population(jh)
    state = interop.state_from_numpy(
        np.asarray(jpop.genomes), np.asarray(jpop.scores), device="cpu"
    )
    p = port.pga_init(1, CPU)
    h = p.install_population(state)
    np.testing.assert_array_equal(p.population(h).genomes.numpy(), np.asarray(jpop.genomes))
    np.testing.assert_array_equal(p.population(h).scores.numpy(), np.asarray(jpop.scores))
    p.set_objective("onemax")
    assert p.get_best_with_score(h)[1] == pytest.approx(
        jp.get_best_with_score(jh)[1], rel=1e-6
    )
    assert p.run(3) == 3
    # a plain matrix installs too, unevaluated
    h2 = p.install_population(np.asarray(jpop.genomes))
    assert torch.isinf(p.population(h2).scores).all()


def test_rowwise_custom_objective_and_elitism():
    cfg = port.PGAConfig(device="cpu", elitism=2, selection="truncation")
    p = port.pga_init(4, cfg)
    h = p.create_population(600, 16)
    p.set_objective(lambda m: -torch.sum((m - 0.25) ** 2, dim=1))
    p.run(1)
    best = p.get_best_with_score(h)[1]
    p.run(10)
    # elitism keeps the best score monotone
    assert p.get_best_with_score(h)[1] >= best


def test_whole_run_statistics_match_jax():
    """OneMax 4096x32, best after 30 generations, three populations per
    package. The port's deme tournament and JAX's panmictic tournament
    have the same selection intensity, so the mean bests agree within
    1% (the spread between seeds is about 0.4%)."""
    n, size, L = 30, 4096, 32
    jp = libpga_tpu.PGA(seed=0)
    jp.set_objective("onemax")
    jbest = []
    for _ in range(3):
        jh = jp.create_population(size, L)
        jp.run(n, population=jh)
        jbest.append(jp.get_best_with_score(jh)[1])
    pbest = []
    for seed in range(3):
        p, h = _port_onemax(seed, size=size, genome_len=L)
        p.run(n)
        pbest.append(p.get_best_with_score(h)[1])
    assert np.mean(pbest) == pytest.approx(np.mean(jbest), rel=0.01)


IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "libpga_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "ab_run.py"]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        for mod in IMPORT.findall(text):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "libpga_tpu"), f"{f}: imports {mod}"
        assert "__import__(" not in text and "import_module(" not in text, f


def test_cpu_run_counts_breeds_but_launches_no_kernel():
    before = dict(kernels.LAUNCHES)
    p, h = _port_onemax(2, size=1000, genome_len=20)
    assert p.run(7) == 7 and p.run(3) == 3
    assert p.launches == 10
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("size,elitism", [(8, 20), (1024, 2000), (8, 8)])
def test_elitism_above_the_population_size_raises_in_both(size, elitism):
    """Elitism above the size raises ValueError in both packages (JAX:
    ``lax.top_k``); ``elitism == size`` runs in both."""
    jp = libpga_tpu.PGA(seed=0, config=libpga_tpu.PGAConfig(elitism=elitism))
    jp.create_population(size, 16)
    jp.set_objective("onemax")
    p, _ = _port_onemax(0, size=size, genome_len=16,
                        config=port.PGAConfig(device="cpu", elitism=elitism))
    if elitism > size:
        with pytest.raises(ValueError):
            jp.run(2)
        with pytest.raises(ValueError, match="exceeds the population size"):
            p.run(2)
    else:
        assert jp.run(2) == p.run(2) == 2


def _two_populations(pkg, seed, config):
    pga = pkg.pga_init(seed, config)
    handles = [pkg.pga_create_population(pga, 64, 8) for _ in range(2)]
    pkg.pga_set_objective_function(pga, "onemax")
    for h in handles:
        assert pga.run(2, population=h) == 2
    return pga, handles[0]


TOP_CALLS = {
    "get_best_top": lambda pkg, pga, h, k: pga.get_best_top(h, k),
    "get_best_top_all": lambda pkg, pga, h, k: pga.get_best_top_all(k),
    "pga_get_best_top": lambda pkg, pga, h, k: pkg.pga_get_best_top(pga, h, k),
    "pga_get_best_top_all": lambda pkg, pga, h, k: pkg.pga_get_best_top_all(pga, k),
}


@pytest.mark.parametrize("k", [-1, -64])
@pytest.mark.parametrize("call", sorted(TOP_CALLS))
def test_negative_top_k_raises_jax_s_value_error(call, k):
    """A negative k raises ``lax.top_k``'s ValueError in both packages,
    in the four top-k calls (two 64x8 populations after 2 generations);
    at k = 3 both return 3 (or, across populations, 3) rows."""
    fn = TOP_CALLS[call]
    jp, jh = _two_populations(libpga_tpu, 0, None)
    p, h = _two_populations(port, 0, CPU)
    with pytest.raises(ValueError) as want:
        fn(libpga_tpu, jp, jh, k)
    with pytest.raises(ValueError) as got:
        fn(port, p, h, k)
    assert "must be nonnegative" in str(want.value)
    assert str(got.value) == "k argument to top_k must be nonnegative"
    assert fn(libpga_tpu, jp, jh, 3).shape == fn(port, p, h, 3).shape == (3, 8)
