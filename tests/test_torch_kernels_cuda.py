"""The deme-breed CUDA kernel (libpga_tpu_torch/csrc/deme_breed.cu)
against its plain torch version, on the card. These tests skip on a
machine without one. They import neither JAX nor the JAX package, so
they run where only torch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from libpga_tpu_torch.objectives import onemax, onemax_bits
from libpga_tpu_torch.ops import fused_step as fs
from libpga_tpu_torch.ops import kernels


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (P, L, layout, selection, selection_param, k, mutate, objective, gene_atol)
# gene_atol is 0 (exact) except for gaussian mutation, whose log and cos
# may differ in the last ulp between the kernel and torch's own kernels.
VARIANTS = [
    (8192, 100, None, "tournament", None, 2, "point", onemax, 0.0),
    (1000, 100, None, "tournament", None, 2, "point", onemax, 0.0),
    (2100, 100, None, "tournament", None, 4, "swap", onemax_bits, 0.0),
    (1000, 300, "riffle", "truncation", 0.3, 2, "point", None, 0.0),
    (1000, 20, None, "linear_rank", 1.7, 3, "gaussian", onemax, 1e-6),
    (256, 3968, None, "tournament", None, 3, "point", onemax, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: f"{v[0]}x{v[1]}-{v[3]}-{v[6]}")
def test_kernel_equals_plain_on_card(cuda_device, variant):
    """The kernel equals its plain version on the same inputs, in
    production (Philox) and injected mode, every parity of the layout."""
    P, L, layout, sel, param, k, mutate, obj, atol = variant
    geom = fs.resolve_geometry(
        P, L, layout=layout, tournament_size=k, selection=sel,
        selection_param=param, fused=obj is not None,
    )
    gen = torch.Generator(device=cuda_device).manual_seed(P + L)
    g = torch.rand((geom.Pp, L), generator=gen, device=cuda_device)
    s = torch.rand(geom.Pp, generator=gen, device=cuda_device)
    s[P:] = -torch.inf
    kw = dict(tournament_size=k, selection=sel, selection_param=param,
              mutate=mutate, mparams=torch.tensor([0.3, 0.05], device=cuda_device),
              obj_id=0 if obj is None else obj.fused_id)
    for parity in range(geom.parities):
        ranks = fs.compute_ranks(s, geom, parity, fs.draw_tie_words(gen, geom.Pp, cuda_device))
        seed = torch.randint(0, 2**62, (1,), generator=gen, device=cuda_device)
        draws = fs.philox_draws(seed, geom.G, geom.K, L, mutate)
        want = fs.deme_breed_reference(g, ranks, geom, parity, draws, **kw)
        for got in (fs.deme_breed(g, ranks, geom, parity, seed=seed, **kw),
                    fs.deme_breed(g, ranks, geom, parity, draws=draws, **kw)):
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=atol)
            if obj is None:
                assert got[1] is None and want[1] is None
            else:
                torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda_device):
    geom = fs.resolve_geometry(1000, 20)
    g = torch.rand((geom.Pp, 20), device=cuda_device)
    ranks = torch.zeros((geom.G, geom.K), dtype=torch.int32, device=cuda_device)
    seed = torch.tensor([1], dtype=torch.int64, device=cuda_device)
    mp = torch.tensor([0.01, 0.0], device=cuda_device)
    with pytest.raises(ValueError, match="ranks"):
        fs.deme_breed(g, ranks.long(), geom, 0, seed=seed, mparams=mp)
    with pytest.raises(ValueError, match="alias"):
        fs.deme_breed(g, ranks, geom, 0, seed=seed, mparams=mp, out=g)
    with pytest.raises(ValueError, match="genomes"):
        fs.deme_breed(g[:, :10].contiguous(), ranks, geom, 0, seed=seed, mparams=mp)
    before = kernels.LAUNCHES["pingpong"]
    fs.deme_breed(g, ranks, geom, 0, seed=seed, mparams=mp)
    assert kernels.LAUNCHES["pingpong"] == before + 1


@pytest.mark.cuda
def test_engine_on_card_counts_one_launch_per_generation(cuda_device):
    from libpga_tpu_torch import pga_create_population, pga_init, pga_run
    from libpga_tpu_torch import pga_set_objective_function

    p = pga_init(0)
    pga_create_population(p, 40_000, 100)
    pga_set_objective_function(p, "onemax")
    kernels.reset_launches()
    assert pga_run(p, 12) == 12
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"pingpong": 0, "riffle": 12}
