"""The port's reading of the JAX package's ``PGAConfig``
(libpga_tpu_torch/interop.py, ``pga_config_from_fields``) over EVERY field
of that dataclass: each field is carried, accepted with a stated reason,
or refused with ``NotImplementedError`` naming the ROADMAP item that ports
it. A field that JAX adds later fails ``test_every_jax_field_is_decided``
until the port decides it."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import libpga_tpu
from libpga_tpu.utils.telemetry import TelemetryConfig
from libpga_tpu_torch import interop
from libpga_tpu_torch.config import PGAConfig

JAX_FIELDS = [f.name for f in dataclasses.fields(libpga_tpu.PGAConfig)]

# A value other than JAX's default for every field of its PGAConfig.
NON_DEFAULT = {
    "tournament_size": 3,
    "selection": "truncation",
    "selection_param": 0.3,
    "mutation_rate": 0.05,
    "elitism": 2,
    "gene_dtype": jnp.bfloat16,
    "max_populations": 3,
    "migration_topology": "random",
    "use_pallas": False,
    "pallas_deme_size": 256,
    "pallas_generations_per_launch": 4,
    "pallas_layout": "riffle",
    "pallas_subblock": 2,
    "pop_shards": 4,
    "donate_buffers": False,
    "validate": True,
    "fallback": "raise",
    "telemetry": TelemetryConfig(),
    "seed": 7,
}

# What each converted field becomes on the port's config.
CONVERTED = {
    "use_pallas": ("use_deme_kernel", False),
    "gene_dtype": ("gene_dtype", torch.bfloat16),
}


def _port(**jax_fields) -> PGAConfig:
    return interop.pga_config_from_fields(libpga_tpu.PGAConfig(**jax_fields), device="cpu")


def test_every_jax_field_is_decided():
    decided = (set(interop.PGA_FIELDS.values()) | set(interop.CONVERTED_FIELDS)
               | set(interop.ACCEPTED_FIELDS) | set(interop.UNPORTED_FIELDS))
    assert set(JAX_FIELDS) <= decided, sorted(set(JAX_FIELDS) - decided)
    assert set(JAX_FIELDS) == set(NON_DEFAULT), "the test's table must name every field"
    for name, reason in interop.ACCEPTED_FIELDS.items():
        assert reason, name


def test_default_config_crosses_as_the_port_default():
    assert _port() == PGAConfig(device="cpu")


@pytest.mark.parametrize("field", JAX_FIELDS)
def test_round_trip_of_a_non_default_field(field):
    """One JAX field set away from its default, everything else default:
    the port's config holds the same value under the port's name (read
    back by the JAX name through the tables), or the port's default where
    the field is accepted, or the conversion raises naming the item."""
    value = NON_DEFAULT[field]
    if field in interop.UNPORTED_FIELDS:
        item = interop.UNPORTED_FIELDS[field][1]
        with pytest.raises(NotImplementedError, match=item.split(" (")[0]):
            _port(**{field: value})
        return
    got = _port(**{field: value})
    ours = {theirs: mine for mine, theirs in interop.PGA_FIELDS.items()}
    if field in ours:
        assert getattr(got, ours[field]) == value
        assert got == dataclasses.replace(PGAConfig(device="cpu"), **{ours[field]: value})
    elif field in CONVERTED:
        name, want = CONVERTED[field]
        assert getattr(got, name) == want
        assert got == dataclasses.replace(PGAConfig(device="cpu"), **{name: want})
    else:
        assert field in interop.ACCEPTED_FIELDS
        assert got == PGAConfig(device="cpu")


@pytest.mark.parametrize("field,off", [("pallas_subblock", 1), ("pop_shards", 1),
                                       ("validate", False), ("telemetry", None)])
def test_unported_fields_at_off_cross(field, off):
    """An unported field at its "off" value crosses as the port's default.
    ``pallas_subblock`` is ported now (the port's ``subblock``): it crosses
    at any value >= 1, ``off`` among them."""
    if field in interop.PGA_FIELDS.values():
        for value in (off, 2, 4):
            assert _port(**{field: value}) == PGAConfig(device="cpu", subblock=value)
        return
    assert _port(**{field: off}) == PGAConfig(device="cpu")


def test_islands_settings_cross_and_drive_the_port():
    """``migration_topology`` and ``max_populations`` reach the port's
    solver: the cap holds, and the random ring draws a new order."""
    import libpga_tpu_torch as port

    cfg = _port(migration_topology="random", max_populations=2)
    assert (cfg.migration_topology, cfg.max_populations) == ("random", 2)
    p = port.pga_init(0, cfg)
    port.pga_create_population(p, 64, 8)
    port.pga_create_population(p, 64, 8)
    with pytest.raises(RuntimeError, match="max_populations"):
        port.pga_create_population(p, 64, 8)
