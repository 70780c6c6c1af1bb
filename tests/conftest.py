"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Per SURVEY.md 4(c): multi-device sharding is tested on a host-platform
mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8) so multi-card
behaviour is exercised without a GPU.  Set before jax import.

Tests marked ``gpu`` need the card: they skip here, and their checks run
on the card in chip_smoke.py's kernel-parity phase.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skipped on the CPU suite (chip_smoke.py "
        "runs these checks on the card)",
    )


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's device here is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def random_genome(rng, length, seed_contigs=None):
    """Generate a random DNA string."""
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=length)])


@pytest.fixture(scope="session")
def small_reference(rng):
    """A small multi-contig reference with some N bases and a repeat."""
    c1 = random_genome(rng, 5000)
    # embed an exact repeat of a 300bp block to exercise multi-hit logic
    c1 = c1[:1200] + c1[400:700] + c1[1500:]
    c2 = random_genome(rng, 3000)
    c2 = c2[:1000] + "N" * 25 + c2[1025:]
    return [("chr1", "test contig 1", c1), ("chr2", "", c2)]
