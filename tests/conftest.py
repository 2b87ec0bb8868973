"""Test configuration.

By default (``--device cpu``) the suite runs on the CPU with an 8-device
virtual mesh (XLA_FLAGS is read when the CPU client is first created), so
the multi-device sharding logic is checked without hardware.  Tests that
need the card carry the ``gpu`` marker and the ``gpu_device`` fixture;
run them with ``pytest -m gpu --device gpu``.
"""

import os

import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="include tests marked slow (>10 s; CI-nightly tier)")
    parser.addoption(
        "--device", choices=("cpu", "gpu"), default="cpu",
        help="cpu (default): pin JAX to the CPU with 8 virtual devices; "
             "gpu: leave JAX on its default backend for -m gpu tests")


def pytest_configure(config):
    if config.getoption("--device") != "cpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


def pytest_collection_modifyitems(config, items):
    """Skip @pytest.mark.slow by default so the everyday suite stays fast;
    `--runslow` (or an explicit -m expression) runs the full tier."""
    if config.getoption("--runslow") or config.getoption("-m"):
        return
    skip_slow = pytest.mark.skip(reason="slow tier; run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def gpu_device(request):
    """The first GPU; skips unless the run asked for the card
    (``--device gpu``) and JAX sees one."""
    if request.config.getoption("--device") != "gpu":
        pytest.skip("needs the card: pytest -m gpu --device gpu")
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x7E74A)


@pytest.fixture(scope="session")
def noisy_carrier_iq():
    """10 ms of a noisy complex carrier at 2.4 MS/s (mirrors the reference
    fixture tests/conftest.py:53-67)."""
    fs = 2.4e6
    n = int(fs * 0.010)
    t = np.arange(n) / fs
    rng_ = np.random.default_rng(42)
    sig = np.exp(2j * np.pi * 10e3 * t)
    noise = (rng_.standard_normal(n) + 1j * rng_.standard_normal(n)) * 0.1
    return (sig + noise).astype(np.complex64)
