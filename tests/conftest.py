"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding tests need multiple devices.  Tests that need an NVIDIA GPU carry
the ``gpu`` marker and take the ``gpu_device`` fixture, which skips them
when JAX finds no GPU; run them on a GPU host with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib  # noqa: E402

import pytest  # noqa: E402

from paffy_tpu.jaxconf import ensure_jax  # noqa: E402

ensure_jax()   # x64 + platform config (lazy since the -S launcher work)

GOLDEN_PAF = pathlib.Path("/root/reference/tests/human_chimp.paf")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips when JAX finds none)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none.  Decided
    here, at run time, never at import: every xdist worker must collect
    the same tests."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU visible to JAX")
    return devs[0]


@pytest.fixture(scope="session")
def golden_paf_path():
    if not GOLDEN_PAF.exists():
        pytest.skip("golden human_chimp.paf not available")
    return GOLDEN_PAF
