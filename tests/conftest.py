"""Test configuration: the CPU backend with 8 virtual devices by default.

Multi-device sharding is validated on a virtual 8-device CPU mesh; the
kernels' XLA paths are numerically identical on the CPU. JAX_PLATFORMS is
only defaulted, so that the tests marked ``gpu`` can run on a GPU host:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Those tests take the ``gpu`` fixture, which skips them when JAX's first
device is not a GPU (decided when the test runs, never at import).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys  # noqa: E402

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent.parent))
from varlociraptor_tpu.utils.jaxcache import enable as _enable_xla_cache  # noqa: E402

_enable_xla_cache()

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE_TESTS = pathlib.Path("/root/reference/tests")
REFERENCE_RESOURCES = REFERENCE_TESTS / "resources"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (see the gpu fixture)"
    )


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def ref_tests():
    """Reference repo tests/ dir (test.bam, chr17.prefix.fa, indels+clips.bam)."""
    if not REFERENCE_TESTS.exists():
        pytest.skip("reference test data not available")
    return REFERENCE_TESTS


@pytest.fixture(scope="session")
def ref_resources():
    """Reference repo tests/resources dir (testcases/, per-test dirs)."""
    if not REFERENCE_RESOURCES.exists():
        pytest.skip("reference test resources not available")
    return REFERENCE_RESOURCES
