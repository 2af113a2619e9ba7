"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Correctness tests run on CPU (deterministic, fast recompiles); sharding
tests use the 8 virtual devices. Tests that need the GPU take the `gpu`
fixture and skip there; chip_smoke.py runs their checks on the card, and
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` runs the tests
themselves on a GPU machine.
"""

import os
import subprocess

# must be set before jax is imported anywhere
PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
if PLATFORMS == "cpu":
    os.environ["JAX_PLATFORM_NAME"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", PLATFORMS)

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "oracle", "detect_oracle")
GOLDEN = os.path.join(REPO, "tests", "golden")


def _ensure_oracle():
    """Build the OpenCV parity oracle if possible; None when unavailable."""
    if os.path.exists(ORACLE):
        return ORACLE
    try:
        subprocess.run(
            ["make", "-C", os.path.join(REPO, "oracle"), "detect_oracle"],
            check=True,
            capture_output=True,
        )
        return ORACLE if os.path.exists(ORACLE) else None
    except Exception:
        return None


@pytest.fixture(scope="session")
def oracle_bin():
    path = _ensure_oracle()
    if path is None:
        pytest.skip("OpenCV C++ oracle not available")
    return path


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; the card runs this check in chip_smoke.py")
