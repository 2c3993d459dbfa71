"""Test configuration: run everything on an 8-device virtual CPU mesh.

Multi-device hardware is not available in CI; per SURVEY.md §4 the fake
distributed backend is JAX's host-platform device multiplication. Must run
before the first ``import jax`` anywhere in the test process.

Tests that need a GPU carry the ``gpu`` marker (registered in
pyproject.toml) and take the ``gpu_device`` fixture, which skips them
here; ``python chip_smoke.py`` runs what they cover on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Keep test compiles fast and deterministic.
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", jax.default_backend()
assert jax.device_count() == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0xD5B)


def make_interleaved(rng, frames: int, channels: int) -> np.ndarray:
    """Random int16 interleaved stream covering the full dynamic range."""
    return rng.integers(-32768, 32768, size=frames * channels, dtype=np.int16)
