"""Smoke: every example script runs clean on CPU and reports success."""

import subprocess
import sys
from pathlib import Path

import pytest

EXAMPLES = sorted((Path(__file__).parents[1] / "examples").glob("*.py"))


# Each example runs through a shim that pins the CPU platform via
# jax.config BEFORE any backend query.
_CPU_SHIM = (
    "import sys, runpy, jax; "
    "jax.config.update('jax_platforms', 'cpu'); "
    "runpy.run_path(sys.argv.pop(1), run_name='__main__')"
)


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.name)
def test_example_runs(script):
    r = subprocess.run(
        [sys.executable, "-c", _CPU_SHIM, str(script)],
        capture_output=True,
        text=True,
        timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "MISS" not in r.stdout
