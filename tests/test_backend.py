"""Which engine runs where, the compile cache's place, the chain reference,
and the GPU smoke script's refusal to run anywhere else."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from digital_signal_processsing_tpu.ops.moving_average import auto_method
from digital_signal_processsing_tpu.utils import backend, cache
from digital_signal_processsing_tpu.utils.dispatch import last_choice

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "digital_signal_processsing_tpu"


# --- backend -> engine table --------------------------------------------------


@pytest.mark.parametrize(
    "platform,engines",
    [("gpu", ("triton", "xla")), ("cpu", ("xla",)), ("rocm", ("xla",))],
)
def test_engine_table(platform, engines):
    assert backend.engines(platform) == engines
    assert backend.has_engine("xla", platform)
    assert backend.has_engine("triton", platform) == (platform == "gpu")  # else XLA


def test_running_backend_is_cpu_here():
    assert backend.engines() == ("xla",)


@pytest.mark.parametrize(
    "window,channels,platform,method",
    [
        (16, 2, "gpu", "windowed"),
        (1024, 2, "gpu", "windowed"),
        (65535, 128, "gpu", "windowed"),
        (16, 3, "gpu", "xla_scan"),  # Triton tiles need power-of-two sides
        (16, 256, "gpu", "xla_scan"),  # beyond the widest tile
        (16, 2, "cpu", "xla_scan"),
        (16, 2, "rocm", "xla_scan"),  # any other backend: XLA only
    ],
)
def test_moving_average_auto_method(window, channels, platform, method):
    assert auto_method(window, channels, platform) == method


def test_streaming_chunk_records_its_engine(rng):
    from digital_signal_processsing_tpu.ops.streaming import (
        moving_average_chunk,
        moving_average_init,
    )

    x = rng.integers(-32768, 32768, size=512, dtype=np.int16)
    moving_average_chunk(moving_average_init(8, 2), x, 8, 2)
    assert last_choice("moving_average_chunk") == "xla_scan"


def _sources():
    return [p for p in PACKAGE.rglob("*.py")] + [
        ROOT / "bench.py",
        ROOT / "chip_smoke.py",
        ROOT / "__graft_entry__.py",
    ]


def test_no_production_path_interprets():
    # no module of the earlier accelerator's Pallas route, no interpret
    # switch keyed on the backend, no interpret=True outside the tests
    bad = re.compile(
        r"pallas\.tpu|pallas import tpu|pltpu|interpret=jax|interpret=True"
        r'|default_backend\(\) *[!=]= *"tpu"'
    )
    hits = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in _sources()
        for i, text in enumerate(p.read_text().splitlines(), 1)
        if bad.search(text)
    ]
    assert hits == []


def test_every_pallas_call_names_its_gpu_route():
    for p in _sources():
        text = p.read_text()
        for m in re.finditer(r"pl\.pallas_call\(", text):
            call = text[m.end() : m.end() + 2000]
            assert re.search(r'backend="(triton|mosaic_gpu)"', call), p


# --- persistent compile cache -------------------------------------------------


@pytest.fixture
def restore_cache_config():
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)


def test_cache_uses_the_env_var_and_sets_nothing(
    monkeypatch, tmp_path, restore_cache_config
):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_persistent_cache() == tmp_path / "c"
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_a_fixed_dir_in_the_checkout(
    monkeypatch, restore_cache_config
):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    path = cache.enable_persistent_cache()
    assert path == ROOT / ".jax_cache" == cache.DEFAULT_DIR
    assert path.is_dir()
    assert jax.config.jax_compilation_cache_dir == str(path)
    assert cache.enable_persistent_cache() == path  # same place every call


def test_cache_dir_is_ignored_by_git():
    lines = (ROOT / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in lines


# --- float64 FM chain reference -----------------------------------------------


def _chain_and_signal(t):
    from digital_signal_processsing_tpu.golden.fm_chain import fm_test_signal
    from digital_signal_processsing_tpu.models.chain import ChainConfig, DspChain

    chain = DspChain(ChainConfig(channels=16, decimation=8))
    i, q = fm_test_signal(chain.config.lo_frequencies(), t)
    return chain, i, q


def _reference(chain, i, q, channels):
    from digital_signal_processsing_tpu.golden.fm_chain import fm_chain_reference
    from digital_signal_processsing_tpu.ops.fir import design_lowpass

    c = chain.config
    return fm_chain_reference(
        i[:channels],
        q[:channels],
        c.lo_frequencies()[:channels],
        np.asarray(chain.channel_taps),
        design_lowpass(8 * c.decimation, 0.8 / c.decimation),
        np.asarray(chain.audio_taps),
        c.decimation,
        c.fm_gain,
    )


def test_chain_matches_float64_reference():
    from digital_signal_processsing_tpu.golden.fm_chain import tone_snr_db

    chain, i, q = _chain_and_signal(1 << 14)
    out = np.asarray(chain.forward_planar(i, q))
    ref = _reference(chain, i, q, 4)
    c = chain.config
    ramp = (c.channel_taps + 8 * c.decimation) // c.decimation + c.audio_taps
    rms = np.sqrt(np.mean(ref[:, ramp:] ** 2))
    assert np.max(np.abs(out[:4, ramp:] - ref[:, ramp:])) / rms < 1e-4
    assert tone_snr_db(out[:, ramp:], 0.002 * c.decimation) > 30.0


def test_chain_reference_matches_a_literal_loop():
    # the reference's vectorized stages against per-sample definitions
    from digital_signal_processsing_tpu.golden.fm_chain import fm_chain_reference

    rng = np.random.default_rng(3)
    t, d = 96, 4
    i, q = rng.standard_normal((2, 1, t))
    f = np.array([0.13])
    hc, hd, ha = rng.standard_normal(9), rng.standard_normal(8), rng.standard_normal(5)
    got = fm_chain_reference(i, q, f, hc, hd, ha, d, 0.7)[0]

    z = (i[0] + 1j * q[0]) * np.exp(-2j * np.pi * f[0] * np.arange(t))

    def fir(x, h):
        return np.array(
            [sum(h[j] * x[n - j] for j in range(len(h)) if n - j >= 0)
             for n in range(len(x))]
        )

    dec = fir(fir(z, hc), hd)[::d]
    disc = [0.0] + [
        0.7 * np.angle(dec[m] * np.conj(dec[m - 1])) for m in range(1, len(dec))
    ]
    np.testing.assert_allclose(got, fir(np.array(disc), ha), atol=1e-9)


def test_fm_test_signal_snr():
    from digital_signal_processsing_tpu.golden.fm_chain import fm_test_signal

    i, q = fm_test_signal(np.array([0.1, -0.2]), 1 << 14, snr_db=30.0, seed=1)
    n = np.arange(1 << 14)
    phase = 2 * np.pi * np.mod(0.1 * n, 1.0) + 5.0 * np.sin(2 * np.pi * 0.002 * n)
    noise = (i[0] + 1j * q[0]) - np.exp(1j * phase)
    snr = 10 * np.log10(1.0 / np.mean(np.abs(noise) ** 2))
    assert abs(snr - 30.0) < 0.5
    assert i.dtype == np.float32 and i.shape == (2, 1 << 14)


# --- chip_smoke.py refuses to run off the GPU ---------------------------------


def _run_smoke(cwd, script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, str(script)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def _no_result(proc):
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    try:
        return not json.loads(last[0]).get("ok")
    except ValueError:
        return True


def test_chip_smoke_refuses_the_cpu():
    proc = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert _no_result(proc)
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert _no_result(proc)
