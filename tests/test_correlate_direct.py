"""Direct (banded conv) correlate path vs scipy/numpy and the FFT path.

Round-4 addition: ops.correlate grew a ``method='direct'`` spelling that
lowers the reversed (conjugated) template onto ops.fir.blocked_causal_conv
— the radar matched filter's fast path (the FFT path runs three padded
pow2 transforms regardless of template length). Parity here is on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest

from digital_signal_processsing_tpu.ops import correlate as C

jnp = pytest.importorskip("jax.numpy")


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("ta,tv", [(300, 7), (1024, 128), (513, 64), (64, 64)])
def test_real_direct_matches_numpy(rng, mode, ta, tv):
    a = rng.normal(size=(3, ta)).astype(np.float32)
    v = rng.normal(size=tv).astype(np.float32)
    want = np.stack(
        [np.correlate(r.astype(np.float64), v.astype(np.float64), mode) for r in a]
    )
    got = np.asarray(C.correlate(jnp.asarray(a), jnp.asarray(v), mode, method="direct"))
    assert got.shape == want.shape
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert err < 5e-6, (ta, tv, mode, err)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_complex_direct_matches_numpy(rng, mode):
    ta, tv = 1000, 33
    ac = rng.normal(size=(2, ta)) + 1j * rng.normal(size=(2, ta))
    vc = rng.normal(size=tv) + 1j * rng.normal(size=tv)
    want = np.stack([np.correlate(r, vc, mode) for r in ac])
    fr, fi = C.correlate_complex(
        jnp.asarray(ac.real, jnp.float32),
        jnp.asarray(ac.imag, jnp.float32),
        jnp.asarray(vc.real, jnp.float32),
        jnp.asarray(vc.imag, jnp.float32),
        mode,
        method="direct",
    )
    got = np.asarray(fr) + 1j * np.asarray(fi)
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert err < 5e-6, (mode, err)


def test_direct_equals_fft_path(rng):
    """The two engines are the same function at f32 tolerance."""
    a = rng.normal(size=(2, 4096)).astype(np.float32)
    v = rng.normal(size=200).astype(np.float32)
    d = np.asarray(C.correlate(jnp.asarray(a), jnp.asarray(v), "full", method="direct"))
    f = np.asarray(C.correlate(jnp.asarray(a), jnp.asarray(v), "full", method="xla"))
    scale = np.abs(f).max()
    assert np.abs(d - f).max() / scale < 1e-5


def test_auto_picks_direct_at_radar_shape(rng):
    """The auto resolver routes long-stream/short-template to direct."""
    assert (
        C._resolve_corr_method("auto", 1 << 20, 128, 1) == "direct"
    )
    # short stream stays on the DFT engine
    assert C._resolve_corr_method("auto", 8192, 128, 1) == "auto"
    # long template stays on the DFT engine
    assert C._resolve_corr_method("auto", 1 << 20, 8192, 1) == "auto"
    # batched template cannot ride direct
    assert C._resolve_corr_method("auto", 1 << 20, 128, 2) == "auto"


def test_direct_rejects_batched_template(rng):
    with pytest.raises(ValueError, match="1-D template"):
        C.correlate(
            jnp.zeros((2, 100)), jnp.zeros((2, 5)), "full", method="direct"
        )


def test_auto_long_stream_parity(rng):
    """End-to-end: auto at a shape that now rides direct matches numpy."""
    ta, tv = 1 << 17, 96
    a = rng.normal(size=ta).astype(np.float32)
    v = rng.normal(size=tv).astype(np.float32)
    got = np.asarray(C.correlate(jnp.asarray(a), jnp.asarray(v), "valid"))
    want = np.correlate(a.astype(np.float64), v.astype(np.float64), "valid")
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert err < 5e-6


def test_gauss_matches_direct(rng):
    # the 3-multiplication complex identity (method='direct_gauss') must
    # match the 4-conv direct spelling within f32 recombination rounding
    ar = rng.standard_normal((4, 3000)).astype(np.float32)
    ai = rng.standard_normal((4, 3000)).astype(np.float32)
    vr = rng.standard_normal(128).astype(np.float32)
    vi = rng.standard_normal(128).astype(np.float32)
    for mode in ("full", "valid"):
        r4, i4 = C.correlate_complex(
            jnp.asarray(ar), jnp.asarray(ai), jnp.asarray(vr),
            jnp.asarray(vi), mode, method="direct",
        )
        r3, i3 = C.correlate_complex(
            jnp.asarray(ar), jnp.asarray(ai), jnp.asarray(vr),
            jnp.asarray(vi), mode, method="direct_gauss",
        )
        scale = float(np.max(np.abs(np.asarray(r4))))
        assert float(np.max(np.abs(np.asarray(r3 - r4)))) / scale < 1e-5
        assert float(np.max(np.abs(np.asarray(i3 - i4)))) / scale < 1e-5


def test_gauss_rejects_real_correlate(rng):
    with pytest.raises(ValueError):
        C.correlate(
            jnp.asarray(rng.standard_normal(512).astype(np.float32)),
            jnp.asarray(rng.standard_normal(16).astype(np.float32)),
            method="direct_gauss",
        )
