"""PFB channelizer vs the literal mix-filter-decimate bank."""

import numpy as np
import pytest

from digital_signal_processsing_tpu.ops.channelizer import (
    design_prototype,
    pfb_channelize,
)


def _bank_golden(x, h, n):
    """Channel k = causal FIR of (x * e^{-2πikn/N}), sampled every N."""
    t = x.shape[0]
    out = []
    idx = np.arange(t)
    hpad = h.astype(np.float64)
    for k in range(n):
        mixed = x.astype(np.float64) * np.exp(-2j * np.pi * k * idx / n)
        filt = np.convolve(mixed, hpad)[:t]
        out.append(filt[::n])
    return np.stack(out)


@pytest.mark.parametrize("n,p", [(8, 4), (16, 8)])
def test_pfb_matches_literal_bank(rng, n, p):
    t = n * 64
    x = rng.normal(size=t).astype(np.float32)
    h = design_prototype(n, p)
    got = np.asarray(pfb_channelize(x, n, jnp_taps(h)))
    want = _bank_golden(x, h, n)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def jnp_taps(h):
    import jax.numpy as jnp

    return jnp.asarray(h)


def test_pfb_isolates_a_tone(rng):
    n = 16
    t = n * 512
    idx = np.arange(t)
    # tone centered exactly on channel 3
    x = np.cos(2 * np.pi * 3 / n * idx).astype(np.float32)
    y = np.asarray(pfb_channelize(x, n))
    power = np.mean(np.abs(y[:, 32:]) ** 2, axis=1)  # skip filter settling
    assert np.argmax(power) == 3
    others = np.delete(power, [3, n - 3])  # n-3 holds the conjugate image
    assert power[3] > 100 * others.max()


def test_pfb_rejects_bad_shapes(rng):
    with pytest.raises(ValueError, match="multiple"):
        pfb_channelize(np.zeros(100, np.float32), 16)
    with pytest.raises(ValueError, match="flat"):
        pfb_channelize(np.zeros((2, 32), np.float32), 16)


def test_pfb_synthesize_then_analyze_recovers_channels(rng):
    # transmultiplexer direction: bandlimited channel signals survive the
    # synthesize -> wideband -> channelize round trip to prototype accuracy
    import jax.numpy as jnp

    from digital_signal_processsing_tpu.ops.channelizer import pfb_synthesize

    n, m = 8, 2048
    idx = np.arange(m)
    ch = np.zeros((n, m), np.complex64)
    for k in range(n):
        ch[k] = (0.5 + 0.1 * k) * np.exp(2j * np.pi * (0.02 + 0.01 * k) * idx)
    wide = np.asarray(pfb_synthesize(jnp.asarray(ch)))
    assert wide.shape == (n * m,)

    # analysis is linear with real taps: Y(x) = Y(re) + i Y(im)
    back = np.asarray(pfb_channelize(wide.real.copy(), n)) + 1j * np.asarray(
        pfb_channelize(wide.imag.copy(), n)
    )
    for k in (0, 3, 7):
        c = np.correlate(back[k][:512], ch[k][:512], "full")
        d = int(np.argmax(np.abs(c))) - 511
        assert d >= 0
        a = back[k][d:]
        b = ch[k][: a.size]
        n0 = 64
        g0 = (a[n0 : n0 + 1000] / b[n0 : n0 + 1000]).mean()
        err = a[n0 : n0 + 1000] / g0 - b[n0 : n0 + 1000]
        snr = 10 * np.log10(
            np.sum(np.abs(b[n0 : n0 + 1000]) ** 2) / np.sum(np.abs(err) ** 2)
        )
        assert snr > 45, f"channel {k}: {snr:.1f} dB"


def test_pfb_synthesize_planar_matches_complex(rng):
    from digital_signal_processsing_tpu.ops.channelizer import (
        pfb_synthesize,
        pfb_synthesize_planar,
    )
    import jax.numpy as jnp

    ch = (rng.normal(size=(8, 256)) + 1j * rng.normal(size=(8, 256))).astype(
        np.complex64
    )
    want = np.asarray(pfb_synthesize(jnp.asarray(ch)))
    i, q = pfb_synthesize_planar(
        jnp.asarray(ch.real.copy()), jnp.asarray(ch.imag.copy())
    )
    np.testing.assert_allclose(np.asarray(i), want.real, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(q), want.imag, rtol=1e-5, atol=1e-6)


def test_pfb_streaming_chunks_match_one_shot(rng):
    from digital_signal_processsing_tpu.ops.channelizer import (
        pfb_channelize_chunk,
        pfb_stream_init,
    )

    n = 16
    x = rng.normal(size=n * 1024).astype(np.float32)
    want = np.asarray(pfb_channelize(x, n))

    state = pfb_stream_init(n)
    outs, i = [], 0
    for ln in (n * 300, n * 500, n * 224):
        state, y = pfb_channelize_chunk(state, x[i : i + ln], n)
        outs.append(np.asarray(y))
        i += ln
    got = np.concatenate(outs, axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_pfb_chunk_state_taps_mismatch_rejected(rng):
    from digital_signal_processsing_tpu.ops.channelizer import (
        design_prototype,
        pfb_channelize_chunk,
        pfb_stream_init,
    )
    import jax.numpy as jnp
    import pytest as _pytest

    n = 16
    state = pfb_stream_init(n)  # sized for the default 8 taps/phase
    taps16 = jnp.asarray(design_prototype(n, 16))
    with _pytest.raises(ValueError, match="carried state"):
        pfb_channelize_chunk(state, np.zeros(n * 64, np.float32), n, taps16)


def test_pfb_chunk_planar(rng):
    from digital_signal_processsing_tpu.ops.channelizer import (
        pfb_channelize_chunk_planar,
        pfb_stream_init,
    )

    n = 16
    x = rng.normal(size=n * 256).astype(np.float32)
    state = pfb_stream_init(n)
    state, i, q = pfb_channelize_chunk_planar(state, x, n)
    want = np.asarray(pfb_channelize(x, n))
    np.testing.assert_allclose(np.asarray(i), want.real, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(q), want.imag, rtol=1e-4, atol=1e-5)


def _bank_fft(x, h, n):
    """_bank_golden through scipy's fftconvolve: float64, all channels."""
    import scipy.signal as sps

    t = x.shape[0]
    idx = np.arange(t)
    k = np.arange(n)[:, None]
    mixed = x.astype(np.float64)[None, :] * np.exp(-2j * np.pi * k * idx / n)
    filt = sps.fftconvolve(mixed, np.asarray(h, np.float64)[None, :], axes=1)
    return filt[:, :t][:, ::n]


class TestFusedPfb:
    """The composed branch-FIR + DFT path at the shapes the removed fused
    kernels served, against the float64 mix-filter-decimate bank."""

    @staticmethod
    def _err(got, want):
        return np.max(np.abs(got - want)) / np.max(np.abs(want))

    def test_fused_matches_composed(self, rng):
        x = rng.normal(size=64 * 2000).astype(np.float32)
        got = np.asarray(pfb_channelize(x, 64))
        err = self._err(got, _bank_fft(x, design_prototype(64), 64))
        assert err < 1e-5, err

    def test_fused_dilated_matches_composed(self, rng):
        # the 2x-oversampled bank's stride-2 branch filters + DFT matmul
        # against float64 numpy
        import jax.numpy as jnp

        from digital_signal_processsing_tpu.ops.channelizer import (
            branch_fir,
            dft_matmul,
        )

        u = rng.normal(size=(777, 32)).astype(np.float32)
        hq = rng.normal(size=(8, 32)).astype(np.float32)
        v = np.asarray(
            branch_fir(jnp.asarray(u)[None], jnp.asarray(hq), dilation=2)
        )[0]
        re, im = dft_matmul(jnp.asarray(v), None, 32)
        u64 = u.astype(np.float64)
        v64 = np.zeros_like(u64)
        for r in range(8):
            v64[2 * r :] += hq[r].astype(np.float64) * u64[: 777 - 2 * r]
        q = np.arange(32)
        y64 = v64 @ np.exp(2j * np.pi * np.outer(q, q) / 32)
        np.testing.assert_allclose(np.asarray(re), y64.real, atol=1e-4)
        np.testing.assert_allclose(np.asarray(im), y64.imag, atol=1e-4)

    def test_fused_raw_matches_composed(self, rng):
        # the shapes of the removed raw-stream kernel's envelope, including
        # streams shorter than its carry history
        for n, t in [
            (64, 128 * 517),
            (32, 128 * 77),
            (128, 128 * 33),
            (128, 1024),
            (128, 512),
        ]:
            x = rng.normal(size=t).astype(np.float32)
            proto = design_prototype(n, 8)
            got = np.asarray(pfb_channelize(x, n, jnp_taps(proto)))
            err = self._err(got, _bank_fft(x, proto, n))
            assert err < 1e-5, (n, t, err)

    def test_fused_raw_envelope_rejected(self, rng):
        x = rng.normal(size=16 * 100).astype(np.float32)
        with pytest.raises(ValueError):
            pfb_channelize(x, 16, method="fused_raw")

    def test_fused_raw_wide_matches_composed(self, rng):
        # wide banks: whole/partial old tiles and short streams
        for n, t in [
            (256, 256 * 67),
            (256, 256 * 8),
            (512, 512 * 33),
            (1024, 1024 * 9),
        ]:
            x = rng.normal(size=t).astype(np.float32)
            proto = design_prototype(n, 8)
            got = np.asarray(pfb_channelize(x, n, jnp_taps(proto)))
            err = self._err(got, _bank_fft(x, proto, n))
            assert err < 1e-5, (n, t, err)
