"""FFT stage: wrapper parity with NumPy, STFT framing, periodogram peaks."""

import jax.numpy as jnp
import numpy as np
import pytest

from digital_signal_processsing_tpu.ops.fft import (
    fft,
    ifft,
    irfft,
    power_spectrum,
    rfft,
    stft,
)


def test_fft_matches_numpy(rng):
    x = rng.normal(size=(4, 1024)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(fft(x)), np.fft.fft(x), rtol=1e-4, atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(rfft(x)), np.fft.rfft(x), rtol=1e-4, atol=1e-2
    )


def test_fft_roundtrip(rng):
    x = rng.normal(size=512).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(irfft(rfft(x), 512)), x, rtol=1e-5, atol=1e-5
    )
    z = np.asarray(ifft(fft(x)))
    np.testing.assert_allclose(z.real, x, rtol=1e-5, atol=1e-5)


def test_stft_shapes_and_content(rng):
    t = np.arange(8192)
    x = np.sin(2 * np.pi * 0.05 * t).astype(np.float32)
    s = np.asarray(stft(x, nfft=512, hop=128))
    assert s.shape == ((8192 - 512) // 128 + 1, 257)
    # tone at 0.05 cyc/sample -> bin 0.05*512 = 25.6
    peak = np.argmax(np.abs(s).mean(axis=0))
    assert peak in (25, 26)
    # multichannel keeps the channel axis
    s2 = np.asarray(stft(np.stack([x, x]), nfft=512, hop=128))
    assert s2.shape == (2, (8192 - 512) // 128 + 1, 257)


def test_stft_framing_matches_direct(rng):
    # the gather-free framing must produce exactly x[i*hop : i*hop+nfft]
    x = rng.normal(size=4000).astype(np.float32)
    s = np.asarray(stft(x, nfft=256, hop=100, window="rect"))
    for i in (0, 7, 37):
        want = np.fft.rfft(x[i * 100 : i * 100 + 256])
        np.testing.assert_allclose(s[i], want, rtol=1e-4, atol=1e-2)


def test_power_spectrum_peak(rng):
    t = np.arange(1 << 14)
    x = (np.sin(2 * np.pi * 0.1 * t) + 0.01 * rng.normal(size=t.size)).astype(
        np.float32
    )
    p = np.asarray(power_spectrum(x, nfft=1024))
    assert abs(int(np.argmax(p[1:])) + 1 - round(0.1 * 1024)) <= 1


def test_stft_rejects_unknown_window(rng):
    with pytest.raises(ValueError):
        stft(rng.normal(size=1024).astype(np.float32), window="kaiser")


def test_hilbert_analytic_signal(rng):
    from digital_signal_processsing_tpu.ops.fft import envelope, hilbert

    # analytic signal of cos is exp(i*theta): envelope 1, imag = sin
    # (bin-aligned tone: the FFT Hilbert is exact only without leakage)
    t = np.arange(1024)
    f = 64 / 1024
    x = np.cos(2 * np.pi * f * t).astype(np.float32)
    z = np.asarray(hilbert(x))
    np.testing.assert_allclose(z.real, x, atol=1e-4)
    np.testing.assert_allclose(
        z.imag[32:-32], np.sin(2 * np.pi * f * t)[32:-32], atol=1e-3
    )
    env = np.asarray(envelope(x))
    np.testing.assert_allclose(env[32:-32], 1.0, atol=1e-3)


def test_hilbert_odd_length_and_am_envelope(rng):
    from digital_signal_processsing_tpu.ops.fft import envelope

    t = np.arange(4097)
    msg = 1.0 + 0.5 * np.sin(2 * np.pi * 0.001 * t)
    x = (msg * np.cos(2 * np.pi * 0.2 * t)).astype(np.float32)
    env = np.asarray(envelope(x))
    np.testing.assert_allclose(env[200:-200], msg[200:-200], rtol=2e-2)


def test_wola_perfect_reconstruction(rng):
    # sqrt-hann at 50% overlap: istft(stft(x)) == x away from the edges
    from digital_signal_processsing_tpu.ops.fft import istft, stft

    x = rng.normal(size=8192).astype(np.float32)
    nfft, hop = 256, 128
    s = stft(x, nfft=nfft, hop=hop, window="sqrt_hann")
    y = np.asarray(istft(s, nfft=nfft, hop=hop, window="sqrt_hann"))
    t = min(y.size, x.size)
    np.testing.assert_allclose(y[nfft : t - nfft], x[nfft : t - nfft], atol=1e-5)


def test_wola_spectral_processing_roundtrip(rng):
    # the point of WOLA: modify in the STFT domain, resynthesize cleanly —
    # zeroing high bins acts as a lowpass with no frame artifacts
    import jax.numpy as jnp

    from digital_signal_processsing_tpu.ops.fft import istft, stft, welch

    t = np.arange(16384)
    x = (
        np.sin(2 * np.pi * 0.02 * t) + np.sin(2 * np.pi * 0.3 * t)
    ).astype(np.float32)
    s = stft(x, nfft=256, hop=128, window="sqrt_hann")
    mask = (np.arange(129) < 32).astype(np.float32)  # keep < 0.25 Nyquist
    y = np.asarray(istft(s * jnp.asarray(mask), nfft=256, hop=128))
    p = np.asarray(welch(y[256:-256], nfft=512))
    k_low, k_high = round(0.04 * 512 / 2) * 2 // 2, round(0.6 * 512 / 2)
    assert p[round(0.02 * 512)] > 1000 * p[round(0.3 * 512)]


def test_istft_validation(rng):
    from digital_signal_processsing_tpu.ops.fft import istft

    with pytest.raises(ValueError, match="hop"):
        istft(np.zeros((4, 129), np.complex64), nfft=256, hop=100)


def test_tone_power_exact_frequency(rng):
    # a non-bin tone measured exactly; off-tone frequencies near zero
    from digital_signal_processsing_tpu.ops.fft import tone_power

    t = np.arange(100_000)
    f0 = 0.123456  # not any FFT bin
    x = (0.8 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    p = np.asarray(tone_power(x, np.array([f0, 0.2, 0.05], np.float32)))
    np.testing.assert_allclose(p[0], 0.8**2 / 2, rtol=1e-3)
    assert p[1] < 1e-6 and p[2] < 1e-6


def test_tone_power_batched(rng):
    from digital_signal_processsing_tpu.ops.fft import tone_power

    x = rng.normal(size=(3, 4096)).astype(np.float32)
    assert np.asarray(tone_power(x, np.array([0.1], np.float32))).shape == (3, 1)


def test_hilbert_fir_matches_fft_midband(rng):
    # the blocked FIR spelling approximates the exact spectral method to
    # the FIR's ripple for mid-band content (interior samples)
    from digital_signal_processsing_tpu.ops.fft import hilbert, hilbert_fir

    t = np.arange(1 << 14)
    x = (
        np.sin(2 * np.pi * 0.11 * t)
        + 0.5 * np.cos(2 * np.pi * 0.31 * t + 0.7)
    ).astype(np.float32)
    z_fft = np.asarray(hilbert(x, method="fft"))
    z_fir = np.asarray(hilbert_fir(x, num_taps=513))
    d = 513 // 2
    err = np.max(np.abs(z_fir.imag[d:-d] - z_fft.imag[d:-d]))
    assert err < 2e-3, err
    np.testing.assert_array_equal(z_fir.real, x)


def test_hilbert_auto_dispatch_and_planar(rng):
    from digital_signal_processsing_tpu.ops.fft import (
        HILBERT_BLOCKED_MIN_T,
        hilbert,
        hilbert_fir,
    )
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    hilbert(np.zeros(4096, np.float32))
    assert last_choice("hilbert") == "fft"
    # planar batch through the FIR path
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    z = np.asarray(hilbert(x, method="fir"))
    assert last_choice("hilbert") == "fir"
    assert z.shape == x.shape
    for c in range(3):
        np.testing.assert_allclose(
            z[c], np.asarray(hilbert_fir(x[c])), rtol=1e-6, atol=1e-6
        )
    assert HILBERT_BLOCKED_MIN_T >= 1 << 20


def test_design_hilbert_fir_response():
    # frequency response ~ -j sign(f): |H| ~ 1 over the band, antisymmetric
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.fft import design_hilbert_fir

    h = design_hilbert_fir(513)
    np.testing.assert_allclose(h, -h[::-1], atol=0)  # type III antisymmetry
    w, resp = sps.freqz(h.astype(np.float64), worN=2048)
    f = w / np.pi
    band = (f > 0.05) & (f < 0.95)
    assert np.max(np.abs(np.abs(resp[band]) - 1.0)) < 1e-3


def test_hilbert_fir_folded_rows_match_flat(rng):
    # long flat streams fold into (B, row_len) with overlap halos; the
    # folded spelling must equal the unfolded conv exactly (same taps,
    # same zero-halo semantics), including a non-divisible length
    from digital_signal_processsing_tpu.ops.fft import hilbert_fir

    for t in (40960, 40000):  # divisible and ragged
        x = rng.normal(size=t).astype(np.float32)
        flat = np.asarray(hilbert_fir(x, num_taps=129, row_len=1 << 30))
        folded = np.asarray(hilbert_fir(x, num_taps=129, row_len=8192))
        np.testing.assert_allclose(flat.imag, folded.imag, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(flat.real, folded.real)


class TestMxuSpectralEngine:
    """Round-3: the matmul-factored engine behind the public spectral surface
    (VERDICT r2 item 2) must match the XLA anchors bit-closely."""

    def test_stft_welch_spectrogram_methods_agree(self, rng):
        from digital_signal_processsing_tpu.ops.fft import (
            spectrogram,
            stft,
            welch,
        )

        x = rng.normal(size=(2, 30000)).astype(np.float32)
        for nfft in (256, 1024):
            a = np.asarray(stft(x, nfft=nfft, hop=nfft // 4, method="mxu"))
            b = np.asarray(stft(x, nfft=nfft, hop=nfft // 4, method="xla"))
            assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 1e-5
        wa = np.asarray(welch(x, nfft=512, method="mxu"))
        wb = np.asarray(welch(x, nfft=512, method="xla"))
        np.testing.assert_allclose(wa, wb, rtol=1e-4, atol=1e-6)
        sa = np.asarray(spectrogram(x, nfft=512, hop=128, method="mxu"))
        sb = np.asarray(spectrogram(x, nfft=512, hop=128, method="xla"))
        np.testing.assert_allclose(sa, sb, rtol=1e-3, atol=1e-5)

    def test_istft_mxu_roundtrip(self, rng):
        from digital_signal_processsing_tpu.ops.fft import istft, stft

        x = rng.normal(size=(2, 20480)).astype(np.float32)
        s = stft(x, nfft=1024, hop=512, window="sqrt_hann", method="mxu")
        y = np.asarray(istft(s, nfft=1024, hop=512, method="mxu"))
        seg = slice(1024, 18000)
        np.testing.assert_allclose(y[:, seg], x[:, seg], atol=1e-5)

    def test_correlate_autocorr_mxu(self, rng):
        from digital_signal_processsing_tpu.ops.correlate import (
            autocorrelate,
            correlate,
        )

        a = rng.normal(size=(2, 5000)).astype(np.float32)
        v = rng.normal(size=300).astype(np.float32)
        for mode in ("full", "same", "valid"):
            c1 = np.asarray(correlate(a, v, mode, method="mxu"))
            c2 = np.asarray(correlate(a, v, mode, method="xla"))
            assert np.max(np.abs(c1 - c2)) / np.max(np.abs(c2)) < 1e-5, mode
        r1 = np.asarray(autocorrelate(a, 64, method="mxu"))
        r2 = np.asarray(autocorrelate(a, 64, method="xla"))
        np.testing.assert_allclose(r1, r2, atol=1e-6)

    def test_fft_large_matches_numpy(self, rng):
        from digital_signal_processsing_tpu.ops.fft_mxu import fft_large

        n = 128 * 128 * 2
        x = rng.normal(size=(2, n)).astype(np.float32)
        fr, fi = fft_large(jnp.asarray(x), None)
        got = np.asarray(fr) + 1j * np.asarray(fi)
        want = np.fft.fft(x.astype(np.float64), axis=-1)
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5
        br, bi = fft_large(fr, fi, inverse=True)
        np.testing.assert_allclose(np.asarray(br), x, atol=1e-4)
        np.testing.assert_allclose(np.asarray(bi), 0.0, atol=1e-4)

    def test_fft_large_rejects_off_grid(self):
        import pytest as _pytest

        from digital_signal_processsing_tpu.ops.fft_mxu import fft_large

        with _pytest.raises(ValueError, match="16384"):
            fft_large(jnp.zeros(12345, jnp.float32), None)

    def test_hilbert_fft_large_matches_exact(self, rng):
        # the exact spectral method on jnp.fft at a 128*128 length
        import scipy.signal as sps

        from digital_signal_processsing_tpu.ops.fft import hilbert

        x = rng.normal(size=(2, 128 * 128)).astype(np.float32)
        a = np.asarray(hilbert(x, method="fft"))
        b = sps.hilbert(x.astype(np.float64), axis=-1)
        assert np.max(np.abs(a - b)) < 1e-4


class TestDenseRfftEngine:
    """The dense (n, n//2+1) matmul rfft/irfft behind _mxu_rfft at small
    nfft must match both the factored engine and numpy."""

    def test_dense_vs_factored_vs_numpy(self, rng):
        from digital_signal_processsing_tpu.ops.fft_mxu import (
            dft_factored,
            irfft_dense,
            rfft_dense,
        )

        x = rng.normal(size=(3, 17, 512)).astype(np.float32)
        fr, fi = rfft_dense(jnp.asarray(x))
        ref = np.fft.rfft(x, axis=-1)
        scale = np.abs(ref).max()
        assert np.abs(np.asarray(fr) - ref.real).max() / scale < 1e-5
        assert np.abs(np.asarray(fi) - ref.imag).max() / scale < 1e-5
        gr, gi = dft_factored(jnp.asarray(x), None)
        h = 257
        assert np.abs(np.asarray(gr[..., :h]) - np.asarray(fr)).max() / scale < 1e-5
        # inverse closes the loop
        y = np.asarray(irfft_dense(fr, fi, 512))
        assert np.abs(y - x).max() < 1e-4

    def test_dense_handles_offgrid_and_odd(self, rng):
        from digital_signal_processsing_tpu.ops.fft_mxu import (
            irfft_dense,
            rfft_dense,
        )

        for n in (500, 129, 33):
            x = rng.normal(size=(2, n)).astype(np.float32)
            fr, fi = rfft_dense(jnp.asarray(x))
            ref = np.fft.rfft(x, axis=-1)
            scale = np.abs(ref).max()
            assert np.abs(np.asarray(fr) - ref.real).max() / scale < 1e-5, n
            y = np.asarray(irfft_dense(fr, fi, n))
            assert np.abs(y - x).max() < 1e-4, n

    def test_mxu_rfft_dispatches_dense_then_factored(self):
        from digital_signal_processsing_tpu.ops import fft_mxu

        # the public stft rides _mxu_rfft; its engine split is the constant
        assert fft_mxu.DENSE_RFFT_MAX_N == 4096


def test_stft_framed_dense_matches_xla(rng):
    # the framed dense engine (framing + window folded into banded
    # matmuls, fft_mxu.rfft_dense_framed) must match the XLA rfft path at
    # every gated (nfft, hop, window, detrend) combination
    for c, t, nfft, hop, win, det in [
        (3, 40000, 512, 256, "hann", False),
        (2, 30000, 1024, 256, "hann", True),
        (1, 9999, 512, 128, "hamming", False),
        (2, 20000, 2048, 512, "sqrt_hann", True),
    ]:
        x = rng.normal(size=(c, t)).astype(np.float32)
        a = np.asarray(
            stft(jnp.asarray(x), nfft=nfft, hop=hop, window=win,
                 method="mxu", detrend_segments=det)
        )
        b = np.asarray(
            stft(jnp.asarray(x), nfft=nfft, hop=hop, window=win,
                 method="xla", detrend_segments=det)
        )
        scale = np.max(np.abs(b))
        # HIGH-precision dense default
        assert np.max(np.abs(a - b)) / scale < 5e-5, (nfft, hop, win, det)


def test_stft_framed_gate_falls_back(rng):
    # hop not dividing nfft / hop off the 128 grid must take the
    # overlapping_frames path and still be correct
    x = rng.normal(size=4000).astype(np.float32)
    s = np.asarray(stft(x, nfft=256, hop=100, window="rect", method="mxu"))
    for i in (0, 7, 37):
        want = np.fft.rfft(x[i * 100 : i * 100 + 256])
        np.testing.assert_allclose(s[i], want, rtol=1e-4, atol=1e-2)
