"""Beamforming/DOA model family: real-embedding parity vs complex-domain
numpy oracles, end-to-end bearing accuracy, and the sharded batch path.

North-star scope (the CUDA reference has no array processing; SURVEY.md
§2) — validates the covariance, embedded Cholesky/eigh subspace math
and the dp batch story.
"""

import numpy as np
import pytest

from digital_signal_processsing_tpu.models import beamform


def _cfg(**kw):
    base = dict(n_sensors=8, spacing=0.5, n_grid=361)
    base.update(kw)
    return beamform.ArrayConfig(**base)


def _complex(xi, xq):
    return np.asarray(xi, np.float64) + 1j * np.asarray(xq, np.float64)


def test_config_validation():
    with pytest.raises(ValueError):
        _cfg(n_sensors=1)
    with pytest.raises(ValueError):
        _cfg(spacing=0.75)
    with pytest.raises(ValueError):
        _cfg(n_grid=2)


def test_steering_matches_complex_exponential():
    cfg = _cfg()
    angles = np.array([-40.0, 0.0, 25.0])
    ai, aq = beamform.steering(cfg, angles)
    m = np.arange(cfg.n_sensors)[:, None]
    oracle = np.exp(
        -2j * np.pi * cfg.spacing * m * np.sin(np.deg2rad(angles))[None, :]
    )
    np.testing.assert_allclose(_complex(ai, aq), oracle, atol=1e-6)


def test_sample_covariance_parity():
    cfg = _cfg()
    xi, xq = beamform.synthesize(cfg, [-20.0, 35.0], 128, seed=1)
    rr, ri = beamform.sample_covariance(xi, xq)
    x = _complex(xi, xq)
    r = x @ x.conj().T / x.shape[1]
    np.testing.assert_allclose(np.asarray(rr), r.real, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ri), r.imag, atol=1e-4)
    # Hermitian structure in planar form
    np.testing.assert_allclose(np.asarray(rr), np.asarray(rr).T, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ri), -np.asarray(ri).T, atol=1e-5)


def test_forward_backward_parity():
    cfg = _cfg()
    xi, xq = beamform.synthesize(cfg, [10.0], 64, seed=2)
    rr, ri = beamform.sample_covariance(xi, xq, forward_backward=True)
    x = _complex(xi, xq)
    r = x @ x.conj().T / x.shape[1]
    jex = np.eye(cfg.n_sensors)[::-1]
    rfb = 0.5 * (r + jex @ r.conj() @ jex)
    np.testing.assert_allclose(np.asarray(rr), rfb.real, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ri), rfb.imag, atol=1e-4)


def _oracle_spectra(cfg, xi, xq, n_sources, loading):
    """Complex-domain Bartlett/MVDR/MUSIC straight from the textbook."""
    x = _complex(xi, xq)
    r = x @ x.conj().T / x.shape[1]
    ai, aq = beamform.steering(cfg, beamform.scan_angles(cfg))
    a = _complex(ai, aq)
    bart = np.real(np.sum(a.conj() * (r @ a), axis=0)) / cfg.n_sensors
    rl = r + loading * np.trace(r).real / cfg.n_sensors * np.eye(cfg.n_sensors)
    mvdr = 1.0 / np.real(np.sum(a.conj() * np.linalg.solve(rl, a), axis=0))
    w, v = np.linalg.eigh(r)
    en = v[:, : cfg.n_sensors - n_sources]
    g = en.conj().T @ a
    music = cfg.n_sensors / np.real(np.sum(g.conj() * g, axis=0))
    return bart, mvdr, music


def test_spectra_match_complex_oracles():
    cfg = _cfg()
    xi, xq = beamform.synthesize(cfg, [-20.0, 35.0], 256, snr_db=10.0, seed=3)
    rr, ri = beamform.sample_covariance(xi, xq)
    ai, aq = beamform.steering(cfg, beamform.scan_angles(cfg))
    bart, mvdr, music = _oracle_spectra(cfg, xi, xq, 2, cfg.diagonal_loading)
    got_b = np.asarray(beamform.bartlett_spectrum(rr, ri, ai, aq))
    got_m = np.asarray(
        beamform.mvdr_spectrum(rr, ri, ai, aq, loading=cfg.diagonal_loading)
    )
    got_u = np.asarray(beamform.music_spectrum(rr, ri, ai, aq, n_sources=2))
    np.testing.assert_allclose(got_b, bart, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got_m, mvdr, rtol=2e-3, atol=1e-6)
    # MUSIC nulls are 1/tiny — compare on the inverted (projection) scale
    np.testing.assert_allclose(1.0 / got_u, 1.0 / music, rtol=5e-3, atol=1e-5)


def test_music_analytic_one_source():
    """Exact R = 10 a0 a0^H + I: the noise subspace is a0's orthogonal
    complement, so the normalized spectrum is ~1 away from the source and
    diverges at it."""
    cfg = _cfg()
    a0 = _complex(*beamform.steering(cfg, [15.0]))[:, 0]
    r = 10.0 * np.outer(a0, a0.conj()) + np.eye(cfg.n_sensors)
    rr = r.real.astype(np.float32)
    ri = r.imag.astype(np.float32)
    angles = beamform.scan_angles(cfg)
    ai, aq = beamform.steering(cfg, angles)
    spec = np.asarray(beamform.music_spectrum(rr, ri, ai, aq, n_sources=1))
    at_src = spec[np.argmin(np.abs(angles - 15.0))]
    far = spec[np.abs(angles - 15.0) > 20.0]
    assert at_src > 1e3
    assert 0.8 < np.median(far) < 1.3


def test_music_n_sources_validation():
    cfg = _cfg()
    rr = np.eye(cfg.n_sensors, dtype=np.float32)
    ri = np.zeros_like(rr)
    ai, aq = beamform.steering(cfg, [0.0])
    with pytest.raises(ValueError):
        beamform.music_spectrum(rr, ri, ai, aq, n_sources=cfg.n_sensors)


@pytest.mark.parametrize("method,tol", [("music", 0.5), ("mvdr", 0.8), ("bartlett", 2.0)])
def test_estimate_doa_two_sources(method, tol):
    cfg = _cfg()
    truth = np.array([-24.0, 33.0])
    xi, xq = beamform.synthesize(cfg, truth, 512, snr_db=15.0, seed=4)
    got = beamform.estimate_doa(cfg, xi, xq, n_sources=2, method=method)
    np.testing.assert_allclose(got, truth, atol=tol)


def test_estimate_doa_off_grid():
    """Parabolic refinement resolves bearings between grid points."""
    cfg = _cfg(n_grid=181)  # 1-degree grid
    truth = np.array([12.3])
    xi, xq = beamform.synthesize(cfg, truth, 1024, snr_db=20.0, seed=5)
    got = beamform.estimate_doa(cfg, xi, xq, n_sources=1, method="music")
    np.testing.assert_allclose(got, truth, atol=0.25)


def test_forward_backward_rescues_coherent_sources():
    """Two fully coherent sources break plain MUSIC (rank-1 signal
    subspace); persymmetric FB averaging restores the second dimension."""
    cfg = _cfg()
    truth = np.array([-30.0, 20.0])
    xi, xq = beamform.synthesize(
        cfg, truth, 512, snr_db=20.0, seed=6, coherent=True
    )
    got_fb = beamform.estimate_doa(
        cfg, xi, xq, n_sources=2, method="music", forward_backward=True
    )
    np.testing.assert_allclose(got_fb, truth, atol=1.0)


def test_mvdr_weights_distortionless_and_nulling():
    """w^H a(look) = 1 exactly; interferer 40 dB stronger than noise is
    suppressed well below the look direction's unit gain."""
    cfg = _cfg()
    look, interf = 0.0, 30.0
    xi, xq = beamform.synthesize(cfg, [interf], 2048, snr_db=40.0, seed=7)
    rr, ri = beamform.sample_covariance(xi, xq)
    ai, aq = beamform.steering(cfg, [look])
    wi, wq = beamform.mvdr_weights(rr, ri, ai[:, 0], aq[:, 0], loading=1e-4)
    w = _complex(wi, wq)
    a_look = _complex(*beamform.steering(cfg, [look]))[:, 0]
    a_int = _complex(*beamform.steering(cfg, [interf]))[:, 0]
    np.testing.assert_allclose(w.conj() @ a_look, 1.0, atol=1e-4)
    assert abs(w.conj() @ a_int) < 0.03


@pytest.mark.parametrize("method", [beamform.esprit, beamform.root_music])
def test_gridfree_estimators(method):
    cfg = _cfg()
    truth = np.array([-37.5, 11.25, 42.8])  # deliberately off any grid
    xi, xq = beamform.synthesize(cfg, truth, 1024, snr_db=15.0, seed=8)
    got = method(cfg, xi, xq, n_sources=3)
    np.testing.assert_allclose(got, truth, atol=0.4)


def test_gridfree_validation():
    cfg = _cfg()
    xi, xq = beamform.synthesize(cfg, [0.0], 64, seed=9)
    with pytest.raises(ValueError):
        beamform.esprit(cfg, xi, xq, n_sources=cfg.n_sensors)


def test_esprit_coherent_forward_backward():
    cfg = _cfg()
    truth = np.array([-28.0, 17.0])
    xi, xq = beamform.synthesize(
        cfg, truth, 1024, snr_db=20.0, seed=10, coherent=True
    )
    got = beamform.esprit(
        cfg, xi, xq, n_sources=2, forward_backward=True
    )
    np.testing.assert_allclose(got, truth, atol=1.0)


def test_smoothed_covariance_parity_and_coherent_trio():
    cfg = _cfg(n_sensors=10)
    # oracle parity for the smoothing itself
    xi, xq = beamform.synthesize(cfg, [5.0], 128, seed=12)
    L = 6
    rr, ri = beamform.smoothed_covariance(
        xi, xq, subarray=L, forward_backward=False
    )
    x = _complex(xi, xq)
    j = cfg.n_sensors - L + 1
    r = sum(
        x[i : i + L] @ x[i : i + L].conj().T / x.shape[1] for i in range(j)
    ) / j
    np.testing.assert_allclose(np.asarray(rr), r.real, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ri), r.imag, atol=1e-4)
    with pytest.raises(ValueError):
        beamform.smoothed_covariance(xi, xq, subarray=1)
    # THREE fully coherent sources: beyond FB alone (rank 2), resolved by
    # smoothing + FB on the subarray grid
    truth = np.array([-35.0, 5.0, 40.0])
    ci, cq = beamform.synthesize(
        cfg, truth, 2048, snr_db=20.0, seed=13, coherent=True
    )
    rr2, ri2 = beamform.smoothed_covariance(ci, cq, subarray=L)
    sub_cfg = beamform.ArrayConfig(
        n_sensors=L, spacing=cfg.spacing, n_grid=721
    )
    ai, aq = beamform.steering(sub_cfg, beamform.scan_angles(sub_cfg))
    spec = np.asarray(
        beamform.music_spectrum(rr2, ri2, ai, aq, n_sources=3)
    )
    got = beamform._pick_peaks(beamform.scan_angles(sub_cfg), spec, 3)
    np.testing.assert_allclose(got, truth, atol=1.5)


def test_wideband_music_two_sources():
    # broadband white sources; per-bin grating lobes (delay 2 samples ->
    # up to 0.9 wavelengths at the band edge) must be suppressed by the
    # incoherent average across bins
    cfg = _cfg()
    truth = np.array([-30.0, 20.0])
    x = beamform.synthesize_wideband(
        cfg, truth, 1 << 15, spacing_samples=2.0, snr_db=10.0, seed=5
    )
    got = beamform.estimate_doa_wideband(
        cfg, x, n_sources=2, spacing_samples=2.0
    )
    np.testing.assert_allclose(got, truth, atol=0.5)


def test_wideband_music_validation():
    cfg = _cfg()
    x = beamform.synthesize_wideband(cfg, [0.0], 4096, spacing_samples=1.0)
    with pytest.raises(ValueError):
        beamform.wideband_music_spectrum(
            cfg, x, n_sources=cfg.n_sensors, spacing_samples=1.0
        )
    with pytest.raises(ValueError):
        beamform.wideband_music_spectrum(
            cfg, x, n_sources=1, spacing_samples=1.0, band=(0.4, 0.2)
        )


def test_spectrum_batch_matches_single():
    cfg = _cfg(n_grid=121)
    blocks_i, blocks_q = [], []
    for s in range(4):
        xi, xq = beamform.synthesize(cfg, [-10.0 + 5 * s], 64, seed=10 + s)
        blocks_i.append(xi)
        blocks_q.append(xq)
    bi = np.stack(blocks_i)
    bq = np.stack(blocks_q)
    batch = np.asarray(
        beamform.spectrum_batch(cfg, bi, bq, method="music", n_sources=1)
    )
    for k in range(4):
        single = np.asarray(
            beamform.spatial_spectrum(
                cfg, bi[k], bq[k], method="music", n_sources=1
            )
        )
        np.testing.assert_allclose(batch[k], single, rtol=1e-4, atol=1e-5)


def test_spectrum_batch_on_mesh():
    import jax

    from digital_signal_processsing_tpu.parallel import make_mesh

    cfg = _cfg(n_grid=121)
    bi, bq = [], []
    for s in range(8):
        xi, xq = beamform.synthesize(cfg, [-35.0 + 10 * s], 64, seed=20 + s)
        bi.append(xi)
        bq.append(xq)
    bi = np.stack(bi)
    bq = np.stack(bq)
    mesh = make_mesh(n_time=1, n_channel=8, devices=np.asarray(jax.devices()[:8]))
    spec = beamform.spectrum_batch(
        cfg, bi, bq, method="mvdr", mesh=mesh
    )
    ref = beamform.spectrum_batch(cfg, bi, bq, method="mvdr")
    np.testing.assert_allclose(np.asarray(spec), np.asarray(ref), rtol=1e-4, atol=1e-6)
    angles = beamform.scan_angles(cfg)
    for k in range(8):
        peak = angles[int(np.argmax(np.asarray(spec)[k]))]
        assert abs(peak - (-35.0 + 10 * k)) <= 2.0


class TestGccPhat:
    """TDOA companion to the array family (ops.correlate.gcc_phat)."""

    def test_integer_delay_exact(self):
        from digital_signal_processsing_tpu.ops.correlate import (
            find_delay_phat,
            gcc_phat,
        )

        rng = np.random.default_rng(0)
        s = rng.standard_normal(8192).astype(np.float32)
        a = np.concatenate([np.zeros(37, np.float32), s[:-37]])
        cc = np.asarray(gcc_phat(a, s, max_lag=100))
        assert cc.shape == (201,)
        assert np.argmax(cc) == 100 + 37
        assert abs(float(find_delay_phat(a, s, max_lag=100)) - 37.0) < 0.01

    def test_fractional_delay_and_coloring(self):
        import scipy.signal as sps

        from digital_signal_processsing_tpu.ops.correlate import find_delay_phat

        rng = np.random.default_rng(1)
        n = 8192
        s = rng.standard_normal(n).astype(np.float32)
        f = np.fft.rfftfreq(n)
        a = np.fft.irfft(np.fft.rfft(s) * np.exp(-2j * np.pi * f * 12.3), n).astype(
            np.float32
        )
        assert abs(float(find_delay_phat(a, s, max_lag=64)) - 12.3) < 0.2
        # PHAT whitens channel coloring on the reference
        b = sps.lfilter([1, 0.7, -0.3, 0.2], [1], s).astype(np.float32)
        assert abs(float(find_delay_phat(a, b, max_lag=64)) - 12.3) < 0.5

    def test_batched_and_validation(self):
        import pytest as _pytest

        from digital_signal_processsing_tpu.ops.correlate import (
            find_delay_phat,
            gcc_phat,
        )

        rng = np.random.default_rng(2)
        s = rng.standard_normal((2, 4096)).astype(np.float32)
        a = np.roll(s, 5, axis=-1)
        d = np.asarray(find_delay_phat(a, s, max_lag=32))
        np.testing.assert_allclose(d, [5.0, 5.0], atol=0.01)
        with _pytest.raises(ValueError):
            gcc_phat(s, s, max_lag=0)
