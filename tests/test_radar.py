"""Pulse-Doppler radar model family: compression gain, Doppler mapping,
CA-CFAR parity vs an explicit-loop oracle, and end-to-end detection.

North-star scope (the CUDA reference has no radar models; SURVEY.md §6) —
validates the framework's correlator, window catalog and 2-D box-sum
machinery composed into a sensing chain.
"""

import numpy as np
import pytest

from digital_signal_processsing_tpu.models import radar


def _cfg(**kw):
    base = dict(
        n_pulses=32,
        n_range=512,
        pulse_len=64,
        guard=(1, 2),
        train=(3, 6),
        pfa=1e-4,
    )
    base.update(kw)
    return radar.RadarConfig(**base)


def test_config_validation():
    with pytest.raises(ValueError):
        _cfg(pulse_len=1024, n_range=512)
    with pytest.raises(ValueError):
        _cfg(bandwidth=0.0)
    with pytest.raises(ValueError):
        radar.synthesize(_cfg(), [(512, 0.0, 1.0)])  # range bin out of window


def test_lfm_pulse_unit_energy():
    cfg = _cfg()
    pr, pi = radar.lfm_pulse(cfg)
    energy = float(np.sum(pr.astype(np.float64) ** 2 + pi.astype(np.float64) ** 2))
    assert energy == pytest.approx(1.0, rel=1e-6)


def test_pulse_compression_gain_and_position():
    """A point echo of amplitude a at bin r compresses to a peak of
    amplitude a at output bin r (unit-energy chirp); sidelobes stay well
    below the mainlobe."""
    cfg = _cfg()
    i, q = radar.synthesize(cfg, [(200, 0.0, 0.8)])
    rc = np.asarray(radar.pulse_compress(cfg, i, q))
    mag = np.abs(rc[0])
    assert int(np.argmax(mag)) == 200
    assert mag[200] == pytest.approx(0.8, rel=1e-4)
    side = np.delete(mag, np.arange(195, 206))
    assert side.max() < 0.2 * mag[200]


def test_doppler_row_mapping():
    cfg = _cfg()
    for fd in (0.0, 0.25, -0.125):
        i, q = radar.synthesize(cfg, [(100, fd, 1.0)])
        power = np.asarray(radar.doppler_map(cfg, radar.pulse_compress(cfg, i, q)))
        row, col = np.unravel_index(np.argmax(power), power.shape)
        assert col == 100
        assert row == cfg.n_pulses // 2 + round(fd * cfg.n_pulses)


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_correlate_complex_matches_numpy(mode):
    """Planar complex correlation == np.correlate (a, conj-template) in
    float64, batched rows, every output mode."""
    from digital_signal_processsing_tpu.ops.correlate import correlate_complex

    rng = np.random.default_rng(9)
    a = (rng.standard_normal((3, 200)) + 1j * rng.standard_normal((3, 200)))
    v = rng.standard_normal(31) + 1j * rng.standard_normal(31)
    fr, fi = correlate_complex(
        a.real.astype(np.float32),
        a.imag.astype(np.float32),
        v.real.astype(np.float32),
        v.imag.astype(np.float32),
        mode=mode,
    )
    got = np.asarray(fr) + 1j * np.asarray(fi)
    import scipy.signal as sps

    ref = np.stack([sps.correlate(row, v, mode=mode, method="fft") for row in a])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_doppler_mxu_dft_matches_fft_oracle():
    """The dense matmul DFT spelling (window + fftshift folded into the
    matrix) equals fftshift(fft(w*x)) |.|^2 computed in float64."""
    from digital_signal_processsing_tpu.ops.fft import get_window

    cfg = _cfg()
    rng = np.random.default_rng(5)
    rc = (
        rng.standard_normal((cfg.n_pulses, cfg.n_bins))
        + 1j * rng.standard_normal((cfg.n_pulses, cfg.n_bins))
    ).astype(np.complex64)
    import jax

    got = np.asarray(radar.doppler_map(cfg, jax.numpy.asarray(rc)))
    w = np.asarray(get_window(cfg.window, cfg.n_pulses), np.float64)
    ref = np.abs(
        np.fft.fftshift(np.fft.fft(rc.astype(np.complex128) * w[:, None], axis=0), 0)
    ) ** 2
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _cfar_oracle(power, guard, train, pfa):
    """Explicit-loop CA-CFAR with true per-cell training counts."""
    gd, gr = guard
    td, tr = train
    nd, nr = power.shape
    thresh = np.zeros_like(power)
    for d in range(nd):
        for r in range(nr):
            z = 0.0
            n = 0
            for dd in range(-(gd + td), gd + td + 1):
                for rr in range(-(gr + tr), gr + tr + 1):
                    if abs(dd) <= gd and abs(rr) <= gr:
                        continue
                    y, x = d + dd, r + rr
                    if 0 <= y < nd and 0 <= x < nr:
                        z += power[y, x]
                        n += 1
            alpha = n * (pfa ** (-1.0 / n) - 1.0)
            thresh[d, r] = alpha * z / n
    return power > thresh, thresh


def test_ca_cfar_matches_loop_oracle():
    rng = np.random.default_rng(7)
    power = rng.exponential(size=(12, 18)).astype(np.float32)
    power[5, 9] += 60.0
    det, thresh = radar.ca_cfar(power, guard=(1, 1), train=(2, 3), pfa=1e-3)
    ref_det, ref_thresh = _cfar_oracle(
        np.asarray(power, np.float64), (1, 1), (2, 3), 1e-3
    )
    np.testing.assert_allclose(np.asarray(thresh), ref_thresh, rtol=2e-5)
    np.testing.assert_array_equal(np.asarray(det), ref_det)


def test_ca_cfar_false_alarm_rate_on_noise():
    """On pure exponential noise the empirical false-alarm rate should sit
    near the design pfa (loose band: CA-CFAR on finite N runs slightly
    above the asymptotic rate, and cells are correlated by the window)."""
    rng = np.random.default_rng(3)
    power = rng.exponential(size=(256, 512)).astype(np.float32)
    det, _ = radar.ca_cfar(power, guard=(1, 1), train=(4, 8), pfa=1e-3)
    rate = float(np.asarray(det).mean())
    assert 1e-4 < rate < 1e-2


def test_detect_end_to_end_in_noise():
    cfg = _cfg(pfa=1e-5)
    targets = [(100, 0.25, 1.0), (300, -0.125, 0.7)]
    i, q = radar.synthesize(cfg, targets, noise_power=0.01, seed=1)
    det, power, thresh = radar.detect(cfg, i, q)
    det = np.asarray(det)
    assert det.shape == (cfg.n_pulses, cfg.n_bins)
    for rbin, fd, _ in targets:
        row = cfg.n_pulses // 2 + round(fd * cfg.n_pulses)
        assert det[row, rbin], (row, rbin)
    # detections stay local to the two targets (mainlobe + straddle cells)
    assert det.sum() < 40


def test_detect_batch_sharded_matches_single():
    """dp over CPIs: the mesh-sharded batch path is bit-identical to the
    per-CPI chain (no collectives — pure data parallelism)."""
    import jax

    from digital_signal_processsing_tpu.parallel import make_mesh

    cfg = _cfg()
    batch = 8
    rng = np.random.default_rng(11)
    i = np.empty((batch, cfg.n_pulses, cfg.n_range), np.float32)
    q = np.empty_like(i)
    for b in range(batch):
        i[b], q[b] = radar.synthesize(
            cfg, [(50 + 40 * b, 0.1 * (b - 4), 1.0)], noise_power=0.01, seed=b
        )
    mesh = make_mesh(n_time=1, n_channel=8, devices=np.asarray(jax.devices()[:8]))
    det_b, pow_b, _ = radar.detect_batch(cfg, i, q, mesh=mesh)
    for b in range(batch):
        det_s, pow_s, _ = radar.detect(cfg, i[b], q[b])
        np.testing.assert_array_equal(np.asarray(det_b)[b], np.asarray(det_s))
        np.testing.assert_allclose(
            np.asarray(pow_b)[b], np.asarray(pow_s), rtol=1e-5, atol=1e-5
        )


def test_detect_jit_cache_reuse():
    cfg = _cfg()
    i, q = radar.synthesize(cfg, [(50, 0.0, 1.0)], noise_power=0.01, seed=2)
    d1, _, _ = radar.detect(cfg, i, q)
    d2, _, _ = radar.detect(cfg, i, q)  # same static cfg: cached trace
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def _ambiguity_oracle(pi, qi, delays, dopplers):
    """Brute-force |chi|^2, complex128 loops."""
    u = pi.astype(np.complex128) + 1j * qi.astype(np.complex128)
    n = np.arange(u.size)
    energy = float(np.sum(np.abs(u) ** 2))
    out = np.zeros((dopplers.size, delays.size))
    for a, fd in enumerate(dopplers):
        ush = u * np.exp(2j * np.pi * fd * n)
        for b, tau in enumerate(delays):
            acc = 0.0 + 0.0j
            for k in range(u.size):
                if 0 <= k + tau < u.size:
                    acc += ush[k + tau] * np.conj(u[k])
            out[a, b] = np.abs(acc) ** 2 / energy**2
    return out


def test_ambiguity_matches_bruteforce_oracle():
    rng = np.random.default_rng(3)
    pi = rng.standard_normal(24).astype(np.float32)
    qi = rng.standard_normal(24).astype(np.float32)
    dop = np.linspace(-0.08, 0.08, 5)
    delays, dops, amb = radar.ambiguity(pi, qi, dopplers=dop)
    ref = _ambiguity_oracle(pi, qi, delays, dops)
    np.testing.assert_allclose(np.asarray(amb), ref, rtol=2e-4, atol=2e-6)


def test_ambiguity_barker13_zero_doppler_cut():
    barker = np.array([1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1], np.float32)
    delays, _, amb = radar.ambiguity(barker, np.zeros_like(barker), dopplers=[0.0])
    cut = np.asarray(amb)[0]
    center = delays.size // 2
    np.testing.assert_allclose(cut[center], 1.0, rtol=1e-5)
    side = np.delete(cut, center)
    # Barker-13: all autocorrelation sidelobes at amplitude 1/13.
    np.testing.assert_allclose(side[side > 1e-8], (1 / 13) ** 2, rtol=1e-4)


def test_ambiguity_lfm_range_doppler_coupling():
    cfg = radar.RadarConfig(
        n_pulses=8, pulse_len=128, n_range=256, bandwidth=0.5
    )
    pi, qi = radar.lfm_pulse(cfg)
    length, bw = cfg.pulse_len, cfg.bandwidth
    fds = np.array([-2.0 / length, 0.0, 2.0 / length])
    delays, _, amb = radar.ambiguity(pi, qi, dopplers=fds)
    amb = np.asarray(amb)
    for row, fd in zip(amb, fds):
        peak_delay = delays[int(np.argmax(row))]
        # LFM ridge: with chi(tau,nu) = sum u[n+tau]u*[n]e^{j2pi nu n}
        # and an UP-chirp, a Doppler shift fd displaces the correlation
        # peak by -fd*L/bw (range-Doppler coupling).
        want = -fd * length / bw
        assert abs(peak_delay - want) <= 1, (peak_delay, want)
    # Peak normalization at (0, 0).
    np.testing.assert_allclose(amb[1].max(), 1.0, rtol=1e-5)


def test_detect_fullwidth_cfar_bitexact():
    """detect()'s round-5 full-width masked CFAR (the aligned-slice
    doctrine applied to the last stage) must be BIT-identical to the
    round-4 spelling: full-mode correlate -> doppler -> power slice ->
    sliced-map ca_cfar."""
    import functools

    import jax
    import jax.numpy as jnp

    from digital_signal_processsing_tpu.ops.correlate import correlate_complex

    cfg = _cfg(n_range=1024, guard=(2, 4), train=(4, 16))
    i, q = radar.synthesize(
        cfg, [(300, 0.1, 3.0), (700, -0.2, 2.5)], noise_power=0.1, seed=3
    )
    i, q = jnp.asarray(i), jnp.asarray(q)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def detect_r4(cfg, i, q):
        pr, pi_ = radar.lfm_pulse(cfg)
        c_re, c_im = correlate_complex(
            i.astype(jnp.float32), q.astype(jnp.float32),
            jnp.asarray(pr), jnp.asarray(pi_), mode="full",
        )
        rc = jax.lax.complex(c_re, c_im)
        lo = cfg.pulse_len - 1
        power = radar.doppler_map(cfg, rc)[:, lo : lo + cfg.n_bins]
        det, thresh = radar.ca_cfar(
            power, guard=cfg.guard, train=cfg.train, pfa=cfg.pfa
        )
        return det, power, thresh

    det, power, thresh = radar.detect(cfg, i, q)
    det_p, p_p, thr_p = detect_r4(cfg, i, q)
    assert bool(jnp.all(det == det_p))
    # detect's round-5 Gauss matched filter recombines in f32 (m3-m1-m2),
    # and the range boxcar's f32 accumulation order shifts with the lane
    # offset — power/thresh agree to the ulp class, detections exactly
    scale = float(jnp.max(jnp.abs(p_p)))
    assert float(jnp.max(jnp.abs(power - p_p))) / scale < 1e-5
    np.testing.assert_allclose(
        np.asarray(thresh), np.asarray(thr_p), rtol=1e-4, atol=scale * 1e-6
    )
