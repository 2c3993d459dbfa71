"""Seeded fuzz regression for the round-3 surface: random specs through
the new ops with scipy (or an in-repo sequential anchor) as the oracle.
Deterministic seeds — kept in CI so the properties survive refactors.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal as sps

from digital_signal_processsing_tpu import compat as dsig
from digital_signal_processsing_tpu.ops import iir, lpc, splines, wavelets


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_classical_designers(seed):
    rng = np.random.default_rng(2000 + seed)
    fam = ["butter", "cheby1", "cheby2", "ellip"][rng.integers(4)]
    order = int(rng.integers(1, 9))
    btype = ["low", "high", "bandpass", "bandstop"][rng.integers(4)]
    if btype in ("bandpass", "bandstop"):
        lo = float(rng.uniform(0.05, 0.6))
        wn = [lo, float(rng.uniform(lo + 0.05, 0.93))]
    else:
        wn = float(rng.uniform(0.05, 0.93))
    args = {"butter": (order, wn), "cheby1": (order, 1.0, wn),
            "cheby2": (order, 40.0, wn), "ellip": (order, 1.0, 40.0, wn)}[fam]
    bg, ag = getattr(dsig, fam)(*args, btype=btype)
    br, ar = getattr(sps, fam)(*args, btype=btype)
    _, hg = sps.freqz(np.atleast_1d(bg), np.atleast_1d(ag), worN=512)
    _, hr = sps.freqz(np.atleast_1d(br), np.atleast_1d(ar), worN=512)
    assert np.max(np.abs(np.abs(hg) - np.abs(hr))) < 1e-5, (fam, order, btype)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_sosfilt_tv_vs_sample_scan(seed):
    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(64, 1500))
    nsec = int(rng.integers(1, 4))
    r = rng.uniform(0.1, 0.9, (nsec, n))
    th = rng.uniform(0.1, 3.0, (nsec, n))
    sos_t = np.stack(
        [
            rng.uniform(-0.5, 0.5, (nsec, n)),
            rng.uniform(-0.5, 0.5, (nsec, n)),
            rng.uniform(-0.5, 0.5, (nsec, n)),
            np.ones((nsec, n)),
            -2 * r * np.cos(th),
            r * r,
        ],
        -1,
    ).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    y_scan = np.asarray(iir.sosfilt_tv(sos_t, x))
    # the per-sample XLA chunk scan is the independent anchor
    _, y_xla = iir._sosfilt_tv_chunk_xla(
        jnp.zeros((nsec, 1, 2)), jnp.asarray(sos_t), jnp.asarray(x)
    )
    y_xla = np.asarray(y_xla).reshape(-1)
    scale = max(1.0, np.max(np.abs(y_xla)))
    assert np.max(np.abs(y_scan - y_xla)) / scale < 2e-4, (n, nsec)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_levinson_and_synthesis(seed):
    rng = np.random.default_rng(4000 + seed)
    p = int(rng.integers(2, 16))
    sig = sps.lfilter(
        [1.0], np.r_[1.0, rng.uniform(-0.4, 0.4, 2)], rng.standard_normal(3000)
    )
    r = np.array([np.dot(sig[: sig.size - k], sig[k:]) for k in range(p + 1)])
    import scipy.linalg as sla

    a_ref = np.concatenate(
        [[1.0], sla.solve_toeplitz((r[:-1], r[:-1]), -r[1:])]
    )
    a, _, err = lpc.levinson(r[None])
    assert np.max(np.abs(np.asarray(a)[0] - a_ref)) < 1e-3
    assert float(np.asarray(err)[0]) > 0
    # random stable frames: parallel synthesis == sequential golden
    F = int(rng.integers(2, 6))
    L = int(rng.integers(32, 128))
    order = 2 * int(rng.integers(1, 4))
    rows = []
    for _ in range(F):
        poles = rng.uniform(0.3, 0.9, order // 2) * np.exp(
            1j * rng.uniform(0.2, np.pi - 0.2, order // 2)
        )
        rows.append(np.poly(np.concatenate([poles, poles.conj()])).real)
    a_fr = np.stack(rows).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, F).astype(np.float32)
    e = rng.standard_normal(F * L).astype(np.float32)
    ref = lpc.lpc_synthesis_ref(a_fr, gain, e, L)
    got = np.asarray(lpc.lpc_synthesis(a_fr, gain, e, L))
    assert np.max(np.abs(got - ref)) / max(1.0, np.max(np.abs(ref))) < 1e-3


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_splines_random_lengths(seed):
    rng = np.random.default_rng(5000 + seed)
    n = int(rng.integers(8, 400))
    x = rng.standard_normal(n)
    assert np.max(np.abs(splines.cspline1d(x) - sps.cspline1d(x))) < 1e-4
    assert np.max(np.abs(splines.qspline1d(x) - sps.qspline1d(x))) < 1e-4
    lam = float(rng.uniform(0.05, 20.0))
    assert (
        np.max(np.abs(splines.cspline1d(x, lam) - sps.cspline1d(x, lamb=lam)))
        < 1e-4
    )
    newx = rng.uniform(-n, 2 * n, 200)
    cj = sps.cspline1d(x)
    assert np.max(
        np.abs(splines.cspline1d_eval(cj, newx) - sps.cspline1d_eval(cj, newx))
    ) < 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_cwt_bank_random_widths(seed):
    rng = np.random.default_rng(6000 + seed)
    n = int(rng.integers(100, 800))
    x = rng.standard_normal(n).astype(np.float32)
    nw = int(rng.integers(1, 9))
    widths = np.unique(rng.integers(1, max(2, n // 8), nw))

    def ref_cwt(data, wavelet, ws):
        out = []
        for wd in ws:
            nn = int(min(10 * wd, len(data)))
            k = wavelet(nn, wd)
            out.append(np.convolve(data, np.conj(k)[::-1], mode="same"))
        return np.stack(out)

    ref = ref_cwt(x.astype(np.float64), wavelets.ricker, widths)
    got = np.asarray(wavelets.cwt(x, wavelets.ricker, widths))
    assert np.max(np.abs(got - ref)) < 1e-4, (n, widths)


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_beamform_music_vs_complex_oracle(seed):
    from digital_signal_processsing_tpu.models import beamform

    rng = np.random.default_rng(6000 + seed)
    m = int(rng.integers(4, 13))
    k = int(rng.integers(1, min(4, m)))
    cfg = beamform.ArrayConfig(n_sensors=m, n_grid=181)
    angles = np.sort(rng.uniform(-70, 70, k))
    xi, xq = beamform.synthesize(
        cfg, angles, int(rng.integers(64, 512)),
        snr_db=float(rng.uniform(0, 20)), seed=seed,
    )
    rr, ri = beamform.sample_covariance(xi, xq)
    ai, aq = beamform.steering(cfg, beamform.scan_angles(cfg))
    got = np.asarray(beamform.music_spectrum(rr, ri, ai, aq, n_sources=k))
    x = np.asarray(xi, np.float64) + 1j * np.asarray(xq, np.float64)
    r = x @ x.conj().T / x.shape[1]
    a = np.asarray(ai, np.float64) + 1j * np.asarray(aq, np.float64)
    _, v = np.linalg.eigh(r)
    en = v[:, : m - k]
    g = en.conj().T @ a
    want = m / np.real(np.sum(g.conj() * g, axis=0))
    np.testing.assert_allclose(1 / got, 1 / want, rtol=2e-2, atol=1e-5)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_compact_row_pass_vs_scipy(seed):
    # cheap randomized sweep; the deterministic grid lives in
    # test_iir.py::TestSosfiltFused::test_compact_row_pass_parity
    rng = np.random.default_rng(7000 + seed)
    nsec = int(rng.integers(1, 5))
    sos = sps.butter(2 * nsec, float(rng.uniform(0.05, 0.9)), output="sos")
    n = 128 * 128 + int(rng.integers(0, 2000))
    x = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(iir.sosfilt(sos.astype(np.float32), x))
    want = sps.sosfilt(sos, x.astype(np.float64))
    sc = np.max(np.abs(want)) + 1e-9
    assert np.max(np.abs(got - want)) / sc < 1e-4, nsec
