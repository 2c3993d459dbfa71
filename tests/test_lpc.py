"""LPC analysis/synthesis and tracking-notch tests.

Goldens: scipy.linalg.solve_toeplitz for Levinson, a sequential float64
loop for the frame-wise all-pole synthesis, and behavioral checks
(reconstruction through the residual, interferer suppression) for the
model-level pipelines.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.linalg as sla
from scipy.signal import lfilter as splf

from digital_signal_processsing_tpu.ops import lpc
from digital_signal_processsing_tpu.models import adaptive


@pytest.fixture(scope="module")
def colored():
    rng = np.random.default_rng(0)
    x = splf([1.0], [1, -1.2, 0.7], rng.standard_normal(4480))
    return x.astype(np.float32)


def test_levinson_matches_toeplitz_solve(colored):
    p = 12
    sig = np.asarray(colored, np.float64)
    r = np.array(
        [np.dot(sig[: sig.size - k], sig[k:]) for k in range(p + 1)]
    )
    a_ref = np.concatenate(
        [[1.0], sla.solve_toeplitz((r[:-1], r[:-1]), -r[1:])]
    )
    a, k, err = lpc.levinson(r[None])
    assert np.max(np.abs(np.asarray(a)[0] - a_ref)) < 1e-3
    assert np.asarray(err)[0] > 0
    assert np.all(np.abs(np.asarray(k)) < 1.0)


def test_levinson_scale_invariant_batched(colored):
    p = 8
    sig = np.asarray(colored, np.float64)
    r = np.array(
        [np.dot(sig[: sig.size - k], sig[k:]) for k in range(p + 1)]
    )
    rb = np.stack([r, 3.0 * r], 0)
    a, k, err = lpc.levinson(rb)
    assert np.allclose(np.asarray(a)[0], np.asarray(a)[1], atol=1e-5)
    assert np.allclose(np.asarray(err)[1], 3.0 * np.asarray(err)[0], rtol=1e-5)


def test_synthesis_matches_sequential_golden():
    rng = np.random.default_rng(1)
    F, L, order = 7, 96, 8
    rows = []
    for _ in range(F):
        poles = 0.85 * np.exp(1j * rng.uniform(0, np.pi, order // 2))
        rows.append(np.poly(np.concatenate([poles, poles.conj()])).real)
    a = np.stack(rows, 0).astype(np.float32)
    gain = rng.uniform(0.5, 2.0, F).astype(np.float32)
    e = rng.standard_normal(F * L).astype(np.float32)
    ref = lpc.lpc_synthesis_ref(a, gain, e, L)
    got = np.asarray(lpc.lpc_synthesis(a, gain, e, L))
    # float32 frame-parallel vs float64 sequential: association-order
    # divergence amplified by resonant poles — 1e-3 relative is the
    # observed envelope over seeds
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-3
    # batched + linear in gain
    got_b = np.asarray(
        lpc.lpc_synthesis(
            np.stack([a, a]), np.stack([gain, 0.5 * gain]),
            np.stack([e, e]), L,
        )
    )
    assert np.allclose(got_b[0], got, atol=1e-5)
    assert np.allclose(got_b[1], 0.5 * got, atol=1e-4)


def test_residual_resynthesis_reconstructs(colored):
    x = colored
    order, fl = 10, 160
    a, _ = lpc.lpc(x, order, fl)
    a = np.asarray(a)
    nf = a.shape[0]
    resid = np.zeros(nf * fl)
    hist = np.zeros(order)
    for f in range(nf):
        for t in range(fl):
            i = f * fl + t
            resid[i] = x[i] + np.dot(a[f, 1:], hist)
            hist = np.concatenate([[x[i]], hist[:-1]])
    recon = np.asarray(
        lpc.lpc_synthesis(
            a, np.ones(nf, np.float32), resid.astype(np.float32), fl
        )
    )
    rel = np.max(np.abs(recon - x[: nf * fl])) / np.max(np.abs(x))
    assert rel < 1e-3, rel


def test_vocoder_keeps_spectral_tilt(colored):
    x = colored
    y = np.asarray(lpc.lpc_vocoder(jnp.asarray(x), 10, 160))

    def bandpow(sig, lo, hi):
        s = np.abs(np.fft.rfft(sig)) ** 2
        f = np.linspace(0, 0.5, s.size)
        return s[(f >= lo) & (f < hi)].mean()

    tilt_x = bandpow(x, 0.0, 0.1) / bandpow(x, 0.3, 0.5)
    tilt_y = bandpow(y, 0.0, 0.1) / bandpow(y, 0.3, 0.5)
    assert 0.1 * tilt_x < tilt_y < 10 * tilt_x


def test_tracking_notch_suppresses_swept_tone():
    rng = np.random.default_rng(2)
    n, fl = 64000, 512
    t = np.arange(n)
    f_inst = 0.1 + 0.25 * t / n
    tone = 10.0 * np.sin(np.cumsum(np.pi * f_inst))
    noise = rng.standard_normal(n)
    x = (tone + noise).astype(np.float32)
    y, w0 = adaptive.tracking_notch(jnp.asarray(x), fl, q=30.0)
    y, w0 = np.asarray(y), np.asarray(w0)
    centers = f_inst[fl // 2 :: fl][: w0.size]
    assert np.mean(np.abs(w0 - centers)) < 0.004
    pow_before = np.mean(tone**2)
    pow_after = np.mean((y - noise)[2 * fl :] ** 2)
    # >= 15 dB interferer suppression once locked
    assert pow_after < 0.05 * pow_before
    # broadband content substantially passes (Q=30 notch eats a narrow band)
    assert np.corrcoef(y[2 * fl :], noise[2 * fl :])[0, 1] > 0.8


def test_tracking_notch_short_signal_raises():
    with pytest.raises(ValueError):
        adaptive.tracking_notch(jnp.zeros(100), 512)


def test_ar_psd_matches_analytic_ar2():
    # round-3: maximum-entropy PSD — whole-grid shape parity against the
    # true AR(2) spectrum and exact peak localization
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.lpc import ar_psd

    rng = np.random.default_rng(0)
    r, th = 0.95, 2 * np.pi * 0.12
    a_true = np.array([1.0, -2 * r * np.cos(th), r * r])
    x = sps.lfilter([1.0], a_true, rng.standard_normal(1 << 16)).astype(
        np.float32
    )
    f, psd = ar_psd(x, 2, nfft=2048)
    psd = np.asarray(psd)
    assert abs(f[np.argmax(psd)] - 0.12) < 2e-3
    w = 2 * np.pi * np.asarray(f)
    a_w = a_true[0] + a_true[1] * np.exp(-1j * w) + a_true[2] * np.exp(-2j * w)
    ratio = psd / (1.0 / np.abs(a_w) ** 2)
    assert ratio.max() / ratio.min() < 1.2
    # frame-wise shape
    f2, psd2 = ar_psd(x, 2, nfft=256, frame_len=4096)
    assert np.asarray(psd2).shape == ((1 << 16) // 4096, 129)


def test_synthesis_methods_agree():
    """The refine engine (auto's pick) vs the scan spelling vs the float64
    golden, at any frame length."""
    rng = np.random.default_rng(5)
    F, L, order = 9, 64, 12
    rows = []
    for _ in range(F):
        poles = 0.8 * np.exp(1j * rng.uniform(0, np.pi, order // 2))
        rows.append(np.poly(np.concatenate([poles, poles.conj()])).real)
    a = np.stack(rows, 0).astype(np.float32)
    gain = rng.uniform(0.5, 2.0, F).astype(np.float32)
    e = rng.standard_normal(F * L).astype(np.float32)
    ref = lpc.lpc_synthesis_ref(a, gain, e, L)
    scale = np.max(np.abs(ref))
    y_scan = np.asarray(lpc.lpc_synthesis(a, gain, e, L, method="scan"))
    y_ref = np.asarray(lpc.lpc_synthesis(a, gain, e, L, method="refine"))
    # f32 frame-parallel vs f64 sequential at 12 resonant poles: the
    # association divergence envelope is wider than the order-8 golden
    # test's 1e-3
    assert np.max(np.abs(y_scan - ref)) / scale < 5e-3
    assert np.max(np.abs(y_ref - ref)) / scale < 5e-3
    # a frame length that is not a multiple of 8 runs as well
    ref60 = lpc.lpc_synthesis_ref(a, gain, e[: F * 60], 60)
    y60 = np.asarray(lpc.lpc_synthesis(a, gain, e[: F * 60], 60, method="refine"))
    assert np.max(np.abs(y60 - ref60)) / np.max(np.abs(ref60)) < 5e-3
    # the removed kernel method is an unknown method
    import pytest as _pytest

    with _pytest.raises(ValueError, match="unknown method"):
        lpc.lpc_synthesis(a, gain, e, L, method="pallas")


def test_refine_beats_compose_at_resonant_poles():
    """The f32 affine compose behind the scan spelling's entry states loses
    digits for resonant polynomials (A^L transient-growth cancellation);
    the refine path propagates states through the actual recurrence and
    stays at the sequential-f32 floor."""
    rng = np.random.default_rng(9)
    F, L, order = 6, 64, 8
    rows = []
    for _ in range(F):
        poles = 0.8 * np.exp(1j * rng.uniform(0.3, 2.8, order // 2))
        rows.append(np.poly(np.concatenate([poles, poles.conj()])).real)
    a = np.stack(rows, 0).astype(np.float32)
    gain = rng.uniform(0.8, 1.2, F).astype(np.float32)
    e = rng.standard_normal(F * L).astype(np.float32)
    ref = lpc.lpc_synthesis_ref(a, gain, e, L)
    scale = np.max(np.abs(ref))
    err_ref = (
        np.max(np.abs(np.asarray(lpc.lpc_synthesis(a, gain, e, L, method="refine")) - ref))
        / scale
    )
    err_comp = (
        np.max(np.abs(np.asarray(lpc.lpc_synthesis(a, gain, e, L, method="scan")) - ref))
        / scale
    )
    assert err_ref < 1e-4, err_ref
    # the compose's conditioning loss at this config is the documented
    # envelope; if this ever IMPROVES past refine the docstring is stale
    assert err_comp > err_ref


def test_factored_resonant_sweep():
    """Round-5 VERDICT item 7: the factored-sections engine must track the
    float64 sequential model within the sequential-f32 floor at pole radii
    0.95-0.999 — the regime where every f32 frame-parallel spelling of the
    order-p recurrence degrades (lpc_synthesis ACCURACY ENVELOPE)."""
    rng = np.random.default_rng(9)
    order, L, F = 6, 128, 8

    def seq_f32(a, gain, e, frame_len):
        a = np.asarray(a, np.float32)
        g = np.asarray(gain, np.float32)
        e = np.asarray(e, np.float32)
        p = a.shape[-1] - 1
        y = np.zeros(a.shape[0] * frame_len, np.float32)
        hist = np.zeros(p, np.float32)
        for f in range(a.shape[0]):
            for t in range(frame_len):
                i = f * frame_len + t
                v = np.float32(g[f] * e[i] - np.dot(a[f, 1:], hist))
                hist = np.concatenate([[v], hist[:-1]]).astype(np.float32)
                y[i] = v
        return y

    for radius in (0.95, 0.98, 0.995, 0.999):
        # frame-constant resonant poles (the regime contract: cascade state
        # carry == direct-form for constant coefficients)
        poles = radius * np.exp(1j * np.array([0.4, 1.3, 2.2]))
        row = np.poly(np.concatenate([poles, poles.conj()])).real
        a = np.tile(row, (F, 1)).astype(np.float32)
        gain = np.ones(F, np.float32)
        e = rng.standard_normal(F * L).astype(np.float32)
        ref = lpc.lpc_synthesis_ref(a, gain, e, L)
        scale = np.max(np.abs(ref))
        err_fact = (
            np.max(np.abs(np.asarray(
                lpc.lpc_synthesis(a, gain, e, L, method="factored")
            ) - ref)) / scale
        )
        err_seq32 = np.max(np.abs(seq_f32(a, gain, e, L) - ref)) / scale
        # the cascade's f32 association sits within ~50x of the sequential
        # direct-form f32 floor across the sweep (measured 2e-6 at 0.95 ->
        # 6e-5 at 0.999) while refine collapses to 3e-3 -> 0.56 there
        assert err_fact < max(err_seq32 * 64, 1e-5), (radius, err_fact, err_seq32)
        err_refine = (
            np.max(np.abs(np.asarray(
                lpc.lpc_synthesis(a, gain, e, L, method="refine")
            ) - ref)) / scale
        )
        if radius >= 0.98:
            # the regime gap the engine exists for
            assert err_fact < err_refine / 100, (radius, err_fact, err_refine)


def test_factored_auto_routing():
    rng = np.random.default_rng(3)
    L, F = 128, 4
    # frame-constant resonant: auto must route to factored and match the
    # float64 sequential golden (refine's compose would degrade here)
    poles = 0.995 * np.exp(1j * np.array([0.5, 1.9]))
    row = np.poly(np.concatenate([poles, poles.conj()])).real
    a_res = np.tile(row, (F, 1)).astype(np.float32)
    assert lpc._constant_frame_row(a_res) is not None
    _, maxr = lpc.lpc_to_sections(a_res[:1])
    assert maxr == pytest.approx(0.995, abs=1e-6)

    gain = np.ones(F, np.float32)
    e = rng.standard_normal(F * L).astype(np.float32)
    y = lpc.lpc_synthesis(a_res, gain, e, L, method="auto")
    ref = lpc.lpc_synthesis_ref(a_res, gain, e, L)
    assert np.max(np.abs(np.asarray(y) - ref)) / np.max(np.abs(ref)) < 1e-4

    # frame-VARYING resonant coefficients must NOT be silently re-routed
    # (the cascade transition contract differs from the direct form)
    a_var = a_res.copy()
    a_var[1, 1] *= 0.999
    assert lpc._constant_frame_row(a_var) is None


def test_factored_rejects_traced_coefficients():
    import jax

    rng = np.random.default_rng(1)
    a = np.tile(np.poly([0.5, -0.3]), (4, 1)).astype(np.float32)
    e = rng.standard_normal(4 * 128).astype(np.float32)

    @jax.jit
    def inner(a):
        return lpc.lpc_synthesis(
            a, np.ones(4, np.float32), e, 128, method="factored"
        )

    with pytest.raises(TypeError):
        inner(jnp.asarray(a))
