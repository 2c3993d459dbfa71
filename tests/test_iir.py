"""IIR via associative scan: parity with literal sequential recurrences."""

import numpy as np
import pytest

from digital_signal_processsing_tpu.ops.iir import (
    design_biquad_lowpass,
    iir_first_order,
    sosfilt,
)


def seq_first_order(x, a, b=1.0):
    y = np.zeros_like(x, dtype=np.float64)
    prev = 0.0
    for t in range(x.shape[-1]):
        prev = a * prev + b * x[t]
        y[t] = prev
    return y


def seq_sos(sos, x):
    y = x.astype(np.float64)
    for b0, b1, b2, a0, a1, a2 in sos:
        s1 = s2 = 0.0
        out = np.zeros_like(y)
        for t in range(y.shape[-1]):
            out[t] = b0 * y[t] + s1
            s1 = b1 * y[t] - a1 * out[t] + s2
            s2 = b2 * y[t] - a2 * out[t]
        y = out
    return y


@pytest.mark.parametrize("a", [0.5, -0.3, 0.99])
def test_first_order_matches_sequential(rng, a):
    x = rng.normal(size=500).astype(np.float32)
    got = np.asarray(iir_first_order(x, a, 0.7))
    want = seq_first_order(x, a, 0.7)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_first_order_batched(rng):
    x = rng.normal(size=(3, 256)).astype(np.float32)
    got = np.asarray(iir_first_order(x, 0.9))
    for c in range(3):
        np.testing.assert_allclose(
            got[c], seq_first_order(x[c], 0.9), rtol=1e-4, atol=1e-4
        )


def test_biquad_matches_sequential(rng):
    sos = design_biquad_lowpass(0.2)
    x = rng.normal(size=400).astype(np.float32)
    got = np.asarray(sosfilt(sos, x))
    want = seq_sos(sos, x)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_sos_cascade(rng):
    sos = np.vstack([design_biquad_lowpass(0.3), design_biquad_lowpass(0.25, q=1.0)])
    x = rng.normal(size=(2, 300)).astype(np.float32)
    got = np.asarray(sosfilt(sos, x))
    for c in range(2):
        np.testing.assert_allclose(got[c], seq_sos(sos, x[c]), rtol=1e-3, atol=1e-4)


def test_biquad_lowpass_behavior(rng):
    # DC passes, high frequency is attenuated
    sos = design_biquad_lowpass(0.1)
    t = np.arange(4096)
    dc = np.ones(4096, np.float32)
    hi = np.sin(2 * np.pi * 0.45 * t).astype(np.float32)
    y_dc = np.asarray(sosfilt(sos, dc))
    y_hi = np.asarray(sosfilt(sos, hi))
    assert abs(y_dc[2000:].mean() - 1.0) < 1e-3
    assert np.abs(y_hi[2000:]).max() < 0.05
    with pytest.raises(ValueError):
        design_biquad_lowpass(1.5)


def test_sosfilt_chunked_matches_one_shot(rng):
    from digital_signal_processsing_tpu.ops.iir import sosfilt_chunk, sosfilt_init

    sos = np.vstack([design_biquad_lowpass(0.2), design_biquad_lowpass(0.15, q=1.2)])
    x = rng.normal(size=(2, 900)).astype(np.float32)
    want = np.asarray(sosfilt(sos, x))
    state = sosfilt_init(sos, batch_shape=(2,))
    outs = []
    for a, b in [(0, 100), (100, 512), (512, 900)]:
        state, y = sosfilt_chunk(state, sos, x[:, a:b])
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _lfilter1(x, a, b):
    import scipy.signal as sps

    return sps.lfilter([b], [1.0, -a], np.asarray(x, np.float64), axis=-1)


def _rel_err(got, want):
    return np.max(np.abs(np.asarray(got) - want)) / (np.max(np.abs(want)) + 1e-9)


def test_iir_first_order_pallas_matches_xla(rng):
    # long streams through the public op, against the float64 recurrence
    for n, a, b in [(1000, 0.95, 1.0), (100_000, 0.999, 0.001), (70_001, 0.5, 2.0)]:
        x = rng.normal(size=n).astype(np.float32)
        assert _rel_err(iir_first_order(x, a, b), _lfilter1(x, a, b)) < 1e-4


@pytest.mark.parametrize("spelling", ["auto", "xla_scan", "jit"])
def test_iir1_scalar_kernel_matches_xla(rng, spelling):
    import jax

    x = rng.normal(size=(2, 140_000)).astype(np.float32)
    if spelling == "jit":
        got = jax.jit(lambda v: iir_first_order(v, 0.93, 0.4))(x)
    else:
        got = iir_first_order(x, 0.93, 0.4, method=spelling)
    assert _rel_err(got, _lfilter1(x, 0.93, 0.4)) < 1e-4


def test_iir1_kernel_validation(rng):
    # the removed kernel engines' names are unknown methods
    x = rng.normal(size=4096).astype(np.float32)
    for method in ("pallas", "nope"):
        with pytest.raises(ValueError, match="unknown method"):
            iir_first_order(x, 0.9, method=method)


def test_iir_first_order_pallas_batched(rng):
    # planar (C, T): each row must match its own independent recurrence
    x = rng.normal(size=(3, 70_000)).astype(np.float32)
    got = np.asarray(iir_first_order(x, 0.97, 0.5))
    for c in range(3):
        assert _rel_err(got[c], _lfilter1(x[c], 0.97, 0.5)) < 1e-4


def test_sosfilt_pallas_matches_xla(rng):
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.iir import (
        design_butterworth,
        design_butterworth_band,
    )

    for n in (1000, 20_001):
        x = rng.normal(size=n).astype(np.float32)
        for sos in (design_butterworth(4, 0.2), design_butterworth_band(2, 0.2, 0.5)):
            want = sps.sosfilt(sos.astype(np.float64), x.astype(np.float64))
            assert _rel_err(sosfilt(sos, x), want) < 1e-4


def test_sosfilt_pallas_batched(rng):
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.iir import design_butterworth

    sos = design_butterworth(4, 0.25)
    x = rng.normal(size=(3, 9_000)).astype(np.float32)
    got = np.asarray(sosfilt(sos, x))
    for c in range(3):
        want = sps.sosfilt(sos.astype(np.float64), x[c].astype(np.float64))
        assert _rel_err(got[c], want) < 1e-4


def test_auto_dispatch_routes_long_concrete_calls_to_pallas(rng):
    # every call, long or short, concrete or traced, takes the XLA scan
    import jax
    import scipy.signal as sps

    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    long = rng.normal(size=65536).astype(np.float32)
    short = rng.normal(size=512).astype(np.float32)
    for v in (long, short):
        iir_first_order(v, 0.9)
        assert last_choice("iir_first_order") == "xla_scan"

    sos = design_biquad_lowpass(0.2)
    want = sps.sosfilt(sos.astype(np.float64), long.astype(np.float64))
    assert _rel_err(sosfilt(sos, long), want) < 1e-4
    assert last_choice("sosfilt") == "xla_scan"
    sosfilt(sos, short)
    assert last_choice("sosfilt") == "xla_scan"
    got = jax.jit(lambda s, v: sosfilt(s, v))(sos, long)
    assert last_choice("sosfilt") == "xla_scan"
    assert _rel_err(got, want) < 1e-4


def test_sosfilt_chunk_pallas_matches_xla_chunks(rng):
    # chunked output + carried state continue the stream
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.iir import (
        design_butterworth,
        sosfilt_chunk,
        sosfilt_init,
    )

    sos = design_butterworth(4, 0.2)
    x = rng.normal(size=(2, 90_000)).astype(np.float32)
    want = sps.sosfilt(sos.astype(np.float64), x.astype(np.float64))
    state = sosfilt_init(sos, batch_shape=(2,))
    outs = []
    for a, b in [(0, 40_000), (40_000, 70_123), (70_123, 90_000)]:
        state, y = sosfilt_chunk(state, sos, x[:, a:b])
        outs.append(np.asarray(y))
    assert _rel_err(np.concatenate(outs, axis=-1), want) < 1e-4


def test_sosfilt_chunk_dispatches_by_length(rng):
    from digital_signal_processsing_tpu.ops.iir import sosfilt_chunk, sosfilt_init
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    sos = design_biquad_lowpass(0.3)
    st = sosfilt_init(sos)
    for n in (1024, 65536):
        sosfilt_chunk(st, sos, np.zeros(n, np.float32))
        assert last_choice("sosfilt_chunk") == "xla_scan"
    with pytest.raises(ValueError, match="unknown method"):
        sosfilt_chunk(st, sos, np.zeros(64, np.float32), method="pallas_fused")


def test_ba_to_sos_and_lfilter_match_scipy(rng):
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.iir import lfilter

    x = rng.normal(size=4000).astype(np.float32)
    for b, a in [
        sps.butter(4, 0.2),
        sps.butter(5, [0.2, 0.5], btype="bandpass"),
        sps.cheby1(3, 1.0, 0.3),
        (np.array([0.5, 0.3, 0.1]), np.array([1.0])),  # pure FIR
        # leading-zero numerators: pure delay + gain (round-2 ADVICE — the
        # old pairing dropped both; scipy.signal.lfilter keeps them)
        (np.array([0.0, 1.0]), np.array([1.0, -0.5])),
        (np.array([0.0, 2.0]), np.array([1.0, -0.5])),
        (np.array([0.0, 0.0, 3.0]), np.array([1.0, -0.5, 0.25, 0.1])),
        (np.array([0.0, 1.0, 0.4, 0.2]), np.array([1.0, -0.3, 0.1])),
    ]:
        got = np.asarray(lfilter(b, a, x))
        want = sps.lfilter(np.atleast_1d(b), np.atleast_1d(a), x.astype(np.float64))
        scale = np.max(np.abs(want)) + 1e-9
        assert np.max(np.abs(got - want)) / scale < 1e-3, (b, a)


def test_sosfiltfilt_matches_scipy(rng):
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.iir import sosfiltfilt

    sos = sps.butter(4, 0.2, output="sos")
    x = rng.normal(size=(2, 3000)).astype(np.float32)
    got = np.asarray(sosfiltfilt(sos, x))
    want = sps.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
    scale = np.max(np.abs(want))
    # round 3: scipy's default padlen + steady-state zi seeding per pass
    # makes the whole stream — EDGES INCLUDED — float32-exact vs scipy
    assert np.max(np.abs(got - want)) / scale < 1e-5
    # zero phase: a delayed impulse stays centered
    imp = np.zeros(2048, np.float32)
    imp[1024] = 1.0
    y = np.asarray(sosfiltfilt(sos, imp))
    assert abs(int(np.argmax(y)) - 1024) <= 1


def test_freqz_helpers_match_scipy():
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.iir import (
        design_butterworth,
        freqz,
        sosfreqz,
    )

    w, h = freqz([0.5, 0.5], [1.0, -0.2], worN=256)
    ws, hs = sps.freqz([0.5, 0.5], [1.0, -0.2], worN=256)
    np.testing.assert_allclose(w, ws)
    np.testing.assert_allclose(h, hs, rtol=1e-10)
    sos = design_butterworth(4, 0.25)
    w2, h2 = sosfreqz(sos, worN=256)
    ws2, hs2 = sps.sosfreqz(sos.astype(np.float64), worN=256)
    np.testing.assert_allclose(h2, hs2, rtol=1e-4, atol=1e-6)


class TestSosfiltFused:
    """The whole cascade through the public ops, against scipy's float64
    sosfilt: section counts, odd orders, batches, chunked streams."""

    @staticmethod
    def _want(sos, x):
        import scipy.signal as sps

        return sps.sosfilt(
            np.asarray(sos, np.float64), np.asarray(x, np.float64), axis=-1
        )

    def test_matches_xla_scan(self, rng):
        from digital_signal_processsing_tpu.ops.iir import (
            design_butterworth,
            design_butterworth_band,
        )

        x = rng.normal(size=20_001).astype(np.float32)
        for sos in (
            design_butterworth(8, 0.2),  # 4 sections
            design_butterworth(5, 0.3),  # odd order: a first-order row
            design_butterworth_band(2, 0.2, 0.5),
        ):
            assert _rel_err(sosfilt(sos, x), self._want(sos, x)) < 1e-4

    def test_batched_and_unrolled_spelling(self, rng):
        import jax

        from digital_signal_processsing_tpu.ops.iir import design_butterworth

        sos = design_butterworth(6, 0.25)
        x = rng.normal(size=(3, 9_000)).astype(np.float32)
        got = np.asarray(sosfilt(sos, x))
        jitted = np.asarray(jax.jit(sosfilt)(sos, x))
        for c in range(3):
            assert _rel_err(got[c], self._want(sos, x[c])) < 1e-4
        np.testing.assert_allclose(jitted, got, rtol=1e-5, atol=1e-6)

    def test_seeded_chunks_continue_stream(self, rng):
        from digital_signal_processsing_tpu.ops.iir import (
            design_butterworth,
            sosfilt_chunk,
            sosfilt_init,
        )

        sos = design_butterworth(4, 0.2)
        x = rng.normal(size=(2, 30_000)).astype(np.float32)
        state = sosfilt_init(sos, batch_shape=(2,))
        outs = []
        for a, b in [(0, 12_000), (12_000, 20_123), (20_123, 30_000)]:
            state, y = sosfilt_chunk(state, sos, x[:, a:b])
            outs.append(np.asarray(y))
        got = np.concatenate(outs, axis=-1)
        assert _rel_err(got, self._want(sos, x)) < 1e-4

    def test_mxu_lane_pass_matches_vpu(self, rng):
        import scipy.signal as sps

        sos = sps.butter(8, 0.2, output="sos").astype(np.float32)
        x = rng.normal(size=(2, 20_000)).astype(np.float32)
        assert _rel_err(sosfilt(sos, x), self._want(sos, x)) < 1e-4

    @pytest.mark.parametrize("order", [6, 8])
    @pytest.mark.parametrize("tile_rows", [128, 256])
    def test_compact_row_pass_parity(self, rng, order, tile_rows):
        # lengths that were whole kernel tiles plus a ragged tail
        import scipy.signal as sps

        sos = sps.butter(order, 0.2, output="sos").astype(np.float32)
        x = rng.normal(size=(2, tile_rows * 128 * 2 + 333)).astype(np.float32)
        assert _rel_err(sosfilt(sos, x), self._want(sos, x)) < 1e-4

    def test_compact_row_pass_validation(self, rng):
        sos = np.array([[0.2, 0.1, 0.05, 1.0, -0.4, 0.1]], np.float32)
        x = rng.normal(size=2048).astype(np.float32)
        for method in ("pallas", "pallas_fused", "nope"):
            with pytest.raises(ValueError, match="unknown method"):
                sosfilt(sos, x, method=method)

    def test_compact_seeded_chunks_bit_equal_full(self, rng):
        # chunks at the old tile boundaries continue the one-shot stream
        import scipy.signal as sps

        from digital_signal_processsing_tpu.ops.iir import (
            sosfilt_chunk,
            sosfilt_init,
        )

        sos = sps.butter(6, 0.31, output="sos").astype(np.float32)
        tile = 128 * 128
        x = rng.normal(size=(2, 3 * tile)).astype(np.float32)
        full = np.asarray(sosfilt(sos, x))
        state = sosfilt_init(sos, batch_shape=(2,))
        outs = []
        for a, b in [(0, tile), (tile, 3 * tile)]:
            state, y = sosfilt_chunk(state, sos, x[:, a:b])
            outs.append(np.asarray(y))
        got = np.concatenate(outs, axis=-1)
        want = self._want(sos, x)
        assert _rel_err(got, want) < 1e-4
        assert _rel_err(full, want) < 1e-4


def test_sosfiltfilt_edges_exact_all_families(rng):
    # the round-3 zi-seeded recipe: parity at the very first/last samples
    import jax.numpy as jnp
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.iir import filtfilt, sosfiltfilt

    x = rng.normal(size=1500).astype(np.float32)
    for sos in [
        sps.butter(4, 0.2, output="sos"),
        sps.ellip(5, 1.0, 40.0, 0.3, output="sos"),
        sps.cheby1(3, 1.0, [0.2, 0.5], btype="bandpass", output="sos"),
    ]:
        got = np.asarray(sosfiltfilt(sos, jnp.asarray(x)))
        want = sps.sosfiltfilt(sos, x.astype(np.float64))
        edge = np.abs(got - want)[list(range(10)) + list(range(-10, 0))]
        assert edge.max() < 1e-4, edge.max()
    b, a = sps.butter(4, 0.25)
    got = np.asarray(filtfilt(b, a, jnp.asarray(x)))
    want = sps.filtfilt(b, a, x.astype(np.float64))
    assert np.abs(got - want).max() < 1e-4
