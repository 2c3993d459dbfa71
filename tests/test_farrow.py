"""Farrow arbitrary-rate resampler: analytic oracles, streaming exactness."""

import numpy as np
import pytest

from digital_signal_processsing_tpu.ops.farrow import (
    as_rational_rate,
    farrow_chunk,
    farrow_init,
    farrow_max_chunk_out,
    farrow_output_len,
    resample_farrow,
)


def oracle_lagrange4(x, up, down, m_out):
    """Float64 mirror of the exact integer schedule + Lagrange stencil."""
    ext = np.concatenate([np.zeros(4), x.astype(np.float64)])
    num = 4 * up + np.arange(m_out, dtype=np.int64) * down
    n = num // up
    mu = (num % up).astype(np.float64) / up
    g = [ext[n - 1 + j] for j in range(4)]
    w0 = -mu * (mu - 1) * (mu - 2) / 6
    w1 = (mu - 1) * (mu + 1) * (mu - 2) / 2
    w2 = -mu * (mu + 1) * (mu - 2) / 2
    w3 = mu * (mu + 1) * (mu - 1) / 6
    return w0 * g[0] + w1 * g[1] + w2 * g[2] + w3 * g[3]


def test_identity_rate_is_exact(rng):
    x = rng.normal(size=4096).astype(np.float32)
    y = np.asarray(resample_farrow(x, 1.0))
    np.testing.assert_array_equal(y, x[: y.shape[0]])


@pytest.mark.parametrize(
    "rate", [np.pi / 3, np.e / 2, 1 / np.sqrt(2), 0.9173, 1.6181, 48000 / 44100]
)
def test_sine_oracle_irrational_rates(rate):
    # bandlimited analytic oracle: resampling a low-frequency sine must
    # reproduce the continuous waveform within the cubic-kernel error bound
    f = 0.02  # of Nyquist: quartic-error bound ~6e-6 at this frequency
    t_in = np.arange(48000)
    x = np.sin(np.pi * f * t_in).astype(np.float32)
    up, down = as_rational_rate(rate)
    y = np.asarray(resample_farrow(x, rate))
    m = np.arange(y.shape[0], dtype=np.float64)
    t_out = m * down / up
    want = np.sin(np.pi * f * t_out)
    # outputs at t < 1 blend with the zero left halo (documented edge
    # semantics — x[0] has no left neighbor); compare the interior
    interior = t_out >= 1.0
    err = np.max(np.abs(y[interior] - want[interior]))
    assert err < 2e-5, err


@pytest.mark.parametrize("rate", [(7, 3), (3, 7), (160, 147), (1000, 999)])
def test_float64_mirror(rng, rate):
    x = rng.normal(size=5000).astype(np.float32)
    up, down = rate
    y = np.asarray(resample_farrow(x, rate))
    assert y.shape[0] == farrow_output_len(5000, rate)
    want = oracle_lagrange4(x, up, down, y.shape[0])
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5)


def test_planar_channels(rng):
    x = rng.normal(size=(3, 3000)).astype(np.float32)
    y = np.asarray(resample_farrow(x, 1.5))
    assert y.shape[0] == 3
    for c in range(3):
        np.testing.assert_array_equal(
            y[c], np.asarray(resample_farrow(x[c], 1.5))
        )


@pytest.mark.parametrize("rate", [np.pi / 3, (160, 147), 0.731, (3, 7)])
def test_streaming_bit_exact_with_one_shot(rng, rate):
    x = rng.normal(size=(2, 9973)).astype(np.float32)  # prime length
    # streaming mirrors the pointwise (gather) spelling bit-for-bit; the
    # matmul path agrees to float rounding (separate test)
    want = np.asarray(resample_farrow(x, rate, method="gather"))

    state = farrow_init(rate, channels=2)
    pieces = []
    edges = [0, 1, 130, 1155, 4099, 7001, 9973]  # ragged chunk sizes
    for a, b in zip(edges[:-1], edges[1:]):
        state, y, count = farrow_chunk(state, x[:, a:b], rate)
        pieces.append(np.asarray(y)[:, : int(count)])
    got = np.concatenate(pieces, axis=-1)
    assert got.shape[1] >= want.shape[1] - 1  # stencil tail may defer 1
    np.testing.assert_array_equal(got[:, : want.shape[1]], want[:, : got.shape[1]])


def test_chunk_capacity_and_counts(rng):
    rate = (44100, 48000)
    x = rng.normal(size=4096).astype(np.float32)
    state = farrow_init(rate)
    total = 0
    for i in range(0, 4096, 512):
        state, y, count = farrow_chunk(state, x[i : i + 512], rate)
        assert y.shape[-1] == farrow_max_chunk_out(512, rate)
        assert 0 <= int(count) <= y.shape[-1]
        total += int(count)
    assert abs(total - farrow_output_len(4096, rate)) <= 1


def test_rejections():
    with pytest.raises(ValueError, match="positive"):
        as_rational_rate(-1.0)
    with pytest.raises(ValueError, match="too short"):
        resample_farrow(np.zeros(2, np.float32), 2.0)
    with pytest.raises(ValueError, match="envelope"):
        # denominator at the cap with a huge chunk blows the int32 phase
        state = farrow_init((65537 // 3, 65536))
        farrow_chunk(state, np.zeros(1 << 20, np.float32), (65537 // 3, 65536))
    with pytest.raises(ValueError, match="envelope"):
        # explicit (up, down) pairs bypass the limit_denominator snap, so
        # the guard must use the ACTUAL denominator (round-2 ADVICE): here
        # down alone exceeds int32 headroom left by (tc+4)*up
        big_down = 2**31 - 1
        state = farrow_init((1, big_down))
        farrow_chunk(state, np.zeros(1 << 20, np.float32), (1, big_down))


def test_float_rate_snaps_to_exact_rational():
    up, down = as_rational_rate(0.5)
    assert (up, down) == (1, 2)
    up, down = as_rational_rate(48000 / 44100)
    assert (up, down) == (160, 147)


@pytest.mark.parametrize("rate", [(7, 3), (3, 7), (160, 147), (441, 2560), 1.5])
def test_matmul_path_matches_gather(rng, rate):
    # the phase-matrix spelling computes the identical schedule
    from digital_signal_processsing_tpu.ops.farrow import (
        MATMUL_MAX_PRODUCT,
        as_rational_rate,
    )

    up, down = as_rational_rate(rate)
    assert up * down <= MATMUL_MAX_PRODUCT
    x = rng.normal(size=(2, 7001)).astype(np.float32)
    got = np.asarray(resample_farrow(x, rate, method="matmul"))
    want = np.asarray(resample_farrow(x, rate, method="gather"))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_auto_picks_matmul_within_envelope(rng):
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    x = rng.normal(size=4096).astype(np.float32)
    resample_farrow(x, (160, 147))
    assert last_choice("resample_farrow") == "matmul"
    # snaps to a ~2^16 fraction beyond the envelope: the exact pointwise
    # gather schedule
    resample_farrow(x, np.pi / 3)
    assert last_choice("resample_farrow") == "gather"


@pytest.mark.parametrize("rate", [(160, 147), (3, 7), (441, 2560), 1.5])
def test_matmul_streaming_matches_one_shot(rng, rate):
    from digital_signal_processsing_tpu.ops.farrow import (
        farrow_matmul_chunk,
        farrow_matmul_init,
        farrow_matmul_max_out,
    )

    x = rng.normal(size=(2, 9973)).astype(np.float32)
    want = np.asarray(resample_farrow(x, rate, method="matmul"))

    state = farrow_matmul_init(rate, channels=2)
    pieces = []
    edges = [0, 1, 130, 1155, 4099, 7001, 9973]
    for a, b in zip(edges[:-1], edges[1:]):
        state, y, count = farrow_matmul_chunk(state, x[:, a:b], rate)
        assert y.shape[-1] == farrow_matmul_max_out(b - a, rate)
        pieces.append(np.asarray(y)[:, : int(count)])
    from digital_signal_processsing_tpu.ops.farrow import farrow_matmul_flush

    yf, cf = farrow_matmul_flush(state, rate)
    pieces.append(np.asarray(yf)[:, : int(cf)])
    got = np.concatenate(pieces, axis=-1)
    # chunks emit whole frames; the flush completes the stream end exactly
    assert got.shape[1] >= want.shape[1]
    np.testing.assert_allclose(
        got[:, : want.shape[1]], want, rtol=1e-5, atol=1e-5
    )


class TestFarrowSegmented:
    """Exact schedules beyond the phase-matrix envelope, through the
    public op, against the float64 mirror of the schedule."""

    @staticmethod
    def _check(x, up, down, tol=2e-5):
        got = np.asarray(resample_farrow(x, (up, down)))
        rows = np.atleast_2d(x)
        want = np.stack(
            [oracle_lagrange4(r, up, down, got.shape[-1]) for r in rows]
        ).reshape(got.shape)
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err < tol, ((up, down), err)

    def test_matches_gather_oracle_beyond_envelope(self, rng):
        from digital_signal_processsing_tpu.ops.farrow import MATMUL_MAX_PRODUCT

        up, down = 46337, 65521  # primes; far beyond the matrix envelope
        assert up * down > MATMUL_MAX_PRODUCT
        self._check(rng.normal(size=(2, 30_000)).astype(np.float32), up, down)

    def test_matches_matmul_in_envelope(self, rng):
        x = rng.normal(size=20_000).astype(np.float32)
        for rate in [(3, 7), (48000, 44100)]:
            up, down = as_rational_rate(rate)
            want = np.asarray(resample_farrow(x, rate, method="matmul"))
            got = np.asarray(resample_farrow(x, rate, method="gather"))
            err = np.max(np.abs(got - want)) / np.max(np.abs(want))
            assert err < 2e-5, (rate, err)

    def test_auto_routes_beyond_envelope_to_segmented(self, rng):
        from digital_signal_processsing_tpu.utils.dispatch import last_choice

        x = rng.normal(size=10_000).astype(np.float32)
        resample_farrow(x, (46337, 65521))
        assert last_choice("resample_farrow") == "gather"
        resample_farrow(x, (48000, 44100))
        assert last_choice("resample_farrow") == "matmul"

    def test_rate_sweep_same_structure(self, rng):
        # a sweep of nearby exact rates: each matches its own schedule
        x = rng.normal(size=(2, 24_000)).astype(np.float32)
        for up, down in [(46337, 65521), (46349, 65521), (46351, 65537)]:
            self._check(x, up, down)

    def test_segment_validation(self, rng):
        x = rng.normal(size=10_000).astype(np.float32)
        with pytest.raises(ValueError, match="unknown method"):
            resample_farrow(x, (3, 7), method="segmented")
