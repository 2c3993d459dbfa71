"""Time-varying SOS (sosfilt_tv family) parity and streaming tests.

Golden model: a per-sample numpy loop of the standard time-varying DF2T
recurrence (coefficients applied at each output sample). The reference
CUDA study has no time-varying analog; this surface exists for LPC
synthesis / adaptive-notch automation (ROADMAP round-3 item 4).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from digital_signal_processsing_tpu.ops import iir


def tv_ref(sos_t, x):
    """(S, n, 6) per-sample rows, float64 loop."""
    S, n, _ = sos_t.shape
    y = x.astype(np.float64).copy()
    for s in range(S):
        st1 = st2 = 0.0
        out = np.zeros(n)
        for t in range(n):
            b0, b1, b2, a0, a1, a2 = sos_t[s, t]
            b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
            yo = b0 * y[t] + st1
            st1 = b1 * y[t] - a1 * yo + st2
            st2 = b2 * y[t] - a2 * yo
            out[t] = yo
        y = out
    return y


def make_schedule(n, seed):
    """Smoothly swept stable biquad rows, a0 != 1 to exercise per-sample
    normalization."""
    r = 0.5 + 0.4 * np.sin(np.linspace(0, 3, n) + seed)
    th = 0.3 + 0.2 * np.cos(np.linspace(0, 2, n) + seed)
    a1 = -2 * r * np.cos(th)
    a2 = r**2
    b0 = np.full(n, 0.3)
    b1 = 0.1 * np.sin(np.linspace(0, 5, n))
    b2 = np.full(n, 0.05)
    a0 = np.full(n, 1.0 + 0.1 * seed)
    return np.stack([b0, b1, b2, a0, a1, a2], -1)


@pytest.fixture(scope="module")
def swept():
    rng = np.random.default_rng(7)
    n = 1000
    x = rng.standard_normal(n).astype(np.float32)
    sos_t = np.stack([make_schedule(n, 0), make_schedule(n, 1)], 0).astype(
        np.float32
    )
    return x, sos_t


def test_matches_golden_loop(swept):
    x, sos_t = swept
    ref = tv_ref(sos_t.astype(np.float64), x)
    got = np.asarray(iir.sosfilt_tv(sos_t, x))
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < 1e-5, err


def test_constant_schedule_matches_sosfilt(swept):
    x, _ = swept
    sos = np.array(
        [
            [0.2, 0.1, 0.05, 1.0, -0.6, 0.2],
            [0.3, 0.0, 0.1, 1.0, -0.2, 0.5],
        ],
        np.float32,
    )
    sos_t = np.broadcast_to(sos[:, None, :], (2, x.size, 6)).copy()
    y_tv = np.asarray(iir.sosfilt_tv(sos_t, x))
    y_c = np.asarray(iir.sosfilt(sos, x))
    assert np.max(np.abs(y_tv - y_c)) < 1e-5


def test_per_channel_schedules(swept):
    x, _ = swept
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((3, x.size)).astype(np.float32)
    sos_b = np.stack(
        [np.stack([make_schedule(x.size, i + 3) for i in range(3)], 0)], 0
    ).astype(np.float32)
    got = np.asarray(iir.sosfilt_tv(sos_b, xb))
    for c in range(3):
        ref = tv_ref(sos_b[:, c].astype(np.float64), xb[c])
        err = np.max(np.abs(got[c] - ref)) / np.max(np.abs(ref))
        assert err < 1e-5, (c, err)


def test_chunked_streaming_bit_consistency(swept):
    x, sos_t = swept
    one_shot = np.asarray(iir.sosfilt_tv(sos_t, x))
    st = jnp.zeros((2, 2))
    parts = []
    for lo in range(0, x.size, 300):
        hi = min(x.size, lo + 300)
        st, yp = iir.sosfilt_tv_chunk(
            st,
            jnp.asarray(sos_t[:, lo:hi]),
            jnp.asarray(x[lo:hi]),
        )
        parts.append(np.asarray(yp))
    assert np.max(np.abs(np.concatenate(parts) - one_shot)) < 1e-5


def test_frames_expansion(swept):
    x, sos_t = swept
    fl = 100
    sos_fr = sos_t[:, ::fl, :]
    got = np.asarray(iir.sosfilt_tv_frames(sos_fr, x, fl))
    ref = tv_ref(np.repeat(sos_fr, fl, axis=1).astype(np.float64), x)
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < 1e-5, err


def frame_schedule(n_frames, seed):
    """Stable per-frame biquad rows (a0 != 1)."""
    f = np.linspace(0, 3, n_frames)
    r = 0.5 + 0.4 * np.sin(f + seed)
    th = 0.3 + 0.2 * np.cos(2 * f + seed)
    return np.stack(
        [
            np.full(n_frames, 0.3),
            0.1 * np.sin(5 * f),
            np.full(n_frames, 0.05),
            np.full(n_frames, 1.0 + 0.1 * seed),
            -2 * r * np.cos(th),
            r**2,
        ],
        -1,
    ).astype(np.float32)


def tv_ref_batched(sos_t, x):
    """tv_ref over the leading axes of x; sos_t (S, n, 6) or (S, C, n, 6)."""
    if x.ndim == 1:
        return tv_ref(sos_t, x)
    return np.stack(
        [
            tv_ref(sos_t if sos_t.ndim == 3 else sos_t[:, c], x[c])
            for c in range(x.shape[0])
        ]
    )


class TestFramesKernel:
    """Per-frame schedules at frame lengths on both sides of the old kernel
    tiles, against the expanded per-sample schedule and the float64
    loop."""

    def _parity(self, n, frame_len, nsec=2, batch=None, seed=0):
        rng = np.random.default_rng(seed)
        shape = (n,) if batch is None else (batch, n)
        x = rng.standard_normal(shape).astype(np.float32)
        nf = -(-n // frame_len)
        sos_fr = np.stack(
            [frame_schedule(nf, s) for s in range(nsec)], 0
        )
        expanded = np.repeat(sos_fr, frame_len, axis=1)[:, :n]
        want = np.asarray(iir.sosfilt_tv(expanded, x))
        got = np.asarray(iir.sosfilt_tv_frames(sos_fr, x, frame_len))
        scale = np.max(np.abs(want)) + 1e-9
        err = np.max(np.abs(got - want)) / scale
        assert err < 1e-5, (n, frame_len, err)
        # and against the float64 loop: the float32 associative scan over
        # 33k-82k samples of these resonant schedules measures <= 2.9e-5
        ref = tv_ref_batched(expanded.astype(np.float64), x)
        err64 = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-9)
        assert err64 < 5e-5, (n, frame_len, err64)

    def test_frames_per_tile(self):
        # several frames per old kernel tile
        self._parity(128 * 128 * 2 + 777, 256)

    def test_tiles_per_frame(self):
        # one frame spans several old kernel tiles
        self._parity(128 * 128 * 5 + 99, 128 * 256)

    def test_frame_equals_tile(self):
        self._parity(128 * 128 * 3, 128 * 128)

    def test_batched_channels(self):
        self._parity(128 * 128 * 2, 512, batch=3, seed=4)

    def test_single_section(self):
        self._parity(128 * 128 * 2 + 17, 1024, nsec=1, seed=9)

    def test_auto_routes_frames(self):
        # any frame length expands in-graph to the per-sample schedule
        n = 128 * 128 * 2
        x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
        for fl in (256, 100):
            sos_fr = frame_schedule(-(-n // fl), 0)[None]
            got = np.asarray(iir.sosfilt_tv_frames(sos_fr, x, fl))
            expanded = np.repeat(sos_fr, fl, axis=1)[:, :n]
            want = np.asarray(iir.sosfilt_tv(expanded, x))
            np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError):
            iir.sosfilt_tv_frames(frame_schedule(4, 0)[None], x, 100)

    def _chunked(self, x, sos_fr, fl, step):
        st = jnp.zeros((sos_fr.shape[0], 2))
        parts = []
        n = x.shape[-1]
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            st, yp = iir.sosfilt_tv_frames_chunk(
                st,
                jnp.asarray(sos_fr[:, lo // fl : -(-hi // fl)]),
                jnp.asarray(x[lo:hi]),
                fl,
            )
            parts.append(np.asarray(yp))
        return np.concatenate(parts)

    def test_chunk_handoff(self):
        n, fl = 128 * 128 * 4, 512
        rng = np.random.default_rng(5)
        x = rng.standard_normal(n).astype(np.float32)
        sos_fr = np.stack(
            [frame_schedule(n // fl, s) for s in range(2)], 0
        )
        one = np.asarray(iir.sosfilt_tv_frames(sos_fr, x, fl))
        scale = np.max(np.abs(one)) + 1e-9
        # halves, and frame-aligned chunks of another length: each chunk
        # is its own scan (different f32 association) — the
        # sosfilt_tv_chunk contract, 1e-5
        for step in (n // 2, n // 2 + fl):
            got = self._chunked(x, sos_fr, fl, step)
            assert np.max(np.abs(got - one)) / scale < 1e-5, step


def test_frames_too_short_raises(swept):
    x, sos_t = swept
    with pytest.raises(ValueError):
        iir.sosfilt_tv_frames(sos_t[:, :3, :], x, 10)


def test_shape_mismatch_raises(swept):
    x, sos_t = swept
    with pytest.raises(ValueError):
        iir.sosfilt_tv(sos_t[:, :-1, :], x)


def test_fused_cascade_matches_scan_spelling(swept):
    # the associative-scan spelling against the serial per-sample scan
    import jax

    x, sos_t = swept
    scan = np.asarray(
        iir._sosfilt_tv_chunk_xla(jnp.zeros((2, 2)), sos_t, x)[1]
    )
    auto = np.asarray(iir.sosfilt_tv(sos_t, x))
    jitted = np.asarray(jax.jit(iir.sosfilt_tv)(sos_t, x))
    assert np.array_equal(jitted, auto)
    assert np.max(np.abs(auto - scan)) < 1e-5
    with pytest.raises(TypeError):
        iir.sosfilt_tv(sos_t, x, method="warp")


@pytest.mark.parametrize("tile_rows", [128, 256])
def test_fused_compact_row_pass(tile_rows):
    # lengths that were whole kernel tiles plus a ragged tail
    rng = np.random.default_rng(11)
    n = tile_rows * 128 * 2 + 99
    x = rng.standard_normal(n).astype(np.float32)
    sos_t = np.stack(
        [make_schedule(n, 0), make_schedule(n, 1)], 0
    ).astype(np.float32)
    want = tv_ref(sos_t.astype(np.float64), x)
    got = np.asarray(iir.sosfilt_tv(sos_t, x))
    scale = np.max(np.abs(want)) + 1e-9
    assert np.max(np.abs(got - want)) / scale < 1e-5
