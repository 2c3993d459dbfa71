"""Serving loop: multi-WAV stream -> chunked device compute -> streaming sink."""

import numpy as np
import pytest

from digital_signal_processsing_tpu import serve
from digital_signal_processsing_tpu.golden import moving_average_golden
from digital_signal_processsing_tpu.io.wav import WavWriter, read_wav, write_wav
from digital_signal_processsing_tpu.serve import run_chunks, stream_moving_average


def test_wav_writer_streaming_equals_one_shot(rng, tmp_path):
    x = rng.integers(-32768, 32768, size=10000, dtype=np.int16)
    write_wav(tmp_path / "oneshot.wav", x, 8000, 2)
    with WavWriter(tmp_path / "streamed.wav", 8000, 2) as w:
        for a, b in [(0, 3000), (3000, 9000), (9000, 10000)]:
            w.append(x[a:b])
    assert (tmp_path / "oneshot.wav").read_bytes() == (
        tmp_path / "streamed.wav"
    ).read_bytes()


def test_stream_moving_average_end_to_end(rng, tmp_path):
    # two files, odd total length: the streamed pipeline must be bit-exact
    # with the one-shot golden on the concatenated stream, pad dropped
    c, w = 2, 257
    xs = [
        rng.integers(-32768, 32768, size=n, dtype=np.int16)
        for n in (30000, 17034)
    ]
    for i, x in enumerate(xs):
        write_wav(tmp_path / f"in{i}.wav", x, 44100, c)
    full = np.concatenate(xs)

    written = stream_moving_average(
        [tmp_path / "in0.wav", tmp_path / "in1.wav"],
        tmp_path / "out.wav",
        w,
        chunk_samples=8192,
    )
    assert written == full.size
    info, got = read_wav(tmp_path / "out.wav")
    assert info.num_channels == c
    np.testing.assert_array_equal(got, moving_average_golden(full, w, c))


def test_run_chunks_generic(rng):
    from digital_signal_processsing_tpu.ops.iir import (
        design_butterworth,
        sosfilt,
        sosfilt_chunk,
        sosfilt_init,
    )

    sos = np.asarray(design_butterworth(4, 0.2))
    x = rng.normal(size=4096).astype(np.float32)
    want = np.asarray(sosfilt(sos, x))
    outs = list(
        run_chunks(
            lambda st, ch: sosfilt_chunk(st, sos, ch),
            sosfilt_init(sos),
            [x[:1000], x[1000:3000], x[3000:]],
        )
    )
    np.testing.assert_allclose(np.concatenate(outs), want, rtol=1e-4, atol=1e-5)


def test_stream_sosfilt_matches_one_shot(tmp_path):
    import jax.numpy as jnp  # noqa: F401

    from digital_signal_processsing_tpu.ops import iir

    rng = np.random.default_rng(8)
    sr, ch = 16000, 2
    paths, parts = [], []
    for i, frames in enumerate([3000, 1700, 2501]):
        x = (rng.standard_normal(frames * ch) * 8000).astype(np.int16)
        p = tmp_path / f"s{i}.wav"
        write_wav(p, x, sr, ch)
        paths.append(p)
        parts.append(x)
    full = np.concatenate(parts)
    sos = iir.design_butterworth(6, 0.15)
    out = tmp_path / "out.wav"
    written = serve.stream_sosfilt(paths, out, sos, chunk_samples=1 << 11)
    _, got = read_wav(out)
    assert written == full.size == got.size
    planar = full.reshape(-1, ch).T.astype(np.float32)
    ref = np.asarray(iir.sosfilt(sos, planar))
    ref_i = np.clip(np.rint(ref.T.reshape(-1)), -32768, 32767).astype(np.int16)
    diff = np.abs(got.astype(int) - ref_i.astype(int))
    # chunked float32 state hand-off: at most LSB-level rounding skew
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3


def test_stream_sosfilt_rejects_mixed_rate(tmp_path):
    from digital_signal_processsing_tpu.ops import iir

    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(a, np.zeros(100, np.int16), 8000, 1)
    write_wav(b, np.zeros(100, np.int16), 16000, 1)
    with pytest.raises(ValueError):
        serve.stream_sosfilt(
            [a, b], tmp_path / "o.wav", iir.design_butterworth(2, 0.3)
        )


def test_stream_time_stretch_scales_duration_keeps_pitch(tmp_path):
    from digital_signal_processsing_tpu.io.wav import read_wav as _read
    import scipy.signal as sps

    sr, ch = 16000, 2
    n = 40960
    t = np.arange(n)
    left = 0.5 * np.sin(2 * np.pi * 0.05 * t)
    right = 0.5 * np.sin(2 * np.pi * 0.11 * t)
    inter = np.stack([left, right], -1).reshape(-1)
    paths = []
    for i, sl in enumerate([slice(0, 2 * 24000), slice(2 * 24000, None)]):
        p = tmp_path / f"v{i}.wav"
        write_wav(p, (inter[sl] * 32767).astype(np.int16), sr, ch)
        paths.append(p)
    out = tmp_path / "stretched.wav"
    written = serve.stream_time_stretch(
        paths, out, 0.5, nfft=1024, chunk_samples=1 << 13
    )
    info, got = _read(out)
    assert info.num_channels == ch and written * ch == got.size
    planar = got.reshape(-1, ch).T.astype(np.float32) / 32768.0
    assert abs(planar.shape[-1] * 0.5 / n - 1.0) < 0.06  # ~2x duration
    for c, f0 in ((0, 0.05), (1, 0.11)):
        f, p = sps.welch(planar[c, 2048:-2048], nperseg=4096)
        assert abs(f[np.argmax(p)] - f0) < 2e-3


def test_stream_time_stretch_rejects_mixed_rate(tmp_path):
    a = tmp_path / "a.wav"
    b = tmp_path / "b.wav"
    write_wav(a, np.zeros(9000, np.int16), 16000, 1)
    write_wav(b, np.zeros(9000, np.int16), 8000, 1)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="sample rate"):
        serve.stream_time_stretch([a, b], tmp_path / "o.wav", 1.0)
