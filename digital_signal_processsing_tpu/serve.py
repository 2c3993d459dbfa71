"""Serving: unbounded WAV streams through stateful chunk ops, end to end.

The production deployment loop the reference's one-WAV-per-binary design
implies but never builds: decode (native C++ fast path when built) ->
stateful chunked compute on the device -> streaming WAV sink, all with
bounded memory. JAX's async dispatch overlaps the host decode of chunk
i+1 with the device compute of chunk i for free — the host only blocks
when it fetches an already-finished result.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np

from .io.dataset import WavChunkLoader
from .io.wav import WavWriter, read_wav_info
from .utils.cache import enable_persistent_cache


def run_chunks(
    chunk_fn: Callable,
    state,
    chunks: Iterable[np.ndarray],
) -> Iterator[np.ndarray]:
    """Drive any (state, chunk) -> (state, out) op over a chunk iterator.

    Works with every streaming op in the framework (moving_average_chunk,
    fir_chunk, sosfilt_chunk, chain_stream_chunk, pfb_channelize_chunk...)
    — anything whose state is a pytree and whose chunk shapes are fixed.
    """
    for chunk in chunks:
        state, out = chunk_fn(state, chunk)
        yield np.asarray(out)


def stream_moving_average(
    paths,
    out_path: str | Path,
    window: int,
    *,
    chunk_samples: int = 1 << 20,
    use_native: bool | None = None,
) -> int:
    """Filter a list of WAVs as ONE stream into an output WAV, chunked.

    Bit-exact with the one-shot averager on the concatenated stream
    (ops/streaming.py carries the raw halo); memory stays bounded by the
    chunk size regardless of total input length. Returns samples written.

    ``use_native``: run the host side on the native C++ streaming executor
    (``io.native.NativeChunkStream`` decode ring + ``NativeWavSink`` encode
    thread — both off the GIL, so host IO genuinely overlaps device
    compute). ``None`` auto-selects it when the library is built; the
    output is byte-identical either way.
    """
    enable_persistent_cache()
    from .ops.streaming import moving_average_chunk, moving_average_init

    paths = list(paths)
    infos = [read_wav_info(p) for p in paths]
    channels = infos[0].num_channels
    rate = infos[0].sample_rate
    for p, i in zip(paths, infos):
        if i.num_channels != channels:
            raise ValueError(
                f"{p}: {i.num_channels} channels != first file's {channels}"
            )
        # checked here (not only in WavChunkLoader) so the native-executor
        # path rejects mixed-rate inputs identically to the Python path
        if i.sample_rate != rate:
            raise ValueError(
                f"{p}: sample rate {i.sample_rate} != first file's {rate}"
            )
    # actual decodable samples: the header's data size clamped to the BODY
    # actually present (a truncated file must not cause filtered padding to
    # be emitted as audio; a streaming-capture 0xFFFFFFFF size must not
    # inflate the count)
    total = sum(
        min(i.num_samples, max(Path(p).stat().st_size - 44, 0) // 2)
        for i, p in zip(infos, paths)
    )
    chunk_samples -= chunk_samples % max(channels, 1)

    if use_native is None:
        from .io import native as _native

        use_native = _native.available()
    state = moving_average_init(window, channels)
    written = 0
    if use_native:
        from .io.native import NativeChunkStream, NativeWavSink

        stream = NativeChunkStream(paths, chunk_samples)
        try:
            with NativeWavSink(out_path, rate, channels) as sink:
                for chunk, _valid in stream:
                    state, out = moving_average_chunk(
                        state, chunk, window, channels
                    )
                    out = np.asarray(out)
                    keep = min(out.size, total - written)
                    if keep <= 0:
                        break
                    sink.append(out[:keep])
                    written += keep
        finally:
            stream.close()
        return written

    loader = WavChunkLoader(paths, chunk_samples)
    with WavWriter(out_path, rate, channels) as sink:
        for chunk in loader:
            state, out = moving_average_chunk(state, chunk, window, channels)
            out = np.asarray(out)
            keep = min(out.size, total - written)  # drop loader tail padding
            if keep <= 0:
                break
            sink.append(out[:keep])
            written += keep
    return written




def stream_sosfilt(
    paths,
    out_path: str | Path,
    sos,
    *,
    chunk_samples: int = 1 << 20,
) -> int:
    """Run an SOS cascade over a list of WAVs as ONE stream, chunked.

    The IIR serving analog of :func:`stream_moving_average`: int16
    interleaved chunks are deinterleaved to planar float, pushed through
    the seeded device chunk kernel (``ops.iir.sosfilt_chunk`` — the
    Pallas block scan at production chunk sizes) with the per-section
    state carried across chunk AND file boundaries, then re-interleaved
    and clipped back to int16. Memory stays bounded by the chunk size;
    the result matches the one-shot ``sosfilt`` of the concatenated
    stream to float32 tolerance.
    """
    enable_persistent_cache()
    import jax.numpy as jnp

    from .ops import iir as _iir

    paths = list(paths)
    infos = [read_wav_info(p) for p in paths]
    channels = infos[0].num_channels
    rate = infos[0].sample_rate
    for p_, i in zip(paths, infos):
        if i.num_channels != channels:
            raise ValueError(
                f"{p_}: {i.num_channels} channels != first file's {channels}"
            )
        if i.sample_rate != rate:
            raise ValueError(
                f"{p_}: sample rate {i.sample_rate} != first file's {rate}"
            )
    total = sum(
        min(i.num_samples, max(Path(p_).stat().st_size - 44, 0) // 2)
        for i, p_ in zip(infos, paths)
    )
    chunk_samples -= chunk_samples % max(channels, 1)
    sos_rows = np.asarray(sos, np.float32).reshape(-1, 6)
    state = jnp.zeros((sos_rows.shape[0], channels, 2), jnp.float32)
    loader = WavChunkLoader(paths, chunk_samples)
    written = 0
    with WavWriter(out_path, rate, channels) as sink:
        for chunk in loader:
            planar = (
                np.asarray(chunk).reshape(-1, channels).T.astype(np.float32)
            )
            state, y = _iir.sosfilt_chunk(state, sos_rows, planar)
            out = np.asarray(y).T.reshape(-1)
            out = np.clip(np.rint(out), -32768, 32767).astype(np.int16)
            keep = min(out.size, total - written)
            if keep <= 0:
                break
            sink.append(out[:keep])
            written += keep
    return written


def stream_time_stretch(
    paths,
    out_path: str | Path,
    rate: float,
    *,
    nfft: int = 2048,
    chunk_samples: int = 1 << 20,
) -> int:
    """Phase-vocoder time stretch over a list of WAVs as ONE stream.

    The audio-family serving loop: int16 interleaved chunks are
    deinterleaved to planar float, buffered to analysis-hop multiples,
    pushed through ``ops.phase_vocoder.time_stretch_chunk`` (carried STFT
    tail + phase chain + WOLA tail across chunk AND file boundaries),
    re-interleaved and written as int16. Output duration ~= input / rate;
    memory stays bounded by the chunk size. Returns samples written per
    channel (any sub-hop remainder at stream end is zero-padded into the
    final hop, matching a zero-padded one-shot call).
    """
    enable_persistent_cache()
    from .ops import phase_vocoder as _pv

    paths = list(paths)
    infos = [read_wav_info(p) for p in paths]
    channels = infos[0].num_channels
    srate = infos[0].sample_rate
    for p_, i in zip(paths, infos):
        if i.num_channels != channels:
            raise ValueError(
                f"{p_}: {i.num_channels} channels != first file's {channels}"
            )
        if i.sample_rate != srate:
            raise ValueError(
                f"{p_}: sample rate {i.sample_rate} != first file's {srate}"
            )
    ha = max(1, int(round(nfft // 4 * rate)))
    chunk_samples -= chunk_samples % max(channels, 1)
    state = _pv.time_stretch_init(rate, nfft=nfft, channels=channels)
    buf = np.zeros((channels, 0), np.float32)
    written = 0

    def emit(sink, y):
        nonlocal written
        out = np.asarray(y).T.reshape(-1)
        out = np.clip(np.rint(out * 32768.0), -32768, 32767).astype(np.int16)
        sink.append(out)
        written += out.size // channels

    loader = WavChunkLoader(paths, chunk_samples)
    with WavWriter(out_path, srate, channels) as sink:
        for chunk in loader:
            planar = (
                np.asarray(chunk).reshape(-1, channels).T.astype(np.float32)
                / 32768.0
            )
            buf = np.concatenate([buf, planar], axis=-1)
            use = buf.shape[-1] // ha * ha
            if use:
                state, y = _pv.time_stretch_chunk(
                    state, buf[:, :use], rate=rate, nfft=nfft
                )
                buf = buf[:, use:]
                emit(sink, y)
        if buf.shape[-1]:
            pad = np.zeros((channels, ha - buf.shape[-1]), np.float32)
            state, y = _pv.time_stretch_chunk(
                state, np.concatenate([buf, pad], axis=-1), rate=rate, nfft=nfft
            )
            emit(sink, y)
        emit(sink, _pv.time_stretch_flush(state))
    return written


def stream_mfcc(
    paths,
    out_path: str | Path | None = None,
    *,
    n_mfcc: int = 13,
    nfft: int = 512,
    hop: int = 256,
    n_mels: int = 40,
    window: str = "hann",
    lifter: float = 0.0,
    chunk_samples: int = 1 << 20,
) -> np.ndarray:
    """MFCC features over a list of WAVs as ONE stream, chunked.

    The feature-extraction serving loop (ASR/audio-ML front end): int16
    interleaved chunks are deinterleaved to planar float, buffered to hop
    multiples and pushed through ``ops.mel.mfcc_chunk`` (streaming-STFT
    tail carried across chunk AND file boundaries). Audio memory stays
    bounded by the chunk size; the returned features — (channels, frames,
    n_mfcc), ~n_mfcc/(2*hop) the size of the int16 audio — are accumulated
    and, with ``out_path``, also saved as .npy. Output equals the one-shot
    ``ops.mel.mfcc`` of the zero-primed concatenated stream (any sub-hop
    stream tail is zero-padded into the final hop).
    """
    enable_persistent_cache()
    from .ops import mel as _mel

    paths = list(paths)
    infos = [read_wav_info(p) for p in paths]
    channels = infos[0].num_channels
    rate = infos[0].sample_rate
    for p_, i in zip(paths, infos):
        if i.num_channels != channels:
            raise ValueError(
                f"{p_}: {i.num_channels} channels != first file's {channels}"
            )
        if i.sample_rate != rate:
            raise ValueError(
                f"{p_}: sample rate {i.sample_rate} != first file's {rate}"
            )
    chunk_samples -= chunk_samples % max(channels, 1)
    # The loader zero-pads its final chunk; trim to the true stream length
    # so padding never masquerades as audio (cf. stream_moving_average).
    remaining = sum(
        min(i.num_samples, max(Path(p_).stat().st_size - 44, 0) // 2)
        for i, p_ in zip(infos, paths)
    ) // channels
    state = _mel.mfcc_init(nfft, hop, channels)
    buf = np.zeros((channels, 0), np.float32)
    feats: list[np.ndarray] = []

    def push(block: np.ndarray) -> None:
        nonlocal state
        state, c = _mel.mfcc_chunk(
            state,
            block,
            sample_rate=float(rate),
            n_mfcc=n_mfcc,
            nfft=nfft,
            hop=hop,
            window=window,
            n_mels=n_mels,
            lifter=lifter,
        )
        feats.append(np.asarray(c))

    for chunk in WavChunkLoader(paths, chunk_samples):
        planar = (
            np.asarray(chunk).reshape(-1, channels).T.astype(np.float32)
            / 32768.0
        )
        planar = planar[:, : max(0, remaining)]
        remaining -= planar.shape[-1]
        buf = np.concatenate([buf, planar], axis=-1)
        use = buf.shape[-1] // hop * hop
        if use:
            push(buf[:, :use])
            buf = buf[:, use:]
    if buf.shape[-1]:
        pad = np.zeros((channels, hop - buf.shape[-1]), np.float32)
        push(np.concatenate([buf, pad], axis=-1))
    out = (
        np.concatenate(feats, axis=1)
        if feats
        else np.zeros((channels, 0, n_mfcc), np.float32)
    )
    if out_path is not None:
        np.save(out_path, out)
    return out


__all__ = [
    "run_chunks",
    "stream_moving_average",
    "stream_sosfilt",
    "stream_time_stretch",
    "stream_mfcc",
]
