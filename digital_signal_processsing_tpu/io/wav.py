"""Canonical 44-byte PCM WAV codec (reference analog: wav_header.h:9-84).

Reads/writes the fixed canonical RIFF/WAVE layout the reference assumes:
"RIFF" + size, "WAVE", a 16-byte "fmt " chunk, then a "data" chunk. Like the
reference (wav_header.h:34-37, :70-73) we support 16-bit PCM only and reject
8/24/32/64-bit files with a clear error (the reference prints and returns an
empty result; we raise, which is the failure mode a framework wants).

Samples are returned as a flat interleaved int16 NumPy array. A widened
reader (int64) mirrors ``extractSamples64`` (wav_header.h:62-84), which the
reference's scan variants used to avoid cumsum overflow — our scan path
doesn't need the widening (int32 modular scan, utils/numerics.py) but the
API parity is kept for users of the reference.

A native C++ fast path lives in io/native.py (built from native/); this
module is the always-available pure-NumPy implementation.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

_HEADER_FMT = "<4sI4s4sIHHIIHH4sI"  # 44 bytes, packed (wav_header.h:8-24)
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert _HEADER_SIZE == 44

@dataclasses.dataclass(frozen=True)
class WavInfo:
    """Parsed header fields (WAVHeader analog, wav_header.h:9-23)."""

    num_channels: int
    sample_rate: int
    bits_per_sample: int
    num_samples: int  # total interleaved samples (frames * channels)

    @property
    def num_frames(self) -> int:
        return self.num_samples // self.num_channels

    @property
    def byte_rate(self) -> int:
        return self.sample_rate * self.num_channels * self.bits_per_sample // 8

    @property
    def block_align(self) -> int:
        return self.num_channels * self.bits_per_sample // 8


def _parse_header(raw: bytes, path: Path) -> WavInfo:
    if len(raw) < _HEADER_SIZE:
        raise ValueError(f"{path}: file shorter than a 44-byte WAV header")
    (
        riff,
        _size_of_file,
        wave,
        fmt,
        _fmt_size,
        audio_format,
        num_channels,
        sample_rate,
        _byte_rate,
        _block_align,
        bits_per_sample,
        data,
        data_bytes,
    ) = struct.unpack_from(_HEADER_FMT, raw)
    if riff != b"RIFF" or wave != b"WAVE" or fmt != b"fmt " or data != b"data":
        raise ValueError(f"{path}: not a canonical 44-byte PCM WAV file")
    if audio_format != 1:
        raise ValueError(f"{path}: only PCM (format 1) supported, got {audio_format}")
    if bits_per_sample != 16:  # rejects 8/24/32/64 like wav_header.h:34-37
        raise ValueError(
            f"{path}: unsupported bits per sample: {bits_per_sample} (16-bit only)"
        )
    if num_channels < 1:
        raise ValueError(f"{path}: invalid channel count {num_channels}")
    bytes_per_sample = bits_per_sample // 8
    return WavInfo(
        num_channels=num_channels,
        sample_rate=sample_rate,
        bits_per_sample=bits_per_sample,
        num_samples=data_bytes // bytes_per_sample,
    )


def read_wav_info(path: str | Path) -> WavInfo:
    """Parse only the 44-byte header (no body decode)."""
    path = Path(path)
    with open(path, "rb") as f:
        raw = f.read(_HEADER_SIZE)
    return _parse_header(raw, path)


def read_wav(path: str | Path) -> tuple[WavInfo, np.ndarray]:
    """Read a 16-bit PCM WAV: (info, flat interleaved int16 samples).

    extractSamples analog (wav_header.h:26-48).
    """
    path = Path(path)
    raw = path.read_bytes()
    info = _parse_header(raw, path)
    body = raw[_HEADER_SIZE:]
    n = min(info.num_samples, len(body) // 2)
    # astype() copies: the result must be WRITEABLE like the native fast
    # path's buffer (frombuffer alone is a read-only view of `raw`)
    samples = np.frombuffer(body, dtype="<i2", count=n).astype(np.int16)
    if n != info.num_samples:
        info = dataclasses.replace(info, num_samples=n)
    return info, samples


def read_wav_widened(path: str | Path) -> tuple[WavInfo, np.ndarray]:
    """Read with int64 widening (extractSamples64 analog, wav_header.h:62-84)."""
    info, samples = read_wav(path)
    return info, samples.astype(np.int64)


def _as_int16_samples(samples: np.ndarray) -> np.ndarray:
    """int16 view with an explicit guard: float input silently truncates
    toward zero and wraps out of range under an unsafe cast — require the
    caller to quantize deliberately (e.g. np.clip(x*32767, -32768, 32767))."""
    arr = np.asarray(samples)
    if np.issubdtype(arr.dtype, np.floating):
        raise TypeError(
            "WAV sinks take int16 samples; quantize float audio explicitly, "
            "e.g. np.clip(x * 32767, -32768, 32767).astype(np.int16)"
        )
    return np.ascontiguousarray(arr, dtype="<i2")


def write_wav(
    path: str | Path,
    samples: np.ndarray,
    sample_rate: int,
    num_channels: int,
) -> None:
    """Write a canonical 16-bit PCM WAV (writeSamples analog, wav_header.h:50-59)."""
    samples = _as_int16_samples(samples)
    if samples.ndim != 1:
        samples = samples.reshape(-1)
    if num_channels < 1:
        raise ValueError(f"num_channels must be >= 1, got {num_channels}")
    if samples.size % num_channels != 0:
        raise ValueError(
            f"{samples.size} samples not a multiple of {num_channels} channels"
        )
    data_bytes = samples.size * 2
    bits = 16
    header = struct.pack(
        _HEADER_FMT,
        b"RIFF",
        36 + data_bytes,
        b"WAVE",
        b"fmt ",
        16,
        1,
        num_channels,
        sample_rate,
        sample_rate * num_channels * bits // 8,
        num_channels * bits // 8,
        bits,
        b"data",
        data_bytes,
    )
    Path(path).write_bytes(header + samples.tobytes())


class WavWriter:
    """Streaming 16-bit PCM WAV writer: header now, frames as they come.

    The serving path's sink — bounded memory for unbounded streams. The
    RIFF/data sizes are patched on close() (or use as a context manager),
    so a crash mid-stream leaves a recognizably-truncated file rather than
    a silently wrong one.
    """

    def __init__(self, path: str | Path, sample_rate: int, num_channels: int):
        if num_channels < 1:
            raise ValueError(f"channels must be >= 1, got {num_channels}")
        self.path = Path(path)
        self.num_channels = num_channels
        self.sample_rate = sample_rate
        self._samples = 0
        self._f = open(self.path, "wb")
        self._f.write(self._header(0))

    def _header(self, data_bytes: int) -> bytes:
        bits = 16
        return struct.pack(
            _HEADER_FMT,
            b"RIFF",
            36 + data_bytes,
            b"WAVE",
            b"fmt ",
            16,
            1,
            self.num_channels,
            self.sample_rate,
            self.sample_rate * self.num_channels * bits // 8,
            self.num_channels * bits // 8,
            bits,
            b"data",
            data_bytes,
        )

    def append(self, samples: np.ndarray) -> None:
        s = _as_int16_samples(samples)
        if s.ndim != 1 or s.size % self.num_channels != 0:
            raise ValueError(
                f"append expects flat whole frames of {self.num_channels} "
                f"channels, got shape {s.shape}"
            )
        self._f.write(s.tobytes())
        self._samples += s.size

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.seek(0)
        self._f.write(self._header(self._samples * 2))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
