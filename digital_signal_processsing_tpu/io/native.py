"""ctypes bindings to the native host runtime (native/dsp_native.cpp).

Provides the fast WAV codec and the C++ serial averager baseline (the
reference's profilable_moving_averager.cpp equivalent) for honest CPU-vs-device
benchmark rows. Auto-builds with make on first use if a toolchain is
present; every entry point has the pure-NumPy fallback in io/wav.py and
golden/reference.py, so the framework works without a compiler.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libdsp_native.so"
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> bool:
    try:
        r = subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            capture_output=True,
            text=True,
            timeout=120,
        )
        return r.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def load(auto_build: bool = True):
    """Load (building if needed) the native library; raises NativeUnavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and (not auto_build or not _build()):
        raise NativeUnavailable(f"{_LIB_PATH} missing and build failed")
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.dsp_wav_info.restype = ctypes.c_int
    lib.dsp_wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dsp_wav_read.restype = ctypes.c_int64
    lib.dsp_wav_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
    ]
    lib.dsp_wav_write.restype = ctypes.c_int
    lib.dsp_wav_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.dsp_wav_read_many.restype = ctypes.c_int
    lib.dsp_wav_read_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.dsp_moving_average.restype = None
    lib.dsp_moving_average.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.dsp_bench_moving_average.restype = ctypes.c_double
    lib.dsp_bench_moving_average.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.dsp_stream_open.restype = ctypes.c_void_p
    lib.dsp_stream_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.dsp_stream_next.restype = ctypes.c_int64
    lib.dsp_stream_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int16),
    ]
    lib.dsp_stream_close.restype = None
    lib.dsp_stream_close.argtypes = [ctypes.c_void_p]
    lib.dsp_sink_open.restype = ctypes.c_void_p
    lib.dsp_sink_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.dsp_sink_append.restype = ctypes.c_int
    lib.dsp_sink_append.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
    ]
    lib.dsp_sink_close.restype = ctypes.c_int64
    lib.dsp_sink_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _i16ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def wav_info_native(path) -> tuple[int, int, int]:
    """(channels, sample_rate, num_samples) from the header only (no body)."""
    lib = load()
    ch = ctypes.c_int32()
    rate = ctypes.c_int32()
    n = ctypes.c_int64()
    rc = lib.dsp_wav_info(str(path).encode(), ch, rate, n)
    if rc != 0:
        raise ValueError(f"{path}: native WAV parse failed (rc={rc})")
    return ch.value, rate.value, n.value


def read_wav_native(path) -> tuple[int, int, np.ndarray]:
    """(channels, sample_rate, samples) via the C++ codec."""
    lib = load()
    ch = ctypes.c_int32()
    rate = ctypes.c_int32()
    n = ctypes.c_int64()
    rc = lib.dsp_wav_info(str(path).encode(), ch, rate, n)
    if rc != 0:
        raise ValueError(f"{path}: native WAV parse failed (rc={rc})")
    out = np.empty(n.value, dtype=np.int16)
    got = lib.dsp_wav_read(str(path).encode(), _i16ptr(out), n.value)
    if got < 0:
        raise ValueError(f"{path}: native WAV read failed (rc={got})")
    return ch.value, rate.value, out[: int(got)]


def write_wav_native(path, samples: np.ndarray, sample_rate: int, channels: int):
    lib = load()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    rc = lib.dsp_wav_write(
        str(path).encode(), _i16ptr(samples), samples.size, sample_rate, channels
    )
    if rc != 0:
        raise ValueError(f"{path}: native WAV write failed (rc={rc})")


def read_wavs_concat_native(
    paths, num_threads: int = 8
) -> tuple[int, int, np.ndarray]:
    """Decode many WAVs concurrently into one concatenated stream.

    Returns (channels, sample_rate, samples) of the whole stream; all files
    must share the channel count and rate of the first.
    """
    lib = load()
    paths = [str(p) for p in paths]
    infos = []
    for p in paths:
        ch = ctypes.c_int32()
        rate = ctypes.c_int32()
        n = ctypes.c_int64()
        rc = lib.dsp_wav_info(p.encode(), ch, rate, n)
        if rc != 0:
            raise ValueError(f"{p}: native WAV parse failed (rc={rc})")
        infos.append((ch.value, rate.value, n.value))
    ch0, rate0 = infos[0][0], infos[0][1]
    for p, (ch, rate, _) in zip(paths, infos):
        if ch != ch0 or rate != rate0:
            raise ValueError(f"{p}: ({ch} ch, {rate} Hz) != first ({ch0}, {rate0})")
    counts = np.array([i[2] for i in infos], np.int64)
    offsets = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=offsets[1:])
    out = np.empty(int(counts.sum()), np.int16)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    ok = lib.dsp_wav_read_many(
        c_paths,
        len(paths),
        _i16ptr(out),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        num_threads,
    )
    if ok != len(paths):
        raise ValueError(f"only {ok}/{len(paths)} files decoded cleanly")
    return ch0, rate0, out


def _validate_avg_args(n: int, window: int, channels: int) -> None:
    """Raise like the golden model — never feed C++ a divide-by-zero."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    if n % channels != 0:
        raise ValueError(f"stream length {n} not a multiple of channels {channels}")


def moving_average_native(
    samples: np.ndarray, window: int, channels: int = 1
) -> np.ndarray:
    """C++ serial sliding-sum averager (golden-equivalent, native speed)."""
    lib = load()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    _validate_avg_args(samples.size, window, channels)
    out = np.empty_like(samples)
    lib.dsp_moving_average(
        _i16ptr(samples), _i16ptr(out), samples.size, channels, window
    )
    return out


def bench_moving_average_native(
    samples: np.ndarray,
    window: int,
    channels: int = 1,
    warmup: int = 5,
    rounds: int = 10,
) -> float:
    """Mean milliseconds per round of the native averager (CPU baseline row)."""
    lib = load()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    _validate_avg_args(samples.size, window, channels)
    out = np.empty_like(samples)
    return float(
        lib.dsp_bench_moving_average(
            _i16ptr(samples), _i16ptr(out), samples.size, channels, window,
            warmup, rounds,
        )
    )


class NativeChunkStream:
    """Iterator over fixed-size chunks of WAVs-as-one-stream, decoded by a
    native background thread (the C++ WavChunkLoader+prefetch: host decode
    runs off the GIL while the consumer drives the device).

    Yields (chunk, valid_count): chunk is always ``chunk_samples`` int16
    (final partial zero-padded); ``valid_count`` tells how many are real.
    """

    def __init__(self, paths, chunk_samples: int, *, depth: int = 4):
        lib = load()
        self.paths = [str(p) for p in paths]
        if not self.paths:
            raise ValueError("no input files")
        if chunk_samples < 1:
            raise ValueError(f"chunk_samples must be >= 1, got {chunk_samples}")
        self.chunk_samples = int(chunk_samples)
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        self._handle = lib.dsp_stream_open(
            arr, len(self.paths), self.chunk_samples, depth
        )
        if not self._handle:
            raise NativeUnavailable("dsp_stream_open failed")
        self._lib = lib

    def __iter__(self):
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        out = np.empty(self.chunk_samples, np.int16)
        got = self._lib.dsp_stream_next(self._handle, _i16ptr(out))
        if got < 0:
            self.close()
            raise IOError(f"native stream decode error ({got})")
        if got == 0:
            self.close()
            raise StopIteration
        return out, int(got)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dsp_stream_close(self._handle)
            self._handle = None

    def __del__(self):  # noqa: D105 — release the worker thread
        try:
            self.close()
        except Exception:
            pass


class NativeWavSink:
    """Streaming WAV writer with a native background encode thread.

    Drop-in for io.wav.WavWriter where throughput matters: append() copies
    into a bounded queue and returns; fwrite happens off the GIL. Header
    sizes patched on close() (context-manager friendly).
    """

    def __init__(self, path, sample_rate: int, num_channels: int, *, depth: int = 4):
        lib = load()
        if num_channels < 1:
            raise ValueError(f"channels must be >= 1, got {num_channels}")
        self.num_channels = num_channels
        self._handle = lib.dsp_sink_open(
            str(path).encode(), sample_rate, num_channels, depth
        )
        if not self._handle:
            raise NativeUnavailable(f"dsp_sink_open failed for {path}")
        self._lib = lib

    def append(self, samples: np.ndarray) -> None:
        s = np.ascontiguousarray(samples, dtype=np.int16).reshape(-1)
        if s.size % self.num_channels != 0:
            raise ValueError(
                f"append expects whole frames of {self.num_channels} channels"
            )
        rc = self._lib.dsp_sink_append(self._handle, _i16ptr(s), s.size)
        if rc != 0:
            raise IOError(f"native sink append failed ({rc})")

    def close(self) -> int:
        if self._handle is None:
            return 0
        total = int(self._lib.dsp_sink_close(self._handle))
        self._handle = None
        if total < 0:
            raise IOError("native sink write error")
        return total

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
