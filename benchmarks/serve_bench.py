"""Serving-path throughput row: streaming WAV->WAV vs one-shot.

Measures what serve.py claims: bounded-memory chunked streaming overlapping
host decode with device compute, at a throughput comparable to the one-shot
path (which must hold the whole stream in RAM). Wall-clock end-to-end
including file IO on both sides; serving is a wall-clock story.

Usage: python benchmarks/serve_bench.py [--total 64000000] [--chunk 4194304]
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WINDOW = 1024
CHANNELS = 2


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--total", type=int, default=64_000_000)
    ap.add_argument("--chunk", type=int, default=4_194_304)
    ap.add_argument("--files", type=int, default=4)
    args = ap.parse_args()

    from digital_signal_processsing_tpu.io.wav import read_wav, write_wav
    from digital_signal_processsing_tpu.ops.moving_average import moving_average
    from digital_signal_processsing_tpu.serve import stream_moving_average

    rng = np.random.default_rng(0)
    tmp = Path(tempfile.mkdtemp(prefix="serve_bench_"))
    per_file = args.total // args.files
    per_file -= per_file % CHANNELS
    paths = []
    for i in range(args.files):
        x = rng.integers(-32768, 32768, size=per_file, dtype=np.int16)
        p = tmp / f"in_{i}.wav"
        write_wav(p, x, 48000, CHANNELS)
        paths.append(p)
    total = per_file * args.files

    # warm the chunk op (compile outside the timed run, like a real server)
    warm = stream_moving_average(
        paths[:1], tmp / "warm.wav", WINDOW, chunk_samples=args.chunk
    )
    assert warm == per_file

    from digital_signal_processsing_tpu.io import native as _native

    modes = [("python_host", False)]
    if _native.available():
        modes.insert(0, ("native_host", True))
    for label, un in modes:
        t0 = time.perf_counter()
        written = stream_moving_average(
            paths, tmp / "out.wav", WINDOW, chunk_samples=args.chunk,
            use_native=un,
        )
        stream_s = time.perf_counter() - t0
        assert written == total
        peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        print(
            json.dumps(
                {
                    "metric": f"serve_stream_wav_to_wav_{label}",
                    "value": round(total / stream_s / 1e6, 1),
                    "unit": "MS/s",
                    "seconds": round(stream_s, 2),
                    "chunk": args.chunk,
                    "peak_rss_mb": round(peak_mb, 1),
                }
            ),
            flush=True,
        )

    # one-shot comparison: read everything, one device call, write
    import jax

    t0 = time.perf_counter()
    datas = [read_wav(p)[1] for p in paths]
    x_all = np.concatenate(datas)
    y = np.asarray(moving_average(jax.device_put(x_all), WINDOW, CHANNELS))
    write_wav(tmp / "oneshot.wav", y, 48000, CHANNELS)
    oneshot_s = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "metric": "serve_oneshot_wav_to_wav",
                "value": round(total / oneshot_s / 1e6, 1),
                "unit": "MS/s",
                "seconds": round(oneshot_s, 2),
            }
        ),
        flush=True,
    )

    # equality of outputs (streaming is bit-exact with one-shot)
    got = read_wav(tmp / "out.wav")[1]
    want = read_wav(tmp / "oneshot.wav")[1]
    ok = bool(np.array_equal(got, want))
    print(json.dumps({"metric": "serve_stream_bit_exact", "value": ok, "unit": "bool"}))
    for p in tmp.iterdir():
        p.unlink()
    tmp.rmdir()


if __name__ == "__main__":
    main()
