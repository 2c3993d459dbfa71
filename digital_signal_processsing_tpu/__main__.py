"""Command-line entry: filter a WAV with the moving averager.

The reference's binaries take ``<wav_path> <grade> <block_size>`` and write
benchmark CSV rows (e.g. profilable_sm_averager.cu:150-163). This CLI keeps
that contract, adds the method switch, and can actually write the filtered
audio out (the reference commented its writeSamples calls out "for
profiling", profilable_sm_vload4.cu:216-217 — a framework should do both).

    python -m digital_signal_processsing_tpu input.wav 16 --out smooth.wav
    python -m digital_signal_processsing_tpu input.wav 1024 --method xla_scan \
        --bench --csv results.csv
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="digital_signal_processsing_tpu", description=__doc__
    )
    p.add_argument("wav_path")
    p.add_argument("grade", type=int, help="moving-average window in frames")
    p.add_argument("--method", default="auto", help="averager method")
    p.add_argument("--out", default=None, help="write filtered WAV here")
    p.add_argument("--bench", action="store_true", help="print phase timings")
    p.add_argument("--csv", default=None, help="append a CSV row here")
    args = p.parse_args(argv)

    import numpy as np

    from .io import read_wav, write_wav
    from .ops import moving_average
    from .utils.cache import enable_persistent_cache

    enable_persistent_cache()
    info, samples = read_wav(args.wav_path)
    if args.bench or args.csv:
        import functools

        from .harness import CsvLogger, time_phases

        fn = functools.partial(
            moving_average,
            window=args.grade,
            channels=info.num_channels,
            method=args.method,
        )
        res = time_phases(fn, samples)
        print(f"--- {args.method} averager ---")
        print(f"total samples: {samples.size}")
        print(f"window: {args.grade}")
        res.print_stats(samples.size, 2)
        if args.csv:
            CsvLogger(args.csv).log(
                args.method, "staged", samples.size, args.grade, 0, res, 2
            )
        out = np.asarray(fn(samples))
    else:
        out = np.asarray(
            moving_average(
                samples, args.grade, info.num_channels, method=args.method
            )
        )

    if args.out:
        write_wav(args.out, out, info.sample_rate, info.num_channels)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
