"""Benchmark sweep driver (reference analog: basics/run_benchmarks.py).

Runs the (variant x input-size x grade) grid over synthetic WAVs and
appends the reference's 14-column CSV rows. Differences by design:

- in-process instead of one subprocess per config (run_benchmarks.py:86-91
  isolated C++ heaps; JAX caches compilations, so isolation would throw away
  exactly the warm state a serving deployment has). ``--subprocess`` restores
  the reference's isolation mode for cold-start studies.
- the reference's grade >= N skip rule (run_benchmarks.py:78-79) is kept.
- the sweep is resumable: append-mode CSV (gpu_utils.h:188).

Usage:
    python -m digital_signal_processsing_tpu.harness.sweep --smoke
    python -m digital_signal_processsing_tpu.harness.sweep \
        --sizes 100000 1000000 --grades 1 16 1024 --out results.csv
"""

from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path

import numpy as np

# Reference grids (run_benchmarks.py:8-26). Its BLOCK_SIZES axis has no
# counterpart: no method here takes a block size.
DEFAULT_GRADES = (
    list(range(1, 11)) + list(range(11, 50, 5)) + list(range(50, 1001, 50))
)
DEFAULT_SIZES = [int(n) for n in np.geomspace(5_000, 50_000_000, 100)]
# Zoo keys (models/averager_zoo.py): each reference rung, run through the
# moving_average method that stands for it.
VARIANTS = (
    "golden_cpu",  # serial CPU golden model (SingleThreadCpu analog)
    "xla_direct",  # naive parallel analog
    "scan",  # the scan family: method='auto'
    "xla_scan",  # cumsum anchor
)


def generate_wav(path: Path, num_samples: int, channels: int = 2, seed: int = 0):
    """Synthetic random stereo WAV (run_benchmarks.py:31-49 analog).

    NOTE: unlike the reference (which silently halved the requested count,
    run_benchmarks.py:37), num_samples here is the total interleaved count.
    """
    from ..io import write_wav

    rng = np.random.default_rng(seed)
    frames = num_samples // channels
    data = rng.integers(-32768, 32768, size=frames * channels, dtype=np.int16)
    write_wav(path, data, 44100, channels)
    return data


def run_config(
    samples: np.ndarray,
    variant: str,
    grade: int,
    channels: int,
    logger,
    warmup: int,
    rounds: int,
) -> None:
    from ..models.averager_zoo import AVERAGER_ZOO
    from ..ops import moving_average
    from .profile import ProfileResult, benchmark, time_phases

    n = samples.size
    if variant == "golden_cpu":
        from ..golden import moving_average_golden

        ms = benchmark(
            lambda: moving_average_golden(samples, grade, channels),
            warmup=warmup,
            rounds=rounds,
        )
        res = ProfileResult(compute_ms=ms, rounds=1)
        logger.log("golden_cpu", "RAM", n, grade, 0, res, 2)
        return

    fn = functools.partial(
        moving_average,
        window=grade,
        channels=channels,
        method=AVERAGER_ZOO[variant].method,
    )
    # the reference benchmarks both memory modes back-to-back
    # (e.g. profilable_sm_averager.cu:76-129): staged then resident
    res = time_phases(fn, samples, warmup=warmup, rounds=rounds)
    logger.log(variant, "staged", n, grade, 0, res, 2)
    res_r = time_phases(fn, samples, warmup=warmup, rounds=rounds, resident=True)
    logger.log(variant, "resident", n, grade, 0, res_r, 2)


def run_suite(
    sizes,
    grades,
    variants,
    out_csv: str,
    channels: int = 2,
    warmup: int = 2,
    rounds: int = 5,
    max_direct: int = 64,
    verbose: bool = True,
) -> int:
    from .csvlog import CsvLogger

    logger = CsvLogger(out_csv)
    failures = 0
    runs = 0
    for n in sizes:
        rng_seed = n % (2**31)
        frames = n // channels
        # in-memory synthesis: run_config consumes the array directly (the
        # reference wrote a temp WAV only because its binaries read files)
        rng = np.random.default_rng(rng_seed)
        samples = rng.integers(
            -32768, 32768, size=frames * channels, dtype=np.int16
        )
        for grade in grades:
            if grade >= frames:  # run_benchmarks.py:78-79 skip rule
                continue
            for variant in variants:
                if variant == "xla_direct" and grade > max_direct:
                    # both O(N*k) naive analogs: unrunnable at 64M x k=1024
                    continue
                if variant == "golden_cpu" and n > 100_000_000:
                    continue  # bound the vectorized-host column's cost
                runs += 1
                try:
                    run_config(
                        samples, variant, grade, channels, logger, warmup, rounds
                    )
                    if verbose:
                        print(
                            f"ok   {variant:12s} N={n:>10d} k={grade:<5d}",
                            flush=True,
                        )
                except Exception as e:  # crash-count, keep sweeping
                    failures += 1
                    print(
                        f"FAIL {variant:12s} N={n:>10d} k={grade:<5d}: {e}",
                        file=sys.stderr,
                        flush=True,
                    )
    if verbose:
        print(f"sweep done: {runs} configs, {failures} failures -> {out_csv}")
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", type=int, nargs="*", default=None)
    p.add_argument("--grades", type=int, nargs="*", default=None)
    p.add_argument("--variants", nargs="*", default=list(VARIANTS))
    p.add_argument("--channels", type=int, default=2)
    p.add_argument("--out", default="benchmark_results.csv")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument(
        "--smoke", action="store_true", help="tiny grid for CI / quick checks"
    )
    p.add_argument(
        "--subprocess",
        action="store_true",
        help="one python process per (size, grade) config — the reference's "
        "isolation mode (run_benchmarks.py:86-91) for cold-start studies",
    )
    args = p.parse_args(argv)

    if args.smoke:
        sizes = [100_000]
        grades = [1, 16, 128]
        variants = [v for v in args.variants if v != "golden_cpu"] + ["golden_cpu"]
    else:
        sizes = args.sizes or DEFAULT_SIZES
        grades = args.grades or DEFAULT_GRADES
        variants = args.variants

    if args.subprocess:
        # one interpreter per (size, grade): cold compile + cold allocator
        # every config (the reference's isolation, run_benchmarks.py:86-91)
        import subprocess

        failures = 0
        for n in sizes:
            for g in grades:
                cmd = [
                    sys.executable, "-m",
                    "digital_signal_processsing_tpu.harness.sweep",
                    "--sizes", str(n), "--grades", str(g),
                    "--variants", *variants,
                    "--channels", str(args.channels),
                    "--out", args.out,
                    "--warmup", str(args.warmup),
                    "--rounds", str(args.rounds),
                ]
                failures += subprocess.run(cmd).returncode != 0
        print(f"subprocess sweep done: {failures} failed configs")
        return failures

    from ..utils.cache import enable_persistent_cache

    enable_persistent_cache()
    return run_suite(
        sizes,
        grades,
        variants,
        args.out,
        channels=args.channels,
        warmup=args.warmup,
        rounds=args.rounds,
    )


if __name__ == "__main__":
    sys.exit(main())
