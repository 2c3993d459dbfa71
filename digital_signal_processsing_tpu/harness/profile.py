"""Phase-split profiling harness (reference analog: benchmark.h:9-132).

The reference times four phases with cudaEvents — init (allocation), H2D,
kernel, D2H — averaged over warmup+measure rounds (5+10,
gpu_utils.h:31-32). The JAX equivalents:

    init    = first-call compile + first device_put (cold start)
    h2d     = jax.device_put of host NumPy input (host staging)
    compute = jitted function + block_until_ready
    d2h     = np.asarray(device output) (fetch)

Derived metrics keep the reference's columns (benchmark.h:56-67): kernel-only
and end-to-end GB/s and MSamples/s, steady-state and cold-start.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import numpy as np

WARMUP_ROUNDS = 5  # gpu_utils.h:31
MEASUREMENT_ROUNDS = 10  # gpu_utils.h:32


@dataclasses.dataclass
class ProfileResult:
    """Accumulated phase timings in milliseconds (benchmark.h:9-31 analog)."""

    initialization_ms: float = 0.0
    h2d_ms: float = 0.0
    compute_ms: float = 0.0
    d2h_ms: float = 0.0
    rounds: int = 0

    @property
    def total_ms(self) -> float:
        return self.h2d_ms + self.compute_ms + self.d2h_ms

    @property
    def cold_total_ms(self) -> float:
        return self.initialization_ms + self.total_ms

    def accumulate(self, h2d: float, compute: float, d2h: float) -> None:
        self.h2d_ms += h2d
        self.compute_ms += compute
        self.d2h_ms += d2h
        self.rounds += 1

    def averaged(self) -> "ProfileResult":
        n = max(self.rounds, 1)
        return ProfileResult(
            initialization_ms=self.initialization_ms,
            h2d_ms=self.h2d_ms / n,
            compute_ms=self.compute_ms / n,
            d2h_ms=self.d2h_ms / n,
            rounds=1,
        )

    # --- derived metrics (benchmark.h:56-67 analog) ---
    def bandwidth_gbs(self, num_samples: int, bytes_per_sample: int) -> float:
        """App-level GB/s: input+output traffic over total time."""
        if self.total_ms <= 0:
            return 0.0
        return num_samples * 2 * bytes_per_sample / (self.total_ms * 1e-3) / 1e9

    def throughput_msps(self, num_samples: int) -> float:
        if self.total_ms <= 0:
            return 0.0
        return num_samples / (self.total_ms * 1e-3) / 1e6

    def compute_throughput_msps(self, num_samples: int) -> float:
        if self.compute_ms <= 0:
            return 0.0
        return num_samples / (self.compute_ms * 1e-3) / 1e6

    def cold_throughput_msps(self, num_samples: int) -> float:
        if self.cold_total_ms <= 0:
            return 0.0
        return num_samples / (self.cold_total_ms * 1e-3) / 1e6

    def print_stats(self, num_samples: int, bytes_per_sample: int) -> None:
        r = self.averaged()
        print(
            f"  init (cold) : {r.initialization_ms:10.3f} ms\n"
            f"  host->device: {r.h2d_ms:10.3f} ms\n"
            f"  compute     : {r.compute_ms:10.3f} ms\n"
            f"  device->host: {r.d2h_ms:10.3f} ms\n"
            f"  total       : {r.total_ms:10.3f} ms\n"
            f"  bandwidth   : {r.bandwidth_gbs(num_samples, bytes_per_sample):10.3f} GB/s\n"
            f"  throughput  : {r.throughput_msps(num_samples):10.3f} MS/s "
            f"(kernel {r.compute_throughput_msps(num_samples):.3f}, "
            f"cold {r.cold_throughput_msps(num_samples):.3f})"
        )


def time_phases(
    fn: Callable[[jax.Array], jax.Array],
    host_input: np.ndarray,
    *,
    warmup: int = WARMUP_ROUNDS,
    rounds: int = MEASUREMENT_ROUNDS,
    sharding=None,
    resident: bool = False,
) -> ProfileResult:
    """Warmup-then-average phase-split benchmark (benchmark.h:116-132 analog).

    Measures init (first h2d + first compiled call) once, then per round:
    h2d staging, compute (block_until_ready), d2h fetch.

    ``resident`` is the analog of the reference's Standard/Unified memory
    A-B (gpu_utils.h:26-65): ``False`` stages the host buffer every round
    (Standard/cudaMemcpy analog); ``True`` keeps the input resident on
    device and re-times only compute+fetch (the serving steady state the
    Unified zero-copy mode approximated).
    """
    res = ProfileResult()

    def put(arr):
        if sharding is not None:
            return jax.device_put(arr, sharding)
        return jax.device_put(arr)

    t0 = time.perf_counter()
    dev = put(host_input)
    out = jax.block_until_ready(fn(dev))
    res.initialization_ms = (time.perf_counter() - t0) * 1e3

    for _ in range(warmup):
        if not resident:
            dev = put(host_input)
        np.asarray(jax.block_until_ready(fn(dev)))

    for _ in range(rounds):
        t0 = time.perf_counter()
        if not resident:
            dev = jax.block_until_ready(put(host_input))
        t1 = time.perf_counter()
        out = jax.block_until_ready(fn(dev))
        t2 = time.perf_counter()
        np.asarray(out)
        t3 = time.perf_counter()
        res.accumulate((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3)
    return res


def benchmark(
    fn: Callable[[], None],
    *,
    warmup: int = WARMUP_ROUNDS,
    rounds: int = MEASUREMENT_ROUNDS,
) -> float:
    """Plain warmup-then-average wall timer; returns mean milliseconds."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn()
    return (time.perf_counter() - t0) * 1e3 / rounds


def trace(fn: Callable[[], object], trace_dir: str, *, warmup: int = 1) -> None:
    """Capture a jax.profiler trace of one execution of ``fn``.

    The deep-profiling path (the reference pointed users at Nsight Systems,
    README.md:10; from JAX the equivalent is a profiler trace viewed in
    XProf/TensorBoard). Warms up first so the trace shows steady-state
    execution, not compilation.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn())
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn())
