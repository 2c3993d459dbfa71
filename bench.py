"""Headline benchmark: moving-average samples/s on one device at k=1024.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

Method: the public ``ops.moving_average`` (``method="auto"``) over a
64M-sample stereo int16 stream resident on the device, window 1024 —
BASELINE.json's per-device headline config. Each repeat is one call that
ends in ``block_until_ready``; the median of the repeats is reported.

vs_baseline: the reference's Jetson Nano scan kernel measures ~19 ms
(logs/benchmark_comparison.png in the reference repo, Hillis-Steele kernel
bar) on the sweep's mid-size ~10M-sample input => ~0.53 GSamples/s
kernel-only. We use 0.5 GS/s as the baseline denominator (BASELINE.md
target: >=10x at k=1024).
"""

from __future__ import annotations

import json
import time

import numpy as np

JETSON_SCAN_K1024_SPS = 0.5e9  # see module docstring
N = 64_000_000
WINDOW = 1024
CHANNELS = 2
REPEATS = 20


def main() -> None:
    import jax

    from digital_signal_processsing_tpu.ops import moving_average
    from digital_signal_processsing_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    rng = np.random.default_rng(0)
    x = rng.integers(-32768, 32768, size=N, dtype=np.int16)
    xd = jax.device_put(x)
    jax.block_until_ready(moving_average(xd, WINDOW, CHANNELS))  # compile
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(moving_average(xd, WINDOW, CHANNELS))
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    if not t > 0:
        raise RuntimeError(f"non-positive median time {t!r}")
    sps = N / t
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "moving_average_samples_per_s_k1024",
                "value": sps,
                "unit": "samples/s",
                "vs_baseline": sps / JETSON_SCAN_K1024_SPS,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
