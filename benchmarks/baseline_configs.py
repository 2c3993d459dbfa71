"""Run BASELINE.json's five headline configurations and emit JSON rows.

Configs (BASELINE.json "configs"):
  1. serial CPU moving averager, 1M samples, k=16  (reference parity row)
  2. direct parallel averager, one device, k in 4..64 (memory regime)
  3. scan averager, k in 256..4096 (compute regime)
  4. scan averager, 64M samples time-block-sharded w/ carry exchange
  5. full chain (FIR + polyphase decimate + FM demod), 16 channels sharded
     over the mesh

Configs 4-5 use every available device (the GPUs, or the virtual CPU mesh
under XLA_FLAGS).

Usage: python benchmarks/baseline_configs.py [--out results.json]
Each time is the median of repeated calls that end in block_until_ready,
with the input resident on the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

# allow running as `python benchmarks/<script>.py` without installing
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _time(fn, *args, repeats=10):
    """Median seconds of ``fn(*args)`` after one compile-and-warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def config1_cpu_serial():
    from digital_signal_processsing_tpu.harness.profile import benchmark
    from digital_signal_processsing_tpu.golden import moving_average_golden

    rng = np.random.default_rng(0)
    x = rng.integers(-32768, 32768, size=1_000_000, dtype=np.int16)
    row = {"config": "cpu_serial_1M_k16"}
    try:
        from digital_signal_processsing_tpu.io import native

        ms = native.bench_moving_average_native(x, 16, 1, warmup=3, rounds=5)
        row["impl"] = "native_cpp"
    except Exception:
        ms = benchmark(lambda: moving_average_golden(x, 16, 1), warmup=2, rounds=3)
        row["impl"] = "numpy_golden"
    row["ms"] = round(ms, 3)
    row["msamples_per_s"] = round(x.size / ms / 1e3, 1)
    return row


def _stream(n):
    import jax

    rng = np.random.default_rng(0)
    return jax.device_put(rng.integers(-32768, 32768, size=n, dtype=np.int16))


def config2_direct_small_windows(n=64_000_000):
    from digital_signal_processsing_tpu.ops import moving_average

    xd = _stream(n)
    rows = []
    for w in (4, 16, 64):
        for method in ("auto", "xla_direct"):
            per = _time(lambda y, w=w, m=method: moving_average(y, w, 2, method=m), xd)
            rows.append(
                {
                    "config": f"{method}_k{w}",
                    "n": n,
                    "gsamples_per_s": round(n / per / 1e9, 2),
                }
            )
    return rows


def config3_scan_large_windows(n=64_000_000):
    from digital_signal_processsing_tpu.ops import moving_average

    xd = _stream(n)
    rows = []
    for w in (256, 1024, 4096):
        for method in ("auto", "xla_scan"):
            per = _time(lambda y, w=w, m=method: moving_average(y, w, 2, method=m), xd)
            rows.append(
                {
                    "config": f"{method}_k{w}",
                    "n": n,
                    "gsamples_per_s": round(n / per / 1e9, 2),
                }
            )
    return rows


def config4_sharded_scan(n=64_000_000):
    import jax

    from digital_signal_processsing_tpu.parallel import (
        make_mesh,
        sharded_moving_average,
        time_sharding,
    )

    ndev = jax.device_count()
    mesh = make_mesh()
    rng = np.random.default_rng(0)
    n = (n // (ndev * 2)) * ndev * 2
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    xd = jax.device_put(x, time_sharding(mesh))

    rows = []
    for method in ("windowed", "scan"):
        per = _time(
            lambda y, m=method: sharded_moving_average(
                y, 1024, 2, mesh=mesh, method=m
            ),
            xd,
        )
        rows.append(
            {
                "config": f"sharded_{method}_64M_k1024",
                "devices": ndev,
                "n": n,
                "gsamples_per_s": round(n / per / 1e9, 2),
            }
        )
    return rows


def config5_full_chain(t=1 << 22):
    import jax

    from digital_signal_processsing_tpu.models import ChainConfig, DspChain
    from digital_signal_processsing_tpu.parallel import make_mesh
    from digital_signal_processsing_tpu.parallel.pipeline import sharded_chain_planar

    ndev = jax.device_count()
    rng = np.random.default_rng(0)
    base_cfg = ChainConfig(channels=16, decimation=8)
    t = (t // (ndev * base_cfg.decimation)) * ndev * base_cfg.decimation
    xi = rng.normal(size=(16, t)).astype(np.float32)
    xq = rng.normal(size=(16, t)).astype(np.float32)
    n_ch = 2 if ndev % 2 == 0 and ndev > 1 else 1
    mesh = make_mesh(n_time=ndev // n_ch, n_channel=n_ch)
    di, dq = jax.device_put(xi), jax.device_put(xq)

    rows = []
    for fused in (False, True):
        chain = DspChain(
            ChainConfig(channels=16, decimation=8, fused_frontend=fused)
        )
        per = _time(lambda a, b: sharded_chain_planar(chain, a, b, mesh), di, dq,
                    repeats=5)
        total_samples = 16 * t
        rows.append(
            {
                "config": "full_chain_16ch"
                + ("_fused_frontend" if fused else ""),
                "devices": ndev,
                "mesh": f"{n_ch}x{ndev // n_ch}",
                "t": t,
                "msamples_per_s_in": round(total_samples / per / 1e6, 1),
                "wall_ms": round(per * 1e3, 2),
            }
        )
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--skip", nargs="*", default=[], help="config numbers to skip")
    args = p.parse_args(argv)
    results = {}
    runners = {
        "1": config1_cpu_serial,
        "2": config2_direct_small_windows,
        "3": config3_scan_large_windows,
        "4": config4_sharded_scan,
        "5": config5_full_chain,
    }
    for num, fn in runners.items():
        if num in args.skip:
            continue
        try:
            results[num] = fn()
        except Exception as e:  # keep going; report the failure
            results[num] = {"error": str(e)[:300]}
        print(json.dumps({num: results[num]}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
