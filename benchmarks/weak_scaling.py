"""Weak-scaling study: time-block-sharded scan at growing mesh sizes.

BASELINE.md target: >=85% weak-scaling efficiency at >=2 hosts. On real
multi-chip hardware this script measures it directly; on a single chip it
degenerates to the 1-device row, and under the virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8 with jax_platforms=cpu)
it exercises the collective path and reports *algorithmic* scaling (virtual
devices share one socket, so treat CPU numbers as a smoke check, not
interconnect performance).

Each row holds the per-device problem size fixed (weak scaling): N = d *
per_device samples, window 1024 stereo. Efficiency = throughput(d) /
(d * throughput(1)).

Usage:
  python benchmarks/weak_scaling.py [--per-device 8000000] [--cpu]
      [--out WEAKSCALING.json] [--two-process]

``--two-process`` additionally measures the 8-device mesh spanned by TWO
jax.distributed processes (4 virtual CPU devices each) — the same
multi-controller path as tests/test_multiprocess.py, so the artifact has a
row where the carry/halo collectives actually cross a process boundary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def measure(mesh, n, window=1024, channels=2, k1=2, k2=8):
    import jax

    from digital_signal_processsing_tpu.parallel import (
        sharded_moving_average,
        time_sharding,
    )

    rng = np.random.default_rng(0)
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    sharding = time_sharding(mesh)
    # make_array_from_callback works in both single- and multi-controller
    # runs (device_put with a process-spanning sharding does not)
    xd = jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
    multi = jax.process_count() > 1

    def force(out):
        if multi:
            # global arrays are not fully addressable: fence on the local
            # shard instead of a global fetch
            out.block_until_ready()
            np.asarray(out.addressable_shards[0].data[:8])
        else:
            np.asarray(out[:8])

    def chained(k):
        @jax.jit
        def f(v):
            def body(i, y):
                return sharded_moving_average(y, window, channels, mesh=mesh)

            return jax.lax.fori_loop(0, k, body, v)

        return f

    ts = {}
    for k in (k1, k2):
        g = chained(k)
        force(g(xd))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            force(g(xd))
            best = min(best, time.perf_counter() - t0)
        ts[k] = best
    per = (ts[k2] - ts[k1]) / (k2 - k1)
    return n / per if per > 0 else n * k2 / ts[k2]


def _row(mode, d, n, sps, base):
    # two readings of the same measurement:
    # - weak_scaling_efficiency: sps(d) / (d * sps(1)) — the REAL-hardware
    #   metric (each device adds its own compute);
    # - algorithmic_efficiency: sps(d) / sps(1) — the virtual-mesh metric
    #   (d devices share ONE socket, so ideal weak scaling keeps absolute
    #   throughput flat; a drop below 1 is pure collective/carry overhead).
    return {
        "mode": mode,
        "devices": d,
        "n": n,
        "gsamples_per_s": round(sps / 1e9, 3),
        "weak_scaling_efficiency": round(sps / (d * base), 3),
        "algorithmic_efficiency": round(sps / base, 3),
    }


def _worker(pid: int, nproc: int, port: int, per_device: int) -> int:
    """One jax.distributed process of the --two-process measurement. Held
    to the CPU: a JAX process reserves most of a GPU's memory, so several
    cannot share one card."""
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from digital_signal_processsing_tpu.parallel import make_mesh
    from digital_signal_processsing_tpu.parallel.multihost import (
        initialize_multihost,
    )

    topo = initialize_multihost(f"localhost:{port}", nproc, pid)
    d = topo["global_devices"]
    mesh = make_mesh(n_time=d)
    sps = measure(mesh, per_device * d)
    if pid == 0:
        print("WORKER_ROW " + json.dumps({"devices": d, "sps": sps}), flush=True)
    return 0


def _two_process_row(per_device: int, base: float) -> dict:
    """Spawn 2 jax.distributed workers (4 virtual devices each); return the
    8-device row measured across the process boundary."""
    import os
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                __file__,
                "--worker",
                str(pid),
                "2",
                str(port),
                str(per_device),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{out[-3000:]}")
    row = next(
        json.loads(line.split(" ", 1)[1])
        for out in outs
        for line in out.splitlines()
        if line.startswith("WORKER_ROW")
    )
    return _row(
        "jax_distributed_2x4", row["devices"], per_device * row["devices"],
        row["sps"], base,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--per-device", type=int, default=8_000_000)
    p.add_argument("--cpu", action="store_true", help="force the virtual CPU mesh")
    p.add_argument("--out", type=str, default=None, help="write a JSON artifact")
    p.add_argument(
        "--two-process",
        action="store_true",
        help="add a 2-process jax.distributed 8-device row",
    )
    p.add_argument("--worker", nargs=4, metavar=("PID", "NPROC", "PORT", "PER"))
    args = p.parse_args(argv)

    if args.worker:
        pid, nproc, port, per = (int(v) for v in args.worker)
        return _worker(pid, nproc, port, per)

    if args.cpu:
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from digital_signal_processsing_tpu.parallel import make_mesh

    ndev = jax.device_count()
    backend = jax.default_backend()
    mode = f"virtual_{backend}_mesh" if backend == "cpu" else f"{backend}_mesh"
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev]
    base = None
    rows = []
    for d in sizes:
        mesh = make_mesh(n_time=d, devices=np.asarray(jax.devices()[:d]))
        n = args.per_device * d
        sps = measure(mesh, n)
        if base is None:
            base = sps
        rows.append(_row(mode, d, n, sps, base))
        print(json.dumps(rows[-1]), flush=True)

    if args.two_process:
        rows.append(_two_process_row(args.per_device, base))
        print(json.dumps(rows[-1]), flush=True)

    if args.out:
        artifact = {
            "protocol": (
                "K-differential fori_loop chains (k=2/8), best-of-3; "
                "sharded_moving_average window=1024 stereo int16; "
                "weak scaling: n = per_device * devices"
            ),
            "per_device": args.per_device,
            "backend": backend,
            "note": (
                "virtual CPU mesh: devices share one socket, so "
                "algorithmic_efficiency (flat-throughput ideal) is the "
                "meaningful column; weak_scaling_efficiency becomes "
                "meaningful on real multi-chip hardware"
            ),
            "rows": rows,
        }
        Path(args.out).write_text(json.dumps(artifact, indent=1) + "\n")
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
