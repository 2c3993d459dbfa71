#!/usr/bin/env python3
"""Smoke test of the main paths on an NVIDIA GPU, at full size.

    python chip_smoke.py               # one GPU: phases A, A', B, C, E
    python chip_smoke.py --four-cards  # four GPUs: phase D only

Phases (each line: wall time, compile time, samples/s, parity):

- A   ops.moving_average(method="auto") on a 64M-sample stereo int16
      stream at windows 16 and 1024, bit-exact against the golden model;
      checks that the dispatcher took the engine utils/backend.py offers.
- A'  the windowed Pallas-Triton kernel against the plain XLA spelling
      (ops/scan_xla.py) at the same shapes, both timed.
- B   serve.stream_moving_average from a 64M-sample stereo WAV to a WAV in
      1M-sample chunks, byte-identical with the one-shot result.
- C   the FM receiver chain (16 channels x 4,194,304 complex samples,
      decimation 8) one-shot and in four chunks, on an FM test signal,
      against the float64 reference of golden/fm_chain.py.
- E   sosfilt at 16 x 4M (compile time, parity with scipy), and the
      ragged-length conv parity (fir_direct, correlate) under jit.
- D   (--four-cards) sharded_moving_average over 4 x 64M samples and
      sharded_chain at 16 x 4 x 4,194,304 on a (ch, t) mesh, against the
      same computations on one card.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed. Off the GPU the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_STREAM = 1 << 26  # 64M interleaved samples
CHANNELS = 2
CHAIN_T = 1 << 22  # 4,194,304 samples per channel
REL_TOL = 1e-4  # chain outputs: max |err| over the reference RMS


def timed(fn, *args, reps=10):
    """(result, first-call seconds, median steady seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def line(phase, what, first, steady, samples, parity):
    print(
        f"phase {phase} {what}: wall {steady * 1e3:.3f} ms, "
        f"compile {max(first - steady, 0.0):.2f} s, "
        f"{samples / steady:.4e} samples/s, parity {parity}",
        flush=True,
    )


def rel_err(got, want):
    rms = float(np.sqrt(np.mean(np.square(want))))
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) / rms


def phase_a(stream, golden):
    import jax

    from digital_signal_processsing_tpu.ops import moving_average
    from digital_signal_processsing_tpu.ops.moving_average import auto_method
    from digital_signal_processsing_tpu.ops.pallas_windowed import (
        windowed_average_pallas,
    )
    from digital_signal_processsing_tpu.ops.scan_xla import moving_average_xla
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    xd = jax.device_put(stream)
    for k in (16, 1024):
        out, first, steady = timed(lambda v: moving_average(v, k, CHANNELS), xd)
        exact = np.array_equal(np.asarray(out), golden[k])
        engine = last_choice("moving_average")
        line("A", f"moving_average(auto) k={k} engine={engine}", first, steady,
             N_STREAM, f"exact={exact}")
        assert exact, f"A k={k}: not bit-exact against the golden model"
        assert engine == auto_method(k, CHANNELS) == "windowed", engine
        for name, fn in (
            ("kernel", lambda v: windowed_average_pallas(v, k, CHANNELS)),
            ("xla_scan", lambda v: moving_average_xla(v, k, CHANNELS)),
        ):
            out, first, steady = timed(fn, xd, reps=30)
            exact = np.array_equal(np.asarray(out), golden[k])
            line("A'", f"{name} k={k}", first, steady, N_STREAM, f"exact={exact}")
            assert exact, f"A' {name} k={k}: not bit-exact"


def phase_b(stream, golden, scratch):
    from digital_signal_processsing_tpu import serve
    from digital_signal_processsing_tpu.harness.sweep import generate_wav
    from digital_signal_processsing_tpu.io import read_wav

    k = 1024
    src, dst = scratch / "in.wav", scratch / "out.wav"
    data = generate_wav(src, N_STREAM, CHANNELS, seed=0)
    assert np.array_equal(data, stream)
    t0 = time.perf_counter()
    n = serve.stream_moving_average([src], dst, k, chunk_samples=1 << 20)
    wall = time.perf_counter() - t0
    _, got = read_wav(dst)
    same = n == N_STREAM and np.array_equal(got, golden[k])
    print(
        f"phase B stream_moving_average k={k} chunks=1M: wall {wall:.3f} s "
        f"(WAV in and out, compile included), {N_STREAM / wall:.4e} samples/s, "
        f"parity byte_identical={same}",
        flush=True,
    )
    assert same, "B: streamed WAV differs from the one-shot result"


def chain_reference_args(chain, channels):
    from digital_signal_processsing_tpu.ops.fir import design_lowpass

    c = chain.config
    return dict(
        lo_freqs=c.lo_frequencies()[:channels],
        channel_taps=np.asarray(chain.channel_taps),
        decim_taps=design_lowpass(8 * c.decimation, 0.8 / c.decimation),
        audio_taps=np.asarray(chain.audio_taps),
        decimation=c.decimation,
        gain=c.fm_gain,
    )


def chain_ramp(chain):
    c = chain.config
    return (c.channel_taps + 8 * c.decimation) // c.decimation + c.audio_taps


def phase_c():
    import jax

    from digital_signal_processsing_tpu.golden.fm_chain import (
        fm_chain_reference,
        fm_test_signal,
        tone_snr_db,
    )
    from digital_signal_processsing_tpu.models.chain import (
        ChainConfig,
        DspChain,
        chain_stream_chunk,
        chain_stream_init,
    )

    chain = DspChain(ChainConfig(channels=16, decimation=8))
    d = chain.config.decimation
    tone = 0.002
    i, q = fm_test_signal(chain.config.lo_frequencies(), CHAIN_T, tone=tone)
    idv, qdv = jax.device_put(i), jax.device_put(q)
    out, first, steady = timed(chain.forward_planar, idv, qdv, reps=5)
    out = np.asarray(out)
    ramp = chain_ramp(chain)
    ref = fm_chain_reference(i[:2], q[:2], **chain_reference_args(chain, 2))
    err = rel_err(out[:2, ramp:], ref[:, ramp:])
    snr = tone_snr_db(out[:, ramp:], tone * d)
    finite = bool(np.isfinite(out).all())
    line("C", "chain one-shot 16x4194304", first, steady, 16 * CHAIN_T,
         f"max_err/rms={err:.3e} (tol {REL_TOL:g}) finite={finite} "
         f"tone_snr={snr:.2f} dB")
    assert finite and err < REL_TOL, f"C one-shot: err {err}"

    chunk = CHAIN_T // 4
    state = chain_stream_init(chain)
    parts, walls = [], []
    for c0 in range(0, CHAIN_T, chunk):
        t0 = time.perf_counter()
        state, y = chain_stream_chunk(
            chain, state, idv[:, c0 : c0 + chunk], qdv[:, c0 : c0 + chunk]
        )
        parts.append(np.asarray(jax.block_until_ready(y)))
        walls.append(time.perf_counter() - t0)
    got = np.concatenate(parts, axis=-1)
    err_c = rel_err(got[:, ramp:], out[:, ramp:].astype(np.float64))
    print(
        f"phase C chain_stream_chunk 4 x 16x{chunk}: chunk walls "
        + ", ".join(f"{w * 1e3:.3f} ms" for w in walls)
        + f" (first includes compile), {16 * chunk / walls[-1]:.4e} samples/s "
        f"(last chunk), parity vs one-shot max_err/rms={err_c:.3e}",
        flush=True,
    )
    assert err_c < REL_TOL, f"C chunked: err {err_c}"


def phase_e():
    import jax
    import jax.numpy as jnp
    from scipy import signal

    from digital_signal_processsing_tpu.ops import correlate as corr
    from digital_signal_processsing_tpu.ops import iir
    from digital_signal_processsing_tpu.ops.fir import fir_direct

    sos = signal.butter(6, 0.1, output="sos").astype(np.float32)
    x = np.random.default_rng(2).standard_normal((16, CHAIN_T)).astype(np.float32)
    xd = jax.device_put(x)
    t0 = time.perf_counter()
    compiled = jax.jit(iir.sosfilt).lower(sos, xd).compile()
    compile_s = time.perf_counter() - t0
    out, _, steady = timed(compiled, sos, xd, reps=5)
    want = signal.sosfilt(sos.astype(np.float64), x[:2].astype(np.float64))
    err = rel_err(np.asarray(out)[:2], want)
    print(
        f"phase E sosfilt 16x4194304 (3 sections): wall {steady * 1e3:.3f} ms, "
        f"compile {compile_s:.2f} s, {16 * CHAIN_T / steady:.4e} samples/s, "
        f"parity vs scipy max_err/rms={err:.3e}",
        flush=True,
    )
    assert err < REL_TOL, f"E sosfilt: err {err}"

    rng = np.random.default_rng(1)
    for k in (7, 257):
        xs = rng.standard_normal((3, 306)).astype(np.float32)
        h = rng.standard_normal(k).astype(np.float32)
        y = np.asarray(jax.jit(fir_direct)(jnp.asarray(xs), jnp.asarray(h)))
        ref = np.stack(
            [np.convolve(r.astype(np.float64), h.astype(np.float64))[:306] for r in xs]
        )
        e1 = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
        a = xs[0]
        c = np.asarray(
            jax.jit(lambda u, v: corr.correlate(u, v, method="direct"))(a, h)
        )
        rc = np.correlate(a.astype(np.float64), h.astype(np.float64), mode="full")
        e2 = float(np.max(np.abs(c - rc)) / np.max(np.abs(rc)))
        print(
            f"phase E ragged conv (3,306) k={k} under jit: fir_direct max rel "
            f"err {e1:.3e}, correlate(direct) max rel err {e2:.3e}",
            flush=True,
        )
        assert e1 < 1e-5 and e2 < 1e-5, (k, e1, e2)


def phase_d():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from digital_signal_processsing_tpu.golden import moving_average_golden
    from digital_signal_processsing_tpu.golden.fm_chain import fm_test_signal
    from digital_signal_processsing_tpu.models.chain import ChainConfig, DspChain
    from digital_signal_processsing_tpu.ops import moving_average
    from digital_signal_processsing_tpu.parallel import (
        make_mesh,
        sharded_moving_average,
        time_sharding,
    )
    from digital_signal_processsing_tpu.parallel.pipeline import sharded_chain

    devs = jax.devices()
    assert len(devs) == 4, f"--four-cards needs 4 GPUs, found {len(devs)}"

    def spread(arr):
        owners = {s.device for s in arr.addressable_shards}
        assert len(owners) == 4, f"output lives on {owners}"
        return len(owners)

    k, n = 1024, 4 * N_STREAM
    x = np.random.default_rng(3).integers(-32768, 32768, size=n, dtype=np.int16)
    mesh_t = make_mesh()  # all four cards on the time axis
    xs = jax.device_put(x, time_sharding(mesh_t))
    out, first, steady = timed(
        lambda v: sharded_moving_average(v, k, CHANNELS, mesh=mesh_t), xs
    )
    owners = spread(out)
    single, s_first, s_steady = timed(
        lambda v: moving_average(v, k, CHANNELS), jax.device_put(x, devs[0])
    )
    golden = moving_average_golden(x, k, CHANNELS)
    exact = np.array_equal(np.asarray(out), np.asarray(single)) and np.array_equal(
        np.asarray(single), golden
    )
    line("D", f"sharded_moving_average 4x64M k={k} on {owners} cards", first,
         steady, n, f"exact_vs_single_card={exact}")
    line("D", "single-card moving_average 256M", s_first, s_steady, n,
         "exact_vs_golden=" + str(np.array_equal(np.asarray(single), golden)))
    assert exact, "D: sharded averager differs from the single-card result"

    chain = DspChain(ChainConfig(channels=16, decimation=8))
    t = 4 * CHAIN_T
    i, q = fm_test_signal(chain.config.lo_frequencies(), t)
    iq = i + 1j * q
    mesh_ct = make_mesh(n_time=2, n_channel=2)
    iq_sh = jax.device_put(iq, NamedSharding(mesh_ct, P("ch", "t")))
    got, first, steady = timed(lambda v: sharded_chain(chain, v, mesh_ct), iq_sh,
                               reps=3)
    owners = spread(got)
    want, s_first, s_steady = timed(chain, jax.device_put(iq, devs[0]), reps=3)
    ramp = chain_ramp(chain)
    err = rel_err(np.asarray(got)[:, ramp:], np.asarray(want)[:, ramp:])
    line("D", f"sharded_chain 16x4x4194304 on a 2x2 (ch, t) mesh, {owners} cards",
         first, steady, 16 * t, f"max_err/rms vs single card={err:.3e}")
    line("D", "single-card chain 16x16777216", s_first, s_steady, 16 * t, "-")
    assert err < REL_TOL, f"D chain: err {err}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--four-cards", action="store_true", help="run phase D on four GPUs"
    )
    args = p.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke.py: needs a GPU, JAX found {jax.default_backend()!r}",
            file=sys.stderr,
        )
        return 2
    sys.path.insert(0, str(ROOT))
    from digital_signal_processsing_tpu.golden import moving_average_golden
    from digital_signal_processsing_tpu.utils.cache import enable_persistent_cache

    print(f"compile cache: {enable_persistent_cache()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip(), flush=True)

    failed = []

    def run(name, fn, *a):
        try:
            fn(*a)
        except Exception as e:  # report, keep going, fail at the end
            failed.append(name)
            print(f"phase {name} FAILED: {type(e).__name__}: {e}", flush=True)

    if args.four_cards:
        run("D", phase_d)
    else:
        stream = np.random.default_rng(0).integers(
            -32768, 32768, size=N_STREAM // CHANNELS * CHANNELS, dtype=np.int16
        )
        golden = {k: moving_average_golden(stream, k, CHANNELS) for k in (16, 1024)}
        scratch = ROOT / ".smoke_scratch"
        scratch.mkdir(parents=True, exist_ok=True)
        try:
            run("A", phase_a, stream, golden)
            run("B", phase_b, stream, golden, scratch)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        run("C", phase_c)
        run("E", phase_e)
    if failed:
        print(f"chip_smoke.py: phases failed: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
