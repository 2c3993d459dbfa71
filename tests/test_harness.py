"""Harness: CSV schema, phase profile math, smoke sweep."""

import numpy as np

from digital_signal_processsing_tpu.harness import (
    CSV_COLUMNS,
    CsvLogger,
    ProfileResult,
    benchmark,
    time_phases,
)
from digital_signal_processsing_tpu.harness.sweep import generate_wav, run_suite


def test_csv_schema_matches_reference(tmp_path):
    # gpu_utils.h:196-199 column set, verbatim
    assert CSV_COLUMNS.split(",") == [
        "Algorithm", "MemoryMode", "N_Samples", "Grade", "BlockSize",
        "H2D_ms", "Compute_ms", "D2H_ms", "Total_ms", "Init_ms",
        "ColdStart_Total_ms", "Bandwidth_GBs", "Throughput_MSs",
        "ColdStart_MSs",
    ]
    p = tmp_path / "r.csv"
    lg = CsvLogger(p)
    res = ProfileResult(initialization_ms=1.0)
    res.accumulate(1.0, 2.0, 1.0)
    lg.log("scan", "device_put", 1000, 16, 256, res, 2)
    lines = p.read_text().strip().split("\n")
    assert lines[0] == CSV_COLUMNS
    assert len(lines) == 2 and len(lines[1].split(",")) == 14
    # append mode keeps rows (gpu_utils.h:188)
    CsvLogger(p).log("scan", "device_put", 1000, 16, 256, res, 2)
    assert len(p.read_text().strip().split("\n")) == 3


def test_profile_result_derived_metrics():
    res = ProfileResult(initialization_ms=5.0)
    for _ in range(2):
        res.accumulate(1.0, 2.0, 1.0)
    r = res.averaged()
    assert r.total_ms == 4.0
    assert r.cold_total_ms == 9.0
    # 1M samples, 2 B/sample: (1e6*2*2 B) / 4 ms = 1 GB/s
    assert abs(r.bandwidth_gbs(1_000_000, 2) - 1.0) < 1e-9
    assert abs(r.throughput_msps(1_000_000) - 250.0) < 1e-9
    assert abs(r.compute_throughput_msps(1_000_000) - 500.0) < 1e-9


def test_time_phases_runs(rng):
    import jax.numpy as jnp

    x = rng.normal(size=1024).astype(np.float32)
    res = time_phases(lambda v: jnp.cumsum(v), x, warmup=1, rounds=2)
    assert res.rounds == 2
    assert res.initialization_ms > 0
    assert res.total_ms > 0


def test_benchmark_wall_timer():
    calls = []
    ms = benchmark(lambda: calls.append(1), warmup=2, rounds=3)
    assert len(calls) == 5
    assert ms >= 0


def test_smoke_sweep(tmp_path):
    out = tmp_path / "sweep.csv"
    fails = run_suite(
        sizes=[20_000],
        grades=[4],
        variants=["xla_scan", "scan", "golden_cpu"],
        out_csv=str(out),
        warmup=0,
        rounds=1,
        verbose=False,
    )
    assert fails == 0
    lines = out.read_text().strip().split("\n")
    # header + 2 device variants x 2 memory modes + golden_cpu
    assert len(lines) == 6
    algos = {l.split(",")[0] for l in lines[1:]}
    assert algos == {"xla_scan", "scan", "golden_cpu"}
    modes = {l.split(",")[1] for l in lines[1:]}
    assert modes == {"staged", "resident", "RAM"}


def test_generate_wav_roundtrip(tmp_path):
    from digital_signal_processsing_tpu.io import read_wav

    data = generate_wav(tmp_path / "g.wav", 10_000, 2, seed=3)
    info, got = read_wav(tmp_path / "g.wav")
    assert info.num_samples == 10_000
    np.testing.assert_array_equal(got, data)


def test_checkpoint_resume_training(tmp_path):
    import jax.numpy as jnp
    import optax

    from digital_signal_processsing_tpu.models.adaptive import lms_train_step
    from digital_signal_processsing_tpu.utils.checkpoint import (
        load_training_state,
        save_training_state,
    )

    rng = np.random.default_rng(3)
    tx = optax.adam(1e-2)
    taps = jnp.zeros((4,), jnp.float32)
    opt_state = tx.init(taps)
    x = jnp.asarray(rng.normal(size=(2, 512)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(2, 512)), jnp.float32)

    # run 3 steps, checkpoint, run 2 more
    for step in range(3):
        taps, opt_state, _ = lms_train_step(taps, opt_state, x, d, tx=tx)
    ckpt = tmp_path / "state.npz"
    save_training_state(ckpt, taps, opt_state, 3)
    taps_cont, opt_cont = taps, opt_state
    for _ in range(2):
        taps_cont, opt_cont, _ = lms_train_step(taps_cont, opt_cont, x, d, tx=tx)

    # restore and replay the same 2 steps: must match exactly
    t2, o2, step2 = load_training_state(ckpt, tx.init(jnp.zeros((4,), jnp.float32)))
    assert step2 == 3
    t2 = jnp.asarray(t2)
    for _ in range(2):
        t2, o2, _ = lms_train_step(t2, o2, x, d, tx=tx)
    np.testing.assert_array_equal(np.asarray(t2), np.asarray(taps_cont))

    # mismatched optimizer template rejected
    import pytest as _pytest

    with _pytest.raises(ValueError, match="leaves"):
        load_training_state(ckpt, optax.sgd(1e-2).init(jnp.zeros((4,), jnp.float32)))
