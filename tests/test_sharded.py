"""Multi-device tests on the 8-device virtual CPU mesh.

The fake-distributed backend the reference never had (SURVEY.md §4):
time-block sharding with carry/halo collectives must be bit-exact against
the single-device golden model.
"""

import jax
import numpy as np
import pytest

from digital_signal_processsing_tpu.golden import moving_average_golden
from digital_signal_processsing_tpu.ops.fir import design_lowpass, fir_direct
from digital_signal_processsing_tpu.parallel import (
    make_mesh,
    sharded_cumsum,
    sharded_fir_filter,
    sharded_moving_average,
    time_sharding,
)
from tests.conftest import make_interleaved


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh()  # all 8 virtual devices on the time axis


@pytest.fixture(scope="module")
def mesh_2x4():
    return make_mesh(n_time=4, n_channel=2)


@pytest.fixture
def gpu_dispatch(monkeypatch):
    """Route the shards the way a GPU backend does: the windowed Triton
    kernel, here in the Pallas interpreter."""
    import functools
    import sys

    from digital_signal_processsing_tpu.ops import pallas_windowed

    ma = sys.modules["digital_signal_processsing_tpu.ops.moving_average"]
    jax.clear_caches()  # drop programs traced with the CPU dispatch
    monkeypatch.setattr(
        ma, "auto_method", functools.partial(ma.auto_method, platform="gpu")
    )
    monkeypatch.setattr(
        pallas_windowed,
        "windowed_average_pallas",
        functools.partial(pallas_windowed.windowed_average_pallas, interpret=True),
    )
    yield
    jax.clear_caches()


@pytest.mark.parametrize(
    "method,engine",
    [("windowed", "auto"), ("windowed", "kernel"), ("scan", "auto")],
)
@pytest.mark.parametrize("window,channels", [(16, 2), (257, 2), (1000, 1)])
def test_sharded_average_parity(
    rng, mesh8, request, method, engine, window, channels
):
    if engine == "kernel":
        request.getfixturevalue("gpu_dispatch")
    x = make_interleaved(rng, 40960 // channels, channels)
    want = moving_average_golden(x, window, channels)
    xd = jax.device_put(x, time_sharding(mesh8))
    got = np.asarray(
        sharded_moving_average(xd, window, channels, mesh=mesh8, method=method)
    )
    np.testing.assert_array_equal(got, want)


def test_sharded_windowed_fallback_small_shards(rng, mesh8):
    # shards smaller than the windowed tail -> silently uses the carry path
    x = make_interleaved(rng, 2048, 2)  # 512 samples/shard < tail_rows*128
    want = moving_average_golden(x, 3, 2)
    got = np.asarray(sharded_moving_average(x, 3, 2, mesh=mesh8))
    np.testing.assert_array_equal(got, want)


def test_sharded_average_unsharded_input(rng, mesh8):
    # works without pre-sharded input (jit re-shards)
    x = make_interleaved(rng, 8192, 2)
    want = moving_average_golden(x, 64, 2)
    got = np.asarray(sharded_moving_average(x, 64, 2, mesh=mesh8))
    np.testing.assert_array_equal(got, want)


def test_sharded_cumsum_parity(rng, mesh8):
    x = make_interleaved(rng, 20480, 2)
    got = np.asarray(sharded_cumsum(x, 2, mesh=mesh8))
    want = np.cumsum(x.reshape(-1, 2).astype(np.int64), axis=0).astype(
        np.int32
    ).reshape(-1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("carry_impl", ["ladder", "allgather"])
def test_carry_impls_bit_exact(rng, mesh8, carry_impl):
    # round 5: the log-depth ppermute carry ladder (new default) and the
    # all_gather anchor must BOTH be bit-exact vs the golden model
    x = make_interleaved(rng, 40960, 2)
    want = moving_average_golden(x, 257, 2)
    got = np.asarray(
        sharded_moving_average(
            x, 257, 2, mesh=mesh8, method="scan", carry_impl=carry_impl
        )
    )
    np.testing.assert_array_equal(got, want)
    cs = np.asarray(
        sharded_cumsum(x, 2, mesh=mesh8, carry_impl=carry_impl)
    )
    want_cs = (
        np.cumsum(x.reshape(-1, 2).astype(np.int64), axis=0)
        .astype(np.int32)
        .reshape(-1)
    )
    np.testing.assert_array_equal(cs, want_cs)
    with pytest.raises(ValueError, match="carry_impl"):
        sharded_moving_average(
            x, 257, 2, mesh=mesh8, method="scan", carry_impl="tree?"
        )


def test_sharded_halo_too_big_rejected(rng, mesh8):
    x = make_interleaved(rng, 4096, 2)
    with pytest.raises(ValueError, match="halo|shard"):
        sharded_moving_average(x, 4000, 2, mesh=mesh8)


def test_sharded_fir_parity(rng, mesh8):
    x = rng.normal(size=(1, 16384)).astype(np.float32)
    taps = design_lowpass(129, 0.2)
    want = np.asarray(fir_direct(x, taps))
    got = np.asarray(sharded_fir_filter(x, taps, mesh=mesh8, method="direct"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_fir_channels_and_time(rng, mesh_2x4):
    # 2-D mesh: 4 channels over ch-axis of 2, time over 4
    x = rng.normal(size=(4, 8192)).astype(np.float32)
    taps = design_lowpass(65, 0.3)
    want = np.asarray(fir_direct(x, taps))
    got = np.asarray(
        sharded_fir_filter(x, taps, mesh=mesh_2x4, method="overlap_save")
    )
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_sharded_fir_auto_ladder(rng, mesh_2x4):
    # method='auto' routes each shard through the single-device
    # fir_filter ladder: overlap-save above the crossover
    from digital_signal_processsing_tpu.ops.fir import FIR_FFT_CROSSOVER
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    x = rng.normal(size=(2, 8192 * 4)).astype(np.float32)
    taps_small = design_lowpass(65, 0.3)
    got = np.asarray(sharded_fir_filter(x, taps_small, mesh=mesh_2x4))
    want = np.asarray(fir_direct(x, taps_small))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert last_choice("fir_filter") == "direct"

    k_big = FIR_FFT_CROSSOVER + 145  # odd tap count above the crossover
    taps_big = design_lowpass(k_big, 0.1)
    got_b = np.asarray(sharded_fir_filter(x, taps_big, mesh=mesh_2x4))
    want_b = np.asarray(fir_direct(x, taps_big))
    scale = np.abs(want_b).max()
    assert np.abs(got_b - want_b).max() / scale < 1e-4
    assert last_choice("fir_filter") == "overlap_save"


def test_weak_scaling_shapes(rng, mesh8):
    # the sharded path must produce shard-local outputs with no re-gather:
    # output sharding matches input sharding
    x = make_interleaved(rng, 8192, 2)
    xd = jax.device_put(x, time_sharding(mesh8))
    out = sharded_moving_average(xd, 16, 2, mesh=mesh8)
    assert out.sharding.spec == time_sharding(mesh8).spec


def test_sharded_chain_matches_single_device(rng, mesh_2x4):
    from digital_signal_processsing_tpu.models import ChainConfig, DspChain
    from digital_signal_processsing_tpu.parallel.pipeline import sharded_chain

    cfg = ChainConfig(channels=4, decimation=4, channel_taps=65, audio_taps=33)
    chain = DspChain(cfg)
    t = 1 << 14
    iq = (
        rng.normal(size=(4, t)) + 1j * rng.normal(size=(4, t))
    ).astype(np.complex64)
    want = np.asarray(chain(iq))
    got = np.asarray(sharded_chain(chain, iq, mesh_2x4))
    assert got.shape == want.shape
    # skip the filter ramp-up: near-zero FM phasors there make angle()
    # amplify float jitter unboundedly (not a sharding artifact)
    ramp = (cfg.channel_taps + 8 * cfg.decimation) // cfg.decimation + cfg.audio_taps
    np.testing.assert_allclose(got[:, ramp:], want[:, ramp:], rtol=1e-3, atol=1e-4)
    # startup region: identical to single-device within float noise of the
    # demod inputs (compare energy, not angles)
    assert np.abs(got[:, :ramp] - want[:, :ramp]).mean() < 0.5


def test_sharded_chain_16_channels(rng, mesh8):
    # BASELINE config 5 shape: 16 channels, time sharded over all devices
    from digital_signal_processsing_tpu.models import ChainConfig, DspChain
    from digital_signal_processsing_tpu.parallel.pipeline import sharded_chain

    cfg = ChainConfig(channels=16, decimation=8, channel_taps=129, audio_taps=33)
    chain = DspChain(cfg)
    t = 1 << 15
    iq = (
        rng.normal(size=(16, t)) + 1j * rng.normal(size=(16, t))
    ).astype(np.complex64)
    want = np.asarray(chain(iq))
    got = np.asarray(sharded_chain(chain, iq, mesh8))
    ramp = (cfg.channel_taps + 8 * cfg.decimation) // cfg.decimation + cfg.audio_taps
    np.testing.assert_allclose(got[:, ramp:], want[:, ramp:], rtol=1e-3, atol=1e-4)


def test_sharded_chain_validation(rng, mesh8):
    from digital_signal_processsing_tpu.models import ChainConfig, DspChain
    from digital_signal_processsing_tpu.parallel.pipeline import sharded_chain

    chain = DspChain(ChainConfig(channels=2, decimation=4, channel_taps=33, audio_taps=17))
    iq = np.zeros((2, 512), np.complex64)  # 64-sample shards < 132 halo
    with pytest.raises(ValueError, match="halo|shard|divide"):
        sharded_chain(chain, iq, mesh8)


def test_pipelined_fir_cascade(rng, mesh8):
    # PP: 8 FIR stages, one per device, GPipe microbatch schedule; result
    # equals the sequential cascade over the unchunked stream.
    from digital_signal_processsing_tpu.parallel.pipeline_parallel import (
        pipelined_fir_cascade,
    )

    s, k, c, m, L = 8, 17, 2, 6, 512
    stage_taps = rng.normal(size=(s, k)).astype(np.float32) * 0.3
    x = rng.normal(size=(c, m * L)).astype(np.float32)
    want = x
    for i in range(s):
        want = np.asarray(fir_direct(want, stage_taps[i]))
    got = np.asarray(
        pipelined_fir_cascade(x.reshape(c, m, L).transpose(1, 0, 2), stage_taps, mesh=mesh8)
    )
    got_stream = got.transpose(1, 0, 2).reshape(c, m * L)
    np.testing.assert_allclose(got_stream, want, rtol=1e-4, atol=1e-5)


def test_pallas_ring_halo_matches_ppermute(rng, mesh8, gpu_dispatch):
    # the seeded GPU kernel behind the ppermute halo is a drop-in for the
    # XLA sliding recurrence
    x = make_interleaved(rng, 20480, 2)
    want = moving_average_golden(x, 257, 2)
    got = np.asarray(sharded_moving_average(x, 257, 2, mesh=mesh8))
    np.testing.assert_array_equal(got, want)


def test_ring_shift_right_semantics(rng, mesh8):
    # the windowed halo: each shard receives its left neighbour's tail,
    # device 0 the zeros ppermute defines (the causal zero halo)
    from jax.sharding import PartitionSpec as P

    def body(xs):
        n = jax.lax.axis_size("t")
        return jax.lax.ppermute(
            xs[xs.shape[0] - 256 :], "t", perm=[(d, d + 1) for d in range(n - 1)]
        )

    x = rng.normal(size=(8 * 1024,)).astype(np.float32)
    fn = jax.shard_map(body, mesh=mesh8, in_specs=P("t"), out_specs=P("t"))
    got = np.asarray(jax.jit(fn)(x)).reshape(8, 256)
    want = np.concatenate(
        [np.zeros((1, 256), np.float32), x.reshape(8, 1024)[:-1, -256:]]
    )
    np.testing.assert_array_equal(got, want)


def test_sharded_giant_halo_falls_back_to_scan(rng):
    # a halo of 2^20 samples per shard stays exact
    c, w = 128, 8192
    x = make_interleaved(rng, 128 * 8192 * 16 // c, c)
    from digital_signal_processsing_tpu.parallel import make_mesh

    mesh = make_mesh()
    got = np.asarray(sharded_moving_average(x, w, c, mesh=mesh))
    np.testing.assert_array_equal(got, moving_average_golden(x, w, c))


def test_sharded_use_pallas_false_respected(rng, mesh8):
    # the scan-carry path is plain XLA: no kernel in its program
    x = make_interleaved(rng, 20480, 2)
    got = np.asarray(sharded_moving_average(x, 64, 2, mesh=mesh8, method="scan"))
    np.testing.assert_array_equal(got, moving_average_golden(x, 64, 2))
    jaxpr = jax.make_jaxpr(
        lambda v: sharded_moving_average(v, 64, 2, mesh=mesh8, method="scan")
    )(x)
    assert "pallas_call" not in str(jaxpr)


def test_sharded_packed_windowed_bit_exact(rng, mesh8):
    # packed transport end-to-end on the mesh: int32 pair shards are
    # unpacked on the device — output view matches golden
    from digital_signal_processsing_tpu.parallel.sharded_scan import (
        sharded_moving_average,
    )

    w, c = 700, 2
    n = 8 * (1 << 15)
    x = make_interleaved(rng, n, c)
    got32 = np.asarray(
        sharded_moving_average(x.view(np.int32), w, c, mesh=mesh8)
    )
    np.testing.assert_array_equal(
        got32.view(np.int16), moving_average_golden(x, w, c)
    )


def test_sharded_packed_rejects_bad_shapes(rng, mesh8):
    from digital_signal_processsing_tpu.parallel.sharded_scan import (
        sharded_moving_average,
    )

    with pytest.raises(ValueError, match="divide"):
        # 16384 samples are no whole number of 3-channel frames per shard
        sharded_moving_average(
            np.zeros(8 * 1024, np.int32), 16, 3, mesh=mesh8
        )


@pytest.mark.parametrize(
    "w,c,n", [(1024, 2, 8 * (1 << 16)), (16, 1, 8 * 4096), (700, 4, 8 * (1 << 15))]
)
def test_fused_ring_windowed_bit_exact(rng, mesh8, gpu_dispatch, w, c, n):
    # the seeded kernel on every shard matches golden bit-exactly
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    x = make_interleaved(rng, n // c, c)
    got = np.asarray(sharded_moving_average(x, w, c, mesh=mesh8))
    assert last_choice("moving_average_chunk") == "windowed"
    np.testing.assert_array_equal(got, moving_average_golden(x, w, c))


def test_fused_ring_single_device_degenerate(rng, gpu_dispatch):
    # one device: the halo is ppermute's zeros, the stream start's halo
    mesh1 = make_mesh(devices=jax.devices()[:1])
    w, c = 300, 2
    x = make_interleaved(rng, 1 << 15, c)
    got = np.asarray(sharded_moving_average(x, w, c, mesh=mesh1))
    np.testing.assert_array_equal(got, moving_average_golden(x, w, c))


def test_sharded_sosfilt_tv_bit_equal(rng, mesh_2x4):
    from digital_signal_processsing_tpu.ops import iir
    from digital_signal_processsing_tpu.parallel.sharded_tv import (
        sharded_sosfilt_tv,
    )

    c, n = 4, 2048
    x = rng.normal(size=(c, n)).astype(np.float32)
    r = 0.5 + 0.3 * np.sin(np.linspace(0, 4, n))
    row = np.stack(
        [np.full(n, 0.3), np.zeros(n), np.full(n, 0.05), np.ones(n),
         -2 * r * 0.8, r * r], -1
    ).astype(np.float32)
    # shared schedule (replicated) and per-channel schedule (sharded)
    sos_shared = np.stack([row, row * np.float32(0.9)], 0)
    want = np.asarray(iir.sosfilt_tv(sos_shared, x))
    got = np.asarray(sharded_sosfilt_tv(sos_shared, x, mesh=mesh_2x4))
    np.testing.assert_array_equal(got, want)
    sos_per = np.stack(
        [np.stack([row * np.float32(0.8 + 0.05 * i) for i in range(c)], 0)],
        0,
    )
    want = np.asarray(iir.sosfilt_tv(sos_per, x))
    got = np.asarray(sharded_sosfilt_tv(sos_per, x, mesh=mesh_2x4))
    np.testing.assert_array_equal(got, want)


def test_sharded_lpc_synthesis_bit_equal(rng, mesh_2x4):
    from digital_signal_processsing_tpu.ops import lpc
    from digital_signal_processsing_tpu.parallel.sharded_tv import (
        sharded_lpc_synthesis,
    )

    streams, nf, fl, order = 4, 6, 64, 6
    rows = []
    for s in range(streams):
        fr = []
        for _ in range(nf):
            poles = 0.8 * np.exp(
                1j * rng.uniform(0.3, np.pi - 0.3, order // 2)
            )
            fr.append(np.poly(np.concatenate([poles, poles.conj()])).real)
        rows.append(fr)
    a = np.asarray(rows, np.float32)
    gain = rng.uniform(0.5, 1.5, (streams, nf)).astype(np.float32)
    e = rng.normal(size=(streams, nf * fl)).astype(np.float32)
    want = np.asarray(lpc.lpc_synthesis(a, gain, e, fl))
    got = np.asarray(sharded_lpc_synthesis(a, gain, e, fl, mesh=mesh_2x4))
    np.testing.assert_array_equal(got, want)
