"""Worker for tests/test_multiprocess.py: one jax.distributed process.

Run as: python multiprocess_worker.py <process_id> <num_processes> <port>
Each process owns 4 virtual CPU devices; together they form the first real
multi-controller exercise of parallel/multihost.py (round-1 gap: the module
was wrapper-thin and never executed).
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from digital_signal_processsing_tpu.golden import moving_average_golden  # noqa: E402
from digital_signal_processsing_tpu.parallel.multihost import (  # noqa: E402
    assert_same_across_hosts,
    initialize_multihost,
)


def main() -> None:
    topo = initialize_multihost(f"localhost:{port}", nproc, pid)
    assert topo["process_count"] == nproc, topo
    assert topo["global_devices"] == 4 * nproc, topo

    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from digital_signal_processsing_tpu.models.adaptive import (
        make_sharded_train_step,
    )
    from digital_signal_processsing_tpu.parallel import (
        make_mesh,
        sharded_moving_average,
        time_sharding,
    )

    # the process-spanning mesh: make_mesh over the GLOBAL device list
    mesh = make_mesh(n_time=2 * nproc, n_channel=2)
    assert mesh.devices.size == 4 * nproc

    # --- sharded averager across processes, bit-exact vs golden
    w, c = 64, 2
    n = 4 * nproc * 8192
    rng = np.random.default_rng(0)  # same seed every process: global data
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    sharding = time_sharding(mesh)
    xd = jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
    out = sharded_moving_average(xd, w, c, mesh=mesh)
    want = moving_average_golden(x, w, c)
    for shard in out.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), want[shard.index])

    # --- explicit scan-carry path with the round-5 log-depth ppermute
    # ladder across processes, still bit-exact vs golden
    out_sc = sharded_moving_average(
        xd, w, c, mesh=mesh, method="scan", carry_impl="ladder"
    )
    for shard in out_sc.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), want[shard.index])

    # --- windowed averager with a wider halo across processes
    w2, c2 = 700, 2
    x2 = rng.integers(-32768, 32768, size=4 * nproc * (1 << 13), dtype=np.int16)
    x2d = jax.make_array_from_callback(x2.shape, sharding, lambda idx: x2[idx])
    out_w = sharded_moving_average(x2d, w2, c2, mesh=mesh)
    want_w = moving_average_golden(x2, w2, c2)
    for shard in out_w.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), want_w[shard.index])

    # --- (ch, t)-sharded receiver chain across processes (round 4): the
    # combined-halo ppermute path under a multi-controller mesh
    import jax.numpy as jnp

    from digital_signal_processsing_tpu.models import ChainConfig, DspChain
    from digital_signal_processsing_tpu.parallel.pipeline import sharded_chain

    ccfg = ChainConfig(
        channels=2, decimation=4, channel_taps=33, audio_taps=17
    )
    dsp_chain = DspChain(ccfg)
    t_chain = 512 * mesh.shape["t"]
    iq = (
        rng.normal(size=(ccfg.channels, t_chain))
        + 1j * rng.normal(size=(ccfg.channels, t_chain))
    ).astype(np.complex64)
    want_c = np.asarray(dsp_chain(jnp.asarray(iq)))  # local single-device ref
    from jax.sharding import PartitionSpec as PS

    iq_sh = jax.make_array_from_callback(
        iq.shape, NamedSharding(mesh, PS("ch", "t")), lambda idx: iq[idx]
    )
    got_c = sharded_chain(dsp_chain, iq_sh, mesh)
    ramp = (
        ccfg.channel_taps + 8 * ccfg.decimation
    ) // ccfg.decimation + ccfg.audio_taps
    for shard in got_c.addressable_shards:
        got_np = np.asarray(shard.data)
        want_np = want_c[shard.index]
        # skip the per-channel ramp-up region like dryrun_multichip does
        col0 = shard.index[1].start or 0
        keep = max(ramp - col0, 0)
        np.testing.assert_allclose(
            got_np[:, keep:], want_np[:, keep:], rtol=1e-3, atol=1e-4
        )

    # --- LMS training step with psum-combined grads across processes
    tx = optax.adam(1e-2)
    step = make_sharded_train_step(mesh, tx)
    taps0 = jax.numpy.zeros((8,), jax.numpy.float32)
    opt_state = tx.init(taps0)
    bshape = (8, 2048 * 2 * nproc)
    bx = rng.normal(size=bshape).astype(np.float32)
    bd = rng.normal(size=bshape).astype(np.float32)
    bsharding = NamedSharding(mesh, P("ch", "t"))
    bxd = jax.make_array_from_callback(bshape, bsharding, lambda i: bx[i])
    bdd = jax.make_array_from_callback(bshape, bsharding, lambda i: bd[i])
    taps1, opt_state, loss = jax.block_until_ready(step(taps0, opt_state, bxd, bdd))
    loss_f = float(np.asarray(loss))
    assert np.isfinite(loss_f)
    # first true exercise of the cross-host agreement check
    assert_same_across_hosts(loss_f, "lms_loss")

    print(f"MULTIPROC_OK pid={pid} loss={loss_f:.6f}", flush=True)


if __name__ == "__main__":
    main()
