"""Multi-host bring-up helpers.

The mesh code in this package is host-count agnostic: ``make_mesh()`` over
``jax.devices()`` spans every process after ``jax.distributed.initialize``,
and the collectives (carry all-gather, halo ppermute) ride ICI within a
host and DCN across hosts with no code change — that is the point of
expressing the carry tree as mesh collectives instead of the reference's
intra-GPU relaunch recursion.

This module packages the bring-up so a pod-slice deployment is one call per
process. It cannot be exercised in a single-host CI (the driver's
``dryrun_multichip`` covers the sharding semantics on a virtual mesh); the
logic below is deliberately thin over jax.distributed for that reason.
"""

from __future__ import annotations

import jax


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Initialize the distributed runtime; returns a topology summary.

    With no arguments, defers to the environment (cluster runtimes
    that populate it); arguments override for manual bring-up.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return topology_summary()


def topology_summary() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": jax.device_count(),
        "platform": jax.default_backend(),
    }


def assert_same_across_hosts(value: float, name: str = "value") -> None:
    """Cross-host agreement check via pmax/pmin (exact — no reduction
    rounding; the earlier psum(v) == v*D spelling false-positived at 16
    devices, where a sequential f32 all-reduce rounds by ~D/2 ulps)."""
    from jax.sharding import Mesh, PartitionSpec as P

    if jax.process_count() == 1:
        return
    mesh = Mesh(jax.devices(), ("p",))
    # plain numpy input: multi-controller jit rejects a host-local jax.Array
    # (addressable by one process) against a mesh spanning all processes
    import numpy as np

    hi, lo = jax.shard_map(
        lambda a: (jax.lax.pmax(a, "p"), jax.lax.pmin(a, "p")),
        mesh=mesh,
        in_specs=P(),
        out_specs=(P(), P()),
    )(np.asarray([float(value)], dtype=np.float32))
    if float(hi[0]) != float(lo[0]):
        raise RuntimeError(
            f"{name} differs across hosts: max={float(hi[0])!r} "
            f"min={float(lo[0])!r}"
        )
