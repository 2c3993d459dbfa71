"""Mesh construction and sharding helpers.

The distributed layer the reference never had (SURVEY.md §2 parallelism
checklist: single-GPU only). Axis conventions:

- ``"t"`` — time/sequence axis: contiguous time-blocks of the sample stream,
  the cross-chip generalization of the reference's intra-GPU multi-block
  scan decomposition (hillis_steele_averager.cu:69-84). Scan carries and
  FIR halos ride this axis via collectives (NCCL over NVLink on GPUs).
- ``"ch"`` — channel/stream axis: embarrassingly parallel streams (the DP
  analog; BASELINE.json's 16-channel chain shards here).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TIME_AXIS = "t"
CHANNEL_AXIS = "ch"


def make_mesh(
    n_time: int | None = None, n_channel: int = 1, devices=None
) -> Mesh:
    """1-D or 2-D device mesh: (channel, time). Defaults to all devices on t."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_time is None:
        n_time = devices.size // n_channel
    if n_time * n_channel != devices.size:
        raise ValueError(
            f"mesh {n_channel}x{n_time} != {devices.size} devices"
        )
    return Mesh(
        devices.reshape(n_channel, n_time), (CHANNEL_AXIS, TIME_AXIS)
    )


def time_sharding(mesh: Mesh) -> NamedSharding:
    """Flat stream sharded into contiguous time blocks."""
    return NamedSharding(mesh, P(TIME_AXIS))


def planar_sharding(mesh: Mesh) -> NamedSharding:
    """(channels, time) planar signal: channels over ch, time over t."""
    return NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
