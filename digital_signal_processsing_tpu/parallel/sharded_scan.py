"""Time-block-sharded scan averager: the reference's carry tree across devices.

The reference splits the sequence across thread blocks and propagates
carries through a recursive aux-scan + uniform_add relaunch tree
(hillis_steele_averager.cu:69-84, blelloch_scan_averager.cu:134-167). Across
chips the same decomposition needs exactly ONE collective round:

  1. each device scans its contiguous time block locally (the fused Pallas
     kernel or the XLA anchor — both per-channel segmented, int32 modular);
  2. per-channel block totals combine into each device's exclusive prefix
     — the cross-chip ``uniform_add``. Default since round 5: a log2(D)
     ppermute doubling ladder (:func:`_carry_exclusive`), the reference's
     recursive carry tree lifted onto the device axis; the one-round
     ``all_gather`` spelling stays as ``carry_impl='allgather'``;
  3. the windowed difference needs ``cum[i - k*C]`` which may live on the
     left neighbor: one ``ppermute`` pushes each device's cumsum tail one
     step right (device 0 receives the zeros ppermute defines — the
     reference's zeroed halo, gpu_utils.h:112-114, falling out of collective
     semantics).

All collectives ride the mesh's time axis (NVLink between GPUs); payloads are
C + k*C int32 words per device — independent of the stream length.

That three-step decomposition is kept as ``method='scan'`` (the reference's
carry-tree analog). The default ``method='windowed'`` goes further: the
windowed averager needs no global cumsum at all, so the only communication
is ONE right-shift ``ppermute`` of each shard's trailing ``k*C`` raw int16
samples, the seed of the neighbour's local averager. Under ``shard_map``
on GPUs the ``ppermute`` lowers to NCCL.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.numerics import MAX_EXACT_WINDOW, trunc_div
from ..utils import layout
from .mesh import TIME_AXIS


def _local_cumsum(xs: jax.Array, channels: int) -> jax.Array:
    frames = xs.shape[0] // channels
    return jnp.cumsum(
        xs.reshape(frames, channels).astype(jnp.int32), axis=0
    ).reshape(-1)


def _carry_exclusive(
    totals: jax.Array, axis: str, impl: str = "ladder"
) -> jax.Array:
    """Exclusive per-channel prefix of per-device block totals.

    ``impl='ladder'`` (default, round 5): a log2(D) ppermute doubling
    ladder — the reference's recursive carry tree
    (hillis_steele_averager.cu:69-84) lifted onto the device axis. Each
    round shifts partial sums right by doubling strides (missing sources
    deliver ppermute's zeros), giving the INCLUSIVE prefix in ceil(log2 D)
    dependent collective steps; subtracting the local total makes it
    exclusive (int32 modular arithmetic — exact). Its critical path is
    log-depth in the device count.

    ``impl='allgather'``: the r2-r4 one-round spelling, kept as the
    parity anchor.
    """
    if impl == "allgather":
        gathered = jax.lax.all_gather(totals, axis)  # (D, C)
        my = jax.lax.axis_index(axis)
        dev_ids = jnp.arange(jax.lax.axis_size(axis))[:, None]
        return jnp.sum(jnp.where(dev_ids < my, gathered, 0), axis=0)
    if impl != "ladder":
        raise ValueError(
            f"unknown carry_impl {impl!r}; options ('ladder', 'allgather')"
        )
    ndev = jax.lax.axis_size(axis)
    acc = totals
    shift = 1
    while shift < ndev:
        recv = jax.lax.ppermute(
            acc, axis, perm=[(d, d + shift) for d in range(ndev - shift)]
        )
        acc = acc + recv
        shift *= 2
    return acc - totals  # inclusive -> exclusive


def _shard_body(
    xs: jax.Array,
    *,
    window: int,
    channels: int,
    axis: str,
    carry_impl: str = "ladder",
) -> jax.Array:
    n_loc = xs.shape[0]
    halo = window * channels
    cum = _local_cumsum(xs, channels)

    # cross-chip uniform_add: exclusive prefix of per-device channel totals
    totals = cum[n_loc - channels :]  # (C,) last frame's per-channel cumsum
    ndev = jax.lax.axis_size(axis)
    carry = _carry_exclusive(totals, axis, carry_impl)  # (C,)
    cum = (cum.reshape(-1, channels) + carry[None, :]).reshape(-1)

    # halo exchange: last `halo` cumsum values -> right neighbor
    tail = cum[n_loc - halo :]
    left_tail = jax.lax.ppermute(
        tail, axis, perm=[(d, d + 1) for d in range(ndev - 1)]
    )  # device 0 gets zeros: the causal zero halo
    ext = jnp.concatenate([left_tail, cum])  # (halo + n_loc,)
    shifted = ext[:n_loc]  # shifted[i] = cum_global[i - halo]
    wsum = cum - shifted
    return trunc_div(wsum, window).astype(jnp.int16)


def _shard_body_windowed(
    xs: jax.Array, *, window: int, channels: int, axis: str
) -> jax.Array:
    """Carry-free sharded averager: ONE raw-sample halo ppermute.

    The windowed averager never needs a global cumsum: each shard only
    needs the ``window * channels`` raw samples that precede it. So the
    reference's whole cross-block carry machinery (aux-scan + uniform_add,
    hillis_steele_averager.cu:69-84) reduces to a single right-shift
    ppermute of int16 samples; device 0 receives ppermute's zeros = the
    causal zero halo (gpu_utils.h:112-114). The shard then runs the
    streaming chunk op seeded with that halo, which takes the windowed GPU
    kernel where the backend has it.
    """
    from ..ops.streaming import MovingAverageState, moving_average_chunk

    h = window * channels
    ndev = jax.lax.axis_size(axis)
    tail = xs[xs.shape[0] - h :]
    left = jax.lax.ppermute(tail, axis, perm=[(d, d + 1) for d in range(ndev - 1)])
    _, out = moving_average_chunk(MovingAverageState(tail=left), xs, window, channels)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("window", "channels", "mesh", "method", "carry_impl"),
)
def sharded_moving_average(
    x: jax.Array,
    window: int,
    channels: int = 1,
    *,
    mesh: Mesh,
    method: str = "windowed",
    carry_impl: str = "ladder",
) -> jax.Array:
    """Causal moving average of a time-block-sharded interleaved stream.

    ``x`` length must divide evenly into mesh-time-axis shards of whole
    frames, and ``window*channels`` must fit in one shard (single-hop halo).
    Bit-exact against the golden model for window <= 65535.

    ``method='windowed'`` (default) exchanges a raw int16 halo and runs the
    seeded local averager. ``method='scan'`` keeps the explicit cumsum +
    carry + cumsum-tail halo decomposition (the reference's carry-tree
    analog).

    An int32 ``x`` is the packed little-endian pair view of the int16
    stream (io/dataset.py packed loaders); it is unpacked on the device and
    the output returned in the same view.
    """
    layout.validate_window(window, MAX_EXACT_WINDOW)
    if method not in ("windowed", "scan"):
        raise ValueError(f"unknown method {method!r}; options: windowed, scan")
    ndev = mesh.shape[TIME_AXIS]
    if x.dtype == jnp.int32:
        x16 = jax.lax.bitcast_convert_type(x, jnp.int16).reshape(-1)
        y16 = sharded_moving_average(
            x16, window, channels, mesh=mesh, method=method, carry_impl=carry_impl
        )
        return jax.lax.bitcast_convert_type(y16.reshape(-1, 2), jnp.int32)
    n = x.shape[0]
    if n % (ndev * channels) != 0:
        raise ValueError(
            f"stream length {n} must divide into {ndev} shards of whole "
            f"frames of {channels} channels"
        )
    if window * channels > n // ndev:
        raise ValueError(
            f"window*channels = {window * channels} exceeds one shard "
            f"({n // ndev}); halo exchange is single-hop"
        )
    if method == "windowed":
        body = functools.partial(
            _shard_body_windowed, window=window, channels=channels, axis=TIME_AXIS
        )
    else:
        body = functools.partial(
            _shard_body,
            window=window,
            channels=channels,
            axis=TIME_AXIS,
            carry_impl=carry_impl,
        )
    spec = P(TIME_AXIS)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=spec,
        out_specs=spec,
        check_vma=False,  # pallas_call outputs carry no vma annotation
    )(x)


@functools.partial(jax.jit, static_argnames=("channels", "mesh", "carry_impl"))
def sharded_cumsum(
    x: jax.Array,
    channels: int = 1,
    *,
    mesh: Mesh,
    carry_impl: str = "ladder",
) -> jax.Array:
    """Per-channel int32 modular cumsum of a time-block-sharded stream."""

    def body(xs):
        n_loc = xs.shape[0]
        cum = _local_cumsum(xs, channels)
        totals = cum[n_loc - channels :]
        carry = _carry_exclusive(totals, TIME_AXIS, carry_impl)
        return (cum.reshape(-1, channels) + carry[None, :]).reshape(-1)

    spec = P(TIME_AXIS)
    return jax.shard_map(
        body, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False
    )(x)
