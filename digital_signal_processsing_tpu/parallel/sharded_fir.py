"""Time-sharded FIR via overlap-save halo exchange.

The distributed generalization of overlap-save: each device filters its
contiguous time block after receiving the last ``k-1`` samples of its left
neighbor via one ``ppermute`` (device 0 receives zeros — causal startup).
The chunk boundary math is identical to ops/fir.py's block decomposition,
lifted one level from blocks to mesh shards; channels shard over the
``ch`` axis untouched (embarrassingly parallel).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import numpy as np

from .mesh import CHANNEL_AXIS, TIME_AXIS
from ..ops.fir import fir_direct, fir_filter, fir_overlap_save


def _shard_body(xs: jax.Array, taps: jax.Array, *, method: str) -> jax.Array:
    k = taps.shape[0]
    ndev = jax.lax.axis_size(TIME_AXIS)
    if k > 1:
        halo = jax.lax.ppermute(
            xs[..., -(k - 1) :],
            TIME_AXIS,
            perm=[(d, d + 1) for d in range(ndev - 1)],
        )
        ext = jnp.concatenate([halo, xs], axis=-1)
    else:
        ext = xs
    if method == "direct":
        y = fir_direct(ext, taps)
    elif method == "auto":
        # the single-device ladder (direct below the crossover,
        # overlap-save above it)
        y = fir_filter(ext, taps, method="auto")
    else:
        y = fir_overlap_save(ext, taps)
    return y[..., (k - 1 if k > 1 else 0) :]


@functools.lru_cache(maxsize=64)
def _cached_auto_fn(mesh: Mesh, flat: bool, taps_key: bytes, dtype_str: str):
    """Jitted shard_map whose body closes over CONCRETE taps.

    Passing taps through the jit boundary makes them a tracer inside the
    shard, which forces fir_filter's auto ladder off the fused overlap-
    save kernel (it bakes the frequency response as a constant). Closing
    over the numpy taps keeps them static — each distinct taps value
    compiles once (the cache key is the raw bytes).
    """
    taps_np = np.frombuffer(taps_key, dtype=dtype_str)
    spec = P(TIME_AXIS) if flat else P(CHANNEL_AXIS, TIME_AXIS)

    def body(xs):
        # numpy (not jnp) so shard_map's closure lifting cannot turn the
        # taps into a tracer — fir_filter's auto ladder sees them static
        # and the fused kernel (baked frequency response) stays reachable
        return _shard_body(xs, taps_np, method="auto")

    return jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(spec,),
            out_specs=spec,
            check_vma=False,  # pallas_call outputs carry no vma annotation
        )
    )


def sharded_fir_filter(
    x: jax.Array,
    taps: jax.Array,
    *,
    mesh: Mesh,
    method: str = "auto",
) -> jax.Array:
    """Causal FIR of a (channels, time) signal sharded (ch, t) over the mesh.

    Requires taps length - 1 <= one time shard (single-hop halo).

    ``method='auto'`` (default) runs each shard through the single-device
    :func:`fir_filter` ladder — direct below the crossover, overlap-save
    above it; 'direct'/'overlap_save' pin one spelling.
    """
    k = int(taps.shape[0])
    t = x.shape[-1]
    ndev = mesh.shape[TIME_AXIS]
    if t % ndev != 0:
        raise ValueError(f"time length {t} not divisible by {ndev} shards")
    if k - 1 > t // ndev:
        raise ValueError(
            f"taps-1 = {k - 1} exceeds one time shard ({t // ndev})"
        )
    if method == "auto" and not isinstance(taps, jax.core.Tracer):
        taps_np = np.ascontiguousarray(np.asarray(taps))
        return _cached_auto_fn(
            mesh, x.ndim == 1, taps_np.tobytes(), str(taps_np.dtype)
        )(x)
    return _sharded_fir_jit(x, jnp.asarray(taps), mesh=mesh, method=method)


@functools.partial(jax.jit, static_argnames=("mesh", "method"))
def _sharded_fir_jit(
    x: jax.Array, taps: jax.Array, *, mesh: Mesh, method: str
) -> jax.Array:
    if x.ndim == 1:
        spec = P(TIME_AXIS)
    else:
        spec = P(CHANNEL_AXIS, TIME_AXIS)
    fn = jax.shard_map(
        functools.partial(_shard_body, method=method),
        mesh=mesh,
        in_specs=(spec, P()),
        out_specs=spec,
    )
    return fn(x, taps)
