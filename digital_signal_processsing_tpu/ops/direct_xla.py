"""XLA-lowered direct averager — the naive-parallel baseline, compiler-scheduled.

The second correctness anchor (beside scan_xla): expresses the O(N·k) direct
window sum as ``lax.reduce_window`` over the frames axis and lets XLA pick
the schedule. Analog of profilable_parallel_averager.cu:13-23 the way a JAX
programmer would first write it — no kernel, no tiling decisions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.numerics import trunc_div


@functools.partial(jax.jit, static_argnames=("window", "channels"))
def moving_average_reduce_window(
    x: jax.Array, window: int, channels: int = 1
) -> jax.Array:
    """Causal box sum via reduce_window on the (frames, channels) view."""
    frames = x.shape[0] // channels
    xi = x.reshape(frames, channels).astype(jnp.int32)
    wsum = jax.lax.reduce_window(
        xi,
        jnp.int32(0),
        jax.lax.add,
        window_dimensions=(window, 1),
        window_strides=(1, 1),
        padding=((window - 1, 0), (0, 0)),  # causal: zeros before frame 0
    )
    return trunc_div(wsum, window).astype(jnp.int16).reshape(-1)
