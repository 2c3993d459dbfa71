"""Mesh sharding for the round-3 time-varying / LPC surface.

Both ops are embarrassingly parallel over their stream axis (per-channel
coefficient schedules, per-stream LPC frames), so the sharded spelling is
a pure ``shard_map`` over the ``ch`` mesh axis with NO collectives — the
value is the wiring: coefficients shard (or replicate) consistently with
the signal, and the result is bit-equal to the unsharded op because each
device runs the identical computation on its slice.
"""

from __future__ import annotations

import jax
from jax.sharding import PartitionSpec as P
from .mesh import CHANNEL_AXIS


def sharded_sosfilt_tv(sos_t, x, *, mesh):
    """:func:`ops.iir.sosfilt_tv` with channels sharded over ``ch``.

    ``x``: (C, T); ``sos_t``: (S, T, 6) (replicated — shared schedule) or
    (S, C, T, 6) (sharded with the channels). C must divide by the mesh's
    channel-axis size.
    """
    from ..ops import iir

    if x.ndim != 2:
        raise ValueError(f"expected (channels, time), got shape {x.shape}")
    if sos_t.ndim == 3:
        sos_spec = P(None, None, None)
    elif sos_t.ndim == 4:
        sos_spec = P(None, CHANNEL_AXIS, None, None)
    else:
        raise ValueError("sos_t must be (S, T, 6) or (S, C, T, 6)")

    fn = jax.shard_map(
        iir.sosfilt_tv,
        mesh=mesh,
        in_specs=(sos_spec, P(CHANNEL_AXIS, None)),
        out_specs=P(CHANNEL_AXIS, None),
        check_vma=False,
    )
    return fn(sos_t, x)


def sharded_lpc_synthesis(a, gain, excitation, frame_len: int, *, mesh):
    """:func:`ops.lpc.lpc_synthesis` with the leading stream axis sharded
    over ``ch`` (the frame-parallel passes run per device slice)."""
    from ..ops import lpc

    fn = jax.shard_map(
        lambda aa, gg, ee: lpc.lpc_synthesis(aa, gg, ee, frame_len),
        mesh=mesh,
        in_specs=(
            P(CHANNEL_AXIS, None, None),
            P(CHANNEL_AXIS, None),
            P(CHANNEL_AXIS, None),
        ),
        out_specs=P(CHANNEL_AXIS, None),
        check_vma=False,
    )
    return fn(a, gain, excitation)


__all__ = ["sharded_sosfilt_tv", "sharded_lpc_synthesis"]
