"""Layout / padding helpers — the DspWorkspace analog.

The reference's ``DspWorkspace`` (gpu_utils.h:67-160) solves three problems
with device-side buffer arithmetic: a zeroed *halo prefix* so causal windows
may read "before" sample 0, tail alignment to the vector-load width, and
scan-scratch sizing for the recursive carry tree. Here all three collapse
into shape arithmetic done once at trace time:

- the halo prefix becomes a masked select (``where(i >= k*C, cum[i-k*C], 0)``)
  or an explicit zero-pad — no allocation tricks;
- vector alignment becomes masked loads of whole power-of-two tiles,
  which also subsumes the int2/int4 alignment ladder (gpu_utils.h:133-140);
- scan scratch is a carry held in registers — the recursive aux-buffer
  sizing (gpu_utils.h:142-151) has no analog.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (alignUp, gpu_utils.h:127-131)."""
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def interleaved_frames(num_samples: int, channels: int) -> int:
    """Number of complete interleaved frames in a flat stream."""
    if channels <= 0:
        raise ValueError(f"channels must be positive, got {channels}")
    if num_samples % channels != 0:
        raise ValueError(
            f"stream length {num_samples} is not a multiple of channels {channels}"
        )
    return num_samples // channels


def validate_window(window: int, max_window: int | None = None) -> None:
    from .numerics import MAX_EXACT_WINDOW

    bound = MAX_EXACT_WINDOW if max_window is None else max_window
    if not (1 <= window <= bound):
        raise ValueError(
            f"window must be in [1, {bound}] for exact int32 modular scans, "
            f"got {window}"
        )


def overlapping_frames(x, num_frames: int, hop: int, frame_len: int):
    """Overlapping frames of the last axis WITHOUT a gather.

    frame i = x[..., i*hop : i*hop + frame_len]. A direct index-matrix
    gather is slow on some backends; instead build ceil(frame_len/hop) shifted contiguous
    views, each a pure reshape, and concatenate:

        part_j[..., i, :] = x[..., (i+j)*hop : (i+j+1)*hop]

    so concat_j(part_j)[..., i, :frame_len] is frame i. Requires
    x.shape[-1] >= (num_frames + ceil(frame_len/hop) - 1) * hop (caller
    pads; the tail garbage past frame_len is sliced off).
    """
    parts = []
    j_max = cdiv(frame_len, hop)
    need = (num_frames + j_max - 1) * hop
    if x.shape[-1] < need:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, need - x.shape[-1])]
        x = jnp.pad(x, pad)
    for j in range(j_max):
        view = x[..., j * hop : (j + num_frames) * hop]
        parts.append(view.reshape(*x.shape[:-1], num_frames, hop))
    return jnp.concatenate(parts, axis=-1)[..., :frame_len]


def as_numpy_int16(x) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype != np.int16:
        raise TypeError(f"expected int16 samples, got {x.dtype}")
    return x
