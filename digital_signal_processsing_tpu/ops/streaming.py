"""Stateful streaming: process unbounded streams chunk-by-chunk, exactly.

The reference processes one whole WAV per run; a production deployment
filters an unbounded stream in chunks. These ops carry explicit state
across chunks so the chunked output is bit-exact with processing the
concatenated stream in one shot — the same carry/halo math as the
multi-device layer (parallel/), applied across time instead of across chips.

All state is a pytree of arrays, so the step functions jit cleanly and can
be scanned (`jax.lax.scan`) over pre-chunked batches.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..utils.numerics import MAX_EXACT_WINDOW, trunc_div
from ..utils import layout
from ..utils.dispatch import record_choice


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MovingAverageState:
    """Carry for the streaming averager: the last window*channels raw
    samples (the causal halo) — zeros at stream start (gpu_utils.h:112-114's
    zeroed prefix, carried through time)."""

    tail: jax.Array  # (window*channels,) int16


def moving_average_init(window: int, channels: int = 1) -> MovingAverageState:
    layout.validate_window(window, MAX_EXACT_WINDOW)
    return MovingAverageState(tail=jnp.zeros((window * channels,), jnp.int16))


@functools.partial(jax.jit, static_argnames=("window", "channels"))
def moving_average_chunk(
    state: MovingAverageState,
    x: jax.Array,
    window: int,
    channels: int = 1,
) -> tuple[MovingAverageState, jax.Array]:
    """One chunk of the causal moving average (any whole-frame chunk length).

    Bit-exact with the one-shot op on the concatenated stream. Where the
    backend has the windowed GPU kernel it runs seeded with the carried
    halo; otherwise the XLA sliding recurrence below.
    """
    halo = window * channels
    n = x.shape[0]

    from .moving_average import auto_method
    from .pallas_windowed import windowed_average_pallas

    if n > 0 and auto_method(window, channels) == "windowed":
        record_choice("moving_average_chunk", "windowed")
        out = windowed_average_pallas(x, window, channels, seed=state.tail)
        new_tail = (
            x[n - halo :]
            if n >= halo
            else jnp.concatenate([state.tail[n:], x])
        )
        return MovingAverageState(tail=new_tail), out

    record_choice("moving_average_chunk", "xla_scan")
    ext = jnp.concatenate([state.tail, x])
    # sliding recurrence: window sums are the per-channel cumsum of the
    # difference signal d[i] = x[i] - x[i-halo], plus the carry-in sums
    d = (ext[halo:].astype(jnp.int32) - ext[:-halo].astype(jnp.int32)).reshape(
        -1, channels
    )
    # carry-in window sums: sums over the tail's last `window` frames
    tail_f = state.tail.astype(jnp.int32).reshape(-1, channels)
    wsum0 = jnp.sum(tail_f, axis=0)  # (C,): window sum just before chunk
    wsum = jnp.cumsum(d, axis=0) + wsum0[None, :]
    out = trunc_div(wsum, window).astype(jnp.int16).reshape(-1)
    new_tail = ext[n:]  # last halo samples of the extended stream
    return MovingAverageState(tail=new_tail), out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FirState:
    """Carry for streaming FIR: the last taps-1 input samples per channel."""

    tail: jax.Array  # (channels, taps-1) float32


def fir_init(num_taps: int, channels: int = 1) -> FirState:
    return FirState(tail=jnp.zeros((channels, max(num_taps - 1, 0)), jnp.float32))


@jax.jit
def fir_chunk(
    state: FirState, x: jax.Array, taps: jax.Array
) -> tuple[FirState, jax.Array]:
    """One chunk of a causal FIR over (channels, chunk_len) float32."""
    from .fir import fir_direct

    k = taps.shape[0]
    squeeze = x.ndim == 1
    xp = x[None, :] if squeeze else x
    if k > 1:
        ext = jnp.concatenate([state.tail, xp.astype(jnp.float32)], axis=-1)
        y = fir_direct(ext, taps)[..., k - 1 :]
        new_tail = ext[..., ext.shape[-1] - (k - 1) :]
    else:
        y = fir_direct(xp, taps)
        new_tail = state.tail
    return FirState(tail=new_tail), (y[0] if squeeze else y)


# --- streaming STFT / WOLA synthesis -------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StftState:
    """Carry for streaming analysis: the last nfft-hop input samples.

    Zero at stream start, so the streamed frame sequence equals the
    one-shot :func:`ops.fft.stft` of the stream PREFIXED with nfft-hop
    zeros (the standard real-time priming); dropping the first
    ``nfft//hop - 1`` frames recovers exact unprimed one-shot parity.
    """

    tail: jax.Array  # (channels, nfft - hop) float32


def stft_init(nfft: int, hop: int, channels: int = 1) -> StftState:
    if hop < 1 or nfft % hop != 0:
        raise ValueError(f"streaming stft needs hop | nfft, got {hop}/{nfft}")
    return StftState(tail=jnp.zeros((channels, nfft - hop), jnp.float32))


@functools.partial(jax.jit, static_argnames=("nfft", "hop", "window", "method"))
def stft_chunk(
    state: StftState,
    x: jax.Array,
    *,
    nfft: int = 1024,
    hop: int = 512,
    window: str = "sqrt_hann",
    method: str = "auto",
) -> tuple[StftState, jax.Array]:
    """One chunk of the streaming STFT: (channels, L) -> (channels,
    L//hop, nfft//2+1), L a multiple of hop (static frame count — the
    jit-friendly granularity contract; buffer ragged input host-side).
    """
    from .fft import stft

    squeeze = x.ndim == 1
    xp = (x[None, :] if squeeze else x).astype(jnp.float32)
    c, L = xp.shape
    if L % hop != 0 or L == 0:
        raise ValueError(
            f"chunk length {L} must be a nonzero multiple of hop {hop}"
        )
    ext = jnp.concatenate([state.tail, xp], axis=-1)
    out = stft(ext, nfft=nfft, hop=hop, window=window, method=method)
    new_tail = ext[..., L:]
    return StftState(tail=new_tail), (out[0] if squeeze else out)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class IstftState:
    """Carry for streaming WOLA synthesis: the not-yet-complete OLA tail
    (nfft - hop samples)."""

    tail: jax.Array  # (channels, nfft - hop) float32


def istft_init(nfft: int, hop: int, channels: int = 1) -> IstftState:
    if hop < 1 or nfft % hop != 0:
        raise ValueError(f"streaming istft needs hop | nfft, got {hop}/{nfft}")
    return IstftState(tail=jnp.zeros((channels, nfft - hop), jnp.float32))


@functools.partial(jax.jit, static_argnames=("nfft", "hop", "window", "method"))
def istft_chunk(
    state: IstftState,
    s: jax.Array,
    *,
    nfft: int = 1024,
    hop: int = 512,
    window: str = "sqrt_hann",
    method: str = "auto",
) -> tuple[IstftState, jax.Array]:
    """One chunk of WOLA synthesis: (channels, f, nfft//2+1) frames ->
    (channels, f*hop) fully-summed output samples.

    Concatenated chunk outputs + a final :func:`istft_flush` equal the
    one-shot :func:`ops.fft.istft` of the concatenated frames. With
    ``window='sqrt_hann'``, ``hop = nfft//2`` frames from
    :func:`stft_chunk`, the round trip reconstructs the input delayed by
    nfft - hop samples (the WOLA pipeline latency).
    """
    from .fft import _resolve_fft_method, _mxu_irfft, spectral_window
    import numpy as np

    squeeze = s.ndim == 2
    sp = s[None] if squeeze else s
    c, f, _ = sp.shape
    if f < 1:
        raise ValueError("need at least one frame per chunk")
    r = nfft // hop
    if _resolve_fft_method(method, nfft) == "mxu":
        time_frames = _mxu_irfft(sp, nfft)
    else:
        time_frames = jnp.fft.irfft(sp, n=nfft, axis=-1)
    frames = time_frames * jnp.asarray(spectral_window(window, nfft))
    parts = frames.reshape(c, f, r, hop)
    acc = jnp.zeros((c, f + r - 1, hop), jnp.float32)
    for i in range(r):
        acc = acc.at[:, i : i + f, :].add(parts[:, :, i, :])
    flat = acc.reshape(c, (f + r - 1) * hop)
    flat = flat.at[:, : nfft - hop].add(state.tail)
    out = flat[:, : f * hop]
    new_tail = flat[:, f * hop :]
    return IstftState(tail=new_tail), (out[0] if squeeze else out)


def istft_flush(state: IstftState) -> jax.Array:
    """The final nfft-hop OLA tail after the last chunk."""
    return state.tail
