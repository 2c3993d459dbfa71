"""Phase vocoder: time stretching and pitch shifting on the STFT engine.

North-star audio scope (the CUDA reference has no time-frequency
modification; SURVEY.md §2) — the classic Flanagan/Dolson phase vocoder,
built as batched array ops:

- analysis/synthesis ride :func:`ops.fft.stft`/:func:`istft`;
- phase propagation is fully BATCHED: the per-bin instantaneous
  frequency comes from wrapped frame-to-frame phase differences
  (elementwise), and the synthesis phase ramp is one ``jnp.cumsum`` over
  the frame axis — no sequential Python loop, no scan;
- the synthesis hop is fixed at ``nfft // 4`` (COLA-exact for the
  sqrt-hann pair at 4x overlap) and the ANALYSIS hop is quantized to
  ``round(hs * rate)``, so any rate maps onto one compiled program per
  (nfft, hop) structure. Exact arbitrary output lengths compose with
  the resamplers (``ops.resample`` / ``ops.farrow``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .fft import istft, stft

__all__ = [
    "time_stretch",
    "pitch_shift",
    "TimeStretchState",
    "time_stretch_init",
    "time_stretch_chunk",
    "time_stretch_flush",
    "spectral_subtract",
]


def _princarg(p: jax.Array) -> jax.Array:
    """Wrap phase to (-pi, pi]."""
    two_pi = 2.0 * np.pi
    return p - two_pi * jnp.round(p / two_pi)


def time_stretch(
    x: jax.Array,
    rate: float,
    *,
    nfft: int = 2048,
    window: str = "sqrt_hann",
) -> jax.Array:
    """Change duration without changing pitch: output lasts ~1/rate times
    the input (rate > 1 compresses, rate < 1 stretches).

    (..., T) real -> (..., T_out) float32; T_out = (frames-1)*nfft//4
    + nfft with frames = (T - nfft)//round(nfft/4*rate) + 1. The
    effective rate is quantized to hs/ha (hs = nfft//4, ha = the rounded
    analysis hop); compose with the resamplers for exact ratios.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if window != "sqrt_hann":
        # the fixed 2*hs/nfft OLA normalization below is the sqrt-hann
        # pair's COLA constant; other windows would silently mis-scale
        raise ValueError("time_stretch supports window='sqrt_hann' only")
    hs = nfft // 4
    ha = max(1, int(round(hs * rate)))
    xp = jnp.asarray(x, jnp.float32)
    if xp.shape[-1] < nfft + ha:
        raise ValueError(
            f"input too short: need at least nfft+ha = {nfft + ha} samples,"
            f" got {xp.shape[-1]}"
        )
    s = stft(xp, nfft=nfft, hop=ha, window=window)  # (..., F, K)
    mag = jnp.abs(s)
    ph = jnp.angle(s)
    k = np.arange(nfft // 2 + 1)
    wk = jnp.asarray(2.0 * np.pi * k / nfft, jnp.float32)  # rad/sample
    # heterodyned phase increment -> per-bin instantaneous frequency
    dph = ph[..., 1:, :] - ph[..., :-1, :] - wk * ha
    inst = wk + _princarg(dph) / ha  # rad/sample, frames-1 entries
    # synthesis phases: phi[0] = ph[0]; phi[t] = phi[t-1] + hs*inst[t]
    phs = jnp.concatenate(
        [ph[..., :1, :], ph[..., :1, :] + jnp.cumsum(hs * inst, axis=-2)],
        axis=-2,
    )
    # lax.complex, not a 1j literal (unimplemented on the target platform)
    y = istft(
        jax.lax.complex(mag * jnp.cos(phs), mag * jnp.sin(phs)),
        nfft=nfft,
        hop=hs,
        window=window,
    )
    # sqrt-hann analysis x synthesis overlap-adds to nfft/(2*hs) at this hop
    return y * (2.0 * hs / nfft)


def pitch_shift(
    x: jax.Array,
    factor: float,
    *,
    nfft: int = 2048,
    window: str = "sqrt_hann",
    resample_method: str = "auto",
) -> jax.Array:
    """Scale pitch by ``factor`` (2.0 = up one octave) at ~constant
    duration: time-stretch by 1/factor, then resample by 1/factor
    (``ops.resample.resample_farrow`` — the banded-matmul Farrow)."""
    if factor <= 0:
        raise ValueError(f"factor must be positive, got {factor}")
    from .farrow import resample_farrow

    stretched = time_stretch(x, 1.0 / factor, nfft=nfft, window=window)
    return resample_farrow(stretched, 1.0 / factor, method=resample_method)


# ---------------------------------------------------------------------------
# Streaming form: carried STFT tail + phase chain + WOLA tail, so an
# unbounded stream time-stretches chunk-by-chunk (ops/streaming.py doctrine:
# explicit pytree state, jit-clean step). Chunked output matches the
# one-shot time_stretch of the concatenated stream to f32 rounding (the
# synthesis-phase cumsum re-associates at chunk boundaries).

import dataclasses
import functools


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TimeStretchState:
    """Carry: analysis STFT tail, WOLA synthesis tail, the previous
    frame's analysis/synthesis phases, and a started flag (the stream's
    first frame passes its analysis phase through)."""

    stft_tail: jax.Array  # (C, nfft - ha) float32
    ola_tail: jax.Array  # (C, nfft - hs) float32
    prev_ph: jax.Array  # (C, K) float32
    prev_synth: jax.Array  # (C, K) float32
    started: jax.Array  # () bool


def _vocoder_hops(nfft: int, rate: float) -> tuple[int, int]:
    hs = nfft // 4
    return max(1, int(round(hs * rate))), hs


def time_stretch_init(
    rate: float, *, nfft: int = 2048, channels: int = 1
) -> TimeStretchState:
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    ha, hs = _vocoder_hops(nfft, rate)
    k = nfft // 2 + 1
    return TimeStretchState(
        stft_tail=jnp.zeros((channels, nfft - ha), jnp.float32),
        ola_tail=jnp.zeros((channels, nfft - hs), jnp.float32),
        prev_ph=jnp.zeros((channels, k), jnp.float32),
        prev_synth=jnp.zeros((channels, k), jnp.float32),
        started=jnp.asarray(False),
    )


@functools.partial(jax.jit, static_argnames=("rate", "nfft"))
def time_stretch_chunk(
    state: TimeStretchState,
    x: jax.Array,
    *,
    rate: float,
    nfft: int = 2048,
) -> tuple[TimeStretchState, jax.Array]:
    """One chunk: (C, L) -> (C, L//ha * hs) stretched samples, L a nonzero
    multiple of the analysis hop ha = round(nfft//4 * rate). Stream tail:
    :func:`ops.streaming.istft_flush` semantics via ``state.ola_tail``.
    """
    from .streaming import (
        IstftState,
        StftState,
        istft_chunk,
        stft_chunk,
    )

    ha, hs = _vocoder_hops(nfft, rate)
    squeeze = x.ndim == 1
    xp = (x[None, :] if squeeze else x).astype(jnp.float32)
    st, s = stft_chunk(
        StftState(tail=state.stft_tail), xp, nfft=nfft, hop=ha,
        window="sqrt_hann",
    )
    mag = jnp.abs(s)  # (C, F, K)
    ph = jnp.angle(s)
    k = np.arange(nfft // 2 + 1)
    wk = jnp.asarray(2.0 * np.pi * k / nfft, jnp.float32)
    ph_chain = jnp.concatenate([state.prev_ph[:, None, :], ph], axis=1)
    dph = ph_chain[:, 1:, :] - ph_chain[:, :-1, :] - wk * ha
    inst = wk + _princarg(dph) / ha
    cum = jnp.cumsum(hs * inst, axis=1)
    started = state.prev_synth[:, None, :] + cum
    fresh = ph[:, :1, :] + (cum - cum[:, :1, :])
    synth = jnp.where(state.started, started, fresh)
    ist, y = istft_chunk(
        IstftState(tail=state.ola_tail),
        jax.lax.complex(mag * jnp.cos(synth), mag * jnp.sin(synth)),
        nfft=nfft,
        hop=hs,
        window="sqrt_hann",
    )
    y = y * (2.0 * hs / nfft)
    new = TimeStretchState(
        stft_tail=st.tail,
        ola_tail=ist.tail,
        prev_ph=ph[:, -1, :],
        prev_synth=synth[:, -1, :],
        started=jnp.asarray(True),
    )
    return new, (y[0] if squeeze else y)


def time_stretch_flush(state: TimeStretchState) -> jax.Array:
    """The final WOLA tail, scaled like the chunk outputs (2*hs/nfft = 1/2
    at the fixed 4x-overlap synthesis hop)."""
    return state.ola_tail * 0.5


def spectral_subtract(
    x: jax.Array,
    *,
    nfft: int = 1024,
    noise_frames: int = 8,
    noise_psd: jax.Array | None = None,
    oversubtract: float = 2.0,
    floor: float = 0.05,
) -> jax.Array:
    """Classic magnitude spectral subtraction (Boll/Berouti) on the STFT
    engine: estimate the noise magnitude from the first ``noise_frames``
    frames (or take ``noise_psd`` of shape (nfft//2+1,) directly),
    subtract ``oversubtract`` times it from every frame's magnitude with a
    ``floor``-scaled spectral floor, and resynthesize with the original
    phases. Fully batched — the gain mask is elementwise over the whole
    (..., frames, bins) STFT at once. Output keeps the input's length
    contract of :func:`ops.fft.istft` at 50% overlap.
    """
    if not 0.0 <= floor < 1.0:
        raise ValueError(f"floor must be in [0, 1), got {floor}")
    hop = nfft // 2
    xp = jnp.asarray(x, jnp.float32)
    s = stft(xp, nfft=nfft, hop=hop, window="sqrt_hann")
    mag = jnp.abs(s)
    if noise_psd is None:
        if s.shape[-2] <= noise_frames:
            raise ValueError(
                f"need more than noise_frames={noise_frames} frames,"
                f" got {s.shape[-2]}"
            )
        noise = jnp.mean(mag[..., :noise_frames, :], axis=-2, keepdims=True)
    else:
        noise = jnp.asarray(noise_psd, jnp.float32)[None, :]
    cleaned = jnp.maximum(mag - oversubtract * noise, floor * mag)
    # keep the noisy phase: scale the complex frames by the magnitude gain
    gain = cleaned / jnp.maximum(mag, 1e-30)
    return istft(s * gain, nfft=nfft, hop=hop, window="sqrt_hann")
