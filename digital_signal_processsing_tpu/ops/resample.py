"""Polyphase resampling: decimate / interpolate / rational resample.

North-star stage (BASELINE.json: "polyphase decimate"). Shape: the
polyphase decomposition is a reshape — phase p of the signal is column p of
the (time/q, q) view — so each phase convolution is a batched conv and
no strided gathers survive to runtime.

Conventions match ops/fir.py: planar ``(channels, time)`` float32, causal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .fir import _as_planar, design_lowpass


@functools.partial(jax.jit, static_argnames=("factor",))
def _poly_decimate(x: jax.Array, taps: jax.Array, factor: int) -> jax.Array:
    """y[m] = sum_j h[j] x[m*q - j] — one lane-blocked decimating conv.

    The polyphase sum IS a strided conv; lane-blocking it (fir.py's
    blocked_causal_conv with ``stride=q``: output frames of 128 lanes,
    input frames of q*128) keeps the conv's output-feature dim full. A
    per-phase decomposition would issue q strided slices of the full
    stream (q-fold memory traffic), and a plain single-feature strided
    conv has an output-feature dim of 1.
    """
    from .fir import blocked_causal_conv

    return blocked_causal_conv(x, taps, stride=factor)


def decimate(
    x: jax.Array,
    factor: int,
    *,
    taps: jax.Array | np.ndarray | None = None,
    taps_per_phase: int = 8,
    ftype: str = "fir",
) -> jax.Array:
    """Anti-aliased downsampling by an integer factor.

    ``ftype='fir'`` (default): polyphase FIR — windowed-sinc lowpass at
    0.8/factor Nyquist with ``taps_per_phase * factor`` taps, one
    lane-blocked conv. ``ftype='iir'``: scipy.signal.decimate-style
    zero-phase Chebyshev-I cascade (ops/iir.decimate_iir) for chains ported
    from scipy; ``taps``/``taps_per_phase`` are FIR-only.
    """
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if ftype == "iir":
        if taps is not None:
            raise ValueError("taps is only meaningful with ftype='fir'")
        from .iir import decimate_iir

        return decimate_iir(x, factor)
    if ftype != "fir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    xp, squeeze = _as_planar(x)
    if factor == 1:
        y = xp.astype(jnp.float32)  # dtype-consistent with factor > 1
        return y[0] if squeeze else y
    if taps is None:
        taps = design_lowpass(taps_per_phase * factor, 0.8 / factor)
    y = _poly_decimate(xp.astype(jnp.float32), jnp.asarray(taps), factor)
    return y[0] if squeeze else y


@functools.partial(jax.jit, static_argnames=("factor",))
def _poly_interpolate(x: jax.Array, taps: jax.Array, factor: int) -> jax.Array:
    """Zero-stuff by `factor` then lowpass — one lane-blocked conv.

    fir.py's blocked_interp_conv folds the zero-stuffing into the banded
    tap matrix (output frames q*128 lanes from input frames of 128), keeping
    the conv dense; an lhs-dilated single-feature conv has one output
    feature, and a per-phase conv + interleave pays a q-fold
    stack/reshape round-trip.
    """
    from .fir import blocked_interp_conv

    return blocked_interp_conv(x, taps, up=factor)


def interpolate(
    x: jax.Array,
    factor: int,
    *,
    taps: jax.Array | np.ndarray | None = None,
    taps_per_phase: int = 8,
) -> jax.Array:
    """Anti-imaged upsampling by an integer factor (polyphase zero-stuff)."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    xp, squeeze = _as_planar(x)
    if factor == 1:
        y = xp.astype(jnp.float32)  # dtype-consistent with factor > 1
        return y[0] if squeeze else y
    if taps is None:
        # gain `factor` compensates the zero-stuffing energy loss
        taps = design_lowpass(taps_per_phase * factor, 0.8 / factor) * factor
    y = _poly_interpolate(xp.astype(jnp.float32), jnp.asarray(taps), factor)
    return y[0] if squeeze else y


def resample_poly(
    x: jax.Array,
    up: int,
    down: int,
    *,
    taps: jax.Array | np.ndarray | None = None,
    taps_per_phase: int = 8,
) -> jax.Array:
    """Rational-rate resample by up/down with ONE combined filter.

    scipy.signal.resample_poly semantics: a single lowpass at the tighter
    of the anti-image/anti-alias cutoffs (min(1/up, 1/down) of Nyquist),
    gain-compensated by ``up`` for the zero-stuffing energy loss, applied
    once — never once per stage (double-filtering squares the response).
    """
    if up < 1 or down < 1:
        raise ValueError(f"up/down must be >= 1, got {up}/{down}")
    g = np.gcd(up, down)
    up, down = up // g, down // g
    xp, squeeze = _as_planar(x)
    xp = xp.astype(jnp.float32)
    if up == 1 and down == 1:
        return xp[0] if squeeze else xp
    q = max(up, down)
    if taps is None:
        taps = design_lowpass(taps_per_phase * q, 0.8 / q)
    taps = jnp.asarray(taps, jnp.float32)
    if up > 1:
        y = _poly_interpolate(xp, taps * up, up)
        if down > 1:
            y = y[:, ::down]  # the combined filter already anti-aliased
    else:
        y = _poly_decimate(xp, taps, down)
    return y[0] if squeeze else y


@functools.partial(jax.jit, static_argnames=("num",))
def resample_fft(x: jax.Array, num: int) -> jax.Array:
    """Fourier-domain resampling to exactly ``num`` samples
    (scipy.signal.resample, real input, no window).

    Truncates or zero-extends the one-sided spectrum, with scipy's
    Nyquist-bin bookkeeping (doubled when downsampling drops its conjugate
    half, halved when upsampling splits it). Assumes the signal is
    periodic like scipy does; use :func:`resample_poly` / Farrow for
    streaming or non-periodic data.
    """
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    xp, squeeze = _as_planar(x)
    c, t = xp.shape
    X = jnp.fft.rfft(xp.astype(jnp.float32), axis=-1)
    n = min(num, t)
    nyq = n // 2 + 1
    Y = jnp.zeros((c, num // 2 + 1), X.dtype)
    Y = Y.at[:, :nyq].set(X[:, :nyq])
    if n % 2 == 0:
        if num < t:
            Y = Y.at[:, n // 2].multiply(2.0)
        elif num > t:
            Y = Y.at[:, n // 2].multiply(0.5)
    y = jnp.fft.irfft(Y, n=num, axis=-1) * (num / t)
    return y[0] if squeeze else y


@functools.partial(jax.jit, static_argnames=("up", "down"))
def upfirdn(
    h: jax.Array | np.ndarray, x: jax.Array, up: int = 1, down: int = 1
) -> jax.Array:
    """Zero-stuff by ``up``, FIR filter by ``h``, keep every ``down``-th
    sample (scipy.signal.upfirdn semantics + output length).

    Spelling: the zero-stuffing rides :func:`ops.fir.blocked_interp_conv`'s
    banded tap matrix (dense frames; an lhs-dilated conv would have one
    output feature), and the decimation is a strided slice of the full
    conv — XLA folds it into the output gather.
    """
    if up < 1 or down < 1:
        raise ValueError(f"up/down must be >= 1, got {up}/{down}")
    from .fir import blocked_causal_conv, blocked_interp_conv

    taps = jnp.asarray(h, jnp.float32)
    if taps.ndim != 1:
        raise ValueError(f"h must be 1-D taps, got shape {taps.shape}")
    xp, squeeze = _as_planar(x)
    xp = xp.astype(jnp.float32)
    t, k = xp.shape[-1], taps.shape[0]
    n_full = (t - 1) * up + k  # full conv length of the zero-stuffed stream
    # right-pad so the causal blocked conv covers the full-conv tail
    extra = -(-(k - 1) // up) if up > 1 else k - 1
    xpad = jnp.pad(xp, ((0, 0), (0, extra)))
    if up > 1:
        y = blocked_interp_conv(xpad, taps, up=up)
    else:
        y = blocked_causal_conv(xpad, taps)
    y = y[..., :n_full][..., ::down]
    return y[0] if squeeze else y
