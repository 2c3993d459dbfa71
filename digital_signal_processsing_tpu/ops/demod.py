"""Demodulators: FM (quadrature discriminator), AM envelope, frequency xlate.

North-star stage (BASELINE.json: "FM demod"). Pure VPU elementwise math —
XLA fuses the whole discriminator into its producers, so these never need a
hand kernel. Complex baseband convention: planar ``(channels, time)``
complex64 (or a float32 I/Q pair).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _to_c64(x: jax.Array) -> jax.Array:
    """float -> complex64 without complex constants (PJRT-portable)."""
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return x.astype(jnp.complex64)
    xf = x.astype(jnp.float32)
    return jax.lax.complex(xf, jnp.zeros_like(xf))


@jax.jit
def fm_demodulate(iq: jax.Array, gain: float = 1.0) -> jax.Array:
    """Quadrature discriminator: angle(z[n] * conj(z[n-1])) * gain.

    The instantaneous frequency of the complex baseband, in radians/sample;
    the first output sample is 0 (prev is zero-padded: angle(z*conj(0)) =
    atan2(0,0) = 0 — the same zero-history convention as every causal stage,
    which keeps time-sharded halos consistent with the unsharded chain).
    """
    z = _to_c64(iq)
    prev = jnp.pad(z[..., :-1], [(0, 0)] * (z.ndim - 1) + [(1, 0)])
    d = z * jnp.conj(prev)
    return jnp.arctan2(jnp.imag(d), jnp.real(d)).astype(jnp.float32) * gain


@jax.jit
def am_demodulate(iq: jax.Array) -> jax.Array:
    """Envelope detector: |z| with the DC carrier removed per channel."""
    env = jnp.abs(_to_c64(iq)).astype(jnp.float32)
    return env - jnp.mean(env, axis=-1, keepdims=True)


def _frac_mul_int(f: jax.Array, n: jax.Array) -> jax.Array:
    """frac(f * n) computed EXACTLY in float32, for integer n >= 0.

    Naive ``f * n`` loses the phase entirely once f*n outgrows the 24-bit
    mantissa (0.4 cyc/sample at n = 4M is ~0.1 cycle of error). Split both
    factors into 12-bit limbs so every partial product fits 24 bits (exact
    in f32), drop the integer-valued terms, and fold each remainder:

        f = k1/2^12 + k2/2^24 (exact),  n = a*2^12 + c
        frac(f n) = frac( frac(k1 c / 2^12) + frac(k2 (a mod 2^12) / 2^12)
                          + k2 c / 2^24 )

    (k1*a and k2*floor(a/2^12)*2^12 are integers — dropped; k2*a folds to
    its low limb.) Max error ~2^-23 cycles.
    """
    two12, two24, two36 = 4096.0, 16777216.0, 68719476736.0
    f32 = f.astype(jnp.float32)
    # exact limb peel on the SIGNED value (an up-front frac-reduction of a
    # negative f rounds away its low bit — 2^-25 of frequency error is 0.02
    # rad by n = 100k); each residual is representable in f32 (<= 23 bits
    # between its magnitude bound and the previous limb's quantum), so the
    # subtractions are exact; r3 = 0 exactly for |f| >= 2^-13
    k1 = jnp.round(f32 * two12)
    r1 = f32 - k1 / two12
    k2 = jnp.round(r1 * two24)
    r2 = r1 - k2 / two24
    k3 = jnp.round(r2 * two36)
    k1 = jnp.mod(k1, two12)  # only frac survives: reduce before multiplying
    n0 = jnp.mod(n, 4096).astype(jnp.float32)
    n1 = jnp.mod(jnp.floor_divide(n, 4096), 4096).astype(jnp.float32)
    n2 = jnp.mod(jnp.floor_divide(n, 4096 * 4096), 4096).astype(jnp.float32)

    def fr(x):
        return x - jnp.floor(x)

    # k_i * n_j * 2^(12(j-i)): integer-valued terms (j >= i) drop; every
    # surviving product <= 2^24 is exact in f32
    s = (
        fr(k1 * n0 / two12)
        + fr(k2 * n1 / two12)
        + k2 * n0 / two24
        + fr(k3 * n2 / two12)
        + k3 * n1 / two24
        + k3 * n0 / two36
    )
    return fr(s)


@functools.partial(jax.jit, static_argnames=("t",))
def oscillator_bank(
    freqs: jax.Array,
    t: int,
    t0: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array]:
    """(cos, sin) of -2π f (t0 + n) for a bank of LOs — (C, t) float32 each.

    Phase comes from the exact fractional multiply above — pure elementwise
    f32 ops with scalar/iota broadcasts, so XLA fuses it straight into the
    sin/cos pass. The
    naive ``-2π f (t0+n)`` in f32 is 0.2 rad wrong by n ~ 1M at f = 0.373
    and pure noise at shard offsets past 2^24; this stays exact (< 5e-6) at
    ANY stream offset, which is what keeps time-sharded shards
    (parallel/pipeline.py) mixing coherently.
    """
    f = jnp.atleast_1d(jnp.asarray(freqs, jnp.float32))[:, None]
    # frac(f*(t0+n)) = frac(frac(f*t0) + frac(f*n)): splitting keeps every
    # integer argument < 2^31 — adding t0 into the iota would silently wrap
    # int32 once a shard starts past ~2.1e9 samples. (t0 itself must still
    # fit int32; document larger offsets as out of scope.)
    p0 = _frac_mul_int(f, jnp.asarray(t0, jnp.int32))
    pn = _frac_mul_int(f, jnp.arange(t, dtype=jnp.int32)[None, :])
    p = p0 + pn
    theta = -2.0 * jnp.pi * (p - jnp.floor(p))
    return jnp.cos(theta), jnp.sin(theta)


@functools.partial(jax.jit, static_argnames=())
def frequency_translate(x: jax.Array, freq_norm: jax.Array | float) -> jax.Array:
    """Mix a signal down/up by freq (cycles/sample): x * exp(-2πi f n)."""
    t = x.shape[-1]
    fr = jnp.asarray(freq_norm, jnp.float32).reshape(-1)
    if x.ndim == 1 and fr.shape[0] != 1:
        raise ValueError(
            f"a 1-D signal takes one frequency, got {fr.shape[0]}; "
            "pass a (channels, time) signal for per-channel mixing"
        )
    c, s = oscillator_bank(fr, t)
    lo = jax.lax.complex(c, s)
    lo = lo[0] if x.ndim == 1 else lo
    return _to_c64(x) * lo


@jax.jit
def fm_modulate(msg: jax.Array, deviation: float = 0.5) -> jax.Array:
    """Inverse of fm_demodulate (for test loopback): z = exp(i·cumsum(msg·dev))."""
    phase = jnp.cumsum(msg.astype(jnp.float32) * deviation, axis=-1)
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
