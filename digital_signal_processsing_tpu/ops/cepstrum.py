"""Cepstral analysis: real/complex cepstrum and inverses.

Classic homomorphic DSP (echo detection, pitch tracking, the cepstral
face of the LPC envelope in ``ops.lpc``). All spectra ride the package's
FFT surface; complex spectra stay PLANAR (re, im) on device — the public
API accepts/returns real arrays plus the standard
``ndelay`` integer, matching the scipy cookbook / matlab ``rceps`` /
``cceps`` conventions. No reference analog (the CUDA study has no
cepstral surface).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@jax.jit
def real_cepstrum(x: jax.Array) -> jax.Array:
    """c = irfft(log |rfft(x)|) over the last axis (matlab ``rceps``)."""
    n = x.shape[-1]
    spec = jnp.fft.rfft(jnp.asarray(x, jnp.float32), axis=-1)
    logmag = jnp.log(jnp.maximum(jnp.abs(spec), 1e-30))
    return jnp.fft.irfft(logmag, n=n, axis=-1)


@jax.jit
def complex_cepstrum(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Complex cepstrum with linear-phase removal (matlab ``cceps``).

    Returns ``(cepstrum, ndelay)``: the phase is unwrapped, the linear
    trend (circular delay of ``ndelay`` samples) removed so the log
    spectrum is continuous and the cepstrum real. Invert with
    :func:`inverse_complex_cepstrum`.
    """
    xf = jnp.asarray(x, jnp.float32)
    n = xf.shape[-1]
    spec = jnp.fft.fft(xf, axis=-1)
    phase = jnp.unwrap(jnp.angle(spec), axis=-1)
    center = (n + 1) // 2
    ndelay = jnp.round(phase[..., center] * (n / (2.0 * jnp.pi * center)))
    k = jnp.arange(n, dtype=jnp.float32)
    phase = phase - 2.0 * jnp.pi * ndelay[..., None] * k / n
    logspec = jax.lax.complex(
        jnp.log(jnp.maximum(jnp.abs(spec), 1e-30)), phase
    )
    ceps = jnp.real(jnp.fft.ifft(logspec, axis=-1))
    return ceps, ndelay.astype(jnp.int32)


@jax.jit
def inverse_complex_cepstrum(
    ceps: jax.Array, ndelay: jax.Array
) -> jax.Array:
    """Invert :func:`complex_cepstrum` (matlab ``icceps``): restore the
    linear phase and exponentiate back to the signal."""
    cf = jnp.asarray(ceps, jnp.float32)
    n = cf.shape[-1]
    logspec = jnp.fft.fft(cf, axis=-1)
    k = jnp.arange(n, dtype=jnp.float32)
    lin = 2.0 * jnp.pi * jnp.asarray(ndelay, jnp.float32)[..., None] * k / n
    logspec = logspec + jax.lax.complex(jnp.zeros_like(lin), lin)
    return jnp.real(jnp.fft.ifft(jnp.exp(logspec), axis=-1))


@functools.partial(jax.jit, static_argnames=("n_lifter",))
def cepstral_pitch(
    x: jax.Array, *, fs: float = 1.0, n_lifter: int = 32
) -> jax.Array:
    """Pitch estimate from the real cepstrum's dominant quefrency peak
    (the classic Noll method); ``n_lifter`` low quefrencies are excluded
    to skip the spectral-envelope region. Returns Hz (given ``fs``)."""
    c = real_cepstrum(x)
    n = c.shape[-1]
    hi = n // 2
    region = c[..., n_lifter:hi]
    q = jnp.argmax(region, axis=-1) + n_lifter
    return fs / q.astype(jnp.float32)


__all__ = [
    "real_cepstrum",
    "complex_cepstrum",
    "inverse_complex_cepstrum",
    "cepstral_pitch",
]
