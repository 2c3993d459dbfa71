"""G.711 companding codecs (mu-law / A-law) and continuous mu compression.

The telephony byte codecs every serving stack meets at its edges: 8-bit
G.711 streams in, int16 PCM through the framework, G.711 back out. Exact
ITU G.711 integer semantics (the Sun Microsystems g711.c reference
algorithm every implementation reproduces), spelled as vectorized int32
lane arithmetic — branch ladders become comparison sums and masked
selects, so encode/decode jit cleanly and run as fused elementwise
work. The continuous ``mu_compress``/``mu_expand`` pair is the float
variant ML pipelines use (e.g. WaveNet-style 8-bit targets).

North-star scope beside ``io/wav.py`` (the CUDA reference reads 16-bit PCM
only; SURVEY.md §6). Spec pins in tests: byte-codebook idempotence
(encode(decode(c)) == c for all 256 codes), scalar g711.c oracle parity on
the full 65536-value int16 range, sign symmetry, and monotone decode
levels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "mulaw_encode",
    "mulaw_decode",
    "alaw_encode",
    "alaw_decode",
    "mu_compress",
    "mu_expand",
]

_BIAS = 0x84  # 132, the mu-law bias
_CLIP = 32635


def mulaw_encode(x: jax.Array) -> jax.Array:
    """int16 linear PCM -> uint8 mu-law (ITU G.711, g711.c semantics)."""
    v = jnp.asarray(x, jnp.int32)
    sign = v < 0
    mag = jnp.minimum(jnp.where(sign, -v, v), _CLIP) + _BIAS
    # exponent = bit position of mag's MSB above bit 7, in 0..7
    exp = jnp.zeros_like(mag)
    for k in range(1, 8):
        exp = exp + (mag >= (1 << (7 + k))).astype(jnp.int32)
    mant = (mag >> (exp + 3)) & 0xF
    byte = ~((jnp.where(sign, 0x80, 0x00)) | (exp << 4) | mant) & 0xFF
    return byte.astype(jnp.uint8)


def mulaw_decode(c: jax.Array) -> jax.Array:
    """uint8 mu-law -> int16 linear PCM (exact g711.c ulaw2linear)."""
    u = (~jnp.asarray(c, jnp.int32)) & 0xFF
    t = (((u & 0xF) << 3) + _BIAS) << ((u >> 4) & 0x7)
    out = jnp.where((u & 0x80) != 0, _BIAS - t, t - _BIAS)
    return out.astype(jnp.int16)


_ALAW_SEG_END = (0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF)


def alaw_encode(x: jax.Array) -> jax.Array:
    """int16 linear PCM -> uint8 A-law (ITU G.711, g711.c semantics).

    The 16-bit input is arithmetic-shifted to the spec's 13-bit domain;
    the even-bit inversion (XOR 0x55) is folded into the mask.
    """
    v = jnp.asarray(x, jnp.int32) >> 3
    neg = v < 0
    mask = jnp.where(neg, 0x55, 0xD5)
    pcm = jnp.where(neg, -v - 1, v)
    seg = jnp.zeros_like(pcm)
    for end in _ALAW_SEG_END:
        seg = seg + (pcm > end).astype(jnp.int32)
    shift = jnp.where(seg < 2, 1, seg)
    aval = (jnp.minimum(seg, 7) << 4) | ((pcm >> shift) & 0xF)
    byte = jnp.where(seg >= 8, 0x7F, aval) ^ mask
    return byte.astype(jnp.uint8)


def alaw_decode(c: jax.Array) -> jax.Array:
    """uint8 A-law -> int16 linear PCM (exact g711.c alaw2linear)."""
    a = jnp.asarray(c, jnp.int32) ^ 0x55
    t = (a & 0xF) << 4
    seg = (a & 0x70) >> 4
    t = jnp.where(seg == 0, t + 8, (t + 0x108) << jnp.maximum(seg - 1, 0))
    out = jnp.where((a & 0x80) != 0, t, -t)
    return out.astype(jnp.int16)


def mu_compress(x: jax.Array, *, mu: float = 255.0) -> jax.Array:
    """Continuous mu-law compression of float in [-1, 1]:
    sign(x) * log1p(mu |x|) / log1p(mu)."""
    if mu <= 0:
        raise ValueError(f"mu must be > 0, got {mu}")
    xf = jnp.asarray(x, jnp.float32)
    return jnp.sign(xf) * jnp.log1p(mu * jnp.abs(xf)) / np.log1p(mu)


def mu_expand(y: jax.Array, *, mu: float = 255.0) -> jax.Array:
    """Inverse of :func:`mu_compress`."""
    if mu <= 0:
        raise ValueError(f"mu must be > 0, got {mu}")
    yf = jnp.asarray(y, jnp.float32)
    return jnp.sign(yf) * (jnp.expm1(jnp.abs(yf) * np.log1p(mu))) / mu
