"""Continuous wavelet transform and unevenly-sampled spectra.

``cwt`` is a bank of batched correlations (one lane-blocked conv over
centered symmetric padding; gathers and dynamic shapes are avoided
throughout). ``lombscargle`` is two dense trig outer-product
contractions — the (freqs x samples) structure is exactly a matmul.
Wavelet generators are host-side numpy design functions like the FIR/IIR
designers. Parity target: scipy.signal (``cwt``/``ricker``/``morlet2``/
``lombscargle``); no reference analog (the CUDA study has no wavelet or
irregular-sampling surface).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def ricker(points: int, a: float) -> np.ndarray:
    """Ricker (mexican-hat) wavelet (scipy.signal.ricker)."""
    A = 2.0 / (np.sqrt(3.0 * a) * np.pi**0.25)
    vec = np.arange(points) - (points - 1.0) / 2.0
    xsq = vec**2
    mod = 1.0 - xsq / a**2
    return (A * mod * np.exp(-xsq / (2.0 * a**2))).astype(np.float64)


def morlet2(points: int, s: float, w: float = 5.0) -> np.ndarray:
    """Complex Morlet wavelet normalized for :func:`cwt`
    (scipy.signal.morlet2)."""
    x = (np.arange(points) - (points - 1.0) / 2.0) / s
    return (
        np.exp(1j * w * x) * np.exp(-0.5 * x**2) * np.pi**-0.25 * s**-0.5
    ).astype(np.complex128)


def _correlate_same_bank(xb: jax.Array, kernels: list) -> jax.Array:
    """Batched 'same' correlation with a BANK of kernels in ONE conv.

    scipy.cwt runs convolve(data, conj(wavelet)[::-1], 'same') per width
    — i.e. centered correlation with conj(wavelet). Per-width 1-D convs
    have one output feature; stacking the bank as output FEATURES of a
    single conv gives a real contraction.
    Each kernel of length L is placed in a max-length row at offset
    ``Lmax//2 - L//2``, which reproduces every kernel's own centered
    'same' alignment (convolution-split centering: extra sample BEFORE
    for even L).

    Returns ``(C, W, n)``.
    """
    lmax = max(k.size for k in kernels)
    bank = np.zeros((len(kernels), lmax), np.float64)
    for i, k in enumerate(kernels):
        off = lmax // 2 - k.size // 2
        bank[i, off : off + k.size] = k
    before, after = lmax // 2, (lmax - 1) // 2
    ext = jnp.pad(xb, ((0, 0), (before, after)))
    return _bank_conv_blocked(ext, bank, xb.shape[-1])


def _bank_conv_blocked(ext: jax.Array, bank: np.ndarray, n: int) -> jax.Array:
    """VALID correlation of ``ext`` with every bank row, lane-blocked.

    A feature-stacked NCHW spelling has only n_widths output features
    and a single stream gives batch 1. The fix is the fir.py lane-block
    mapping with the whole bank stacked as
    output features: frame the time axis into 128 lanes and fold each
    (reversed) bank row into a banded (P+1, 128, 128) tap matrix — one
    dense conv with W*128 output features.
    """
    w_n, lmax = bank.shape
    c = ext.shape[0]
    B = 128
    P = (lmax + B - 2) // B
    t_ext = ext.shape[-1]
    tb = -(-t_ext // B)
    xf = jnp.pad(ext.astype(jnp.float32), ((0, 0), (0, tb * B - t_ext))).reshape(
        c, tb, B
    )
    # convolution-form taps per row: z_w[i] = sum_j rev_w[j] ext[i-j], and
    # the VALID correlation is out_w[t] = z_w[t + lmax - 1]
    rev = bank[:, ::-1]  # (W, lmax)
    idx = (
        np.arange(B)[None, None, :]
        - np.arange(B)[None, :, None]
        + B * (P - np.arange(P + 1))[:, None, None]
    )  # (P+1, l, p) tap index for q=1
    valid = (idx >= 0) & (idx < lmax)
    h = np.where(valid[..., None], rev.T[np.clip(idx, 0, lmax - 1)], 0.0)
    # h: (P+1, 128, 128, W) -> output features w*128 + p? keep (..., p, w)
    # ordering consistent: reshape to (P+1, 128, W*128) with p-minor
    h = np.moveaxis(h, -1, -2)  # (P+1, l, W, p)
    rhs = jnp.asarray(
        h.reshape(P + 1, B, w_n * B).astype(np.float32)
    )
    z = jax.lax.conv_general_dilated(
        xf,
        rhs,
        window_strides=(1,),
        padding=((P, 0),),
        dimension_numbers=("NWC", "WIO", "NWC"),
        precision=jax.lax.Precision.HIGHEST,
    )  # (c, tb, W*B)
    z = z.reshape(c, tb, w_n, B).transpose(0, 2, 1, 3).reshape(c, w_n, tb * B)
    return z[:, :, lmax - 1 : lmax - 1 + n]


def cwt(
    data: jax.Array,
    wavelet,
    widths,
    *,
    dtype=None,
    w: float | None = None,
) -> jax.Array:
    """Continuous wavelet transform (scipy.signal.cwt semantics).

    ``wavelet(length, width)`` is called host-side per width with
    ``length = min(10 * width, n)``; complex wavelets (e.g.
    :func:`morlet2`) run as two planar real passes and return a
    complex numpy-compatible array via ``lax.complex``. Extra ``w`` is
    forwarded to the wavelet (morlet2's center frequency).

    Returns ``(..., len(widths), n)``.
    """
    xf = jnp.asarray(data, jnp.float32)
    n = xf.shape[-1]
    batch = xf.shape[:-1]
    xb = xf.reshape(-1, n)
    kernels = []
    complex_out = False
    for width in np.atleast_1d(widths):
        length = int(min(10 * float(width), n))
        wv = (
            wavelet(length, float(width))
            if w is None
            else wavelet(length, float(width), w)
        )
        wv = np.conj(np.asarray(wv))
        complex_out = complex_out or np.iscomplexobj(wv)
        kernels.append(wv)
    out_re = _correlate_same_bank(
        xb, [np.real(k).astype(np.float64) for k in kernels]
    )
    if complex_out:
        out_im = _correlate_same_bank(
            xb, [np.imag(k).astype(np.float64) for k in kernels]
        )
        out = jax.lax.complex(out_re, out_im)
    else:
        out = out_re
    if dtype is not None:
        out = out.astype(dtype)
    return out.reshape(batch + out.shape[-2:])


@functools.partial(jax.jit, static_argnames=("precenter", "normalize"))
def lombscargle(
    x: jax.Array,
    y: jax.Array,
    freqs: jax.Array,
    *,
    precenter: bool = False,
    normalize: bool = False,
) -> jax.Array:
    """Lomb-Scargle periodogram for UNEVENLY sampled data
    (scipy.signal.lombscargle, tau-shifted form).

    ``x``: sample times ``(n,)``; ``y``: values ``(n,)``; ``freqs``:
    angular frequencies ``(f,)``. Every term is a dense (f, n) trig
    matrix contracted over samples — two einsums per statistic.
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    freqs = jnp.asarray(freqs, jnp.float32)
    if precenter:
        y = y - jnp.mean(y)
    arg = freqs[:, None] * x[None, :]  # (f, n)
    s2 = jnp.sum(jnp.sin(2.0 * arg), -1)
    c2 = jnp.sum(jnp.cos(2.0 * arg), -1)
    tau_arg = 0.5 * jnp.arctan2(s2, c2)  # omega * tau
    carg = jnp.cos(arg - tau_arg[:, None])
    sarg = jnp.sin(arg - tau_arg[:, None])
    cy = carg @ y
    sy = sarg @ y
    cc = jnp.sum(carg * carg, -1)
    ss = jnp.sum(sarg * sarg, -1)
    pgram = 0.5 * (cy * cy / cc + sy * sy / ss)
    if normalize:
        pgram = pgram * (2.0 / jnp.sum(y * y))
    return pgram


__all__ = ["ricker", "morlet2", "cwt", "lombscargle"]
