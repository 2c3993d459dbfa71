"""Matmul-factorized DFT: the FFT stage as two batched matmul passes.

A DFT of composite length N = N1*N2 factors (Cooley-Tukey) into

    X[k1 + N1*k2] = sum_n2 W_N^(n2*k1) * W_N2^(n2*k2)
                            * sum_n1 x[N2*n1 + n2] * W_N1^(n1*k1)

i.e. a batched (N2, N1) @ (N1, N1) matmul, an elementwise twiddle, and a
batched (N1-many) (N2) @ (N2, N2) contraction — dense matmul work at
~N1+N2 MACs/point. Complex arithmetic is planar (re, im) real matmuls,
with HIGH precision giving ~1e-6 relative error on the backend it was
tuned for — two orders below the FIR design ripple that dominates any
filtering use.

These engines are explicit ``method="mxu"`` choices of ops/fft.py and
``fir_filter(method="overlap_save_mxu")``; ``auto`` takes jnp.fft (cuFFT
on a GPU). The name is historical: the engines were first written for a
matrix unit whose FFT lowering was slow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pick_factored_nfft(min_n: int, n1: int = 128) -> int:
    """Smallest multiple of ``n1`` >= min_n (the factored-DFT length grid)."""
    return -(-min_n // n1) * n1


def _stage_consts(n: int, n1: int, inverse: bool):
    """numpy planar constants: (W1 (n1,n1), twiddle (n2,n1), W2 (n2,n2))."""
    n2 = n // n1
    sign = 2j if inverse else -2j
    k1 = np.arange(n1)
    w1 = np.exp(sign * np.pi * np.outer(k1, k1) / n1)
    tw = np.exp(sign * np.pi * np.outer(np.arange(n2), k1) / n)
    k2 = np.arange(n2)
    w2 = np.exp(sign * np.pi * np.outer(k2, k2) / n2)

    def planar(w):
        return w.real.astype(np.float32), w.imag.astype(np.float32)

    return planar(w1), planar(tw), planar(w2)


def dft_factored(
    x_re: jax.Array,
    x_im: jax.Array | None,
    *,
    n1: int = 128,
    inverse: bool = False,
    precision=jax.lax.Precision.HIGH,
) -> tuple[jax.Array, jax.Array]:
    """Planar complex DFT over the last axis via two matmul stages.

    ``x_im=None`` marks a real input (halves the first stage's matmuls).
    Returns planar ``(re, im)``; the inverse applies the 1/N scale. The
    last axis length must be a multiple of ``n1``.
    """
    n = x_re.shape[-1]
    if n % n1 != 0:
        raise ValueError(f"factored DFT needs len % {n1} == 0, got {n}")
    n2 = n // n1
    (w1r_, w1i_), (twr_, twi_), (w2r_, w2i_) = _stage_consts(n, n1, inverse)
    w1r, w1i = jnp.asarray(w1r_), jnp.asarray(w1i_)
    twr, twi = jnp.asarray(twr_), jnp.asarray(twi_)
    w2r, w2i = jnp.asarray(w2r_), jnp.asarray(w2i_)

    def mm(a, b):
        return jnp.matmul(a, b, precision=precision)

    # x[..., N2*n1 + n2] -> x2[..., n2, n1]
    def to2(v):
        return jnp.swapaxes(v.reshape(v.shape[:-1] + (n1, n2)), -1, -2)

    x2r = to2(x_re)
    # stage A: contract n1 against W1 -> A[..., n2, k1]
    if x_im is None:
        ar, ai = mm(x2r, w1r), mm(x2r, w1i)
    else:
        x2i = to2(x_im)
        ar = mm(x2r, w1r) - mm(x2i, w1i)
        ai = mm(x2r, w1i) + mm(x2i, w1r)
    # twiddle: elementwise (n2, k1) complex multiply
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    # stage B: contract n2 against W2 -> X[..., k2, k1]; einsum keeps k1
    # batched so the contraction is one (..., k1, n2) @ (n2, k2) matmul
    def stage2(r, i):
        return (
            jnp.einsum("...nk,nm->...mk", r, w2r, precision=precision)
            - jnp.einsum("...nk,nm->...mk", i, w2i, precision=precision),
            jnp.einsum("...nk,nm->...mk", r, w2i, precision=precision)
            + jnp.einsum("...nk,nm->...mk", i, w2r, precision=precision),
        )

    xr, xi = stage2(br, bi)
    # X[..., k2, k1] flattens to k = k1 + N1*k2 (k2-major) directly
    out_r = xr.reshape(xr.shape[:-2] + (n,))
    out_i = xi.reshape(xi.shape[:-2] + (n,))
    if inverse:
        s = jnp.float32(1.0 / n)
        return out_r * s, out_i * s
    return out_r, out_i


# Largest single-level factored length: n2 = n/128 becomes the (n2, n2)
# stage-B constant, which must stay a sane matmul operand.
FACTORED_MAX_N = 32768

# Dense real-DFT crossover: up to this length, ONE (n, n//2+1) matmul pair
# beats the factored engine's batched tiny stage-B contractions +
# relayouts (chosen on the earlier accelerator; not measured on a GPU).
# Matrices are (n, h) f32 pairs — 67 MB device-resident at 4096; 8192
# would need 268 MB, so the factored engine keeps larger sizes.
DENSE_RFFT_MAX_N = 4096


@functools.lru_cache(maxsize=32)
def _dense_rfft_consts(n: int):
    """(n, h) planar forward real-DFT matrices, h = n//2 + 1."""
    k = np.arange(n // 2 + 1)
    w = np.exp(-2j * np.pi * np.outer(np.arange(n), k) / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _dense_irfft_consts(n: int):
    """(h, n) planar synthesis matrices with the hermitian fold baked in.

    x[t] = (1/n) sum_k w_k (re_k cos(2 pi k t / n) - im_k sin(...)),
    w_0 = w_{n/2} = 1, else 2 — so irfft is re @ Ar + im @ Ai, one pair.
    """
    h = n // 2 + 1
    k = np.arange(h)
    ang = 2.0 * np.pi * np.outer(k, np.arange(n)) / n
    wk = np.full(h, 2.0)
    wk[0] = 1.0
    if n % 2 == 0:
        wk[-1] = 1.0
    ar = (wk[:, None] * np.cos(ang) / n).astype(np.float32)
    ai = (-(wk[:, None]) * np.sin(ang) / n).astype(np.float32)
    return ar, ai


def rfft_dense(
    x: jax.Array, *, precision=jax.lax.Precision.HIGH
) -> tuple[jax.Array, jax.Array]:
    """Real (..., n) -> planar (re, im) half spectrum, ONE matmul pair.

    HIGH is the default precision: its error sits far inside the hann
    window's -31 dB sidelobe floor; pass ``precision`` to pin HIGHEST.
    """
    n = x.shape[-1]
    cr, ci = _dense_rfft_consts(n)
    xr = x.astype(jnp.float32)
    return (
        jnp.matmul(xr, jnp.asarray(cr), precision=precision),
        jnp.matmul(xr, jnp.asarray(ci), precision=precision),
    )


def irfft_dense(
    s_re: jax.Array,
    s_im: jax.Array,
    nfft: int,
    *,
    precision=jax.lax.Precision.HIGH,
) -> jax.Array:
    """Planar half spectrum (..., n//2+1) -> real (..., nfft).

    HIGH default for the same measured reason as :func:`rfft_dense`."""
    ar, ai = _dense_irfft_consts(nfft)
    return jnp.matmul(
        s_re.astype(jnp.float32), jnp.asarray(ar), precision=precision
    ) + jnp.matmul(
        s_im.astype(jnp.float32), jnp.asarray(ai), precision=precision
    )


def rfft_dense_framed(
    x: jax.Array,
    num_frames: int,
    hop: int,
    nfft: int,
    window: np.ndarray,
    *,
    detrend: bool = False,
    precision=jax.lax.Precision.HIGH,
) -> tuple[jax.Array, jax.Array]:
    """Windowed framed real DFT with the framing folded into banded matmuls.

    out[..., i, k] = sum_t w[t] x[..., i*hop + t] W[t, k]. When hop divides
    nfft, frame i is rows i..i+J-1 of the (nb, hop) reshape (J = nfft/hop):

        out = sum_j x2[..., j : j + num_frames, :] @ (w ⊙ W)[j*hop:(j+1)*hop]

    — J shifted CONTIGUOUS views of the same reshape, so the (frames, nfft)
    tensor is never materialized: no concat + windowed-segment
    materialization of overlapping frames. ``detrend`` reproduces per-segment mean removal analytically:
    DFT(w*(x - m)) = DFT(w*x) - m*DFT(w), with the per-frame means from the
    same shifted row sums.

    Returns planar (re, im), each (..., num_frames, nfft//2 + 1).
    """
    if nfft % hop or hop % 128:
        raise ValueError(f"need hop | nfft and 128 | hop, got {nfft=} {hop=}")
    j_max = nfft // hop
    nb = num_frames + j_max - 1
    need = nb * hop
    if x.shape[-1] < need:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, need - x.shape[-1])]
        x = jnp.pad(x, pad)
    x2 = x[..., :need].astype(jnp.float32).reshape(*x.shape[:-1], nb, hop)
    cr, ci = _dense_rfft_consts(nfft)
    w = np.asarray(window, np.float32).reshape(nfft, 1)
    out_r = out_i = None
    for j in range(j_max):
        seg = x2[..., j : j + num_frames, :]
        band = slice(j * hop, (j + 1) * hop)
        r = jnp.matmul(seg, jnp.asarray(w[band] * cr[band]), precision=precision)
        im = jnp.matmul(seg, jnp.asarray(w[band] * ci[band]), precision=precision)
        out_r = r if out_r is None else out_r + r
        out_i = im if out_i is None else out_i + im
    if detrend:
        rows = jnp.sum(x2, axis=-1)  # (..., nb)
        m = rows[..., 0:num_frames]
        for j in range(1, j_max):
            m = m + rows[..., j : j + num_frames]
        m = m * jnp.float32(1.0 / nfft)
        wd = np.asarray(window, np.float64)
        dr = jnp.asarray((wd @ cr.astype(np.float64)).astype(np.float32))
        di = jnp.asarray((wd @ ci.astype(np.float64)).astype(np.float32))
        out_r = out_r - m[..., None] * dr
        out_i = out_i - m[..., None] * di
    return out_r, out_i


def fft_large(
    x_re: jax.Array,
    x_im: jax.Array | None,
    *,
    inverse: bool = False,
    precision=jax.lax.Precision.HIGH,
) -> tuple[jax.Array, jax.Array]:
    """Planar complex DFT for LARGE n via the four-step (Bailey) split.

    n = n1*n2 with each factor itself a multiple of 128 run through
    :func:`dft_factored` (so four matmul stages total), joined by an
    in-graph twiddle whose exponent ``(t2*k1) mod n`` is computed EXACTLY
    in int32 (both factors <= 2^15, so the product never overflows; a
    host-side (n,) constant would be 512 MB at 64M and a float32 phase
    accumulator would be ~0.2 rad wrong by t ~ 1M — the oscillator-bank
    lesson). Handles n up to 2^30; this engine is matmuls + transposes
    only.
    """
    n = x_re.shape[-1]
    n1 = _pick_large_factor(n)
    n2 = n // n1
    batch = x_re.shape[:-1]

    def to2(v):  # x[t = n2*t1 + t2] -> (..., t2, t1)
        return jnp.swapaxes(v.reshape(batch + (n1, n2)), -1, -2)

    x2r = to2(x_re)
    x2i = to2(x_im) if x_im is not None else None
    # stage A: n1-point DFTs along the last axis (batched over t2). For the
    # inverse, the two sub-transforms' 1/n1 and 1/n2 scales compose to the
    # full 1/n — no extra scaling pass needed.
    ar, ai = dft_factored(x2r, x2i, inverse=inverse, precision=precision)
    # twiddle W_n^(t2*k1), exponent exact in int32 (n1, n2 <= 2^15)
    t2 = jax.lax.broadcasted_iota(jnp.int32, (n2, n1), 0)
    k1 = jax.lax.broadcasted_iota(jnp.int32, (n2, n1), 1)
    m = (t2 * k1) % n
    sign = 2.0 if inverse else -2.0
    phase = m.astype(jnp.float32) * jnp.float32(sign * np.pi / n)
    twr, twi = jnp.cos(phase), jnp.sin(phase)
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    # stage B: n2-point DFTs along t2 -> transpose to put t2 minor
    br = jnp.swapaxes(br, -1, -2)  # (..., k1, t2)
    bi = jnp.swapaxes(bi, -1, -2)
    cr, ci = dft_factored(br, bi, inverse=inverse, precision=precision)
    # X[k1, k2] with k = k1 + n1*k2: k2-major flatten
    out_r = jnp.swapaxes(cr, -1, -2).reshape(batch + (n,))
    out_i = jnp.swapaxes(ci, -1, -2).reshape(batch + (n,))
    return out_r, out_i


def _pick_large_factor(n: int) -> int:
    """n1 for the four-step split: both factors multiples of 128, <= 2^15."""
    if n % (128 * 128) != 0:
        raise ValueError(
            f"fft_large needs len % {128 * 128} == 0, got {n} "
            "(use dft_factored / jnp.fft for short transforms)"
        )
    # balanced split keeps both stage constants small: scan divisors of
    # m = n/128^2 for the n1 = 128*d closest to sqrt(n)
    m = n // (128 * 128)
    best = None
    for cand in range(1, int(np.sqrt(m)) + 1):
        if m % cand == 0:
            for d in (cand, m // cand):
                n1 = 128 * d
                n2 = n // n1
                if n1 <= FACTORED_MAX_N and n2 <= FACTORED_MAX_N:
                    score = abs(np.log(n1 / n2))
                    if best is None or score < best[0]:
                        best = (score, n1)
    if best is None:
        raise ValueError(
            f"no balanced 128-multiple factorization of {n} with both "
            f"factors <= {FACTORED_MAX_N}"
        )
    return best[1]


def overlap_save_mxu(
    x: jax.Array,
    taps: jax.Array,
    *,
    block: int,
    n1: int = 128,
) -> jax.Array:
    """Causal FIR via overlap-save with the matmul-factorized DFT.

    Same semantics as ops/fir.py's ``fir_overlap_save``; ``block`` is the
    useful samples per segment, nfft = block rounded with the k-1 overlap
    onto the n1 grid. Concrete taps get a host-side float64 numpy FFT for
    the frequency response; traced taps compute it on device with the same
    factored DFT.
    """
    k = int(taps.shape[0])
    nfft = pick_factored_nfft(block + k, n1)
    if isinstance(taps, jax.core.Tracer):
        tp = jnp.pad(taps.astype(jnp.float32), (0, nfft - k))
        hr, hi = dft_factored(tp[None, :], None, n1=n1)
        hr, hi = hr[0], hi[0]
    else:
        h_f = np.fft.fft(np.asarray(taps, np.float64), n=nfft)
        hr = jnp.asarray(h_f.real.astype(np.float32))
        hi = jnp.asarray(h_f.imag.astype(np.float32))
    return _overlap_save_mxu_jit(x, hr, hi, k=k, block=block, n1=n1)


@functools.partial(jax.jit, static_argnames=("k", "block", "n1"))
def _overlap_save_mxu_jit(x, hr, hi, *, k: int, block: int, n1: int):
    from ..utils.layout import overlapping_frames
    from .fir import _as_planar

    xp, squeeze = _as_planar(x)
    c, t = xp.shape
    nfft = hr.shape[-1]
    nblocks = -(-t // block)
    pad_r = nblocks * block - t
    xpad = jnp.pad(
        xp.astype(jnp.float32),
        ((0, 0), (k - 1, pad_r + (nfft - block - (k - 1)))),
    )
    segs = overlapping_frames(xpad, nblocks, block, nfft)  # (c, nb, nfft)
    fr, fi = dft_factored(segs, None, n1=n1)
    yr = fr * hr - fi * hi
    yi = fr * hi + fi * hr
    out_r, _ = dft_factored(yr, yi, n1=n1, inverse=True)
    y = out_r[:, :, k - 1 : k - 1 + block].reshape(c, nblocks * block)[:, :t]
    return y[0] if squeeze else y


__all__ = [
    "dft_factored",
    "overlap_save_mxu",
    "pick_factored_nfft",
]
