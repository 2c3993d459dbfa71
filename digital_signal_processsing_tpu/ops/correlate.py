"""Cross-/auto-correlation over the last axis (FFT-based, batched).

Beyond-reference framework op (the reference has no correlation tooling);
semantics match ``scipy.signal.correlate`` for real inputs (validated
against it in tests/test_design_spectral.py::TestCorrelate). Correlation is convolution with the
flipped template, so one rfft/irfft pair at a padded power-of-two length
does the whole batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MODES = ("full", "same", "valid")

# Direct-vs-FFT auto crossover for correlate/correlate_complex: the direct
# path is the lane-blocked banded conv (ops.fir.blocked_causal_conv via
# fir_direct), the FFT path one padded pow2 DFT round trip that processes
# nfft = 2^ceil(log2(ta+tv-1)) points three times regardless of template
# length. The thresholds were set on the earlier accelerator and are not
# yet measured on a GPU (ROADMAP queue 1, item 4).
DIRECT_MAX_TAPS = 2048
DIRECT_MIN_STREAM = 65536


def _resolve_corr_method(
    method: str, ta: int, tv: int, v_ndim: int
) -> str:
    """'direct' | the FFT-engine name to hand to _resolve_fft_method.

    The direct path needs a single (1-D) template — the FFT path also
    accepts batched templates, which stay on the DFT engines.
    """
    if method in ("direct", "direct_gauss"):
        if v_ndim != 1:
            raise ValueError(
                f"method={method!r} needs a 1-D template, got ndim={v_ndim}"
            )
        return method
    if (
        method == "auto"
        and v_ndim == 1
        and tv <= DIRECT_MAX_TAPS
        and ta >= DIRECT_MIN_STREAM
        and ta >= 8 * tv
    ):
        return "direct"
    return method


def _direct_full_real(a: jax.Array, v: jax.Array, n: int) -> jax.Array:
    """Full correlation via the banded causal conv (real planar).

    Correlation is causal convolution with the reversed template over the
    tail-padded stream: conv(a_pad, v[::-1])[t] = sum_m v[m] a[t-tv+1+m]
    — elementwise identical to the FFT path's first ``n`` outputs.
    """
    from .fir import fir_direct

    ta = a.shape[-1]
    batch = a.shape[:-1]
    # pad to whole 128-lane frames
    nr = -(-n // 128) * 128
    xp = jnp.pad(
        a.astype(jnp.float32).reshape(-1, ta), ((0, 0), (0, nr - ta))
    )
    full = fir_direct(xp, jnp.asarray(v, jnp.float32)[::-1])[..., :n]
    return full.reshape(batch + (n,))


def _direct_full_complex(
    ar: jax.Array, ai: jax.Array, vr: jax.Array, vi: jax.Array, n: int
) -> tuple[jax.Array, jax.Array]:
    """Full complex correlation as TWO banded convs (planar I/Q).

    Template h = reversed conj(v); the I and Q streams stack as channels so
    each real conv covers both products: yr = ar*hr - ai*hi,
    yi = ar*hi + ai*hr.
    """
    from .fir import fir_direct

    ta = ar.shape[-1]
    batch = ar.shape[:-1]
    # whole-frame pad: see _direct_full_real
    nr = -(-n // 128) * 128
    x2 = jnp.pad(
        jnp.concatenate(
            [
                ar.astype(jnp.float32).reshape(-1, ta),
                ai.astype(jnp.float32).reshape(-1, ta),
            ],
            0,
        ),
        ((0, 0), (0, nr - ta)),
    )
    c = x2.shape[0] // 2
    hr = jnp.asarray(vr, jnp.float32)[::-1]
    hi = -jnp.asarray(vi, jnp.float32)[::-1]
    yh_r = fir_direct(x2, hr)[..., :n]  # [ar*hr ; ai*hr]
    yh_i = fir_direct(x2, hi)[..., :n]  # [ar*hi ; ai*hi]
    fr = (yh_r[:c] - yh_i[c:]).reshape(batch + (n,))
    fi = (yh_i[:c] + yh_r[c:]).reshape(batch + (n,))
    return fr, fi


def _direct_full_complex_gauss(
    ar: jax.Array, ai: jax.Array, vr: jax.Array, vi: jax.Array, n: int
) -> tuple[jax.Array, jax.Array]:
    """Complex correlation via Gauss's 3-multiplication identity.

    With h = reversed conj(v): m1 = ar*hr, m2 = ai*hi,
    m3 = (ar+ai)*(hr+hi); yr = m1 - m2, yi = m3 - m1 - m2 — THREE banded
    convs of c rows each vs :func:`_direct_full_complex`'s four
    conv-channel products (25% of the MACs saved on the radar matched
    filter). The recombination is f32 adds of ~2x-magnitude
    intermediates, so the last-ulp rounding can differ from the 4-conv
    spelling.
    """
    from .fir import fir_direct

    ta = ar.shape[-1]
    batch = ar.shape[:-1]
    nr = -(-n // 128) * 128  # whole-frame pad: see _direct_full_real
    ar2 = ar.astype(jnp.float32).reshape(-1, ta)
    ai2 = ai.astype(jnp.float32).reshape(-1, ta)

    def padded(x):
        return jnp.pad(x, ((0, 0), (0, nr - ta)))

    hr = jnp.asarray(vr, jnp.float32)[::-1]
    hi = -jnp.asarray(vi, jnp.float32)[::-1]
    m1 = fir_direct(padded(ar2), hr)[..., :n]
    m2 = fir_direct(padded(ai2), hi)[..., :n]
    m3 = fir_direct(padded(ar2 + ai2), hr + hi)[..., :n]
    fr = (m1 - m2).reshape(batch + (n,))
    fi = (m3 - m1 - m2).reshape(batch + (n,))
    return fr, fi


@functools.partial(jax.jit, static_argnames=("mode", "method"))
def correlate(
    a: jax.Array, v: jax.Array, mode: str = "full", *, method: str = "auto"
) -> jax.Array:
    """Correlate ``a`` with template ``v`` along the last axis.

    Real float32; leading axes of ``a`` are batch. Output lengths follow
    scipy.signal.correlate: full = Ta+Tv-1, same = Ta (centered),
    valid = Ta-Tv+1 (requires Ta >= Tv). ``method``: DFT engine (see
    ops/fft.py) — ``auto`` is jnp.fft.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {MODES}")
    ta = a.shape[-1]
    tv = v.shape[-1]
    if mode == "valid" and ta < tv:
        raise ValueError(f"valid mode needs len(a) >= len(v), got {ta} < {tv}")
    n = ta + tv - 1
    nfft = 1 << int(np.ceil(np.log2(max(n, 2))))
    from .fft import _mxu_fft_planar, _resolve_fft_method

    method = _resolve_corr_method(method, ta, tv, v.ndim)
    if method == "direct_gauss":
        raise ValueError(
            "method='direct_gauss' is the complex 3-multiplication "
            "identity — real correlate has no cross products; use 'direct'"
        )
    if method == "direct":
        full = _direct_full_real(a, v, n)
    elif _resolve_fft_method(method, nfft) == "mxu" and nfft >= 128:
        pa = jnp.pad(a.astype(jnp.float32), [(0, 0)] * (a.ndim - 1) + [(0, nfft - ta)])
        pv = jnp.pad(
            v.astype(jnp.float32)[..., ::-1],
            [(0, 0)] * (v.ndim - 1) + [(0, nfft - tv)],
        )
        ar, ai = _mxu_fft_planar(pa, None)
        vr, vi = _mxu_fft_planar(pv, None)
        yr = ar * vr - ai * vi
        yi = ar * vi + ai * vr
        full, _ = _mxu_fft_planar(yr, yi, inverse=True)
        full = full[..., :n]
    else:
        fa = jnp.fft.rfft(a.astype(jnp.float32), n=nfft)
        fv = jnp.fft.rfft(v.astype(jnp.float32)[..., ::-1], n=nfft)
        full = jnp.fft.irfft(fa * fv, n=nfft)[..., :n]
    if mode == "full":
        return full
    if mode == "same":
        start = (tv - 1) // 2
        return full[..., start : start + ta]
    return full[..., tv - 1 : ta]


@functools.partial(jax.jit, static_argnames=("mode", "method"))
def correlate_complex(
    ar: jax.Array,
    ai: jax.Array,
    vr: jax.Array,
    vi: jax.Array,
    mode: str = "full",
    *,
    method: str = "auto",
) -> tuple[jax.Array, jax.Array]:
    """Complex correlation y[k] = sum_n a[n+k] conj(v[n]), planar I/Q.

    The I/Q matched-filter primitive (scipy.signal.correlate semantics for
    complex inputs), spelled as ONE complex DFT round trip — half the
    transform work of composing four real :func:`correlate` calls, which
    is how a planar caller would otherwise write it. Planar in/out because
    complex64 host<->device transfer is unimplemented on some PJRT
    backends; everything inside is device math. Leading axes of ``a``
    batch; returns (real, imag).
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {MODES}")
    ta = ar.shape[-1]
    tv = vr.shape[-1]
    if mode == "valid" and ta < tv:
        raise ValueError(f"valid mode needs len(a) >= len(v), got {ta} < {tv}")
    n = ta + tv - 1
    nfft = 1 << int(np.ceil(np.log2(max(n, 2))))
    method = _resolve_corr_method(method, ta, tv, vr.ndim)
    if method == "direct":
        fr, fi = _direct_full_complex(ar, ai, vr, vi, n)
    elif method == "direct_gauss":
        fr, fi = _direct_full_complex_gauss(ar, ai, vr, vi, n)
    else:
        pad_a = [(0, 0)] * (ar.ndim - 1) + [(0, nfft - ta)]
        pad_v = [(0, 0)] * (vr.ndim - 1) + [(0, nfft - tv)]
        # correlation = convolution with the reversed conjugated template
        par = jnp.pad(ar.astype(jnp.float32), pad_a)
        pai = jnp.pad(ai.astype(jnp.float32), pad_a)
        pvr = jnp.pad(vr.astype(jnp.float32)[..., ::-1], pad_v)
        pvi = jnp.pad(-vi.astype(jnp.float32)[..., ::-1], pad_v)
        from .fft import _mxu_fft_planar, _resolve_fft_method

        if _resolve_fft_method(method, nfft) == "mxu" and nfft >= 128:
            far, fai = _mxu_fft_planar(par, pai)
            fvr, fvi = _mxu_fft_planar(pvr, pvi)
            yr = far * fvr - fai * fvi
            yi = far * fvi + fai * fvr
            fr, fi = _mxu_fft_planar(yr, yi, inverse=True)
        else:
            fa = jnp.fft.fft(jax.lax.complex(par, pai))
            fv = jnp.fft.fft(jax.lax.complex(pvr, pvi))
            y = jnp.fft.ifft(fa * fv)
            fr, fi = jnp.real(y), jnp.imag(y)
        fr = fr[..., :n]
        fi = fi[..., :n]
    if mode == "full":
        return fr, fi
    if mode == "same":
        start = (tv - 1) // 2
        return fr[..., start : start + ta], fi[..., start : start + ta]
    return fr[..., tv - 1 : ta], fi[..., tv - 1 : ta]


@functools.partial(jax.jit, static_argnames=("maxlag", "normalize", "method"))
def autocorrelate(
    x: jax.Array, maxlag: int, *, normalize: bool = True, method: str = "auto"
) -> jax.Array:
    """Autocorrelation r[k] = sum_n x[n] x[n+k] for k in [0, maxlag].

    ``normalize=True`` divides by r[0] (unit lag-0). Batched over leading
    axes; maxlag must be < the time length. ``method``: DFT engine (see
    ops/fft.py).
    """
    t = x.shape[-1]
    if not 0 <= maxlag < t:
        raise ValueError(f"need 0 <= maxlag < {t}, got {maxlag}")
    nfft = 1 << int(np.ceil(np.log2(max(2 * t - 1, 2))))
    from .fft import _mxu_fft_planar, _resolve_fft_method

    if _resolve_fft_method(method, nfft) == "mxu" and nfft >= 128:
        p = jnp.pad(
            x.astype(jnp.float32), [(0, 0)] * (x.ndim - 1) + [(0, nfft - t)]
        )
        fr, fi = _mxu_fft_planar(p, None)
        r, _ = _mxu_fft_planar(fr * fr + fi * fi, None, inverse=True)
        r = r[..., : maxlag + 1]
    else:
        f = jnp.fft.rfft(x.astype(jnp.float32), n=nfft)
        r = jnp.fft.irfft(f * jnp.conj(f), n=nfft)[..., : maxlag + 1]
    if normalize:
        r = r / jnp.maximum(r[..., :1], 1e-30)
    return r


@functools.partial(jax.jit, static_argnames=("mode", "method"))
def fftconvolve(
    a: jax.Array, v: jax.Array, mode: str = "full", *, method: str = "auto"
) -> jax.Array:
    """Convolve ``a`` with ``v`` along the last axis via one padded DFT
    round trip (scipy.signal.fftconvolve, real inputs).

    Convolution is correlation with the flipped template — same engine
    dispatch as :func:`correlate`. ``same`` is centered on ``a`` like
    scipy.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {MODES}")
    full = correlate(a, v[..., ::-1], mode="full", method=method)
    ta, tv = a.shape[-1], v.shape[-1]
    if mode == "full":
        return full
    if mode == "same":
        start = (tv - 1) // 2
        return full[..., start : start + ta]
    if ta < tv:
        raise ValueError(f"valid mode needs len(a) >= len(v), got {ta} < {tv}")
    return full[..., tv - 1 : ta]


def oaconvolve(
    a: jax.Array, v: jax.Array, mode: str = "full", *, method: str = "auto"
) -> jax.Array:
    """Overlap-save convolution for long streams with a short kernel
    (scipy.signal.oaconvolve's role).

    Routes through :func:`ops.fir.fir_filter`'s auto dispatch — block
    overlap-save past the crossover, the lane-blocked direct conv
    otherwise — instead of one monolithic length-(Ta+Tv) FFT. Falls back to
    :func:`fftconvolve` when the "kernel" is more than half the stream
    (block decomposition stops paying).
    """
    ta, tv = a.shape[-1], v.shape[-1]
    if tv > max(ta // 2, 16384):
        return fftconvolve(a, v, mode, method=method)
    from .fir import fir_filter

    xp = a if a.ndim == 2 else a[None, :]
    pad = [(0, 0)] * (xp.ndim - 1) + [(0, tv - 1)]
    full = fir_filter(jnp.pad(xp.astype(jnp.float32), pad), jnp.asarray(v))
    if a.ndim != 2:
        full = full[0]
    if mode == "full":
        return full
    if mode == "same":
        start = (tv - 1) // 2
        return full[..., start : start + ta]
    if ta < tv:
        raise ValueError(f"valid mode needs len(a) >= len(v), got {ta} < {tv}")
    return full[..., tv - 1 : ta]


def convolve(
    a: jax.Array, v: jax.Array, mode: str = "full", *, method: str = "auto"
) -> jax.Array:
    """scipy.signal.convolve-compatible front door: auto-dispatches to the
    overlap-save/direct engine (long stream, short kernel) or the one-shot
    DFT (:func:`fftconvolve`)."""
    if method == "fft":
        return fftconvolve(a, v, mode)
    return oaconvolve(a, v, mode, method=method)


def find_delay(a: jax.Array, v: jax.Array) -> jax.Array:
    """Lag (samples) at which template ``v`` best aligns inside ``a``.

    argmax of the full cross-correlation, shifted so that 0 means
    "v starts at a[0]"; positive means v occurs later in a.
    """
    full = correlate(a, v, mode="full")
    return jnp.argmax(full, axis=-1) - (v.shape[-1] - 1)




def correlation_lags(in1_len: int, in2_len: int, mode: str = "full"):
    """Lag index array matching :func:`correlate`'s output
    (scipy.signal.correlation_lags)."""
    import numpy as np

    if mode == "full":
        return np.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = np.arange(-in2_len + 1, in1_len)
        mid = lags.size // 2
        bound = in1_len // 2
        if in1_len % 2 == 0:
            return lags[mid - bound : mid + bound]
        return lags[mid - bound : mid + bound + 1]
    if mode == "valid":
        bound = in1_len - in2_len
        return np.arange(bound + 1) if bound >= 0 else np.arange(bound, 1)
    raise ValueError(f"unknown mode {mode!r}")


def vectorstrength(events, period):
    """Vector strength of events relative to (an array of) periods
    (scipy.signal.vectorstrength): resultant length and angle of the
    events mapped to phase circles."""
    import jax.numpy as jnp

    events = jnp.asarray(events, jnp.float32)
    period = jnp.asarray(period, jnp.float32)
    scalar = period.ndim == 0
    per = jnp.atleast_1d(period)
    ang = 2.0 * jnp.pi * events[None, :] / per[:, None]
    re = jnp.mean(jnp.cos(ang), -1)
    im = jnp.mean(jnp.sin(ang), -1)
    strength = jnp.sqrt(re * re + im * im)
    phase = jnp.arctan2(im, re)
    if scalar:
        return strength[0], phase[0]
    return strength, phase


__all__ = [
    "correlate",
    "autocorrelate",
    "convolve",
    "fftconvolve",
    "oaconvolve",
    "find_delay",
    "gcc_phat",
    "find_delay_phat",
    "MODES",
    "correlation_lags",
    "vectorstrength",
]


def choose_conv_method(in1, in2, mode: str = "full"):
    """Pick 'fft' or 'direct' (scipy.signal.choose_conv_method).

    The boundary is fir_filter's direct/overlap-save crossover (k ~ several
    thousand), far above scipy's CPU heuristic — this mirrors what :func:`convolve`'s auto dispatch
    actually does so callers can introspect it.
    """
    from ..ops import fir as _fir

    n1 = in1 if isinstance(in1, int) else np.shape(in1)[-1]
    n2 = in2 if isinstance(in2, int) else np.shape(in2)[-1]
    k = min(n1, n2)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    return "fft" if k >= _fir.FIR_FFT_CROSSOVER else "direct"


@functools.partial(jax.jit, static_argnames=("max_lag", "method"))
def gcc_phat(
    a: jax.Array,
    b: jax.Array,
    *,
    max_lag: int | None = None,
    method: str = "auto",
    eps: float = 1e-12,
) -> jax.Array:
    """Generalized cross-correlation with PHAT weighting.

    The robust time-delay estimator for the array family: the cross
    spectrum ``Fa * conj(Fb)`` is magnitude-normalized per bin (phase
    transform), which whitens channel coloring/reverberation so the
    correlation collapses to a band-limited impulse at the true delay.
    Returns ``cc`` of shape (..., 2*max_lag + 1) over lags
    [-max_lag, max_lag]; ``cc[..., max_lag + d]`` peaks when ``a`` is
    ``b`` delayed by ``d`` samples. ``max_lag`` defaults to
    min(len(a), len(b)) - 1. Same DFT-engine ladder as :func:`correlate`.
    """
    ta, tb = a.shape[-1], b.shape[-1]
    if max_lag is None:
        max_lag = min(ta, tb) - 1
    n = ta + tb - 1
    nfft = 1 << int(np.ceil(np.log2(max(n, 2))))
    if not 0 < max_lag < nfft // 2:
        raise ValueError(f"max_lag must be in [1, {nfft // 2 - 1}], got {max_lag}")
    from .fft import _mxu_fft_planar, _resolve_fft_method

    if _resolve_fft_method(method, nfft) == "mxu" and nfft >= 128:
        pa = jnp.pad(a.astype(jnp.float32), [(0, 0)] * (a.ndim - 1) + [(0, nfft - ta)])
        pb = jnp.pad(b.astype(jnp.float32), [(0, 0)] * (b.ndim - 1) + [(0, nfft - tb)])
        ar, ai = _mxu_fft_planar(pa, None)
        br, bi = _mxu_fft_planar(pb, None)
        rr = ar * br + ai * bi  # Fa * conj(Fb), planar
        ri = ai * br - ar * bi
        mag = jnp.maximum(jnp.sqrt(rr * rr + ri * ri), eps)
        cc, _ = _mxu_fft_planar(rr / mag, ri / mag, inverse=True)
    else:
        fa = jnp.fft.rfft(a.astype(jnp.float32), n=nfft)
        fb = jnp.fft.rfft(b.astype(jnp.float32), n=nfft)
        r = fa * jnp.conj(fb)
        r = r / jnp.maximum(jnp.abs(r), eps)
        cc = jnp.fft.irfft(r, n=nfft)
    neg = cc[..., nfft - max_lag :]
    pos = cc[..., : max_lag + 1]
    return jnp.concatenate([neg, pos], axis=-1)


def find_delay_phat(a: jax.Array, b: jax.Array, *, max_lag: int | None = None):
    """Sub-sample delay of ``a`` relative to ``b`` via GCC-PHAT + 3-point
    parabolic interpolation. Returns a float array (batch shape of the
    broadcast inputs)."""
    cc = gcc_phat(a, b, max_lag=max_lag)
    m = (cc.shape[-1] - 1) // 2
    k = jnp.argmax(cc, axis=-1)
    kc = jnp.clip(k, 1, cc.shape[-1] - 2)
    ym = jnp.take_along_axis(cc, (kc - 1)[..., None], axis=-1)[..., 0]
    y0 = jnp.take_along_axis(cc, kc[..., None], axis=-1)[..., 0]
    yp = jnp.take_along_axis(cc, (kc + 1)[..., None], axis=-1)[..., 0]
    denom = ym - 2.0 * y0 + yp
    delta = jnp.where(denom == 0.0, 0.0, 0.5 * (ym - yp) / denom)
    delta = jnp.clip(delta, -0.5, 0.5)
    return (kc - m).astype(jnp.float32) + delta
