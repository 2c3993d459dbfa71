"""Single-tone purity instruments: THD, SINAD, SNR, SFDR, ENOB.

The ADC/RF test-bench metrics (MATLAB ``thd``/``sinad``/``sfdr`` analogs,
IEEE 1241 style): one windowed power spectrum of a tone-dominated record,
the fundamental and its harmonics located and integrated over the window's
leakage width, everything else counted as noise. Complements the sweep
harness's throughput metrics with signal-quality metrics — the other half
of a production DSP qualification story (north-star scope, SURVEY.md §6).

Shape: one rFFT (the framework engine) + masked reductions with
traced bin indices — fully jittable, no host round trips; harmonics
beyond Nyquist are folded back (aliased) like a real ADC measurement.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["tone_metrics", "thd", "sinad", "snr_tone", "sfdr", "enob"]


@functools.partial(
    jax.jit, static_argnames=("window", "n_harmonics", "leak", "dc_guard")
)
def tone_metrics(
    x: jax.Array,
    *,
    window: str = "hann",
    n_harmonics: int = 6,
    leak: int = 3,
    dc_guard: int = 5,
) -> dict:
    """All purity metrics of a tone-dominated record in one pass.

    Returns a dict of scalars: ``f0`` (cycles/sample), ``fund_db`` (dB,
    arbitrary reference), ``thd_db`` (dBc, harmonics 2..n vs fundamental),
    ``snr_db`` (fundamental vs noise excluding harmonics), ``sinad_db``
    (fundamental vs everything else), ``sfdr_db`` (fundamental vs largest
    spur, harmonics included), ``enob`` ((SINAD - 1.76)/6.02).

    Each component integrates ``2*leak + 1`` bins around its line (the
    analysis window's leakage width); the first ``dc_guard`` bins are
    excluded everywhere. Harmonic lines beyond Nyquist fold back.
    """
    from .fft import spectral_window

    xf = jnp.asarray(x, jnp.float32)
    if xf.ndim != 1:
        raise ValueError(f"tone_metrics expects a 1-D record, got {xf.shape}")
    n = xf.shape[0]
    w = jnp.asarray(spectral_window(window, n))
    p = jnp.abs(jnp.fft.rfft(xf * w)) ** 2
    nb = p.shape[0]
    bins = jnp.arange(nb)
    guard = bins < dc_guard

    def line_mask(k):
        return (jnp.abs(bins - k) <= leak) & ~guard

    k0 = jnp.argmax(jnp.where(guard, -jnp.inf, p))
    fund_mask = line_mask(k0)
    p_fund = jnp.sum(jnp.where(fund_mask, p, 0.0))

    harm_mask = jnp.zeros(nb, bool)
    for h in range(2, n_harmonics + 1):
        kh = (h * k0) % n
        kh = jnp.where(kh > n // 2, n - kh, kh)  # fold past Nyquist
        harm_mask = harm_mask | line_mask(kh)
    harm_mask = harm_mask & ~fund_mask
    p_harm = jnp.sum(jnp.where(harm_mask, p, 0.0))

    p_total = jnp.sum(jnp.where(guard, 0.0, p))
    p_noise = jnp.maximum(p_total - p_fund - p_harm, 1e-30)
    p_nad = jnp.maximum(p_total - p_fund, 1e-30)

    # Largest spur: integrate the leak window around the biggest
    # non-fundamental bin (harmonics count as spurs).
    spur_p = jnp.where(fund_mask | guard, -jnp.inf, p)
    ks = jnp.argmax(spur_p)
    p_spur = jnp.sum(jnp.where(line_mask(ks) & ~fund_mask, p, 0.0))

    db = lambda r: 10.0 * jnp.log10(jnp.maximum(r, 1e-30))
    sinad_db = db(p_fund / p_nad)
    return {
        "f0": k0.astype(jnp.float32) / n,
        "fund_db": db(p_fund),
        "thd_db": db(p_harm / p_fund),
        "snr_db": db(p_fund / p_noise),
        "sinad_db": sinad_db,
        "sfdr_db": db(p_fund / jnp.maximum(p_spur, 1e-30)),
        "enob": (sinad_db - 1.76) / 6.02,
    }


def thd(x: jax.Array, **kw) -> float:
    """Total harmonic distortion in dBc (negative for clean signals)."""
    return float(tone_metrics(x, **kw)["thd_db"])


def sinad(x: jax.Array, **kw) -> float:
    """Signal to noise-and-distortion ratio in dB."""
    return float(tone_metrics(x, **kw)["sinad_db"])


def snr_tone(x: jax.Array, **kw) -> float:
    """Tone SNR in dB (harmonics excluded from the noise)."""
    return float(tone_metrics(x, **kw)["snr_db"])


def sfdr(x: jax.Array, **kw) -> float:
    """Spurious-free dynamic range in dB."""
    return float(tone_metrics(x, **kw)["sfdr_db"])


def enob(x: jax.Array, **kw) -> float:
    """Effective number of bits: (SINAD - 1.76 dB) / 6.02."""
    return float(tone_metrics(x, **kw)["enob"])
