"""CIC (cascaded integrator-comb) multirate filters.

The CIC is the standard first decimation/interpolation stage of every DDC/
DUC front end (Hogenauer 1981): N integrators at the high rate, rate change
R, N combs with differential delay M — multiplier-free in hardware. The
textbook spelling is 2N sequential recursions; the mathematically
identical spelling is ONE FIR whose impulse response is the N-fold
convolution of length-R*M boxcars, because

    H(z) = ((1 - z^{-RM}) / (1 - z^{-1}))^N = (boxcar_{RM}(z))^N.

So decimation rides the framework's measured FIR ladder
(``ops.fir.fir_filter``: direct conv / fused overlap-save — the same
engines the headline averager family uses) plus a strided slice, and
interpolation rides the banded ``upfirdn`` machinery (zero-stuffing
folded into the tap matrix). No sequential scans, no modular-arithmetic
state to carry; parity with the integer integrator-comb reference is
pinned by tests. Completes the multirate family beside ``ops.resample``
(polyphase/Farrow) — the CUDA reference has no multirate front end
(SURVEY.md §6 north-star scope).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "cic_taps",
    "cic_gain",
    "cic_response",
    "cic_decimate",
    "cic_interpolate",
    "design_cic_compensator",
]


def _check(rate: int, n_stages: int, diff_delay: int) -> None:
    if rate < 2:
        raise ValueError(f"rate must be >= 2, got {rate}")
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if diff_delay < 1:
        raise ValueError(f"diff_delay must be >= 1, got {diff_delay}")


def cic_gain(rate: int, n_stages: int = 4, diff_delay: int = 1) -> int:
    """DC gain (R*M)^N of the un-normalized cascade."""
    _check(rate, n_stages, diff_delay)
    return (rate * diff_delay) ** n_stages


@functools.lru_cache(maxsize=32)
def cic_taps(rate: int, n_stages: int = 4, diff_delay: int = 1) -> np.ndarray:
    """Impulse response of the CIC: boxcar(R*M) convolved N times, int64.

    Length N*(R*M - 1) + 1; sums to :func:`cic_gain` exactly.
    """
    _check(rate, n_stages, diff_delay)
    box = np.ones(rate * diff_delay, np.int64)
    h = box
    for _ in range(n_stages - 1):
        h = np.convolve(h, box)
    return h


def cic_response(f, rate: int, n_stages: int = 4, diff_delay: int = 1):
    """|H| at high-rate frequencies ``f`` (cycles/sample), DC-normalized:
    |sin(pi R M f) / (R M sin(pi f))|^N (host-side design helper)."""
    _check(rate, n_stages, diff_delay)
    f = np.asarray(f, np.float64)
    rm = rate * diff_delay
    num = np.sin(np.pi * rm * f)
    den = rm * np.sin(np.pi * f)
    ratio = np.where(np.abs(den) < 1e-30, 1.0, num / np.where(den == 0, 1, den))
    return np.abs(ratio) ** n_stages


def cic_decimate(
    x: jax.Array,
    rate: int,
    *,
    n_stages: int = 4,
    diff_delay: int = 1,
    normalize: bool = True,
    method: str = "auto",
) -> jax.Array:
    """CIC decimation by ``rate``: (..., T) -> (..., ceil(T/rate)) float32.

    ``y[m] = (h * x)[m*rate]`` with the causal boxcar^N response — exactly
    the integrator -> decimate -> comb cascade output (pinned by tests
    against the int64 integrator-comb oracle). ``normalize`` divides by
    the (R*M)^N DC gain. ``method`` selects the FIR engine as in
    ``ops.fir.fir_filter``.
    """
    from .fir import fir_filter

    _check(rate, n_stages, diff_delay)
    h = cic_taps(rate, n_stages, diff_delay).astype(np.float64)
    if normalize:
        h = h / cic_gain(rate, n_stages, diff_delay)
    y = fir_filter(
        jnp.asarray(x, jnp.float32), jnp.asarray(h, jnp.float32), method=method
    )
    return y[..., ::rate]


def cic_interpolate(
    x: jax.Array,
    rate: int,
    *,
    n_stages: int = 4,
    diff_delay: int = 1,
    normalize: bool = True,
) -> jax.Array:
    """CIC interpolation by ``rate``: (..., T) -> (..., T*rate) float32.

    Zero-stuff by ``rate`` then filter with boxcar^N — one ``upfirdn``
    call (banded tap matrix), trimmed to exactly T*rate causal
    samples. ``normalize`` divides by (R*M)^N / R so a DC input keeps its
    amplitude through the rate change.
    """
    from .resample import upfirdn

    _check(rate, n_stages, diff_delay)
    h = cic_taps(rate, n_stages, diff_delay).astype(np.float64)
    if normalize:
        h = h * (rate / cic_gain(rate, n_stages, diff_delay))
    y = upfirdn(jnp.asarray(h, jnp.float32), jnp.asarray(x, jnp.float32), up=rate)
    return y[..., : x.shape[-1] * rate]


def design_cic_compensator(
    num_taps: int,
    rate: int,
    *,
    n_stages: int = 4,
    diff_delay: int = 1,
    passband: float = 0.5,
    transition: float = 0.2,
    window: str = "hamming",
) -> np.ndarray:
    """Inverse-sinc^N droop compensator FIR, run at the DECIMATED rate.

    Frequency-sampling design (``ops.fir.design_firwin2``) hitting
    1/|H_cic| across ``[0, passband]`` (low-rate Nyquist units) and 0 from
    ``passband + transition`` up — the standard CIC cleanup stage: cascade
    ``cic_decimate`` then ``fir_filter`` with these taps for a flat
    passband.
    """
    from .fir import design_firwin2

    _check(rate, n_stages, diff_delay)
    if not 0.0 < passband < 1.0:
        raise ValueError(f"passband must be in (0, 1), got {passband}")
    if not 0.0 < transition <= 1.0 - passband:
        raise ValueError(
            f"transition must be in (0, {1.0 - passband}], got {transition}"
        )
    grid = np.linspace(0.0, passband, 65)
    droop = cic_response(grid / (2.0 * rate), rate, n_stages, diff_delay)
    stop_lo = min(passband + transition, 1.0)
    freq = np.concatenate([grid, [stop_lo, 1.0]])
    gain = np.concatenate([1.0 / droop, [0.0, 0.0]])
    if stop_lo >= 1.0:  # transition reaches Nyquist: merge the points
        freq = np.concatenate([grid, [1.0]])
        gain = np.concatenate([1.0 / droop, [0.0]])
    return design_firwin2(num_taps, freq, gain, window=window)
