"""Numerics rules shared by every averager variant.

The reference's numerics dossier (SURVEY.md §5):

- samples are int16; window sums are int64 on the CPU golden model
  (profilable_moving_averager.cpp:17) and int64/int32 on the CUDA variants;
- cumulative sums are int64 in the scan variants with an explicit
  "2^15 · 2^31 < 2^63 never overflows" argument
  (hillis_steele_vloaded_averager.cu:43);
- output quantization is C-style **truncating** integer division
  (profilable_moving_averager.cpp:23) or float ``sum * (1/grade)`` with a
  truncating cast on the GPU variants (profilable_sm_averager.cu:43).

int32 replacement for the int64 cumsum
-------------------------------------
int64 arithmetic doubles the bytes every scan moves. We instead run
the prefix sum in **int32 modular (two's-complement wraparound) arithmetic**:

    window_sum[i] = (cumsum[i] - cumsum[i - k*C]) mod 2^32

equals the true window sum whenever the *true* window sum fits in int32 —
i.e. whenever ``k * 32768 < 2^31  ⇔  k <= 65535``. Intermediate cumsum
overflow is harmless because subtraction mod 2^32 cancels it exactly. This
exceeds the reference's own window ceiling (~11700, smem-bound:
hillis_steele_vloaded_averager.cu:275-276) and its sweep maximum (1000) by
5-65×, so the int32 path is *bit-exact* against the int64 golden model over
the entire supported envelope. ``MAX_EXACT_WINDOW`` enforces the bound.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Largest window for which the int32 modular scan is bit-exact for int16
# input: k * max|int16| = k * 32768 <= 2^31 - 1  =>  k <= 65535.
MAX_EXACT_WINDOW = 65535


def trunc_div(num, den):
    """C-style integer division: truncation toward zero.

    NumPy / JAX ``//`` floors (rounds toward -inf); C++ ``/`` on integers
    truncates toward zero (profilable_moving_averager.cpp:23). The two differ
    for negative window sums, so every variant must use this helper to stay
    bit-exact with the golden model. Works on both NumPy and JAX arrays.
    ``den`` must be positive.
    """
    if isinstance(num, np.ndarray):
        return np.where(num >= 0, num // den, -((-num) // den))
    return jnp.where(num >= 0, num // den, -((-num) // den))


def float_reciprocal_quantize(wsum, window, out_dtype=jnp.int16):
    """Reference-GPU-style quantization: ``sum * (1.0/window)`` + trunc cast.

    The tiled/scan CUDA variants multiply by a precomputed reciprocal
    (profilable_sm_averager.cu:43, hillis_steele_averager.cu:97-98) instead
    of dividing; for a handful of (sum, k) pairs this lands one LSB away from
    true integer division. Provided for A/B parity studies only — the default
    everywhere in this framework is exact :func:`trunc_div`.
    """
    inv = np.float32(1.0) / np.float32(window)
    return jnp.trunc(wsum.astype(jnp.float32) * inv).astype(out_dtype)


def exact_window_bound(sample_bits: int = 16) -> int:
    """Max window for which int32 modular window sums are exact."""
    max_abs = 1 << (sample_bits - 1)  # 32768 for int16 (|-32768| dominates)
    return (2**31 - 1) // max_abs


def snr_db(reference: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-noise ratio of `test` against `reference`, in dB."""
    ref = np.asarray(reference, dtype=np.float64)
    err = np.asarray(test, dtype=np.float64) - ref
    p_sig = float(np.sum(ref * ref))
    p_err = float(np.sum(err * err))
    if p_err == 0.0:
        return float("inf")
    if p_sig == 0.0:
        return float("-inf")
    return 10.0 * np.log10(p_sig / p_err)
