"""Float64 NumPy/SciPy reference of the FM receiver chain, and its input.

Independent of the code under test (models/chain.py): the same stages,
written straight from their definitions —

    mix:          z[n] = x[n] * exp(-2πi f n)          (absolute n)
    channel FIR:  causal convolution with the channel taps
    decimate:     causal convolution with the anti-alias taps, every q-th
    discriminate: angle(z[m] * conj(z[m-1])) * gain,   z[-1] = 0
    audio FIR:    causal convolution with the audio taps

Taps and LO frequencies are configuration, passed in by the caller.

``fm_test_signal`` makes an input on which such a comparison means
something: each channel carries a carrier at its own LO frequency,
frequency-modulated by one audio tone, plus complex white noise at a given
SNR. (On white noise alone the discriminator divides by near-zero
magnitudes, and no float32-against-float64 tolerance holds.)
"""

from __future__ import annotations

import numpy as np
from scipy import signal


def _causal_fir(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """y[n] = sum_j h[j] x[n - j] along the last axis, zeros before 0."""
    h = np.asarray(taps, np.float64)[None, :]
    return signal.oaconvolve(x, h, axes=-1)[..., : x.shape[-1]]


def fm_chain_reference(
    i: np.ndarray,
    q: np.ndarray,
    lo_freqs: np.ndarray,
    channel_taps: np.ndarray,
    decim_taps: np.ndarray,
    audio_taps: np.ndarray,
    decimation: int,
    gain: float = 1.0,
) -> np.ndarray:
    """(C, T) I/Q planes -> (C, T // decimation) float64 audio."""
    x = np.asarray(i, np.float64) + 1j * np.asarray(q, np.float64)
    t = x.shape[-1]
    n = np.arange(t, dtype=np.float64)
    f = np.asarray(lo_freqs, np.float64)[:, None]
    mixed = x * np.exp(-2j * np.pi * np.mod(f * n, 1.0))
    filt = _causal_fir(mixed, channel_taps)
    dec = _causal_fir(filt, decim_taps)[..., ::decimation][..., : t // decimation]
    audio = np.zeros(dec.shape)  # z[-1] = 0: the first sample has no angle
    audio[..., 1:] = np.angle(dec[..., 1:] * np.conj(dec[..., :-1])) * gain
    return _causal_fir(audio, audio_taps)


def fm_test_signal(
    lo_freqs: np.ndarray,
    t: int,
    *,
    tone: float = 0.002,
    beta: float = 5.0,
    snr_db: float = 30.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(C, t) float32 I/Q planes: FM carriers at ``lo_freqs`` plus noise.

    Channel c: ``exp(i (2π f_c n + beta sin(2π tone n)))`` + complex
    white noise of power ``10**(-snr_db/10)``. ``tone`` is in cycles per
    input sample; the peak frequency deviation is ``beta * tone``.
    """
    rng = np.random.default_rng(seed)
    f = np.asarray(lo_freqs, np.float64)[:, None]
    n = np.arange(t, dtype=np.float64)[None, :]
    phase = 2 * np.pi * np.mod(f * n, 1.0) + beta * np.sin(2 * np.pi * tone * n)
    sigma = np.sqrt(10.0 ** (-snr_db / 10.0) / 2.0)
    shape = (f.shape[0], t)
    i = np.cos(phase) + sigma * rng.standard_normal(shape)
    q = np.sin(phase) + sigma * rng.standard_normal(shape)
    return i.astype(np.float32), q.astype(np.float32)


def tone_snr_db(audio: np.ndarray, freq: float) -> float:
    """SNR of the tone at ``freq`` (cycles/sample) in ``audio`` (last axis):
    least-squares fit of a sinusoid plus DC, fitted power over residual."""
    y = np.asarray(audio, np.float64)
    m = np.arange(y.shape[-1], dtype=np.float64)
    basis = np.stack(
        [np.cos(2 * np.pi * freq * m), np.sin(2 * np.pi * freq * m), np.ones_like(m)],
        axis=1,
    )
    coef, *_ = np.linalg.lstsq(basis, y.reshape(-1, y.shape[-1]).T, rcond=None)
    fit = (basis @ coef).T.reshape(y.shape)
    tone_only = (basis[:, :2] @ coef[:2]).T.reshape(y.shape)
    return float(
        10 * np.log10(np.sum(tone_only**2) / np.sum((y - fit) ** 2))
    )


__all__ = ["fm_chain_reference", "fm_test_signal", "tone_snr_db"]
