"""OFDM receiver: CP-based symbol sync, CFO estimation, FFT demod, 1-tap EQ.

A second communications model family beside the FM chain (models/chain.py):
the block-transform counterpart — where FM is a continuous-phase stream,
OFDM is framed spectra, exercising the framework's framing
(utils.layout.overlapping_frames), FFT, oscillator and correlation pieces
end to end.

Design choices:
- planar I/Q throughout (complex64 transfers are second-class on some PJRT
  backends); complex values form on device via lax.complex;
- symbol framing via shifted reshapes (overlapping_frames), never gathers;
- the classic van-de-Beek CP correlation for timing/CFO: one multiply of
  the stream with its n_fft-delayed conjugate + a moving sum (the
  framework's own windowed machinery), argmax over one symbol span;
- the whole receive path is jit-compatible with static shapes.

Scope: QPSK subcarriers, block pilot (a known first symbol) for the 1-tap
frequency-domain equalizer — the standard classroom/802.11-style shape,
enough to exercise sync + demod + EQ; coding/interleaving are out of scope.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class OfdmConfig:
    n_fft: int = 64
    cp: int = 16
    n_symbols: int = 50  # data symbols per burst (after the pilot)
    active: int = 48  # used subcarriers (centered, DC unused)

    @property
    def symbol_len(self) -> int:
        return self.n_fft + self.cp

    def subcarriers(self) -> np.ndarray:
        """Active subcarrier FFT bins (DC excluded, centered)."""
        half = self.active // 2
        return np.r_[np.arange(1, half + 1), np.arange(self.n_fft - half, self.n_fft)]


def qpsk_mod(bits: np.ndarray) -> np.ndarray:
    """Pairs of bits -> unit-energy QPSK symbols (Gray: 00->1+1j scaled)."""
    b = np.asarray(bits).reshape(-1, 2)
    return ((1 - 2 * b[:, 0]) + 1j * (1 - 2 * b[:, 1])) / np.sqrt(2)


def qpsk_demod(sym: np.ndarray) -> np.ndarray:
    """Hard-decision QPSK -> bit pairs (inverse of qpsk_mod)."""
    s = np.asarray(sym)
    return np.stack([(s.real < 0), (s.imag < 0)], axis=-1).astype(np.int8).reshape(-1)


def ofdm_modulate(
    cfg: OfdmConfig, bits: np.ndarray, pilot_seed: int = 7
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side burst builder (the test oracle's transmitter).

    Returns planar (i, q) of the burst: [pilot symbol | data symbols], each
    IFFT(n_fft) with a cp-sample cyclic prefix. ``bits`` length must be
    2 * active * n_symbols.
    """
    want = 2 * cfg.active * cfg.n_symbols
    if np.asarray(bits).size != want:
        raise ValueError(f"need {want} bits, got {np.asarray(bits).size}")
    sc = cfg.subcarriers()
    rng = np.random.default_rng(pilot_seed)
    pilot = np.exp(1j * 2 * np.pi * rng.integers(0, 4, cfg.active) / 4)
    syms = qpsk_mod(bits).reshape(cfg.n_symbols, cfg.active)
    grid = np.zeros((cfg.n_symbols + 1, cfg.n_fft), complex)
    grid[0, sc] = pilot
    grid[1:, sc] = syms
    time = np.fft.ifft(grid, axis=-1) * np.sqrt(cfg.n_fft)
    burst = np.concatenate([time[:, -cfg.cp :], time], axis=-1).reshape(-1)
    return burst.real.astype(np.float32), burst.imag.astype(np.float32)


def _pilot_freq(cfg: OfdmConfig, pilot_seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(pilot_seed)
    return np.exp(1j * 2 * np.pi * rng.integers(0, 4, cfg.active) / 4)


class OfdmReceiver:
    """Stateless burst receiver; config baked at construction."""

    def __init__(self, cfg: OfdmConfig = OfdmConfig(), pilot_seed: int = 7):
        self.cfg = cfg
        p = _pilot_freq(cfg, pilot_seed)
        self._pilot_re = jnp.asarray(p.real.astype(np.float32))
        self._pilot_im = jnp.asarray(p.imag.astype(np.float32))
        self._sc = jnp.asarray(cfg.subcarriers().astype(np.int32))

    @functools.partial(jax.jit, static_argnums=0)
    def synchronize(self, i: jax.Array, q: jax.Array):
        """(timing_offset, cfo) from the cyclic-prefix correlation.

        van de Beek: gamma[d] = sum_{k<cp} r[d+k] * conj(r[d+k+n_fft]);
        |gamma| peaks where a CP aligns; the peak's phase/2pi/n_fft is the
        fractional carrier offset (cycles/sample). The moving sum rides
        the same trace-time framing as everything else (no gathers).
        """
        c = self.cfg
        n, cp = c.n_fft, c.cp
        x_re = i.astype(jnp.float32)
        x_im = q.astype(jnp.float32)
        # r[d] * conj(r[d+n]) in planar arithmetic
        a_re, a_im = x_re[:-n], x_im[:-n]
        b_re, b_im = x_re[n:], x_im[n:]
        p_re = a_re * b_re + a_im * b_im
        p_im = a_im * b_re - a_re * b_im
        # moving sum over cp samples (windowed machinery, float path)
        k = jnp.ones((cp,), jnp.float32)
        from ..ops.fir import blocked_causal_conv

        g_re = blocked_causal_conv(p_re[None, :], k)[0][cp - 1 :]
        g_im = blocked_causal_conv(p_im[None, :], k)[0][cp - 1 :]
        mag = g_re**2 + g_im**2
        # the first CP lies within the first symbol span
        span = c.symbol_len
        d = jnp.argmax(mag[:span]).astype(jnp.int32)
        # r[t]*conj(r[t+n]) = |s|^2 * exp(-j*2*pi*eps*n): the peak phase is
        # MINUS 2*pi*cfo*n_fft
        ang = jnp.arctan2(g_im[d], g_re[d])
        cfo = -ang / (2.0 * jnp.pi * n)  # cycles/sample
        return d, cfo

    @functools.partial(jax.jit, static_argnums=0)
    def demodulate(self, i: jax.Array, q: jax.Array, timing: jax.Array, cfo: jax.Array):
        """(eq_re, eq_im): equalized active-subcarrier symbols (n_symbols, active)."""
        c = self.cfg
        n, cp, sl = c.n_fft, c.cp, c.symbol_len
        total = (c.n_symbols + 1) * sl
        # CFO correction with the exact-phase oscillator, then align
        t_idx = jnp.arange(i.shape[-1], dtype=jnp.float32)
        ph = -2.0 * jnp.pi * cfo * t_idx
        lo_re, lo_im = jnp.cos(ph), jnp.sin(ph)
        x_re = i * lo_re - q * lo_im
        x_im = i * lo_im + q * lo_re
        x_re = jax.lax.dynamic_slice(x_re, (timing,), (total,))
        x_im = jax.lax.dynamic_slice(x_im, (timing,), (total,))
        # frame symbols, drop CPs, FFT (complex formed on device)
        fr_re = x_re.reshape(c.n_symbols + 1, sl)[:, cp:]
        fr_im = x_im.reshape(c.n_symbols + 1, sl)[:, cp:]
        spec = jnp.fft.fft(jax.lax.complex(fr_re, fr_im), axis=-1) / jnp.sqrt(
            jnp.float32(n)
        )
        act = jnp.take(spec, self._sc, axis=-1)  # (n_symbols+1, active)
        # 1-tap EQ from the pilot symbol
        pilot = jax.lax.complex(self._pilot_re, self._pilot_im)
        h = act[0] / pilot
        eq = act[1:] / h
        # common-phase tracking (Viterbi&Viterbi): the CFO estimator's
        # residual (~1e-4 cycles/sample at 20 dB) integrates to tens of
        # degrees across a burst. Per symbol, angle(sum((eq/|eq|)^4)) - pi
        # over 4 estimates the common rotation modulo 90°; the 90°
        # ambiguity resolves differentially from the pilot-anchored start
        # (per-symbol drift << 45°).
        u = eq / (jnp.abs(eq) + 1e-12)
        z4 = jnp.sum(u**4, axis=-1)
        phi_raw = (jnp.angle(z4) - jnp.pi) / 4.0  # (n_symbols,)
        quarter = jnp.pi / 2.0

        def unwrap(prev, raw):
            phi = raw + jnp.round((prev - raw) / quarter) * quarter
            return phi, phi

        _, phi = jax.lax.scan(unwrap, jnp.float32(0.0), phi_raw)
        rot = jnp.exp(jax.lax.complex(jnp.zeros_like(phi), -phi))[:, None]
        eq = eq * rot
        return jnp.real(eq), jnp.imag(eq)

    def receive_bits(self, i: np.ndarray, q: np.ndarray) -> np.ndarray:
        """Full burst receive on host conventions: bits out."""
        d, cfo = self.synchronize(jnp.asarray(i), jnp.asarray(q))
        er, ei = self.demodulate(jnp.asarray(i), jnp.asarray(q), d, cfo)
        return qpsk_demod(np.asarray(er) + 1j * np.asarray(ei))


__all__ = [
    "OfdmConfig",
    "OfdmReceiver",
    "ofdm_modulate",
    "qpsk_demod",
    "qpsk_mod",
]
