"""Pulse-Doppler radar chain: LFM compression, Doppler FFT, CA-CFAR.

Fourth model family beside the FM chain, OFDM and the QAM modem: the
sensing counterpart — a coherent processing interval of LFM pulses turned
into a range-Doppler detection map. Exercises the framework's
correlator (ops.correlate: fast-time matched filter), window catalog
(slow-time taper), batched FFT and the moving-sum machinery in two
dimensions (CA-CFAR noise estimation = box sums over the range-Doppler
map — the headline averager family's 2-D shape). North-star scope like
models/ofdm.py (the CUDA reference has no radar models; SURVEY.md §6).

Design choices:
- fast-time matched filtering of ALL pulses in one batched planar
  correlation (4 real correlations through one engine) — never a
  per-pulse loop;
- slow-time Doppler as one batched FFT over the pulse axis;
- CA-CFAR with exact edge handling: training-cell sums AND per-cell
  training counts both come from 2-D box convolutions, so edge cells get
  their true cell count and threshold multiplier instead of a padded bias
  (no gathers, no masks in Python loops);
- planar I/Q at the host boundary; complex forms on device.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "RadarConfig",
    "lfm_pulse",
    "synthesize",
    "pulse_compress",
    "doppler_map",
    "ca_cfar",
    "detect",
    "detect_batch",
    "ambiguity",
]


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """One coherent processing interval. ``bandwidth`` is the LFM sweep in
    cycles/sample (time-bandwidth product = bandwidth * pulse_len);
    ``guard``/``train`` are CFAR half-window cell counts per axis
    (doppler, range)."""

    n_pulses: int = 64
    n_range: int = 1024  # fast-time samples per PRI
    pulse_len: int = 128
    bandwidth: float = 0.5
    window: str = "hann"
    guard: tuple[int, int] = (2, 2)
    train: tuple[int, int] = (4, 8)
    pfa: float = 1e-4

    def __post_init__(self):
        if self.pulse_len > self.n_range:
            raise ValueError(
                f"pulse_len {self.pulse_len} exceeds n_range {self.n_range}"
            )
        if not 0.0 < self.bandwidth <= 1.0:
            raise ValueError(f"bandwidth must be in (0, 1], got {self.bandwidth}")

    @property
    def n_bins(self) -> int:
        """Output range bins after 'valid' compression."""
        return self.n_range - self.pulse_len + 1


def lfm_pulse(cfg: RadarConfig) -> tuple[np.ndarray, np.ndarray]:
    """Unit-energy linear-FM chirp sweeping [-bw/2, +bw/2), planar (i, q)."""
    t = np.arange(cfg.pulse_len, dtype=np.float64)
    phase = np.pi * cfg.bandwidth * (t * t / cfg.pulse_len - t)
    p = np.exp(1j * phase) / np.sqrt(cfg.pulse_len)
    return p.real.astype(np.float32), p.imag.astype(np.float32)


def synthesize(
    cfg: RadarConfig,
    targets,
    *,
    noise_power: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side echo simulator (the tests' oracle).

    ``targets``: iterable of (range_bin, doppler, amplitude) with
    ``doppler`` in cycles/PRI in [-0.5, 0.5) — the stop-and-hop model: a
    constant phase step per pulse. Returns planar (i, q), each
    (n_pulses, n_range).
    """
    pr, pi = lfm_pulse(cfg)
    pulse = pr.astype(np.float64) + 1j * pi.astype(np.float64)
    x = np.zeros((cfg.n_pulses, cfg.n_range), np.complex128)
    for rbin, fd, amp in targets:
        rbin = int(rbin)
        if not 0 <= rbin <= cfg.n_range - cfg.pulse_len:
            raise ValueError(f"range bin {rbin} outside [0, {cfg.n_bins - 1}]")
        steps = np.exp(2j * np.pi * fd * np.arange(cfg.n_pulses))
        x[:, rbin : rbin + cfg.pulse_len] += amp * np.outer(steps, pulse)
    if noise_power > 0.0:
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(noise_power / 2.0)
        x += sigma * (
            rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
        )
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def pulse_compress(cfg: RadarConfig, i: jax.Array, q: jax.Array) -> jax.Array:
    """Fast-time matched filter: valid correlation of every pulse with the
    transmit chirp, all pulses in one batched planar complex correlation
    (ops.correlate.correlate_complex — at production shapes its auto picks
    the lane-blocked banded direct conv).
    A point echo of amplitude a at range bin r peaks at output bin r with
    amplitude a (unit-energy chirp), while noise is spread — the
    sqrt(pulse_len) SNR compression gain."""
    from ..ops.correlate import correlate_complex

    pr, pi = lfm_pulse(cfg)
    c_re, c_im = correlate_complex(
        i.astype(jnp.float32),
        q.astype(jnp.float32),
        jnp.asarray(pr),
        jnp.asarray(pi),
        mode="valid",
    )
    return jax.lax.complex(c_re, c_im)


@functools.lru_cache(maxsize=16)
def _doppler_dft(n_pulses: int, window: str) -> tuple[np.ndarray, np.ndarray]:
    """Windowed, fftshifted slow-time DFT as one dense matrix: row r is
    doppler (r - n//2)/n cycles/PRI with the taper folded in (host-side,
    cached per (n, window) — the shift is free row ordering)."""
    from ..ops.fft import get_window

    n = n_pulses
    f = (np.arange(n) - n // 2)[:, None] / n
    c = np.exp(-2j * np.pi * f * np.arange(n)[None, :])
    c *= np.asarray(get_window(window, n), np.float64)[None, :]
    return c.real.astype(np.float32), c.imag.astype(np.float32)


def doppler_map(cfg: RadarConfig, rc: jax.Array) -> jax.Array:
    """Slow-time DFT across pulses -> fftshifted power map
    (n_pulses dopplers, n_bins ranges). Doppler f maps to row
    n_pulses//2 + round(f * n_pulses).

    The pulse count is small (tens to hundreds), so the spelling is NOT
    an FFT but one dense (P, P) x (P, n_bins) DFT matmul pair with the
    taper and fftshift folded into the matrix; for large P it falls back
    to the batched FFT. Both spellings are numerically identical up to
    matmul precision (pinned by tests)."""
    xr = jnp.real(rc)
    xi = jnp.imag(rc)
    if cfg.n_pulses <= 512:
        cr, ci = _doppler_dft(cfg.n_pulses, cfg.window)
        cr = jnp.asarray(cr)
        ci = jnp.asarray(ci)
        hp = jax.lax.Precision.HIGHEST
        rr = jnp.dot(cr, xr, precision=hp) - jnp.dot(ci, xi, precision=hp)
        ri = jnp.dot(cr, xi, precision=hp) + jnp.dot(ci, xr, precision=hp)
        return rr * rr + ri * ri
    from ..ops.fft import get_window

    w = jnp.asarray(get_window(cfg.window, cfg.n_pulses), jnp.float32)
    rd = jnp.fft.fft(rc * w[:, None], axis=0)
    rd = jnp.fft.fftshift(rd, axes=0)
    return jnp.abs(rd) ** 2


def _box_sum(a: jax.Array, hd: int, hr: int) -> jax.Array:
    """Zero-filled centered 2-D box sum, separable: banded (D, D) matmul
    over the (small) doppler axis x centered boxcar FIR over the (long)
    range axis: two matmuls + two banded FIRs, where four dense 2-D convs
    through a single-feature conv (533 taps at the default config) would
    leave the feature dims at 1."""
    from ..ops.fir import fir_direct

    d = a.shape[0]
    band = np.zeros((d, d), np.float32)
    for i in range(d):
        band[i, max(0, i - hd) : min(d, i + hd + 1)] = 1.0
    y = jnp.matmul(jnp.asarray(band), a, precision=jax.lax.Precision.HIGHEST)
    # centered range boxcar: causal k=2hr+1 conv of the right-padded
    # rows, sliced back by hr
    yp = jnp.pad(y, ((0, 0), (0, hr)))
    taps = jnp.ones(2 * hr + 1, jnp.float32)
    return fir_direct(yp, taps)[:, hr:]


def _count1d(n: int, h: int) -> np.ndarray:
    i = np.arange(n)
    return (np.minimum(i + h, n - 1) - np.maximum(i - h, 0) + 1).astype(
        np.float32
    )


def _count1d_window(n_full: int, lo: int, nb: int, h: int) -> np.ndarray:
    """Per-cell 1-D training count CLIPPED TO THE VALID WINDOW [lo, lo+nb):
    the count _count1d(nb, h) would produce on the sliced axis, evaluated
    at full-width positions (1.0 outside the window — masked downstream)."""
    i = np.arange(n_full)
    j = np.clip(i - lo, 0, max(nb - 1, 0))
    c = np.minimum(j + h, nb - 1) - np.maximum(j - h, 0) + 1
    return np.where(
        (i >= lo) & (i < lo + nb), c.astype(np.float32), np.float32(1.0)
    )


def _cfar_core(
    p: jax.Array,
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
    count_d: tuple[np.ndarray, np.ndarray],
    count_r: tuple[np.ndarray, np.ndarray],
) -> tuple[jax.Array, jax.Array]:
    """CA-CFAR sums + exact per-cell-count alpha, with the 1-D count
    factors supplied by the caller (array bounds for the public ca_cfar;
    valid-window bounds for detect's full-width fused chain)."""
    gd, gr = guard
    td, tr = train
    outer_sum = _box_sum(p, gd + td, gr + tr)
    inner_sum = _box_sum(p, gd, gr)
    # counts stay as FOUR 1-D host constants broadcast on device — an
    # (D, R) host-side outer product would ride the HLO as a giant
    # constant
    n = jnp.asarray(count_d[0])[:, None] * jnp.asarray(count_r[0])[None, :] - (
        jnp.asarray(count_d[1])[:, None] * jnp.asarray(count_r[1])[None, :]
    )
    z = outer_sum - inner_sum  # training-cell power sum
    alpha = n * (pfa ** (-1.0 / n) - 1.0)
    thresh = alpha * z / n
    return p > thresh, thresh


def ca_cfar(
    power: jax.Array,
    *,
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
) -> tuple[jax.Array, jax.Array]:
    """Cell-averaging CFAR over a 2-D power map -> (detections, threshold).

    Noise is estimated per cell from the ring of training cells (the
    (guard+train) box minus the guard box); the threshold multiplier is
    the exact exponential-noise CA-CFAR alpha = N * (pfa^(-1/N) - 1)
    evaluated with each cell's TRUE training count N (edge cells have
    fewer): sums from separable box filters (banded doppler matmul +
    range boxcar FIR), counts from closed-form 1-D factors.
    """
    if not 0.0 < pfa < 1.0:
        raise ValueError(f"pfa must be in (0, 1), got {pfa}")
    gd, gr = guard
    td, tr = train
    if td < 1 or tr < 1:
        raise ValueError(f"need >= 1 training cell per axis, got {train}")
    p = power.astype(jnp.float32)
    d, r = p.shape
    return _cfar_core(
        p,
        guard,
        train,
        pfa,
        (_count1d(d, gd + td), _count1d(d, gd)),
        (_count1d(r, gr + tr), _count1d(r, gr)),
    )


def ambiguity(
    pulse_i,
    pulse_q,
    *,
    dopplers=None,
    n_doppler: int = 65,
):
    """Normalized power ambiguity surface |chi(tau, nu)|^2 of a pulse.

    The waveform-design side of the radar family: the matched filter's
    delay-Doppler response. ``chi(tau, nu) = sum_n u[n+tau] u*[n]
    e^{j 2 pi nu n}`` (power is convention-phase free), peak-normalized so
    ``|chi(0, 0)|^2 = 1``. Returns ``(delays, dopplers, amb)``: integer
    delays -(L-1)..(L-1), Doppler grid in cycles/sample (default
    ``n_doppler`` points spanning +-2/L — two Doppler resolution cells),
    and the (n_doppler, 2L-1) float32 surface.

    The whole surface is ONE batched planar complex
    correlation (``ops.correlate.correlate_complex``) of the
    Doppler-shifted bank u * e^{j 2 pi nu n} against u — no per-delay
    loops; the Doppler bank rides broadcasting.
    """
    from ..ops.correlate import correlate_complex

    pi_ = np.asarray(pulse_i, np.float32)
    qi_ = np.asarray(pulse_q, np.float32)
    if pi_.ndim != 1 or pi_.shape != qi_.shape:
        raise ValueError(
            f"pulse must be planar 1-D (i, q), got {pi_.shape}/{qi_.shape}"
        )
    length = pi_.shape[0]
    if dopplers is None:
        dopplers = np.linspace(-2.0 / length, 2.0 / length, n_doppler)
    dopplers = np.asarray(dopplers, np.float64)
    ph = 2.0 * np.pi * np.outer(dopplers, np.arange(length))
    cr = jnp.asarray(np.cos(ph), jnp.float32)
    sr = jnp.asarray(np.sin(ph), jnp.float32)
    ui = jnp.asarray(pi_)
    uq = jnp.asarray(qi_)
    ar = cr * ui - sr * uq  # u * e^{j 2 pi nu n}, planar
    ai = sr * ui + cr * uq
    rr, ri = correlate_complex(ar, ai, ui, uq, mode="full")
    energy = float(np.sum(pi_.astype(np.float64) ** 2 + qi_.astype(np.float64) ** 2))
    amb = (rr * rr + ri * ri) / np.float32(energy**2)
    delays = np.arange(-(length - 1), length)
    return delays, dopplers, amb


def detect_batch(cfg: RadarConfig, i: jax.Array, q: jax.Array, *, mesh=None):
    """Batch of CPIs through the full chain — the radar family's dp story.

    ``i``/``q``: (batch, n_pulses, n_range) planar echoes. The chain is
    vmapped over the leading axis; with ``mesh`` the batch is placed on the
    channel mesh axis and GSPMD runs each device's CPIs independently (no
    collectives — one CPI never spans devices, so this scales linearly).
    Returns (detections, power, threshold), each (batch, n_pulses, n_bins).
    """
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.mesh import CHANNEL_AXIS

        sharding = NamedSharding(mesh, PartitionSpec(CHANNEL_AXIS))
        i = jax.device_put(i, sharding)
        q = jax.device_put(q, sharding)
    fn = jax.vmap(lambda a, b: detect(cfg, a, b))
    return fn(i, q)


@functools.partial(jax.jit, static_argnames=("cfg",))
def detect(cfg: RadarConfig, i: jax.Array, q: jax.Array):
    """Full chain: planar (n_pulses, n_range) echoes -> detection map.

    Returns (detections, power, threshold): boolean (n_pulses, n_bins)
    range-Doppler detections plus the underlying map and CFAR threshold.

    The matched filter's 'valid' slice starts at lane offset
    pulse_len-1 — a misaligned minor axis that every downstream op would
    pay relayout for. The chain therefore correlates in 'full' mode
    (aligned start) and takes the tail slice on the final power map, with
    bit-identical output.
    """
    from ..ops.correlate import correlate_complex

    pr, pi_ = lfm_pulse(cfg)
    # Gauss 3-multiplication matched filter — 3 banded convs instead of 4
    c_re, c_im = correlate_complex(
        i.astype(jnp.float32),
        q.astype(jnp.float32),
        jnp.asarray(pr),
        jnp.asarray(pi_),
        mode="full",
        method="direct_gauss",
    )
    rc = jax.lax.complex(c_re, c_im)
    full = doppler_map(cfg, rc)  # (n_pulses, ta + pulse_len - 1), aligned
    lo, nb = cfg.pulse_len - 1, cfg.n_bins
    # Round-5 composition fix: the whole CFAR runs at ALIGNED full width
    # and the misaligned valid slice moves to the very END (one read each
    # of det/power/thresh instead of every CFAR pass paying the offset-127
    # relayout — the r4 aligned-slice doctrine applied to the last stage).
    # Exactness: out-of-valid columns are MASKED TO ZERO (an iota select
    # fused into the power epilogue), which reproduces _box_sum's
    # zero-fill edge semantics exactly, and the range count factors come
    # from _count1d_window so every alpha matches the sliced-map CFAR's in
    # exact arithmetic; the range boxcar's f32 accumulation ORDER shifts
    # with the lane offset, so thresholds agree to the ulp (power and
    # detections pinned equal by test_detect_fullwidth_cfar_bitexact).
    col = jnp.arange(full.shape[-1])
    p_masked = jnp.where((col >= lo) & (col < lo + nb), full, 0.0)
    gd, gr = cfg.guard
    td, tr = cfg.train
    w = full.shape[-1]
    det_f, thresh_f = _cfar_core(
        p_masked,
        cfg.guard,
        cfg.train,
        cfg.pfa,
        (_count1d(cfg.n_pulses, gd + td), _count1d(cfg.n_pulses, gd)),
        (_count1d_window(w, lo, nb, gr + tr), _count1d_window(w, lo, nb, gr)),
    )
    sl = slice(lo, lo + nb)
    return det_f[:, sl], full[:, sl], thresh_f[:, sl]
