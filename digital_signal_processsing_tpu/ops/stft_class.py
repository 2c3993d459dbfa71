"""ShortTimeFFT — scipy's canonical sliding-window STFT API.

The class form of the package's STFT surface (scipy.signal.ShortTimeFFT):
explicit window/hop/fs bookkeeping, signal-edge covering slices, exact
inversion through the canonical dual window, and the four fft modes. The
transform itself rides the same engines as :func:`ops.fft.stft` — the
framing is the gather-free shifted-view decomposition and the DFT goes
through ``jnp.fft`` (or the matmul engine with ``method='mxu'``); slices are batched so the whole spectrogram is
one device call.

Conventions verified against scipy empirically (pinned in
tests/test_stft_class.py): slice ``p`` windows
``x[p*hop - m_num_mid : ... + m_num]``; the default ``phase_shift=0``
multiplies bin ``q`` by ``exp(2j pi q (m_num_mid + phase_shift)/mfft)``
(``None`` = no factor); ``p_min = -((m_num - m_num_mid - 1) // hop)`` (first slice whose window
overlaps the signal); ``p_max(n) = (n - 1 + m_num_mid) // hop + 1``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _calc_dual_canonical_window(win: np.ndarray, hop: int) -> np.ndarray:
    """Canonical dual window of the (painless-case) STFT frame."""
    w2 = win.real**2 + win.imag**2
    dd = w2.copy()
    for p_ in range(hop, len(win), hop):
        dd[p_:] += w2[:-p_]
        dd[:-p_] += w2[p_:]
    if not np.all(dd > 0):
        raise ValueError(
            "short-time Fourier transform not invertible: the windows do "
            "not cover every sample (zero in the frame diagonal)"
        )
    return win / dd


def closest_STFT_dual_window(
    win: np.ndarray, hop: int, desired_dual=None, *, scaled: bool = True
):
    """The dual window of ``(win, hop)`` closest to ``desired_dual``
    (scipy.signal.closest_STFT_dual_window): per-residue-class
    least-squares correction of the canonical dual; returns
    ``(dual, alpha)``."""
    win = np.asarray(win)
    if desired_dual is None:
        desired_dual = np.ones_like(win)
    desired_dual = np.asarray(desired_dual)
    if win.ndim != 1 or win.shape != desired_dual.shape:
        raise ValueError("win and desired_dual must be equal-length 1-D")
    if not (np.all(np.isfinite(win)) and np.all(np.isfinite(desired_dual))):
        raise ValueError("windows must have finite entries")
    if not (1 <= hop <= len(win)) or int(hop) != hop:
        raise ValueError(f"hop must be an integer in [1, {len(win)}]")
    w_d = _calc_dual_canonical_window(win, hop)
    wdd = np.conjugate(win) * desired_dual
    q_d = wdd.copy()
    for k_ in range(hop, len(win), hop):
        q_d[k_:] += wdd[:-k_]
        q_d[:-k_] += wdd[k_:]
    q_d = w_d * q_d
    if not scaled:
        return w_d + desired_dual - q_d, 1.0
    numerator = np.conjugate(q_d).T @ w_d
    denominator = q_d.T.real @ q_d.real + q_d.T.imag @ q_d.imag
    if not (abs(numerator) > 0 and denominator > np.finfo(float).resolution):
        raise ValueError(
            "scaling factor numerically unstable; use scaled=False"
        )
    alpha = numerator / denominator
    return w_d + alpha * (desired_dual - q_d), alpha


@functools.partial(
    jax.jit, static_argnames=("hop", "mfft", "mode", "n_slices")
)
def _framed_fft(xp, win, hop, mfft, mode, n_slices):
    """(C, padded_n) -> (C, f_pts, n_slices) complex batched DFT."""
    from ..utils.layout import overlapping_frames

    m_num = win.shape[0]
    frames = overlapping_frames(xp, n_slices, hop, m_num)  # (C, P, m)
    seg = frames * win
    if mfft > m_num:
        seg = jnp.pad(seg, ((0, 0), (0, 0), (0, mfft - m_num)))
    if mode == "onesided":
        spec = jnp.fft.rfft(seg, axis=-1)
    else:
        spec = jnp.fft.fft(seg, axis=-1)
        if mode == "centered":
            spec = jnp.fft.fftshift(spec, axes=-1)
    return jnp.moveaxis(spec, -1, -2)  # (C, f, P)


class ShortTimeFFT:
    """scipy.signal.ShortTimeFFT-compatible sliding-window STFT.

    Supports ``fft_mode`` 'onesided'/'twosided'/'centered',
    ``phase_shift`` int or None, ``scale_to`` 'magnitude'/'psd', and
    stft ``padding`` 'zeros'/'edge'/'even'/'odd'.
    """

    def __init__(
        self,
        win,
        hop: int,
        fs: float,
        *,
        fft_mode: str = "onesided",
        mfft: int | None = None,
        phase_shift: int | None = 0,
        scale_to: str | None = None,
    ):
        self.win = np.asarray(win, np.float64).copy()
        if self.win.ndim != 1 or self.win.size < 1:
            raise ValueError("win must be a non-empty 1-D array")
        if int(hop) != hop or hop < 1:
            raise ValueError(f"hop must be a positive integer, got {hop}")
        self.hop = int(hop)
        self.fs = float(fs)
        if fft_mode not in ("onesided", "twosided", "centered"):
            raise ValueError(f"unsupported fft_mode {fft_mode!r}")
        self.fft_mode = fft_mode
        self.mfft = int(mfft) if mfft is not None else self.win.size
        if self.mfft < self.win.size:
            raise ValueError("mfft must be >= len(win)")
        if phase_shift is not None and not (
            -self.mfft < phase_shift < self.mfft
        ):
            raise ValueError("phase_shift must be in (-mfft, mfft) or None")
        self.phase_shift = phase_shift
        self.scaling = None
        self._dual_win = None
        if scale_to is not None:
            self.scale_to(scale_to)

    @classmethod
    def from_window(
        cls, win_param, fs: float, nperseg: int, noverlap: int, **kwargs
    ):
        """Build from a window NAME + nperseg/noverlap (scipy's
        from_window): symmetric window, hop = nperseg - noverlap."""
        from .fft import get_window

        win = get_window(win_param, nperseg, fftbins=True)
        return cls(win, nperseg - noverlap, fs, **kwargs)

    # geometry ------------------------------------------------------------
    @property
    def m_num(self) -> int:
        return self.win.size

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    @property
    def f_pts(self) -> int:
        return self.mfft // 2 + 1 if self.fft_mode == "onesided" else self.mfft

    @property
    def f(self) -> np.ndarray:
        if self.fft_mode == "onesided":
            return np.fft.rfftfreq(self.mfft, 1.0 / self.fs)
        freqs = np.fft.fftfreq(self.mfft, 1.0 / self.fs)
        return np.fft.fftshift(freqs) if self.fft_mode == "centered" else freqs

    @property
    def T(self) -> float:
        return 1.0 / self.fs

    @property
    def delta_t(self) -> float:
        return self.hop / self.fs

    @property
    def delta_f(self) -> float:
        return self.fs / self.mfft

    @property
    def p_min(self) -> int:
        # first slice whose window still overlaps the signal start
        return -((self.m_num - self.m_num_mid - 1) // self.hop)

    @property
    def k_min(self) -> int:
        return self.p_min * self.hop - self.m_num_mid

    def p_max(self, n: int) -> int:
        return (n - 1 + self.m_num_mid) // self.hop + 1

    def k_max(self, n: int) -> int:
        return (self.p_max(n) - 1) * self.hop + self.m_num - self.m_num_mid

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    def t(self, n: int, p0: int | None = None, p1: int | None = None):
        p0 = self.p_min if p0 is None else p0
        p1 = self.p_max(n) if p1 is None else p1
        return np.arange(p0, p1) * self.delta_t

    # duality -------------------------------------------------------------
    @property
    def dual_win(self) -> np.ndarray:
        if self._dual_win is None:
            self._dual_win = _calc_dual_canonical_window(self.win, self.hop)
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            _ = self.dual_win
            return True
        except ValueError:
            return False

    def scale_to(self, scaling: str):
        """Rescale the window pair for 'magnitude' or 'psd' readout
        (scipy semantics: the analysis window absorbs the factor, the
        dual the reciprocal)."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError("scaling must be 'magnitude' or 'psd'")
        if self.scaling == scaling:
            return
        if self.scaling is not None:
            raise ValueError("window already scaled; build a new instance")
        if scaling == "magnitude":
            fac = 1.0 / abs(self.win.sum())
        else:
            fac = 1.0 / np.sqrt(self.fs * np.sum(self.win**2))
        dual = self.dual_win  # materialize before rescale
        self.win = self.win * fac
        self._dual_win = dual / fac
        self.scaling = scaling

    # transforms ----------------------------------------------------------
    def _phase_factor(self):
        if self.phase_shift is None:
            return None
        q = np.arange(self.f_pts)
        if self.fft_mode == "centered":
            q = q - self.mfft // 2
        shift = self.m_num_mid + self.phase_shift
        return np.exp(2j * np.pi * q * shift / self.mfft)

    def stft(self, x, p0=None, p1=None, *, padding: str = "zeros", axis=-1):
        """Complex STFT ``(..., f_pts, p1-p0)`` over slices
        ``[p0, p1)`` (defaults cover the whole signal, ``p_min`` to
        ``p_max``)."""
        xj = jnp.moveaxis(jnp.asarray(x, jnp.float32), axis, -1)
        n = xj.shape[-1]
        if n < self.m_num - self.m_num_mid:
            raise ValueError(f"signal too short ({n} samples)")
        p0 = self.p_min if p0 is None else int(p0)
        p1 = self.p_max(n) if p1 is None else int(p1)
        if p1 <= p0:
            raise ValueError(f"need p0 < p1, got {p0}, {p1}")
        left = self.m_num_mid - p0 * self.hop
        right = max(
            0, (p1 - 1) * self.hop - self.m_num_mid + self.m_num - n
        ) + self.hop * 2
        mode_map = {
            "zeros": "constant",
            "edge": "edge",
            "even": "reflect",
            "odd": "reflect",  # odd handled below
        }
        if padding not in mode_map:
            raise ValueError(f"unknown padding {padding!r}")
        batch = xj.shape[:-1]
        xb = xj.reshape((-1, n))
        pads = ((0, 0), (max(0, left), right))
        if padding == "zeros":
            xp = jnp.pad(xb, pads)
        elif padding == "edge":
            xp = jnp.pad(xb, pads, mode="edge")
        elif padding == "even":
            xp = jnp.pad(xb, pads, mode="reflect")
        else:  # odd: 2*edge - reflect
            refl = jnp.pad(xb, pads, mode="reflect")
            edge = jnp.pad(xb, pads, mode="edge")
            xp = 2.0 * edge - refl
        spec = _framed_fft(
            xp,
            jnp.asarray(self.win, jnp.float32),
            self.hop,
            self.mfft,
            self.fft_mode,
            p1 - p0,
        )
        fac = self._phase_factor()
        if fac is not None:
            spec = spec * jnp.asarray(fac)[:, None]
        return spec.reshape(batch + spec.shape[-2:])

    def spectrogram(self, x, **kwargs):
        """|STFT|^2 (scipy's ShortTimeFFT.spectrogram)."""
        s = self.stft(x, **kwargs)
        return jnp.real(s) ** 2 + jnp.imag(s) ** 2

    def istft(self, S, k0: int = 0, k1: int | None = None):
        """Invert :meth:`stft` via the canonical dual window; returns
        samples ``[k0, k1)`` (defaults to the maximal exactly-covered
        range)."""
        S = jnp.asarray(S)
        if S.ndim < 2:
            raise ValueError("S must have at least (f_pts, slices) axes")
        q_pts, n_slices = S.shape[-2], S.shape[-1]
        if q_pts != self.f_pts:
            raise ValueError(f"expected {self.f_pts} frequency rows")
        fac = self._phase_factor()
        if fac is not None:
            S = S * jnp.asarray(np.conj(fac))[:, None]
        if self.fft_mode == "onesided":
            segs = jnp.fft.irfft(S, n=self.mfft, axis=-2)
        else:
            if self.fft_mode == "centered":
                S = jnp.fft.ifftshift(S, axes=-2)
            segs = jnp.real(jnp.fft.ifft(S, axis=-2))
        segs = jnp.moveaxis(segs, -2, -1)[..., : self.m_num]  # (..., P, m)
        segs = segs * jnp.asarray(self.dual_win, jnp.float32)
        # overlap-add on the hop grid: m_num <= r*hop parts, no scatter
        r = -(-self.m_num // self.hop)
        pad_m = r * self.hop - self.m_num
        if pad_m:
            segs = jnp.pad(
                segs, [(0, 0)] * (segs.ndim - 1) + [(0, pad_m)]
            )
        batch = segs.shape[:-2]
        sb = segs.reshape((-1, n_slices, r, self.hop))
        out = jnp.zeros((sb.shape[0], n_slices + r - 1, self.hop), sb.dtype)
        for i in range(r):
            out = out.at[:, i : i + n_slices, :].add(sb[:, :, i, :])
        y = out.reshape(sb.shape[0], -1)
        # sample k of the signal sits at position k - (p_min*hop - mid)
        offset = -(self.p_min * self.hop - self.m_num_mid)
        if k1 is None:
            k1 = (n_slices - 1 + self.p_min) * self.hop - self.m_num_mid + self.m_num
            k1 = min(k1, y.shape[-1] - offset)
        y = y[:, offset + k0 : offset + k1]
        return y.reshape(batch + (y.shape[-1],))


__all__ = ["ShortTimeFFT", "closest_STFT_dual_window"]
