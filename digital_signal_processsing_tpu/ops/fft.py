"""FFT stage: the public spectral surface with a pluggable DFT engine.

Two engines behind one ``method`` knob on every op:

- ``xla``: jnp.fft wrappers (cuFFT on a GPU) — what ``auto`` runs.
- ``mxu``: the factored-DFT engines (ops/fft_mxu.py) — Cooley-Tukey as
  batched planar matmuls (dft_factored up to 32768; the four-step
  fft_large beyond). An explicit choice; ``auto`` never takes it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

FFT_METHODS = ("auto", "xla", "mxu")

def _resolve_fft_method(method: str, nfft: int) -> str:
    """auto -> xla; explicit methods pass through."""
    del nfft  # every length goes to jnp.fft
    if method not in FFT_METHODS:
        raise ValueError(f"unknown method {method!r}; options {FFT_METHODS}")
    return "xla" if method == "auto" else method


def _mxu_fft_planar(x_re, x_im, *, inverse: bool = False):
    """Planar full-spectrum DFT via the right factored engine for the size."""
    from .fft_mxu import FACTORED_MAX_N, dft_factored, fft_large

    n = x_re.shape[-1]
    if n <= FACTORED_MAX_N:
        return dft_factored(x_re, x_im, inverse=inverse)
    return fft_large(x_re, x_im, inverse=inverse)


def _mxu_rfft(x: jax.Array) -> jax.Array:
    """Real input -> complex half spectrum (..., n//2+1) via the matmul engine.

    Small transforms ride ONE dense (n, h) matmul pair instead of the
    factored engine: at stft-class sizes the factored spelling degenerates
    to batched (n/128, 128) stage-B matmuls + per-frame relayouts.
    """
    from .fft_mxu import DENSE_RFFT_MAX_N, rfft_dense

    n = x.shape[-1]
    if n <= DENSE_RFFT_MAX_N:
        fr, fi = rfft_dense(x)
        return jax.lax.complex(fr, fi)
    fr, fi = _mxu_fft_planar(x.astype(jnp.float32), None)
    h = n // 2 + 1
    return jax.lax.complex(fr[..., :h], fi[..., :h])


def _mxu_irfft(s: jax.Array, nfft: int) -> jax.Array:
    """Complex half spectrum -> real time signal via the matmul engine.

    Small transforms: dense (h, n) synthesis matmul pair with the
    hermitian fold baked into the matrices (see _mxu_rfft). Larger:
    mirror the hermitian half back to the full spectrum (even nfft), run
    the planar inverse, keep the real part.
    """
    from .fft_mxu import DENSE_RFFT_MAX_N, irfft_dense

    re, im = jnp.real(s).astype(jnp.float32), jnp.imag(s).astype(jnp.float32)
    if nfft <= DENSE_RFFT_MAX_N:
        return irfft_dense(re, im, nfft)
    mid = slice(nfft // 2 - 1, 0, -1)
    full_re = jnp.concatenate([re, re[..., mid]], axis=-1)
    full_im = jnp.concatenate([im, -im[..., mid]], axis=-1)
    out_r, _ = _mxu_fft_planar(full_re, full_im, inverse=True)
    return out_r


@functools.partial(jax.jit, static_argnames=("n", "axis"))
def fft(a, n=None, axis=-1):
    return jnp.fft.fft(a, n=n, axis=axis)


@functools.partial(jax.jit, static_argnames=("n", "axis"))
def ifft(a, n=None, axis=-1):
    return jnp.fft.ifft(a, n=n, axis=axis)


@functools.partial(jax.jit, static_argnames=("n", "axis"))
def rfft(a, n=None, axis=-1):
    return jnp.fft.rfft(a, n=n, axis=axis)


@functools.partial(jax.jit, static_argnames=("n", "axis"))
def irfft(a, n=None, axis=-1):
    return jnp.fft.irfft(a, n=n, axis=axis)


def spectral_window(window: str | tuple, nfft: int) -> np.ndarray:
    """PERIODIC analysis window (the scipy.signal spectral convention —
    np.hanning's symmetric form biases every PSD bin ~0.3%).

    The classic four ("hann"/"sqrt_hann"/"hamming"/"rect") are computed
    directly; any other name or ``(name, param)`` spec goes through
    :func:`get_window`'s full family (fftbins form), so the spectral ops
    accept every scipy window spec.
    """
    k = np.arange(nfft)
    if window == "hann":
        return (0.5 - 0.5 * np.cos(2 * np.pi * k / nfft)).astype(np.float32)
    if window == "sqrt_hann":
        # analysis*synthesis = hann, which overlap-adds to a constant at
        # hop = nfft/2: the WOLA perfect-reconstruction pair
        return np.sqrt(0.5 - 0.5 * np.cos(2 * np.pi * k / nfft)).astype(
            np.float32
        )
    if window == "hamming":
        return (0.54 - 0.46 * np.cos(2 * np.pi * k / nfft)).astype(np.float32)
    if window == "rect":
        return np.ones(nfft, np.float32)
    return get_window(window, nfft, fftbins=True).astype(np.float32)


@functools.partial(
    jax.jit,
    static_argnames=("nfft", "hop", "window", "method", "detrend_segments"),
)
def stft(
    x: jax.Array,
    *,
    nfft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    method: str = "auto",
    detrend_segments: bool = False,
) -> jax.Array:
    """Short-time FT of (channels, time) -> (channels, frames, nfft//2+1).

    ``method``: DFT engine — see the module docstring (``auto`` is
    jnp.fft).
    """
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    xp = x if x.ndim == 2 else x[None, :]
    c, t = xp.shape
    nframes = max(0, (t - nfft) // hop + 1)
    from .fft_mxu import DENSE_RFFT_MAX_N, rfft_dense_framed

    if (
        _resolve_fft_method(method, nfft) == "mxu"
        and nfft <= DENSE_RFFT_MAX_N
        and nfft % hop == 0
        and hop % 128 == 0
        and nframes > 0
    ):
        # framing + window folded into the dense-DFT matmuls — the
        # (frames, nfft) tensor is never materialized (rfft_dense_framed)
        fr, fi = rfft_dense_framed(
            xp, nframes, hop, nfft,
            spectral_window(window, nfft), detrend=detrend_segments,
        )
        out = jax.lax.complex(fr, fi)
        return out if x.ndim == 2 else out[0]
    from ..utils.layout import overlapping_frames

    segs = overlapping_frames(xp.astype(jnp.float32), nframes, hop, nfft)
    if detrend_segments:
        # scipy's welch-family detrend='constant': per-UNWINDOWED-segment
        # mean removal before the analysis window
        segs = segs - jnp.mean(segs, axis=-1, keepdims=True)
    w = jnp.asarray(spectral_window(window, nfft))
    if _resolve_fft_method(method, nfft) == "mxu":
        out = _mxu_rfft(segs * w)
    else:
        out = jnp.fft.rfft(segs * w, axis=-1)
    return out if x.ndim == 2 else out[0]


@functools.partial(
    jax.jit, static_argnames=("nfft", "hop", "window", "method")
)
def istft(
    s: jax.Array,
    *,
    nfft: int = 1024,
    hop: int = 512,
    window: str = "sqrt_hann",
    method: str = "auto",
) -> jax.Array:
    """Inverse STFT by windowed overlap-add — the WOLA synthesis bank.

    With ``window='sqrt_hann'`` and ``hop = nfft // 2`` this is the exact
    inverse of :func:`stft` with the same arguments (analysis x synthesis
    window = periodic hann, which overlap-adds to 1 at 50% overlap): STFT-
    domain processing pipelines reconstruct perfectly away from the edges.
    Requires ``nfft % hop == 0``; the OLA is R-1 shifted adds (R = ratio),
    never a scatter.

    ``s``: (..., frames, nfft//2+1) complex -> (..., (frames-1)*hop + nfft).
    """
    if hop < 1 or nfft % hop != 0:
        raise ValueError(f"need hop >= 1 dividing nfft, got hop={hop} nfft={nfft}")
    r = nfft // hop
    squeeze = s.ndim == 2
    sp = s[None] if squeeze else s
    if _resolve_fft_method(method, nfft) == "mxu":
        time_frames = _mxu_irfft(sp, nfft)
    else:
        time_frames = jnp.fft.irfft(sp, n=nfft, axis=-1)
    frames = time_frames * jnp.asarray(spectral_window(window, nfft))
    c, f, _ = frames.shape
    t_out = (f - 1) * hop + nfft
    # OLA without scatter: frame j contributes its part i (hop samples) to
    # output segment j+i; sum R shifted (frames, hop) planes
    parts = frames.reshape(c, f, r, hop)
    out = jnp.zeros((c, f + r - 1, hop), jnp.float32)
    for i in range(r):
        out = out.at[:, i : i + f, :].add(parts[:, :, i, :])
    y = out.reshape(c, (f + r - 1) * hop)[:, :t_out]
    return y[0] if squeeze else y


@functools.partial(jax.jit, static_argnames=("nfft", "method"))
def power_spectrum(
    x: jax.Array, *, nfft: int = 1024, method: str = "auto"
) -> jax.Array:
    """Mean periodogram over whole frames of the signal."""
    s = stft(x, nfft=nfft, hop=nfft, window="rect", method=method)
    return jnp.mean(jnp.abs(s) ** 2, axis=-2)


@functools.partial(
    jax.jit,
    static_argnames=(
        "nfft", "hop", "window", "scaling", "method", "detrend_segments"
    ),
)
def welch(
    x: jax.Array,
    *,
    nfft: int = 1024,
    hop: int | None = None,
    window: str = "hann",
    fs: float = 1.0,
    scaling: str = "density",
    method: str = "auto",
    detrend_segments: bool = False,
) -> jax.Array:
    """Welch PSD estimate of (channels, time) or (time,) -> (..., nfft//2+1).

    Mean of windowed-overlapped periodograms (default 50% overlap),
    normalized like scipy.signal.welch: "density" divides by fs*sum(w^2),
    one-sided doubling of the interior bins.
    """
    if hop is None:
        hop = nfft // 2
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    s = stft(
        x, nfft=nfft, hop=hop, window=window, method=method,
        detrend_segments=detrend_segments,
    )
    w = spectral_window(window, nfft)  # same array the STFT applied
    if scaling == "density":
        norm = fs * float((w**2).sum())
    elif scaling == "spectrum":
        norm = float(w.sum()) ** 2
    else:
        raise ValueError(f"unknown scaling {scaling!r}")
    p = jnp.mean(jnp.abs(s) ** 2, axis=-2) / norm
    # one-sided: double everything but DC (and Nyquist when nfft is even)
    scale = np.full(nfft // 2 + 1, 2.0, np.float32)
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    return p * jnp.asarray(scale)


@functools.partial(
    jax.jit, static_argnames=("nfft", "window", "scaling", "method")
)
def periodogram(
    x: jax.Array,
    *,
    fs: float = 1.0,
    nfft: int | None = None,
    window: str = "rect",
    scaling: str = "density",
    method: str = "auto",
) -> jax.Array:
    """Single-frame PSD estimate (scipy.signal.periodogram, constant detrend).

    The whole (mean-removed, windowed) signal is one DFT frame; one-sided
    density/spectrum scaling like :func:`welch`. ``nfft`` defaults to the
    stream length (zero-pads beyond it).
    """
    xp = x if x.ndim == 2 else x[None, :]
    t = xp.shape[-1]
    n = nfft or t
    if n < t:
        raise ValueError(f"nfft {n} < signal length {t}")
    xf = xp.astype(jnp.float32)
    xf = xf - jnp.mean(xf, axis=-1, keepdims=True)
    w = jnp.asarray(spectral_window(window, t))
    seg = jnp.pad(xf * w, ((0, 0), (0, n - t)))
    if _resolve_fft_method(method, n) == "mxu":
        s = _mxu_rfft(seg[:, None, :])[:, 0, :]
    else:
        s = jnp.fft.rfft(seg, axis=-1)
    wn = spectral_window(window, t)
    if scaling == "density":
        norm = fs * float((wn**2).sum())
    elif scaling == "spectrum":
        norm = float(wn.sum()) ** 2
    else:
        raise ValueError(f"unknown scaling {scaling!r}")
    p = (jnp.abs(s) ** 2) / norm
    scale = np.full(n // 2 + 1, 2.0, np.float32)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    out = p * jnp.asarray(scale)
    return out if x.ndim == 2 else out[0]


@functools.partial(
    jax.jit,
    static_argnames=(
        "nfft", "hop", "window", "scaling", "method", "detrend_segments"
    ),
)
def csd(
    x: jax.Array,
    y: jax.Array,
    *,
    nfft: int = 1024,
    hop: int | None = None,
    window: str = "hann",
    fs: float = 1.0,
    scaling: str = "density",
    method: str = "auto",
    detrend_segments: bool = False,
) -> jax.Array:
    """Welch cross-spectral density conj(X)*Y (scipy.signal.csd semantics).

    Complex-valued on device (built via the DFT engines — no host complex
    transfer is needed until the caller fetches; fetch ``.real``/``.imag``
    separately on backends without complex host transfer). ``csd(x, x)``
    reduces to :func:`welch` of x.
    """
    if hop is None:
        hop = nfft // 2
    sx = stft(
        x, nfft=nfft, hop=hop, window=window, method=method,
        detrend_segments=detrend_segments,
    )
    sy = stft(
        y, nfft=nfft, hop=hop, window=window, method=method,
        detrend_segments=detrend_segments,
    )
    w = spectral_window(window, nfft)
    if scaling == "density":
        norm = fs * float((w**2).sum())
    elif scaling == "spectrum":
        norm = float(w.sum()) ** 2
    else:
        raise ValueError(f"unknown scaling {scaling!r}")
    p = jnp.mean(jnp.conj(sx) * sy, axis=-2) / norm
    scale = np.full(nfft // 2 + 1, 2.0, np.float32)
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    return p * jnp.asarray(scale)


@functools.partial(
    jax.jit,
    static_argnames=("nfft", "hop", "window", "method", "detrend_segments"),
)
def coherence(
    x: jax.Array,
    y: jax.Array,
    *,
    nfft: int = 1024,
    hop: int | None = None,
    window: str = "hann",
    method: str = "auto",
    detrend_segments: bool = False,
) -> jax.Array:
    """Magnitude-squared coherence |Pxy|^2 / (Pxx Pyy) in [0, 1]
    (scipy.signal.coherence semantics); real float32 output."""
    if hop is None:
        hop = nfft // 2
    sx = stft(
        x, nfft=nfft, hop=hop, window=window, method=method,
        detrend_segments=detrend_segments,
    )
    sy = stft(
        y, nfft=nfft, hop=hop, window=window, method=method,
        detrend_segments=detrend_segments,
    )
    pxy = jnp.mean(jnp.conj(sx) * sy, axis=-2)
    pxx = jnp.mean(jnp.abs(sx) ** 2, axis=-2)
    pyy = jnp.mean(jnp.abs(sy) ** 2, axis=-2)
    return (jnp.abs(pxy) ** 2 / jnp.maximum(pxx * pyy, 1e-30)).astype(
        jnp.float32
    )


@functools.partial(jax.jit, static_argnames=("nfft", "hop", "window", "method"))
def spectrogram(
    x: jax.Array,
    *,
    nfft: int = 1024,
    hop: int = 256,
    window: str = "hann",
    method: str = "auto",
) -> jax.Array:
    """Power spectrogram |STFT|^2: (..., frames, nfft//2+1), float32."""
    s = stft(x, nfft=nfft, hop=hop, window=window, method=method)
    return (jnp.abs(s) ** 2).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=())
def tone_power(x: jax.Array, freqs: jax.Array) -> jax.Array:
    """Power of x at EXACT (non-bin) frequencies — the Goertzel use case.

    ``freqs``: (K,) in cycles/sample. Returns (..., K) mean-square
    amplitude estimates (a unit-amplitude sine at freq f reports ~0.25 +
    0.25 = |a/2|^2 x 2... normalized so it reports (amplitude/2)^2 * 2 =
    amplitude^2/2, the tone's mean power). The classic Goertzel
    recurrence is serial — a dot against the exact-phase
    oscillator bank (ops/demod.py) is one reduction per frequency
    and stays phase-accurate at any length.
    """
    from .demod import oscillator_bank

    t = x.shape[-1]
    f = jnp.atleast_1d(jnp.asarray(freqs, jnp.float32))
    c, s = oscillator_bank(f, t)  # (K, t)
    xf = x.astype(jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    re = jnp.tensordot(xf, c, axes=((-1,), (1,)), precision=hp) / t
    im = jnp.tensordot(xf, s, axes=((-1,), (1,)), precision=hp) / t
    return 2.0 * (re**2 + im**2)


# Exactness/speed boundary for auto (below: exact XLA FFT; at/above: the
# blocked FIR approximation). Carried over from the earlier accelerator;
# not yet measured on a GPU (ROADMAP queue 1, item 4).
HILBERT_BLOCKED_MIN_T = 1 << 22


def hilbert(x: jax.Array, *, method: str = "auto", num_taps: int = 513) -> jax.Array:
    """Analytic signal of a real input over the last axis.

    AUTO ACCURACY ENVELOPE: for ``t >= HILBERT_BLOCKED_MIN_T`` (2^22)
    ``auto`` returns the FIR approximation (~1e-4 mid-band ripple, worse
    near DC/Nyquist) — a speed trade. Pin ``method='fft'``
    if you need exactness at those lengths.

    ``method='fft'``: exact one-shot spectral method (zero the negative
    frequencies, double the positive ones) — the textbook definition,
    via jnp.fft.
    ``method='fir'``: the blocked approximation — a windowed
    ideal-Hilbert-kernel FIR on the lane-blocked conv, group-delay
    aligned; error is the FIR's ripple (~1e-4 mid-band at the default 513
    Kaiser taps, worse near DC/Nyquist). ``auto`` picks exact ``fft``
    below HILBERT_BLOCKED_MIN_T and ``fir`` past it (3x the best exact
    engine at production lengths; round 3's on-grid exact exception was
    contradicted by the round-4 measurements and removed).
    """
    t = x.shape[-1]
    if method == "auto":
        method = "fft" if t < HILBERT_BLOCKED_MIN_T else "fir"
    from ..utils.dispatch import record_choice

    record_choice("hilbert", method)
    if method == "fir":
        return hilbert_fir(x, num_taps=num_taps)
    if method != "fft":
        raise ValueError(f"unknown method {method!r}; options ('auto','fft','fir')")
    return _hilbert_fft(x)


@jax.jit
def _hilbert_fft(x: jax.Array) -> jax.Array:
    t = x.shape[-1]
    xf = jnp.fft.fft(
        jax.lax.complex(x.astype(jnp.float32), jnp.zeros_like(x, jnp.float32))
    )
    h = np.zeros(t, np.float32)
    h[0] = 1.0
    if t % 2 == 0:
        h[t // 2] = 1.0
        h[1 : t // 2] = 2.0
    else:
        h[1 : (t + 1) // 2] = 2.0
    return jnp.fft.ifft(xf * jnp.asarray(h))


def design_hilbert_fir(num_taps: int, *, beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed ideal-Hilbert-kernel FIR (type III: odd, antisymmetric).

    h[m] = 2/(pi*m) for odd offsets m from center, 0 for even — the ideal
    transformer's impulse response — windowed to ``num_taps``. Frequency
    response approximates -j*sign(f) over the band, rolling off near DC and
    Nyquist (inherent to every FIR Hilbert).
    """
    if num_taps % 2 == 0 or num_taps < 3:
        raise ValueError(f"hilbert FIR needs odd num_taps >= 3, got {num_taps}")
    mid = (num_taps - 1) // 2
    m = np.arange(num_taps) - mid
    with np.errstate(divide="ignore"):
        h = np.where(m % 2 != 0, 2.0 / (np.pi * m), 0.0)
    h[mid] = 0.0
    return (h * np.kaiser(num_taps, beta)).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("num_taps", "row_len"))
def hilbert_fir(
    x: jax.Array, *, num_taps: int = 513, row_len: int = 1 << 20
) -> jax.Array:
    """Blocked analytic signal: FIR Hilbert transformer + delay alignment.

    Lane-blocked causal convs (fir.py:blocked_causal_conv) with the
    imaginary part shifted back by the group delay so it aligns with the
    real input. Edge samples within half the FIR of either end see zero
    padding (same halo semantics as every causal op).

    Long flat streams are folded into rows of ``row_len`` with a per-row
    overlap halo (overlap-save across rows): a conv planner can go
    pathological on wide-and-batched shapes for the same total work, so
    the default row keeps the per-row width at 1M samples.
    """
    from .fir import blocked_causal_conv

    h = jnp.asarray(design_hilbert_fir(num_taps))
    d = (num_taps - 1) // 2
    squeeze = x.ndim == 1
    xp = (x[None, :] if squeeze else x).astype(jnp.float32)
    t = xp.shape[-1]

    if t > 2 * row_len:
        # fold EVERY channel: row i covers [i*L, (i+1)*L); halo = the
        # previous row's trailing (num_taps-1) samples + d future samples
        # from the next (planar shapes hit the same conv-planner pathology
        # as flat ones — (32, 2.1M) measured 479 s of compile in round 2)
        halo = num_taps - 1
        c = xp.shape[0]
        tp = -(-t // row_len) * row_len
        m = tp // row_len
        rows = jnp.pad(xp, ((0, 0), (0, tp - t))).reshape(c, m, row_len)
        prev = jnp.pad(rows[:, :-1, -halo:], ((0, 0), (1, 0), (0, 0)))
        nxt = jnp.pad(rows[:, 1:, :d], ((0, 0), (0, 1), (0, 0)))
        ext = jnp.concatenate([prev, rows, nxt], axis=-1).reshape(
            c * m, row_len + halo + d
        )
        im = blocked_causal_conv(ext, h)[:, halo + d : halo + d + row_len]
        z = jax.lax.complex(xp, im.reshape(c, tp)[:, :t])
        return z[0] if squeeze else z

    ext = jnp.pad(xp, ((0, 0), (0, d)))  # future halo for the delay shift
    im = blocked_causal_conv(ext, h)[..., d : d + t]
    z = jax.lax.complex(xp, im)
    return z[0] if squeeze else z


def envelope(x: jax.Array, *, method: str = "auto") -> jax.Array:
    """Instantaneous amplitude of a real signal: |hilbert(x)|."""
    return jnp.abs(hilbert(x, method=method)).astype(jnp.float32)


# --- chirp-z / zoom spectra ----------------------------------------------------

_CZT_MATMUL_MAX = 1 << 23  # t*m entries; two f32 chirp matrices = 64 MB HBM


def _czt_chirp(t: int, m: int, w: complex, a: complex):
    """(t, m) chirp matrix M[n, k] = a^-n w^(nk) as host float64 planar
    (cos, sin) parts. Phases via float64 mod-2pi; magnitudes via logs so
    off-circle a/w don't overflow."""
    n = np.arange(t, dtype=np.float64)[:, None]
    k = np.arange(m, dtype=np.float64)[None, :]
    nk = n * k
    la, ta_ = np.log(np.abs(a)), np.angle(a)
    lw, tw = np.log(np.abs(w)), np.angle(w)
    mag = np.exp(-n * la + nk * lw)
    ph = -n * ta_ + np.mod(nk * tw, 2.0 * np.pi)
    return (mag * np.cos(ph)).astype(np.float32), (mag * np.sin(ph)).astype(
        np.float32
    )


@functools.partial(jax.jit, static_argnames=("m", "w", "a"))
def czt(
    x: jax.Array,
    m: int | None = None,
    w: complex | None = None,
    a: complex = 1.0 + 0.0j,
) -> jax.Array:
    """Chirp-z transform: ``m`` samples along the spiral z_k = a w^-k
    (scipy.signal.czt semantics; default w spaces the unit circle evenly,
    reducing to the DFT).

    Spelling: ONE dense (t, m) planar matmul — an arbitrary-spiral CZT
    is literally a matrix
    product, so for zoom-spectrum shapes (t x m <= 2^23) nothing beats
    spelling it as one. Larger products fall back to Bluestein's
    chirp-convolution identity nk = (n^2 + k^2 - (k-n)^2)/2 on the XLA
    FFT. Real or complex input; complex64 output like :func:`stft`.
    """
    t = x.shape[-1]
    if m is None:
        m = t
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    if w is None:
        w = complex(np.exp(-2j * np.pi / m))
    w = complex(w)
    a = complex(a)
    if jnp.iscomplexobj(x):
        xr, xi = jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
    else:
        xr, xi = x.astype(jnp.float32), None
    if t * m <= _CZT_MATMUL_MAX:
        mr, mi = _czt_chirp(t, m, w, a)
        mr, mi = jnp.asarray(mr), jnp.asarray(mi)
        yr = xr @ mr
        yi = xr @ mi
        if xi is not None:
            yr = yr - xi @ mi
            yi = yi + xi @ mr
        return jax.lax.complex(yr, yi)
    # Bluestein: X[k] = w^(k^2/2) * conv(x[n] a^-n w^(n^2/2), w^(-j^2/2))[t-1+k]
    n = np.arange(t, dtype=np.float64)
    j = np.arange(-(t - 1), m, dtype=np.float64)
    k = np.arange(m, dtype=np.float64)
    la, ta_ = np.log(np.abs(a)), np.angle(a)
    lw, tw = np.log(np.abs(w)), np.angle(w)

    def _cexp(logmag, phase):
        mag = np.exp(logmag)
        return (
            jnp.asarray((mag * np.cos(phase)).astype(np.float32)),
            jnp.asarray((mag * np.sin(phase)).astype(np.float32)),
        )

    ar, ai = _cexp(-n * la + (n * n / 2.0) * lw,
                   -n * ta_ + np.mod(n * n / 2.0 * tw, 2 * np.pi))
    br, bi = _cexp(-(j * j / 2.0) * lw, np.mod(-(j * j / 2.0) * tw, 2 * np.pi))
    cr, ci = _cexp((k * k / 2.0) * lw, np.mod(k * k / 2.0 * tw, 2 * np.pi))
    ur = xr * ar - (xi * ai if xi is not None else 0.0)
    ui = xr * ai + (xi * ar if xi is not None else 0.0)
    u = jax.lax.complex(ur, ui)
    b = jax.lax.complex(br, bi)
    nfft = 1 << int(np.ceil(np.log2(t + m + t - 2)))
    conv = jnp.fft.ifft(
        jnp.fft.fft(u, n=nfft) * jnp.fft.fft(b, n=nfft), n=nfft
    )[..., t - 1 : t - 1 + m]
    return conv * jax.lax.complex(cr, ci)


def zoomfft(
    x: jax.Array, fn, m: int | None = None, *, fs: float = 2.0
) -> jax.Array:
    """Zoomed DFT: ``m`` bins spanning [f1, f2) without computing the full
    spectrum (scipy.signal.zoomfft, endpoint=False).

    ``fn``: (f1, f2) in the units of ``fs`` (default Nyquist units), or a
    scalar for [0, fn). One matmul via :func:`czt` — the classic
    band-selectable alternative to padding the global FFT.
    """
    fn = np.atleast_1d(np.asarray(fn, np.float64))
    if fn.size == 1:
        fn = np.array([0.0, float(fn[0])])
    f1, f2 = float(fn[0]), float(fn[1])
    if not -fs / 2 <= f1 <= f2 <= fs:
        raise ValueError(f"need f1 <= f2 within the sampling band, got {fn}")
    t = x.shape[-1]
    if m is None:
        m = t
    a = complex(np.exp(2j * np.pi * f1 / fs))
    w = complex(np.exp(-2j * np.pi * (f2 - f1) / (m * fs)))
    return czt(x, m, w, a)


def hilbert2(x: jax.Array, n=None) -> jax.Array:
    """2-D analytic signal over the last two axes
    (scipy.signal.hilbert2): fft2, zero the negative quadrants, double
    the positive ones, ifft2. Complex64 output.
    """
    xf = jnp.asarray(x, jnp.float32)
    if xf.ndim < 2:
        raise ValueError("hilbert2 needs at least 2 dimensions")
    if n is None:
        n1, n2 = xf.shape[-2], xf.shape[-1]
    else:
        n1, n2 = (n, n) if jnp.ndim(n) == 0 else (int(n[0]), int(n[1]))
        if n1 < 1 or n2 < 1:
            raise ValueError("shape must be positive")
    spec = jnp.fft.fft2(xf, s=(n1, n2), axes=(-2, -1))

    def half_mask(m: int) -> np.ndarray:
        # scipy.hilbert2 drops the Nyquist bin for even sizes (unlike the
        # 1-D hilbert, which keeps it at weight 1)
        h = np.zeros(m, np.float32)
        h[0] = 1.0
        h[1 : (m + 1) // 2] = 2.0
        return h

    mask = np.outer(half_mask(n1), half_mask(n2))
    return jnp.fft.ifft2(spec * jnp.asarray(mask), axes=(-2, -1))


# --- scipy-compat window factory + WOLA validity checks ------------------------


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """Window factory (scipy.signal.get_window): string name or
    ``(name, param)``; ``fftbins=True`` gives the PERIODIC form used for
    spectral analysis, ``False`` the symmetric filter-design form."""
    if isinstance(window, (tuple, list)):
        name, *params = window
    else:
        name, params = window, []
    if Nx < 1:
        raise ValueError(f"Nx must be >= 1, got {Nx}")
    m = Nx + 1 if fftbins else Nx
    n = np.arange(m, dtype=np.float64)
    if m > 1:
        t = 2.0 * np.pi * n / (m - 1)
    else:
        t = np.zeros(1)

    def cos_sum(coefs):
        w = np.zeros(m)
        for k, c in enumerate(coefs):
            w += c * np.cos(k * t) * (-1.0) ** k
        return w

    name = {"hanning": "hann", "rect": "boxcar", "rectangular": "boxcar"}.get(
        name, name
    )
    if name == "boxcar":
        w = np.ones(m)
    elif name in ("triang",):
        # scipy triang is NOT bartlett: no zero endpoints
        k = np.arange(1, (m + 1) // 2 + 1)
        if m % 2 == 0:
            half = (2 * k - 1) / m
            w = np.concatenate([half, half[::-1]])
        else:
            half = 2 * k / (m + 1)
            w = np.concatenate([half, half[-2::-1]])
    elif name == "bartlett":
        w = 1.0 - np.abs(2.0 * n / (m - 1) - 1.0) if m > 1 else np.ones(1)
    elif name == "hann":
        w = cos_sum([0.5, 0.5])
    elif name == "hamming":
        w = cos_sum([0.54, 0.46])
    elif name == "blackman":
        w = cos_sum([0.42, 0.5, 0.08])
    elif name == "blackmanharris":
        w = cos_sum([0.35875, 0.48829, 0.14128, 0.01168])
    elif name == "nuttall":
        w = cos_sum([0.3635819, 0.4891775, 0.1365995, 0.0106411])
    elif name == "flattop":
        w = cos_sum(
            [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
        )
    elif name == "barthann":
        frac = np.abs(n / (m - 1) - 0.5) if m > 1 else np.zeros(1)
        w = 0.62 - 0.48 * frac + 0.38 * np.cos(2 * np.pi * frac)
    elif name == "bohman":
        frac = np.abs(2.0 * n / (m - 1) - 1.0) if m > 1 else np.zeros(1)
        w = (1 - frac) * np.cos(np.pi * frac) + np.sin(np.pi * frac) / np.pi
        w[0] = w[-1] = 0.0
    elif name == "parzen":
        # scipy's parzen scales by m/2 (not m-1) with the split at (m-1)/4
        nn = np.arange(-(m - 1) / 2.0, (m - 1) / 2.0 + 0.5, 1.0)
        an = np.abs(nn) / (m / 2.0)
        w = np.where(
            np.abs(nn) <= (m - 1) / 4.0,
            1.0 - 6.0 * an**2 + 6.0 * an**3,
            2.0 * (1.0 - an) ** 3,
        )
    elif name == "cosine":
        w = np.sin(np.pi * (n + 0.5) / m)
    elif name == "lanczos":
        w = np.sinc(2.0 * n / (m - 1) - 1.0) if m > 1 else np.ones(1)
    elif name == "kaiser":
        if not params:
            raise ValueError("kaiser window needs a beta parameter")
        w = np.kaiser(m, params[0])
    elif name == "gaussian":
        if not params:
            raise ValueError("gaussian window needs a std parameter")
        w = np.exp(-0.5 * ((n - (m - 1) / 2.0) / params[0]) ** 2)
    elif name == "exponential":
        # scipy's parameter order is (center, tau) — the single-param
        # spelling sets the CENTER; pass (None, tau) for a decay scale
        center = params[0] if len(params) >= 1 else None
        tau = params[1] if len(params) >= 2 else 1.0
        if not fftbins and center is not None:
            raise ValueError("symmetric exponential requires center=None")
        if center is None:
            center = (m - 1) / 2.0
        w = np.exp(-np.abs(n - center) / tau)
    elif name == "tukey":
        alpha = params[0] if params else 0.5
        if alpha <= 0:
            w = np.ones(m)
        elif alpha >= 1:
            w = cos_sum([0.5, 0.5])
        else:
            w = np.ones(m)
            width = int(np.floor(alpha * (m - 1) / 2.0))
            idx = np.arange(width + 1)
            edge = 0.5 * (
                1 + np.cos(np.pi * (2.0 * idx / (alpha * (m - 1)) - 1.0))
            )
            w[: width + 1] = edge
            w[m - width - 1 :] = edge[::-1]
    elif name == "general_cosine":
        if not params:
            raise ValueError("general_cosine needs a coefficient sequence")
        w = cos_sum(np.asarray(params[0], np.float64))
    elif name == "general_hamming":
        if not params:
            raise ValueError("general_hamming needs alpha")
        alpha = float(params[0])
        w = cos_sum([alpha, 1.0 - alpha])
    elif name == "general_gaussian":
        if len(params) < 2:
            raise ValueError("general_gaussian needs (p, sigma)")
        pw, sig = float(params[0]), float(params[1])
        w = np.exp(-0.5 * np.abs((n - (m - 1) / 2.0) / sig) ** (2 * pw))
    elif name == "chebwin":
        if not params:
            raise ValueError("chebwin needs an attenuation in dB")
        w = _chebwin(m, float(params[0]))
    elif name == "taylor":
        nbar = int(params[0]) if len(params) >= 1 else 4
        sll = float(params[1]) if len(params) >= 2 else 30.0
        norm = bool(params[2]) if len(params) >= 3 else True
        w = _taylor(m, nbar, sll, norm)
    elif name == "dpss":
        if not params:
            raise ValueError("dpss needs a half-bandwidth parameter NW")
        nw_ = float(params[0])
        w = dpss_windows(m, nw_, 1)[0][0]
        # scipy's 'approximate' norm: max-normalize, with an even-length
        # half-sample correction M^2/(M^2 + NW)
        w = w / np.max(np.abs(w))
        if m % 2 == 0:
            w = w * (m * m / (m * m + nw_))
    elif name == "kaiser_bessel_derived":
        if not params:
            raise ValueError("kaiser_bessel_derived needs beta")
        if fftbins:
            raise ValueError(
                "Kaiser-Bessel Derived windows are only defined for "
                "symmetric shapes"
            )
        w = _kbd(m, float(params[0]))
    else:
        raise ValueError(f"unknown window {name!r}")
    if fftbins:
        w = w[:-1]
    return w.astype(np.float64)


def check_cola(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Constant-overlap-add check (scipy.signal.check_COLA): windows
    summed at the hop must be constant — the istft/WOLA exactness
    precondition."""
    if not 0 <= noverlap < nperseg:
        raise ValueError("need 0 <= noverlap < nperseg")
    w = (
        np.asarray(window, np.float64)
        if not isinstance(window, (str, tuple))
        else get_window(window, nperseg)
    )
    if w.shape[0] != nperseg:
        raise ValueError("window length must equal nperseg")
    hop = nperseg - noverlap
    binsums = np.sum(
        [w[i * hop : i * hop + hop] for i in range(nperseg // hop)], axis=0
    )
    if nperseg % hop != 0:
        binsums[: nperseg % hop] += w[-(nperseg % hop) :]
    return bool(np.max(np.abs(binsums - binsums[0])) < tol)


def check_nola(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Nonzero-overlap-add check (scipy.signal.check_NOLA): the weaker
    invertibility condition for least-squares istft."""
    if not 0 <= noverlap < nperseg:
        raise ValueError("need 0 <= noverlap < nperseg")
    w = (
        np.asarray(window, np.float64)
        if not isinstance(window, (str, tuple))
        else get_window(window, nperseg)
    )
    if w.shape[0] != nperseg:
        raise ValueError("window length must equal nperseg")
    hop = nperseg - noverlap
    binsums = np.sum(
        [w[i * hop : i * hop + hop] ** 2 for i in range(nperseg // hop)],
        axis=0,
    )
    if nperseg % hop != 0:
        binsums[: nperseg % hop] += w[-(nperseg % hop) :] ** 2
    return bool(np.min(binsums) > tol)


def czt_points(m: int, w: complex | None = None, a: complex = 1 + 0j):
    """The m contour points a * w^-k the CZT evaluates at
    (scipy.signal.czt_points)."""
    k = np.arange(m)
    if w is None:
        w = np.exp(-2j * np.pi / m)
    return a * np.asarray(w) ** -k


class CZT:
    """Plan-style callable chirp-z transform (scipy.signal.CZT): freezes
    (n, m, w, a) so repeated calls reuse the jitted matmul graph."""

    def __init__(self, n: int, m: int | None = None, w=None, a=1 + 0j):
        if m is None:
            m = n
        if w is None:
            w = np.exp(-2j * np.pi / m)
        self._n, self._m, self._w, self._a = int(n), int(m), w, a

    def __call__(self, x, *, axis: int = -1):
        xm = jnp.moveaxis(jnp.asarray(x), axis, -1)
        if xm.shape[-1] != self._n:
            raise ValueError(
                f"CZT planned for n={self._n}, got {xm.shape[-1]}"
            )
        out = czt(xm, m=self._m, w=self._w, a=self._a)
        return jnp.moveaxis(out, -1, axis)

    def points(self):
        return czt_points(self._m, self._w, self._a)


class ZoomFFT(CZT):
    """Plan-style zoom FFT over a frequency band (scipy.signal.ZoomFFT)."""

    def __init__(self, n: int, fn, m: int | None = None, *, fs: float = 2.0):
        fn = np.atleast_1d(np.asarray(fn, np.float64))
        if fn.size == 1:
            f1, f2 = 0.0, float(fn[0])
        else:
            f1, f2 = float(fn[0]), float(fn[1])
        if m is None:
            m = n
        w = np.exp(-2j * np.pi * (f2 - f1) / (m * fs))
        a = np.exp(2j * np.pi * f1 / fs)
        super().__init__(n, m, w, a)
        self.f1, self.f2, self.fs = f1, f2, fs


def _chebwin(m: int, at: float) -> np.ndarray:
    """Dolph-Chebyshev window (scipy.signal.windows.chebwin): inverse DFT
    of the equiripple Chebyshev spectrum."""
    if m == 1:
        return np.ones(1)
    order = m - 1.0
    beta = np.cosh(1.0 / order * np.arccosh(10 ** (abs(at) / 20.0)))
    k = np.arange(m)
    x = beta * np.cos(np.pi * k / m)
    # Chebyshev polynomial T_order evaluated off [-1, 1] without overflow;
    # T_n(-x) = (-1)^n T_n(x) supplies the sign for x < -1
    p = np.zeros(m)
    big = np.abs(x) > 1
    p[big] = np.cosh(order * np.arccosh(np.abs(x[big])))
    p[big & (x < 0)] *= (-1.0) ** (int(order) % 2)
    p[~big] = np.cos(order * np.arccos(x[~big]))
    if m % 2:
        wr = np.real(np.fft.fft(p))
        half = (m + 1) // 2
        wr = wr[:half]
        w = np.concatenate([wr[:0:-1], wr])
    else:
        p_ = p * np.exp(1j * np.pi / m * np.arange(m))
        wr = np.real(np.fft.fft(p_))
        half = m // 2 + 1
        wr = wr[1:half]
        w = np.concatenate([wr[::-1], wr])
    return w / np.max(w)


def _taylor(
    m: int, nbar: int, sll: float, norm: bool
) -> np.ndarray:
    """Taylor window (scipy.signal.windows.taylor semantics)."""
    if m == 1:
        return np.ones(1)
    b = 10.0 ** (sll / 20.0)
    a = np.arccosh(b) / np.pi
    s2 = nbar**2 / (a**2 + (nbar - 0.5) ** 2)
    ma = np.arange(1, nbar)
    fm = np.empty(nbar - 1)
    signs = np.empty_like(ma, float)
    signs[::2] = 1.0
    signs[1::2] = -1.0
    m2 = ma**2
    for mi, _ in enumerate(ma):
        numer = signs[mi] * np.prod(
            1 - m2[mi] / s2 / (a**2 + (ma - 0.5) ** 2)
        )
        denom = 2 * np.prod(1 - m2[mi] / m2[:mi]) * np.prod(
            1 - m2[mi] / m2[mi + 1 :]
        )
        fm[mi] = numer / denom
    def get(n_):
        return 1 + 2 * np.dot(
            fm, np.cos(2 * np.pi * ma[:, None] * (n_ - m / 2.0 + 0.5) / m)
        )
    w = get(np.arange(m))
    if norm:
        w = w / get((m - 1) / 2.0)
    return w


def _kbd(m: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel derived window (symmetric only)."""
    if m % 2:
        raise ValueError("kaiser_bessel_derived requires an even length")
    kw = np.kaiser(m // 2 + 1, beta)
    csum = np.cumsum(kw)
    half = np.sqrt(csum[:-1] / csum[-1])
    return np.concatenate([half, half[::-1]])


def dpss_windows(
    m: int, nw: float, k_max: int, *, return_ratios: bool = False
):
    """Discrete prolate spheroidal (Slepian) sequences — the first
    ``k_max`` maximally band-concentrated windows (scipy.signal.windows.dpss
    semantics: tridiagonal eigenvector formulation, even windows
    positive-mean, odd windows positive-initial-slope).

    Returns ``(windows, ratios)`` with ``windows`` of shape
    ``(k_max, m)``; ``ratios`` are the in-band energy concentrations
    (computed only when ``return_ratios``).
    """
    import scipy.linalg as sla

    if not 0 < nw < m / 2:
        raise ValueError(f"need 0 < NW < M/2, got NW={nw}, M={m}")
    w_bin = nw / m
    n = np.arange(m)
    diag = ((m - 1 - 2 * n) / 2.0) ** 2 * np.cos(2 * np.pi * w_bin)
    off = n[1:] * (m - n[1:]) / 2.0
    vals, vecs = sla.eigh_tridiagonal(
        diag, off, select="i", select_range=(m - k_max, m - 1)
    )
    windows = vecs.T[::-1]
    # sign conventions (scipy): even orders sum positive, odd orders start
    # with a positive slope
    fix_even = windows[::2].sum(axis=1) < 0
    for i, f in enumerate(fix_even):
        if f:
            windows[2 * i] *= -1
    thresh = max(1e-7, 1.0 / m)
    for i, wlp in enumerate(windows[1::2]):
        if wlp[wlp * wlp > thresh][0] < 0:
            windows[2 * i + 1] *= -1
    if not return_ratios:
        return windows, None
    # concentration via the sinc kernel quadratic form
    dn = n[:, None] - n[None, :]
    with np.errstate(invalid="ignore", divide="ignore"):
        kern = np.sin(2 * np.pi * w_bin * dn) / (np.pi * dn)
    kern[np.arange(m), np.arange(m)] = 2 * w_bin
    ratios = np.einsum("km,mn,kn->k", windows, kern, windows)
    return windows, ratios


@functools.partial(
    jax.jit, static_argnames=("nw", "k_tapers", "nfft", "fs", "scaling")
)
def multitaper_psd(
    x: jax.Array,
    *,
    nw: float = 4.0,
    k_tapers: int | None = None,
    nfft: int | None = None,
    fs: float = 1.0,
    scaling: str = "density",
) -> jax.Array:
    """Thomson multitaper PSD: mean of ``k`` DPSS-tapered periodograms
    (the low-variance, low-leakage estimator Welch averaging cannot
    reach for short records). Beyond-scipy.signal surface (scipy keeps
    dpss but no multitaper driver); the taper bank is one batched
    DFT over ``k`` tapered copies."""
    xp = x if x.ndim == 2 else x[None, :]
    t = xp.shape[-1]
    n = nfft or t
    k = k_tapers or max(1, int(2 * nw) - 1)
    tapers, _ = dpss_windows(t, nw, k)
    xf = xp.astype(jnp.float32) - jnp.mean(
        xp.astype(jnp.float32), axis=-1, keepdims=True
    )
    seg = xf[:, None, :] * jnp.asarray(tapers, jnp.float32)  # (C, K, T)
    if n > t:
        seg = jnp.pad(seg, ((0, 0), (0, 0), (0, n - t)))
    s = jnp.fft.rfft(seg, axis=-1)
    p = jnp.mean(jnp.abs(s) ** 2, axis=-2)
    if scaling == "density":
        p = p / fs
    elif scaling != "spectrum":
        raise ValueError(f"unknown scaling {scaling!r}")
    scale = np.full(n // 2 + 1, 2.0, np.float32)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    out = p * jnp.asarray(scale)
    return out if x.ndim == 2 else out[0]
