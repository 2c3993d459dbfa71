"""scipy.signal drop-in namespace.

``from digital_signal_processsing_tpu import compat as signal`` gives a
namespace whose callables carry scipy.signal's NAMES AND SIGNATURES, so
scipy-written DSP code runs against this framework's engines
unchanged. Three kinds of members:

1. direct re-exports — functions implemented scipy-compatible from the
   start (``firwin``, ``lfilter``, ``sosfilt``, ``find_peaks``,
   ``cont2discrete``, the whole LTI/spline/wavelet/cepstrum surface, …);
2. signature adapters — thin wrappers where the native API is spelled
   differently (the classical designers ``butter``/``cheby1``/
   ``cheby2``/``ellip``/``bessel`` with ``analog``/``output``/``fs``,
   ``welch``/``stft`` parameter names, ``resample``, …);
3. nothing else — no behavior lives here; every adapter delegates to a
   tested topical module.

Coverage is pinned by tests/test_compat_facade.py: every public
scipy.signal callable (except its internal ``band_stop_obj`` and the
``test`` runner) resolves here, and a battery of scipy-style calls is
compared against scipy itself.
"""

from __future__ import annotations

import numpy as np

# --- 1. direct re-exports ------------------------------------------------------

from .ops.fir import (  # noqa: F401
    firwin,
    firwin_2d,
    kaiser_atten,
    kaiser_beta,
    kaiserord,
    minimum_phase,
    deconvolve,
)
from .ops.fft import (  # noqa: F401
    CZT,
    ZoomFFT,
    check_cola as check_COLA,
    check_nola as check_NOLA,
    czt,
    czt_points,
    get_window,
    hilbert2,
    envelope,
)
from .ops.fft import zoomfft as zoom_fft  # noqa: F401
from .ops.iir import (  # noqa: F401
    freqz,
    group_delay,
    lfilter_zi,
    lfiltic,
    sosfilt_zi,
    sosfreqz,
)
from .ops.iir_design import (  # noqa: F401
    BadCoefficients,
    besselap,
    bilinear,
    bilinear_zpk,
    buttap,
    buttord,
    cheb1ap,
    cheb1ord,
    cheb2ap,
    cheb2ord,
    ellipap,
    ellipord,
    findfreqs,
    freqs,
    freqs_zpk,
    freqz_sos,
    gammatone,
    iircomb,
    iirdesign,
    iirnotch,
    iirpeak,
    lp2bp,
    lp2bp_zpk,
    lp2bs,
    lp2bs_zpk,
    lp2hp,
    lp2hp_zpk,
    lp2lp,
    lp2lp_zpk,
    normalize,
    sos2tf,
    sos2zpk,
    tf2sos,
    tf2zpk,
    zpk2sos,
    zpk2tf,
)
from .ops.lti import (  # noqa: F401
    StateSpace,
    TransferFunction,
    ZerosPolesGain,
    abcd_normalize,
    bode,
    cont2discrete,
    dbode,
    dfreqresp,
    dimpulse,
    dlsim,
    dlti,
    dstep,
    freqresp,
    freqz_zpk,
    impulse,
    invres,
    invresz,
    lsim,
    lti,
    place_poles,
    residue,
    residuez,
    ss2tf,
    ss2zpk,
    step,
    tf2ss,
    unique_roots,
    zpk2ss,
)
from .ops.correlate import (  # noqa: F401
    choose_conv_method,
    correlation_lags,
    fftconvolve,
    oaconvolve,
    vectorstrength,
)
from .ops.twod import (  # noqa: F401
    convolve2d,
    correlate2d,
    medfilt2d,
    sepfir2d,
)
from .ops.wavelets import cwt, lombscargle, morlet2, ricker  # noqa: F401
from .ops.splines import (  # noqa: F401
    cspline1d,
    cspline1d_eval,
    cspline2d,
    gauss_spline,
    qspline1d,
    qspline1d_eval,
    qspline2d,
    spline_filter,
    symiirorder1,
    symiirorder2,
)
from .ops.peaks import (  # noqa: F401
    argrelextrema,
    argrelmax,
    argrelmin,
    find_peaks_cwt,
    peak_prominences,
    peak_widths,
)
from .ops.rank import medfilt, order_filter, wiener  # noqa: F401
from .ops.signal import (  # noqa: F401
    chirp,
    gausspulse,
    max_len_seq,
    sawtooth,
    square,
    sweep_poly,
    unit_impulse,
)
from .ops.resample import upfirdn  # noqa: F401
from .ops.stft_class import (  # noqa: F401
    ShortTimeFFT,
    closest_STFT_dual_window,
)


# --- 2. signature adapters -----------------------------------------------------


_BTYPES = {
    "low": "lowpass",
    "lowpass": "lowpass",
    "high": "highpass",
    "highpass": "highpass",
    "band": "bandpass",
    "bandpass": "bandpass",
    "stop": "bandstop",
    "bandstop": "bandstop",
}


def _classic_design(
    proto, N, Wn, btype, analog, output, fs, norm_even=None
):
    from .ops import iir_design as d

    try:
        btype = _BTYPES[btype]
    except KeyError:
        raise ValueError(f"invalid btype {btype!r}") from None
    if output not in ("ba", "zpk", "sos"):
        raise ValueError(f"invalid output {output!r}")
    z, p, k = proto()
    Wn = np.asarray(Wn, np.float64)
    if fs is not None:
        Wn = 2.0 * Wn / fs
    if analog:
        if btype == "lowpass":
            z, p, k = d.lp2lp_zpk(z, p, k, float(Wn))
        elif btype == "highpass":
            z, p, k = d.lp2hp_zpk(z, p, k, float(Wn))
        else:
            w1, w2 = (float(v) for v in Wn.reshape(2))
            wo, bw = np.sqrt(w1 * w2), w2 - w1
            f = d.lp2bp_zpk if btype == "bandpass" else d.lp2bs_zpk
            z, p, k = f(z, p, k, wo, bw)
    else:
        if np.any(Wn <= 0) or np.any(Wn >= 1):
            raise ValueError(
                "digital cutoffs must be inside (0, 1) Nyquist "
                "(or (0, fs/2) with fs given)"
            )
        warped = np.tan(np.pi * Wn / 2.0)
        if btype == "lowpass":
            z, p, k = d.lp2lp_zpk(z, p, k, float(warped))
        elif btype == "highpass":
            z, p, k = d.lp2hp_zpk(z, p, k, float(warped))
        else:
            w1, w2 = (float(v) for v in warped.reshape(2))
            wo, bw = np.sqrt(w1 * w2), w2 - w1
            f = d.lp2bp_zpk if btype == "bandpass" else d.lp2bs_zpk
            z, p, k = f(z, p, k, wo, bw)
        z, p, k = d._bilinear_zpk(z, p, k)
    if output == "zpk":
        return z, p, k
    if output == "sos":
        return d.zpk2sos(z, p, k)
    return d.zpk2tf(z, p, k)


def butter(N, Wn, btype="low", analog=False, output="ba", fs=None):
    """Butterworth design with scipy.signal.butter's signature."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.buttap(N), N, Wn, btype, analog, output, fs
    )


def cheby1(N, rp, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev-I design (scipy.signal.cheby1 signature)."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.cheb1ap(N, rp), N, Wn, btype, analog, output, fs
    )


def cheby2(N, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Chebyshev-II design (scipy.signal.cheby2 signature)."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.cheb2ap(N, rs), N, Wn, btype, analog, output, fs
    )


def ellip(N, rp, rs, Wn, btype="low", analog=False, output="ba", fs=None):
    """Elliptic design (scipy.signal.ellip signature)."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.ellipap(N, rp, rs), N, Wn, btype, analog, output, fs
    )


def bessel(N, Wn, btype="low", analog=False, output="ba", norm="phase", fs=None):
    """Bessel design (scipy.signal.bessel signature)."""
    from .ops import iir_design as d

    return _classic_design(
        lambda: d.besselap(N, norm), N, Wn, btype, analog, output, fs
    )


def iirfilter(
    N, Wn, rp=None, rs=None, btype="band", analog=False,
    ftype="butter", output="ba", fs=None,
):
    """Generic classical design (scipy.signal.iirfilter signature)."""
    from .ops import iir_design as d

    protos = {
        "butter": lambda: d.buttap(N),
        "butterworth": lambda: d.buttap(N),
        "cheby1": lambda: d.cheb1ap(N, rp),
        "cheby2": lambda: d.cheb2ap(N, rs),
        "ellip": lambda: d.ellipap(N, rp, rs),
        "elliptic": lambda: d.ellipap(N, rp, rs),
        "bessel": lambda: d.besselap(N),
    }
    if ftype not in protos:
        raise ValueError(f"unknown ftype {ftype!r}")
    return _classic_design(protos[ftype], N, Wn, btype, analog, output, fs)


def firwin2(numtaps, freq, gain, *, nfreqs=None, window="hamming", fs=2.0):
    """Frequency-sampling FIR design (scipy.signal.firwin2 signature)."""
    from .ops.fir import design_firwin2

    freq = np.asarray(freq, np.float64) * (2.0 / fs)
    return design_firwin2(numtaps, freq, gain, window=window, nfreqs=nfreqs)


def firls(numtaps, bands, desired, *, weight=None, fs=2.0):
    """Least-squares FIR design (scipy.signal.firls signature)."""
    from .ops.fir import design_firls

    bands = np.asarray(bands, np.float64) * (2.0 / fs)
    return design_firls(numtaps, bands, desired, weights=weight)


def remez(numtaps, bands, desired, *, weight=None, fs=1.0, maxiter=25):
    """Parks-McClellan design (scipy.signal.remez signature: band edges
    in Hz of ``fs``, one desired value per band)."""
    from .ops.fir import design_remez

    bands = np.asarray(bands, np.float64) / fs * 2.0
    return design_remez(
        numtaps, bands, desired, weights=weight, max_iterations=maxiter
    )


def savgol_coeffs(window_length, polyorder, *, deriv=0, delta=1.0):
    """Savitzky-Golay coefficients (scipy.signal.savgol_coeffs
    signature)."""
    from .ops.fir import design_savgol

    return design_savgol(
        window_length, polyorder, deriv=deriv, delta=delta
    )


def savgol_filter(
    x, window_length, polyorder, deriv=0, delta=1.0, axis=-1,
    mode="interp", cval=0.0,
):
    """Savitzky-Golay smoothing (scipy.signal.savgol_filter signature)."""
    from .ops import fir as _fir

    if cval != 0.0:
        raise ValueError("cval is not supported (constant mode pads 0)")
    return _axis_last(
        lambda v: _fir.savgol_filter(
            v, window_length, polyorder, deriv=deriv, delta=delta, mode=mode
        ),
        x,
        axis,
    )


def resample(x, num, *, axis=-1):
    """Fourier resampling (scipy.signal.resample signature subset)."""
    from .ops.resample import resample_fft

    if axis != -1:
        import jax.numpy as jnp

        return jnp.moveaxis(
            resample_fft(jnp.moveaxis(jnp.asarray(x), axis, -1), num),
            -1,
            axis,
        )
    return resample_fft(x, num)


def decimate(x, q, n=None, ftype="iir", axis=-1, zero_phase=True):
    """Decimation with anti-aliasing (scipy.signal.decimate signature
    subset)."""
    from .ops import iir as _iir, resample as _res

    if not zero_phase and ftype == "iir":
        raise ValueError(
            "only zero_phase=True is supported for the IIR path (the "
            "native decimate_iir is inherently forward-backward)"
        )
    if ftype == "iir":
        return _axis_last(
            lambda v: _iir.decimate_iir(v, q, order=n or 8), x, axis
        )
    return _axis_last(lambda v: _res.decimate(v, q), x, axis)


def _axis_last(fn, x, axis):
    import jax.numpy as jnp

    if axis in (-1, np.ndim(x) - 1):
        return fn(jnp.asarray(x))
    xm = jnp.moveaxis(jnp.asarray(x), axis, -1)
    return jnp.moveaxis(fn(xm), -1, axis)


def sosfilt(sos, x, axis=-1, zi=None):
    """SOS filtering with scipy.signal.sosfilt's signature: supports
    ``axis`` and the streaming ``zi`` state (returns ``(y, zf)`` when
    given), riding the seeded device chunk kernels."""
    from .ops import iir as _iir

    if zi is None:
        return _axis_last(lambda v: _iir.sosfilt(np.asarray(sos), v), x, axis)
    if axis not in (-1, np.ndim(x) - 1):
        import jax.numpy as jnp

        xm = jnp.moveaxis(jnp.asarray(x), axis, -1)
        # scipy's zi carries the section state along the same moved axes
        zim = np.moveaxis(np.asarray(zi), axis + 1 if axis >= 0 else axis, -1)
        zf, y = _iir.sosfilt_chunk(zim, np.asarray(sos), xm)
        return jnp.moveaxis(y, -1, axis), np.moveaxis(
            np.asarray(zf), -1, axis + 1 if axis >= 0 else axis
        )
    zf, y = _iir.sosfilt_chunk(np.asarray(zi), np.asarray(sos), x)
    return y, zf


def lfilter(b, a, x, axis=-1, zi=None):
    """(b, a) filtering with scipy.signal.lfilter's signature (``axis``
    supported; streaming state via the SOS spelling: convert with
    ``tf2sos`` and use :func:`sosfilt` with ``zi``)."""
    from .ops import iir as _iir

    if zi is not None:
        raise ValueError(
            "zi on the (b, a) form is not supported; convert with tf2sos "
            "and carry state through sosfilt(..., zi=...)"
        )
    return _axis_last(lambda v: _iir.lfilter(b, a, v), x, axis)



_CONV_METHODS = {"auto": "auto", "direct": "auto", "fft": "auto"}


def correlate(in1, in2, mode="full", method="auto"):
    """Correlation with scipy.signal.correlate's signature. scipy's
    'direct'/'fft' method hints both map to the framework's engine
    dispatch (the results agree to float tolerance by construction)."""
    from .ops import correlate as _corr

    if method not in _CONV_METHODS:
        raise ValueError(f"unknown method {method!r}")
    return _corr.correlate(in1, in2, mode=mode)


def convolve(in1, in2, mode="full", method="auto"):
    """Convolution with scipy.signal.convolve's signature."""
    from .ops import correlate as _corr

    if method == "fft":
        return _corr.fftconvolve(in1, in2, mode)
    if method not in _CONV_METHODS:
        raise ValueError(f"unknown method {method!r}")
    return _corr.convolve(in1, in2, mode)


def hilbert(x, N=None, axis=-1):
    """Analytic signal with scipy.signal.hilbert's signature (``N``
    pads/truncates to the transform length)."""
    import jax.numpy as jnp

    from .ops import fft as _fft

    xj = jnp.asarray(x)
    if axis not in (-1, xj.ndim - 1):
        xj = jnp.moveaxis(xj, axis, -1)
    n = xj.shape[-1]
    if N is not None:
        N = int(N)
        if N < 1:
            raise ValueError("N must be positive")
        if N < n:
            xj = xj[..., :N]
        elif N > n:
            xj = jnp.pad(xj, [(0, 0)] * (xj.ndim - 1) + [(0, N - n)])
    out = _fft.hilbert(xj)
    if axis not in (-1, jnp.ndim(x) - 1):
        out = jnp.moveaxis(out, -1, axis)
    return out


def detrend(data, axis=-1, type="linear", bp=0):
    """Trend removal with scipy.signal.detrend's signature (breakpoints
    unsupported — pass bp=0)."""
    from .ops import gain as _gain

    if np.ndim(bp) != 0 or bp != 0:
        raise ValueError("breakpoints (bp) are not supported")
    return _axis_last(lambda v: _gain.detrend(v, type=type), data, axis)


def find_peaks(
    x,
    height=None,
    threshold=None,
    distance=None,
    prominence=None,
    width=None,
    wlen=None,
    rel_height=0.5,
    plateau_size=None,
):
    """Peak finding with scipy.signal.find_peaks's full condition set.

    height/threshold/distance/prominence run in the native implementation
    (scipy-ordered); width and plateau_size are applied here through the
    native ``peak_widths``/plateau machinery in scipy's order, with the
    matching properties added to the dict.
    """
    from .ops import peaks as _peaks

    if wlen is not None:
        raise ValueError("wlen is not supported")

    xa = np.asarray(x, np.float64)
    peaks_idx, props = _peaks.find_peaks(
        xa, height=height, threshold=threshold, distance=distance,
        prominence=prominence,
    )
    if plateau_size is not None:
        # plateau sizes: scipy measures the flat-top extent of each peak
        sizes = np.empty(peaks_idx.size, int)
        ledges = np.empty(peaks_idx.size, int)
        redges = np.empty(peaks_idx.size, int)
        for i, pk in enumerate(peaks_idx):
            lo = pk
            while lo > 0 and xa[lo - 1] == xa[pk]:
                lo -= 1
            hi = pk
            while hi < xa.size - 1 and xa[hi + 1] == xa[pk]:
                hi += 1
            ledges[i], redges[i] = lo, hi
            sizes[i] = hi - lo + 1
        pmin, pmax = _as_interval(plateau_size)
        keep = (sizes >= pmin) & (sizes <= pmax)
        peaks_idx = peaks_idx[keep]
        props = {k: v[keep] for k, v in props.items()}
        props["plateau_sizes"] = sizes[keep]
        props["left_edges"] = ledges[keep]
        props["right_edges"] = redges[keep]
    if width is not None:
        if "prominences" not in props:
            pr, lb, rb = _peaks.peak_prominences(xa, peaks_idx)
            props["prominences"] = pr
            props["left_bases"] = lb
            props["right_bases"] = rb
        widths, wh, lips, rips = _peaks.peak_widths(
            xa, peaks_idx, rel_height=rel_height,
            prominence_data=(
                props["prominences"], props["left_bases"],
                props["right_bases"],
            ),
        )
        wmin, wmax = _as_interval(width)
        keep = (widths >= wmin) & (widths <= wmax)
        peaks_idx = peaks_idx[keep]
        props = {k: np.asarray(v)[keep] for k, v in props.items()}
        props["widths"] = np.asarray(widths)[keep]
        props["width_heights"] = np.asarray(wh)[keep]
        props["left_ips"] = np.asarray(lips)[keep]
        props["right_ips"] = np.asarray(rips)[keep]
    return peaks_idx, props


def _as_interval(v):
    arr = np.atleast_1d(np.asarray(v, np.float64))
    if arr.size == 1:
        return float(arr[0]), np.inf
    return float(arr[0]), float(arr[1])



def _upfirdn_len(len_h, len_x, up, down):
    return ((len_x - 1) * up + len_h - 1) // down + 1


def resample_poly(x, up, down, axis=-1, window=("kaiser", 5.0)):
    """Polyphase resampling with scipy.signal.resample_poly's signature
    and EXACT output (scipy's kaiser filter, delay-compensating pad, and
    trim recipe on the native banded upfirdn)."""
    from .ops.fir import firwin as _firwin
    from .ops.resample import upfirdn as _upfirdn

    import jax.numpy as jnp

    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be positive integers")
    g = np.gcd(up, down)
    up, down = up // g, down // g
    xj = jnp.asarray(x, jnp.float32)
    if axis not in (-1, xj.ndim - 1):
        xj = jnp.moveaxis(xj, axis, -1)
    if up == down == 1:
        out = xj
    else:
        n = xj.shape[-1]
        n_out = n * up
        n_out = n_out // down + bool(n_out % down)
        mx = max(up, down)
        half_len = 10 * mx
        h = _firwin(2 * half_len + 1, 1.0 / mx, window=window) * up
        n_pre_pad = down - half_len % down
        n_post_pad = 0
        n_pre_remove = (half_len + n_pre_pad) // down
        while (
            _upfirdn_len(len(h) + n_pre_pad + n_post_pad, n, up, down)
            < n_out + n_pre_remove
        ):
            n_post_pad += 1
        h2 = np.concatenate(
            [np.zeros(n_pre_pad), h, np.zeros(n_post_pad)]
        ).astype(np.float32)
        y = _upfirdn(h2, xj, up, down)
        out = y[..., n_pre_remove : n_pre_remove + n_out]
    if axis not in (-1, np.ndim(x) - 1):
        out = jnp.moveaxis(out, -1, axis)
    return out



def filtfilt(b, a, x, axis=-1, padtype="odd", padlen=None, method="pad",
             irlen=None):
    """Zero-phase filtering with scipy.signal.filtfilt's signature (the
    default 'odd'/'pad' recipe; other padtypes unsupported)."""
    from .ops import iir as _iir

    if padtype != "odd" or padlen is not None or method != "pad":
        raise ValueError(
            "only the default padtype='odd', padlen=None, method='pad' "
            "recipe is supported"
        )
    return _axis_last(lambda v: _iir.filtfilt(b, a, v), x, axis)


def sosfiltfilt(sos, x, axis=-1, padtype="odd", padlen=None):
    """Zero-phase SOS filtering with scipy.signal.sosfiltfilt's
    signature (default 'odd' recipe)."""
    from .ops import iir as _iir

    if padtype != "odd" or padlen is not None:
        raise ValueError(
            "only the default padtype='odd', padlen=None recipe is supported"
        )
    return _axis_last(lambda v: _iir.sosfiltfilt(np.asarray(sos), v), x, axis)


# --- spectral estimation with scipy's (f[, t], result) conventions -------------


def _resolve_spectral(window, nperseg, noverlap, nfft, detrend):
    if nperseg is None:
        nperseg = 256
    nperseg = int(nperseg)
    if nfft is not None and int(nfft) != nperseg:
        raise ValueError(
            "this implementation requires nfft == nperseg (frames are not "
            "zero-padded); resample or change nperseg instead"
        )
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if detrend in ("constant",):
        dt = True
    elif detrend in (False, None):
        dt = False
    else:
        raise ValueError(
            f"unsupported detrend {detrend!r} (use 'constant' or False)"
        )
    win = "rect" if window == "boxcar" else window
    if isinstance(win, list):
        win = tuple(win)
    return win, nperseg, nperseg - noverlap, dt


def welch(
    x, fs=1.0, window="hann", nperseg=None, noverlap=None, nfft=None,
    detrend="constant", scaling="density",
):
    """Welch PSD with scipy.signal.welch's signature; returns (f, Pxx)."""
    from .ops import fft as _fft

    n = np.shape(x)[-1]
    if nperseg is None or int(nperseg) > n:
        # scipy caps nperseg at the signal length (with a warning)
        nperseg = min(256 if nperseg is None else int(nperseg), n)
        noverlap = None if noverlap is None else min(int(noverlap), nperseg - 1)
    win, nseg, hop, dt = _resolve_spectral(
        window, nperseg, noverlap, nfft, detrend
    )
    p = _fft.welch(
        x, nfft=nseg, hop=hop, window=win, fs=fs, scaling=scaling,
        detrend_segments=dt,
    )
    return np.fft.rfftfreq(nseg, 1.0 / fs), p


def periodogram(
    x, fs=1.0, window="boxcar", nfft=None, detrend="constant",
    scaling="density",
):
    """Single-frame PSD with scipy.signal.periodogram's signature;
    returns (f, Pxx)."""
    from .ops import fft as _fft

    if detrend not in ("constant", False, None):
        raise ValueError("unsupported detrend (use 'constant' or False)")
    win = "rect" if window == "boxcar" else window
    n = np.shape(x)[-1]
    p = _fft.periodogram(
        x, fs=fs, nfft=nfft, window=win, scaling=scaling
    )
    return np.fft.rfftfreq(nfft or n, 1.0 / fs), p


def csd(
    x, y, fs=1.0, window="hann", nperseg=None, noverlap=None, nfft=None,
    detrend="constant", scaling="density",
):
    """Cross-spectral density (scipy.signal.csd signature); returns
    (f, Pxy)."""
    from .ops import fft as _fft

    win, nseg, hop, dt = _resolve_spectral(
        window, nperseg, noverlap, nfft, detrend
    )
    p = _fft.csd(
        x, y, nfft=nseg, hop=hop, window=win, fs=fs, scaling=scaling,
        detrend_segments=dt,
    )
    return np.fft.rfftfreq(nseg, 1.0 / fs), p


def coherence(x, y, fs=1.0, window="hann", nperseg=None, noverlap=None,
              nfft=None, detrend="constant"):
    """Magnitude-squared coherence (scipy.signal.coherence signature);
    returns (f, Cxy)."""
    fr, pxy = csd(x, y, fs, window, nperseg, noverlap, nfft, detrend)
    _, pxx = welch(x, fs, window, nperseg, noverlap, nfft, detrend)
    _, pyy = welch(y, fs, window, nperseg, noverlap, nfft, detrend)
    import jax.numpy as jnp

    return fr, (jnp.abs(pxy) ** 2) / (pxx * pyy)


def spectrogram(
    x, fs=1.0, window=("tukey", 0.25), nperseg=None, noverlap=None,
    nfft=None, detrend="constant", scaling="density", mode="psd",
):
    """Spectrogram with scipy.signal.spectrogram's signature (noverlap
    defaults to nperseg//8); returns (f, t, Sxx)."""
    from .ops import fft as _fft

    if nperseg is None:
        nperseg = 256
    if noverlap is None:
        noverlap = nperseg // 8
    win, nseg, hop, dt = _resolve_spectral(
        window, nperseg, noverlap, nfft, detrend
    )
    s = _fft.stft(
        x, nfft=nseg, hop=hop, window=win, detrend_segments=dt
    )
    import jax.numpy as jnp

    wv = _fft.spectral_window(win, nseg).astype(np.float64)
    if scaling == "density":
        norm = fs * float((wv**2).sum())
    elif scaling == "spectrum":
        norm = float(wv.sum()) ** 2
    else:
        raise ValueError(f"unknown scaling {scaling!r}")
    onesided = np.full(nseg // 2 + 1, 2.0, np.float32)
    onesided[0] = 1.0
    if nseg % 2 == 0:
        onesided[-1] = 1.0
    if mode == "psd":
        out = (jnp.abs(s) ** 2) / norm * jnp.asarray(onesided)
    elif mode in ("magnitude", "complex"):
        # amplitude modes use the SQUARE ROOT of the psd normalization
        amp = 1.0 / np.sqrt(norm)
        out = (jnp.abs(s) if mode == "magnitude" else s) * amp
    else:
        raise ValueError(f"unsupported mode {mode!r}")
    nframes = np.shape(out)[-2]
    t = (np.arange(nframes) * hop + nseg / 2.0) / fs
    f = np.fft.rfftfreq(nseg, 1.0 / fs)
    return f, t, jnp.moveaxis(out, -2, -1)


def stft(
    x, fs=1.0, window="hann", nperseg=256, noverlap=None, nfft=None,
    detrend=False, boundary="zeros", padded=True,
):
    """Legacy STFT (scipy.signal.stft signature); returns (f, t, Zxx).

    Implemented on :class:`~.ops.stft_class.ShortTimeFFT` with
    scipy's exact legacy mapping (magnitude scaling, no phase shift,
    slices 0..p_max) — bit-identical to scipy for boundary='zeros'.
    """
    from .ops.fft import get_window as _gw
    from .ops.stft_class import ShortTimeFFT as _S

    if detrend not in (False, None):
        raise ValueError("detrend is not supported on the legacy stft")
    if boundary != "zeros" or not padded:
        raise ValueError("only boundary='zeros', padded=True supported")
    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if nfft is not None and int(nfft) != nperseg:
        raise ValueError("this implementation requires nfft == nperseg")
    win = np.asarray(_gw("rect" if window == "boxcar" else window, nperseg))
    st = _S(
        win, nperseg - noverlap, fs, scale_to="magnitude", phase_shift=None
    )
    n = np.shape(x)[-1]
    z = st.stft(x, p0=0, p1=st.p_max(n))
    t = np.arange(st.p_max(n)) * st.delta_t
    return st.f, t, z


def istft(
    Zxx, fs=1.0, window="hann", nperseg=None, noverlap=None, nfft=None,
    input_onesided=True, boundary=True,
):
    """Legacy inverse STFT (scipy.signal.istft signature); returns
    (t, x)."""
    from .ops.fft import get_window as _gw
    from .ops.stft_class import ShortTimeFFT as _S

    if not input_onesided or not boundary:
        raise ValueError("only input_onesided=True, boundary=True supported")
    q = np.shape(Zxx)[-2]
    if nperseg is None:
        nperseg = 2 * (q - 1)
    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if nfft is not None and int(nfft) != nperseg:
        raise ValueError("this implementation requires nfft == nperseg")
    win = np.asarray(_gw("rect" if window == "boxcar" else window, nperseg))
    hop = nperseg - noverlap
    st = _S(win, hop, fs, scale_to="magnitude", phase_shift=None)
    n_slices = np.shape(Zxx)[-1]
    # legacy output length: everything the slices cover past the boundary
    n_out = (n_slices - 1) * hop
    x = st.istft(Zxx, k0=0, k1=n_out)
    t = np.arange(np.shape(x)[-1]) / fs
    return t, x


# --- names whose native spelling differs only by module path -------------------

from .ops.lpc import levinson as _levinson  # noqa: F401,E402  (bonus surface)


__all__ = [n for n in dir() if not n.startswith("_")]
