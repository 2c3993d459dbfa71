"""B-spline signal processing (scipy.signal's spline subsystem).

Unser's recursive B-spline interpolation/smoothing filters with
mirror-symmetric boundaries (B-Spline Signal Processing, IEEE TSP 1993,
parts I-II). Structure: the boundary initial conditions are
O(K) dot products computed in float64 on host (they are truncated
infinite sums — design-time work), while the forward/backward recursions
run through the package's seeded SOS device path
(``ops.iir.sosfilt_chunk`` — the XLA associative scan), so
spline-filtering a million-sample batch rides the same scan as every other
IIR in the framework.

Parity oracle: scipy.signal. Two scipy quirks are reproduced exactly:
``symiirorder1``'s initial condition uses the HALF-SAMPLE mirror
(``x[-k] = x[k-1]``), and scipy's ``cspline1d(lamb>0)`` (Python path)
and ``symiirorder2`` (C path) use slightly DIFFERENT y[1] boundary sums
— each public function here matches its scipy namesake.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def gauss_spline(x, n: int):
    """Gaussian approximation to the order-``n`` B-spline basis
    (scipy.signal.gauss_spline)."""
    x = jnp.asarray(x)
    sig2 = (n + 1) / 12.0
    return (1.0 / math.sqrt(2.0 * math.pi * sig2)) * jnp.exp(
        -(x**2) / (2.0 * sig2)
    )


def bspline3(x):
    """Closed-form cubic B-spline basis (knots -2..2)."""
    ax = np.abs(np.asarray(x, np.float64))
    return np.where(
        ax <= 1.0,
        2.0 / 3.0 - ax**2 + 0.5 * ax**3,
        np.where(ax < 2.0, (2.0 - ax) ** 3 / 6.0, 0.0),
    )


def bspline2(x):
    """Closed-form quadratic B-spline basis (knots -1.5..1.5)."""
    ax = np.abs(np.asarray(x, np.float64))
    return np.where(
        ax <= 0.5,
        0.75 - ax**2,
        np.where(ax < 1.5, 0.5 * (ax - 1.5) ** 2, 0.0),
    )


def _resolve_precision(precision: float, dtype) -> float:
    if 0.0 < precision < 1.0:
        return float(precision)
    return 1e-3 if dtype == np.float32 else 1e-6


def _trunc_len(base: float, precision: float, k_max: int) -> int:
    """First k with |base|^k < precision (scipy's truncated-sum horizon);
    raises like scipy when the signal is too short for convergence."""
    if base == 0.0:
        return 1
    k = int(np.ceil(np.log(precision) / np.log(abs(base))))
    if k >= k_max:
        raise ValueError(
            "Sum to find symmetric boundary conditions did not converge."
        )
    return max(k, 1)


def _sos_pass(row: np.ndarray, state_s1, state_s2, x):
    """One seeded first/second-order recursion through the device SOS
    path. ``x``: (C, T); states: (C,). Returns (C, T) output."""
    from . import iir as _iir

    c = x.shape[0]
    st = np.zeros((1, c, 2), np.float32)
    st[0, :, 0] = np.asarray(state_s1, np.float64)
    st[0, :, 1] = np.asarray(state_s2, np.float64)
    _, y = _iir.sosfilt_chunk(
        jnp.asarray(st), jnp.asarray(row, jnp.float32).reshape(1, 6),
        jnp.asarray(x, jnp.float32),
    )
    return np.asarray(y, np.float64)


def _symiir1_apply(xb: np.ndarray, c0: float, z1: float, y0: np.ndarray):
    """Forward 1/(1-z1 z^-1) from y0, then backward c0/(1-z1 z)."""
    k = xb.shape[-1]
    if k == 1:
        # the backward pass's boundary value is the whole output
        return (-c0 / (z1 - 1.0) * y0)[:, None]
    y_rest = _sos_pass(
        np.array([1.0, 0, 0, 1.0, -z1, 0]), z1 * y0, 0.0 * y0, xb[:, 1:]
    )
    y1 = np.concatenate([y0[:, None], y_rest], -1)
    out_last = -c0 / (z1 - 1.0) * y1[:, -1]
    out_rest = _sos_pass(
        np.array([c0, 0, 0, 1.0, -z1, 0]),
        z1 * out_last,
        0.0 * out_last,
        y1[:, -2::-1],
    )
    return np.concatenate([out_rest[:, ::-1], out_last[:, None]], -1)


def symiirorder1(signal, c0: float, z1: float, precision: float = -1.0):
    """Mirror-symmetric forward-backward first-order smoothing IIR
    (scipy.signal.symiirorder1): ``H(z) = c0 / ((1 - z1 z^-1)(1 - z1 z))``.

    1-D or 2-D (batched over the leading axis); the recursions run on the
    device SOS path in float32 with float64 boundary sums.
    """
    x = np.asarray(signal, np.float64)
    if abs(z1) >= 1.0:
        raise ValueError("|z1| must be less than 1.0")
    if x.ndim > 2:
        raise ValueError("Input must be 1D or 2D")
    squeeze = x.ndim == 1
    xb = x[None] if squeeze else x
    k = xb.shape[-1]
    prec = _resolve_precision(precision, np.asarray(signal).dtype)
    kc = _trunc_len(z1, prec, k)
    # half-sample mirror IC: y0 = x[0] + z1 * sum_k z1^k x[k]
    pows = z1 ** np.arange(kc)
    y0 = xb[:, 0] + z1 * (pows * xb[:, :kc]).sum(-1)
    out = _symiir1_apply(xb, c0, z1, y0)
    return out[0] if squeeze else out


def _hc(kk, cs: float, rho: float, omega: float):
    kk = np.asarray(kk)
    if omega == 0.0:
        return cs * (kk + 1.0) * rho**kk * (kk > -1)
    return (
        cs
        / np.sin(omega)
        * rho ** np.maximum(kk, 0)
        * np.sin(omega * (kk + 1.0))
        * (kk > -1)
    )


def _hs(kk, cs: float, rho: float, omega: float):
    kk = np.abs(np.asarray(kk))
    c0 = (
        cs
        * cs
        * (1.0 + rho * rho)
        / (1.0 - rho * rho)
        / (1.0 - 2.0 * rho * rho * np.cos(2.0 * omega) + rho**4)
    )
    gamma = (1.0 - rho * rho) / (1.0 + rho * rho) / np.tan(omega)
    return c0 * rho**kk * (np.cos(omega * kk) + gamma * np.sin(omega * kk))


def _symiir2_apply(xb, r, omega, y0, y1, ylast, ylast2):
    """Forward then backward cs/(1 - a2 z^-1 - a3 z^-2) cascade with the
    given boundary values."""
    rsq = r * r
    a2 = 2.0 * r * np.cos(omega)
    a3 = -rsq
    cs = 1.0 - 2.0 * r * np.cos(omega) + rsq
    row = np.array([cs, 0, 0, 1.0, -a2, -a3])
    y_rest = _sos_pass(row, a3 * y0 + a2 * y1, a3 * y1, xb[:, 2:])
    y_fwd = np.concatenate([y0[:, None], y1[:, None], y_rest], -1)
    out_rest = _sos_pass(
        row, a3 * ylast + a2 * ylast2, a3 * ylast2, y_fwd[:, -3::-1]
    )
    return np.concatenate(
        [out_rest[:, ::-1], ylast2[:, None], ylast[:, None]], -1
    )


def symiirorder2(input, r: float, omega: float, precision: float = -1.0):
    """Mirror-symmetric forward-backward second-order smoothing IIR
    (scipy.signal.symiirorder2; C boundary convention)."""
    x = np.asarray(input, np.float64)
    if r >= 1.0:
        raise ValueError("r must be less than 1.0")
    if x.ndim > 2:
        raise ValueError("Input must be 1D or 2D")
    squeeze = x.ndim == 1
    xb = x[None] if squeeze else x
    k = xb.shape[-1]
    prec = _resolve_precision(precision, np.asarray(input).dtype)
    kc = _trunc_len(r, prec, k)  # hc/hs decay as r^k
    cs = 1.0 - 2.0 * r * np.cos(omega) + r * r
    kk = np.arange(kc)
    hck = _hc(kk, cs, r, omega)
    hck1 = _hc(kk + 1, cs, r, omega)
    hck2 = _hc(kk + 2, cs, r, omega)
    # half-sample mirror: y[0] = hc(0)x[0] + sum hc(k+1)x[k];
    # y[1] = (hc(1)+hc(2))x[0] + (hc(0)+hc(3))x[1] + sum_{k>=2} hc(k+2)x[k]
    y0 = hck[0] * xb[:, 0] + (hck1 * xb[:, :kc]).sum(-1)
    w1 = hck2.copy()
    w1[0] = _hc(1, cs, r, omega) + _hc(2, cs, r, omega)
    if kc > 1:
        w1[1] = _hc(0, cs, r, omega) + _hc(3, cs, r, omega)
    y1 = (w1 * xb[:, :kc]).sum(-1)
    xr = xb[:, ::-1]
    hsk = _hs(kk, cs, r, omega)
    hsk1 = _hs(kk + 1, cs, r, omega)
    hskm1 = _hs(kk - 1, cs, r, omega)
    hsk2 = _hs(kk + 2, cs, r, omega)
    ylast = ((hsk + hsk1) * xr[:, :kc]).sum(-1)
    ylast2 = ((hskm1 + hsk2) * xr[:, :kc]).sum(-1)
    out = _symiir2_apply(xb, r, omega, y0, y1, ylast, ylast2)
    return out[0] if squeeze else out


def _coeff_smooth(lam: float):
    xi = 1.0 - 96.0 * lam + 24.0 * lam * math.sqrt(3.0 + 144.0 * lam)
    omeg = math.atan2(math.sqrt(144.0 * lam - 1.0), math.sqrt(xi))
    rho = (24.0 * lam - 1.0 - math.sqrt(xi)) / (24.0 * lam)
    rho = rho * math.sqrt(
        (48.0 * lam + 24.0 * lam * math.sqrt(3.0 + 144.0 * lam)) / xi
    )
    return rho, omeg


def _smooth_coeff_1d(xb: np.ndarray, lamb: float):
    """scipy's _cubic_smooth_coeff boundary convention (Python path:
    y[1] uses hc(0)x0 + hc(1)x1 + sum hc(k+2)x[k] — full-length sums)."""
    rho, omega = _coeff_smooth(lamb)
    cs = 1.0 - 2.0 * rho * np.cos(omega) + rho * rho
    k = xb.shape[-1]
    kk = np.arange(k)
    hck1 = _hc(kk + 1, cs, rho, omega)
    hck2 = _hc(kk + 2, cs, rho, omega)
    y0 = _hc(0, cs, rho, omega) * xb[:, 0] + (hck1 * xb).sum(-1)
    y1 = (
        _hc(0, cs, rho, omega) * xb[:, 0]
        + _hc(1, cs, rho, omega) * xb[:, 1]
        + (hck2 * xb).sum(-1)
    )
    xr = xb[:, ::-1]
    ylast = ((_hs(kk, cs, rho, omega) + _hs(kk + 1, cs, rho, omega)) * xr).sum(-1)
    ylast2 = (
        (_hs(kk - 1, cs, rho, omega) + _hs(kk + 2, cs, rho, omega)) * xr
    ).sum(-1)
    return _symiir2_apply(xb, rho, omega, y0, y1, ylast, ylast2)


def _interp_coeff_1d(xb: np.ndarray, zi: float, gain: float):
    """lamb=0 interpolation coefficients: full-length IC sums, no
    convergence requirement (scipy's _cubic_coeff/_quadratic_coeff)."""
    k = xb.shape[-1]
    if k == 1:
        yplus = xb[:, 0] + zi * (zi ** np.arange(k) * xb).sum(-1)
        return gain * (zi / (zi - 1.0)) * yplus[:, None]
    y0 = xb[:, 0] + zi * (zi ** np.arange(k) * xb).sum(-1)
    return _symiir1_apply(xb, gain * (-zi), zi, y0)


def cspline1d(signal, lamb: float = 0.0):
    """Cubic-spline coefficients of a 1-D signal, mirror-symmetric
    boundaries (scipy.signal.cspline1d); reconstruct by mirror-convolving
    with [1, 4, 1]/6."""
    x = np.asarray(signal, np.float64)
    squeeze = x.ndim == 1
    xb = x[None] if squeeze else x
    if lamb != 0.0:
        out = _smooth_coeff_1d(xb, lamb)
    else:
        out = _interp_coeff_1d(xb, -2.0 + math.sqrt(3.0), 6.0)
    return out[0] if squeeze else out


def qspline1d(signal, lamb: float = 0.0):
    """Quadratic-spline coefficients (scipy.signal.qspline1d;
    reconstruction window [1, 6, 1]/8)."""
    if lamb != 0.0:
        raise ValueError("Smoothing quadratic splines not supported yet.")
    x = np.asarray(signal, np.float64)
    squeeze = x.ndim == 1
    xb = x[None] if squeeze else x
    out = _interp_coeff_1d(xb, -3.0 + 2.0 * math.sqrt(2.0), 8.0)
    return out[0] if squeeze else out


def _spline_eval(cj, newx, dx, x0, kernel, support: float):
    cj = np.asarray(cj, np.float64)
    if cj.size == 0:
        raise ValueError("Spline coefficients 'cj' must not be empty.")
    t = (np.asarray(newx, np.float64) - x0) / float(dx)
    n = cj.shape[-1]
    if n == 1:
        return np.full_like(t, cj[0])
    # whole-sample mirror fold into [0, n-1] (one modular fold covers all
    # reflections)
    period = 2.0 * (n - 1)
    t = np.abs(np.remainder(t, period))
    t = np.minimum(t, period - t)
    jlower = np.floor(t - support).astype(int) + 1
    result = np.zeros_like(t)
    for i in range(int(2 * support)):
        thisj = jlower + i
        indj = np.clip(thisj, 0, n - 1)
        result += cj[indj] * kernel(t - thisj)
    return result


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0):
    """Evaluate a cubic spline at new points with mirror-symmetric edges
    (scipy.signal.cspline1d_eval)."""
    return _spline_eval(cj, newx, dx, x0, bspline3, 2.0)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0):
    """Evaluate a quadratic spline at new points
    (scipy.signal.qspline1d_eval)."""
    return _spline_eval(cj, newx, dx, x0, bspline2, 1.5)


def _root_from_lambda(lamb: float):
    tmp = math.sqrt(3.0 + 144.0 * lamb)
    xi = 1.0 - 96.0 * lamb + 24.0 * lamb * tmp
    omega = math.atan(math.sqrt((144.0 * lamb - 1.0) / xi))
    r = (
        (24.0 * lamb - 1.0 - math.sqrt(xi))
        / (24.0 * lamb)
        * math.sqrt(48.0 * lamb + 24.0 * lamb * tmp)
        / math.sqrt(xi)
    )
    return r, omega


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0):
    """2-D cubic B-spline coefficients (scipy.signal.cspline2d):
    the 1-D recursion along each axis in turn."""
    x = np.asarray(signal, np.float64)
    if x.ndim != 2:
        raise ValueError("cspline2d needs a rank-2 input")
    if lamb <= 1.0 / 144.0:
        r = -2.0 + math.sqrt(3.0)
        out = symiirorder1(x, -r * 6.0, r, precision=precision)
        out = symiirorder1(out.T, -r * 6.0, r, precision=precision).T
        return out
    r, omega = _root_from_lambda(lamb)
    out = symiirorder2(x, r, omega, precision=precision)
    out = symiirorder2(out.T, r, omega, precision=precision).T
    return out


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0):
    """2-D quadratic B-spline coefficients (scipy.signal.qspline2d)."""
    if lamb > 0:
        raise ValueError("lambda must be negative or zero")
    x = np.asarray(signal, np.float64)
    if x.ndim != 2:
        raise ValueError("qspline2d needs a rank-2 input")
    r = -3.0 + 2.0 * math.sqrt(2.0)
    out = symiirorder1(x, -r * 8.0, r, precision=precision)
    return symiirorder1(out.T, -r * 8.0, r, precision=precision).T


def spline_filter(Iin, lmbda: float = 5.0):
    """Cubic smoothing-spline filter of a rank-2 array
    (scipy.signal.spline_filter): coefficients via :func:`cspline2d`,
    reconstruction via the separable mirror FIR [1, 4, 1]/6."""
    from .twod import sepfir2d

    ck = cspline2d(np.asarray(Iin, np.float64), lmbda)
    h = np.array([1.0, 4.0, 1.0]) / 6.0
    return np.asarray(sepfir2d(ck, h, h), np.float64)


__all__ = [
    "gauss_spline",
    "bspline2",
    "bspline3",
    "cspline1d",
    "qspline1d",
    "cspline1d_eval",
    "qspline1d_eval",
    "cspline2d",
    "qspline2d",
    "spline_filter",
    "symiirorder1",
    "symiirorder2",
]
