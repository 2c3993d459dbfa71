"""General IIR design: analog prototypes -> zpk transforms -> SOS cascades.

Completes the classical design surface around ops/iir.py's bespoke
Butterworth/Chebyshev functions: one zpk pipeline gives every family
(Butterworth, Chebyshev I/II, elliptic/Cauer) every band type
(lowpass/highpass/bandpass/bandstop), mirroring scipy.signal.iirfilter's
architecture without depending on scipy at runtime. All host-side float64
numpy — filters run on device through ops/iir.sosfilt; design is a trace-time
constant like the reference's host-side coefficient computation
(profilable_sm_averager.cu:65's precomputed inverseGrade, one level up).

The elliptic prototype uses descending Landen/Gauss transformations for the
Jacobi elliptic functions (cd, sn, and the inverse sn) and the exact
degree-equation solution for the modulus — the standard Orfanidis recipe —
implemented from scratch in numpy; parity vs scipy.signal.ellip is pinned
in tests/test_design_spectral.py.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "iirfilter",
    "iirdesign",
    "design_elliptic",
    "design_bessel",
    "zpk2sos",
    "butter_zpk_proto",
    "buttord",
    "cheb1ord",
    "cheb2ord",
    "ellipord",
    "iirnotch",
    "iirpeak",
    "iircomb",
]


# --- Jacobi elliptic functions via Landen transformations --------------------


def _landen(k: float, tol: float = 1e-18) -> np.ndarray:
    """Descending Landen sequence k_1, k_2, ... until k_n < tol."""
    ks = []
    k = float(k)
    if not 0.0 <= k < 1.0:
        raise ValueError(f"elliptic modulus must be in [0, 1), got {k}")
    while k > tol:
        k = (k / (1.0 + np.sqrt(1.0 - k * k))) ** 2
        ks.append(k)
        if len(ks) > 64:  # quadratic convergence: never reached for k < 1
            break
    return np.asarray(ks)


def _cde(u, k: float):
    """cd(u*K(k), k) for normalized (possibly complex) u."""
    ks = _landen(k)
    w = np.cos(np.asarray(u, dtype=complex) * (np.pi / 2.0))
    for ki in ks[::-1]:
        w = (1.0 + ki) * w / (1.0 + ki * w * w)
    return w


def _sne(u, k: float):
    """sn(u*K(k), k) for normalized (possibly complex) u."""
    ks = _landen(k)
    w = np.sin(np.asarray(u, dtype=complex) * (np.pi / 2.0))
    for ki in ks[::-1]:
        w = (1.0 + ki) * w / (1.0 + ki * w * w)
    return w


def _asne(w, k: float):
    """Inverse of :func:`_sne` (principal branch), complex-safe."""
    ks = _landen(k)
    w = np.asarray(w, dtype=complex)
    kprev = k
    for ki in ks:
        w = 2.0 * w / ((1.0 + ki) * (1.0 + np.sqrt(1.0 - kprev * kprev * w * w)))
        kprev = ki
    return 2.0 / np.pi * np.arcsin(w)


def _ellipdeg(n: int, k1: float) -> float:
    """Solve the elliptic degree equation for the selectivity modulus k.

    Exact solution k = sqrt(1 - (k1'^n * prod sn((2i-1)/n, k1')^4)^2)
    given the degree n and the discrimination modulus k1 = eps_p/eps_s.
    """
    kc = np.sqrt(1.0 - k1 * k1)  # complement of k1
    L = n // 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / n
    kp = kc**n * np.prod(np.real(_sne(ui, kc))) ** 4
    return float(np.sqrt(1.0 - kp * kp))


# --- analog lowpass prototypes (cutoff 1 rad/s) -------------------------------


def butter_zpk_proto(order: int):
    """Butterworth analog prototype: poles on the unit circle, no zeros."""
    k = np.arange(order)
    p = np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order))
    return np.array([], complex), p, 1.0 / np.real(np.prod(-p))


def _cheby1_zpk_proto(order: int, rp_db: float):
    eps = np.sqrt(10.0 ** (rp_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    p = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    gain = np.real(np.prod(-p))
    if order % 2 == 0:  # passband peaks at 1; DC sits at -rp
        gain /= np.sqrt(1.0 + eps * eps)
    return np.array([], complex), p, float(gain)


def _cheby2_zpk_proto(order: int, rs_db: float):
    eps = 1.0 / np.sqrt(10.0 ** (rs_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    p1 = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    p = 1.0 / p1
    with np.errstate(divide="ignore"):
        zc = np.cos(theta)
    z = 1j / zc[np.abs(zc) > 1e-12]  # odd order: middle zero at infinity
    gain = np.real(np.prod(-p)) / np.real(np.prod(-z))
    return z, p, float(gain)


def _ellip_zpk_proto(order: int, rp_db: float, rs_db: float):
    """Elliptic (Cauer) analog prototype (Orfanidis Landen recipe)."""
    if order == 1:  # degenerate: same as Chebyshev I first order
        eps = np.sqrt(10.0 ** (rp_db / 10.0) - 1.0)
        p = np.array([-1.0 / eps], complex)
        return np.array([], complex), p, 1.0 / eps
    ep = np.sqrt(10.0 ** (rp_db / 10.0) - 1.0)
    es = np.sqrt(10.0 ** (rs_db / 10.0) - 1.0)
    k1 = ep / es
    k = _ellipdeg(order, k1)
    L, r = order // 2, order % 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / order
    zeta = np.real(_cde(ui, k))  # in (0, 1)
    z_half = 1j / (k * zeta)
    v0 = np.real(-1j * _asne(1j / ep, k1) / order)
    p_half = 1j * _cde(ui - 1j * v0, k)
    z = np.concatenate([z_half, np.conj(z_half)])
    p = np.concatenate([p_half, np.conj(p_half)])
    if r:
        p0 = 1j * _sne(1j * v0, k)
        p = np.concatenate([p, [complex(np.real(p0), 0.0)]])
    gain = np.real(np.prod(-p)) / np.real(np.prod(-z))
    if r == 0:  # even order: DC gain 1/sqrt(1+eps^2)
        gain /= np.sqrt(1.0 + ep * ep)
    return z, p, float(gain)


# --- zpk band transforms (scipy lp2*_zpk semantics) ----------------------------


def _lp2lp_zpk(z, p, k, wo):
    deg = len(p) - len(z)
    return z * wo, p * wo, k * wo**deg


def _lp2hp_zpk(z, p, k, wo):
    deg = len(p) - len(z)
    zh = wo / z if len(z) else np.array([], complex)
    ph = wo / p
    zh = np.append(zh, np.zeros(deg))
    k = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k / np.real(
        np.prod(-p)
    )
    return zh, ph, k


def _lp2bp_zpk(z, p, k, wo, bw):
    deg = len(p) - len(z)
    zs = z * bw / 2.0
    ps = p * bw / 2.0
    zb = np.concatenate(
        [zs + np.sqrt(zs * zs - wo * wo), zs - np.sqrt(zs * zs - wo * wo)]
    ) if len(z) else np.array([], complex)
    pb = np.concatenate(
        [ps + np.sqrt(ps * ps - wo * wo), ps - np.sqrt(ps * ps - wo * wo)]
    )
    zb = np.append(zb, np.zeros(deg))
    return zb, pb, k * bw**deg


def _lp2bs_zpk(z, p, k, wo, bw):
    deg = len(p) - len(z)
    zi = (bw / 2.0) / z if len(z) else np.array([], complex)
    pi = (bw / 2.0) / p
    zb = np.concatenate(
        [zi + np.sqrt(zi * zi - wo * wo), zi - np.sqrt(zi * zi - wo * wo)]
    ) if len(z) else np.array([], complex)
    pb = np.concatenate(
        [pi + np.sqrt(pi * pi - wo * wo), pi - np.sqrt(pi * pi - wo * wo)]
    )
    zb = np.concatenate([zb, np.full(deg, 1j * wo), np.full(deg, -1j * wo)])
    num = np.real(np.prod(-z)) if len(z) else 1.0
    k = k * num / np.real(np.prod(-p))
    return zb, pb, k


def _bilinear_zpk(z, p, k):
    """Bilinear s -> z with the prewarp convention s_cut = tan(pi*Wn/2)."""
    deg = len(p) - len(z)
    zd = (1.0 + z) / (1.0 - z) if len(z) else np.array([], complex)
    pd = (1.0 + p) / (1.0 - p)
    zd = np.append(zd, -np.ones(deg))
    num = np.real(np.prod(1.0 - z)) if len(z) else 1.0
    kd = k * num / np.real(np.prod(1.0 - p))
    return zd, pd, kd


# --- zpk -> SOS ----------------------------------------------------------------


def _split_conj(roots, tol=1e-8):
    """(conjugate-pair representatives, reals) from a conjugate-closed set."""
    roots = np.asarray(roots, complex)
    upper = sorted(
        (r for r in roots if r.imag > tol), key=lambda r: (r.real, r.imag)
    )
    reals = sorted(r.real for r in roots if abs(r.imag) <= tol)
    return upper, reals


def zpk2sos(z, p, k) -> np.ndarray:
    """Digital zpk -> scipy-layout SOS rows, gain distributed evenly.

    Pairing: conjugate pole pairs sorted by closeness to the unit circle
    (least-damped LAST in the cascade — the scipy ordering that keeps
    intermediate stages bounded); each pole pair takes the nearest
    available zero pair. Leftover reals pair among themselves.
    """
    z = np.asarray(z, complex)
    p = np.asarray(p, complex)
    n_sec = max((max(len(z), len(p)) + 1) // 2, 1)
    z = np.append(z, np.zeros(2 * n_sec - len(z)))
    p = np.append(p, np.zeros(2 * n_sec - len(p)))

    pu, pr = _split_conj(p)
    zu, zr = _split_conj(z)
    pole_pairs = [(c, np.conj(c)) for c in pu]
    for i in range(0, len(pr) - 1, 2):
        pole_pairs.append((pr[i] + 0j, pr[i + 1] + 0j))
    if len(pr) % 2:
        pole_pairs.append((pr[-1] + 0j, 0j))
    zero_pairs = [(c, np.conj(c)) for c in zu]
    for i in range(0, len(zr) - 1, 2):
        zero_pairs.append((zr[i] + 0j, zr[i + 1] + 0j))
    if len(zr) % 2:
        zero_pairs.append((zr[-1] + 0j, 0j))
    while len(zero_pairs) < n_sec:
        zero_pairs.append((0j, 0j))
    while len(pole_pairs) < n_sec:
        pole_pairs.append((0j, 0j))

    # least-damped pole pairs last, each grabbing its nearest zero pair
    pole_pairs.sort(key=lambda pp: abs(1.0 - abs(pp[0])), reverse=True)
    rows = []
    remaining = list(zero_pairs)
    for pp in pole_pairs:
        j = min(
            range(len(remaining)), key=lambda i: abs(remaining[i][0] - pp[0])
        )
        zz = remaining.pop(j)
        bb = np.array([1.0, -(zz[0] + zz[1]).real, (zz[0] * zz[1]).real])
        aa = np.array([1.0, -(pp[0] + pp[1]).real, (pp[0] * pp[1]).real])
        rows.append(np.concatenate([bb, aa]))
    g = abs(k) ** (1.0 / n_sec) * np.sign(k)
    sos = np.asarray(rows, np.float64)
    sos[:, :3] *= g
    return sos.astype(np.float32)


# --- public surface -------------------------------------------------------------


_PROTOS = {
    "butter": lambda n, rp, rs: butter_zpk_proto(n),
    "cheby1": lambda n, rp, rs: _cheby1_zpk_proto(n, rp),
    "cheby2": lambda n, rp, rs: _cheby2_zpk_proto(n, rs),
    "ellip": lambda n, rp, rs: _ellip_zpk_proto(n, rp, rs),
    "bessel": lambda n, rp, rs: _bessel_zpk_proto(n),
}


def iirfilter(
    order: int,
    Wn,
    *,
    btype: str = "lowpass",
    ftype: str = "butter",
    rp: float | None = None,
    rs: float | None = None,
) -> np.ndarray:
    """Classical IIR design -> SOS rows (scipy.signal.iirfilter-compatible).

    ``Wn``: cutoff in (0, 1) Nyquist units — a scalar for lowpass/highpass,
    a (low, high) pair for bandpass/bandstop. ``rp``: passband ripple dB
    (cheby1/ellip); ``rs``: stopband attenuation dB (cheby2/ellip).
    Magnitude response matches scipy.signal.iirfilter(output='sos') across
    the tests' spec grid (tests/test_design_spectral.py).
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if ftype not in _PROTOS:
        raise ValueError(f"ftype must be one of {sorted(_PROTOS)}, got {ftype!r}")
    if ftype in ("cheby1", "ellip") and (rp is None or rp <= 0):
        raise ValueError(f"{ftype} needs passband ripple rp > 0 dB, got {rp}")
    if ftype in ("cheby2", "ellip") and (rs is None or rs <= 0):
        raise ValueError(f"{ftype} needs stopband attenuation rs > 0 dB, got {rs}")
    z, p, k = _PROTOS[ftype](order, rp, rs)

    if btype in ("lowpass", "highpass"):
        wn = float(np.squeeze(np.asarray(Wn)))
        if not 0.0 < wn < 1.0:
            raise ValueError(f"Wn must be in (0,1) of Nyquist, got {Wn}")
        warped = np.tan(np.pi * wn / 2.0)
        if btype == "lowpass":
            z, p, k = _lp2lp_zpk(z, p, k, warped)
        else:
            z, p, k = _lp2hp_zpk(z, p, k, warped)
    elif btype in ("bandpass", "bandstop"):
        lo, hi = (float(v) for v in np.asarray(Wn).reshape(2))
        if not 0.0 < lo < hi < 1.0:
            raise ValueError(f"need 0 < low < high < 1 (Nyquist), got {Wn}")
        w1, w2 = np.tan(np.pi * lo / 2.0), np.tan(np.pi * hi / 2.0)
        wo, bw = np.sqrt(w1 * w2), w2 - w1
        if btype == "bandpass":
            z, p, k = _lp2bp_zpk(z, p, k, wo, bw)
        else:
            z, p, k = _lp2bs_zpk(z, p, k, wo, bw)
    else:
        raise ValueError(
            "btype must be lowpass/highpass/bandpass/bandstop, "
            f"got {btype!r}"
        )
    z, p, k = _bilinear_zpk(z, p, k)
    return zpk2sos(z, p, k)


def design_elliptic(
    order: int, rp_db: float, rs_db: float, Wn, btype: str = "lowpass"
) -> np.ndarray:
    """Elliptic (Cauer) digital filter as an SOS cascade (scipy layout).

    Steepest classical rolloff for a given order: equiripple in BOTH bands
    (``rp_db`` passband ripple, ``rs_db`` stopband attenuation). Matches
    scipy.signal.ellip's magnitude response (tests/test_design_spectral.py).
    """
    return iirfilter(order, Wn, btype=btype, ftype="ellip", rp=rp_db, rs=rs_db)


# --- minimum order selection (scipy *ord semantics) ----------------------------


def _ellipk_modulus(k: float) -> float:
    """Complete elliptic integral K(k) (MODULUS argument, like Orfanidis —
    scipy.special.ellipk takes m = k^2) via the arithmetic-geometric mean."""
    if not 0.0 <= k < 1.0:
        raise ValueError(f"modulus must be in [0, 1), got {k}")
    a, b = 1.0, float(np.sqrt(1.0 - k * k))
    while abs(a - b) > 1e-15 * a:
        a, b = 0.5 * (a + b), float(np.sqrt(a * b))
    return float(np.pi / (2.0 * a))


def _order_continuous(family: str, nat: float, gpass: float, gstop: float) -> float:
    """Continuous (non-integer) minimum order at analog selectivity ``nat``.

    ``nat`` is the stopband-edge frequency of the passband-normalized analog
    prototype. Standard closed forms; elliptic uses the exact degree
    equation N = [K(k) K'(k1)] / [K'(k) K(k1)].
    """
    nat = abs(float(nat))
    d = (10.0 ** (0.1 * gstop) - 1.0) / (10.0 ** (0.1 * gpass) - 1.0)
    if family == "butter":
        return np.log10(d) / (2.0 * np.log10(nat))
    if family in ("cheby1", "cheby2"):
        return float(np.arccosh(np.sqrt(d)) / np.arccosh(nat))
    if family == "ellip":
        k = 1.0 / nat
        k1 = 1.0 / np.sqrt(d)
        kc = np.sqrt(max(1.0 - k * k, 0.0))
        k1c = np.sqrt(max(1.0 - k1 * k1, 0.0))
        return float(
            (_ellipk_modulus(k) * _ellipk_modulus(k1c))
            / (_ellipk_modulus(kc) * _ellipk_modulus(k1))
        )
    raise ValueError(f"unknown family {family!r}")


def _golden_min(f, lo: float, hi: float, tol: float = 1e-8) -> float:
    """Golden-section minimizer on [lo, hi] (hand-rolled: design is
    numpy-only at runtime; mirrors the fminbound role in scipy's *ord)."""
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = float(lo), float(hi)
    c, dd = b - invphi * (b - a), a + invphi * (b - a)
    fc, fd = f(c), f(dd)
    while (b - a) > tol * (abs(a) + abs(b) + 1e-30):
        if fc < fd:
            b, dd, fd = dd, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, dd, fd
            dd = a + invphi * (b - a)
            fd = f(dd)
    return 0.5 * (a + b)


def _band_type(wp, ws) -> str:
    wp = np.atleast_1d(np.asarray(wp, np.float64))
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    if wp.size != ws.size or wp.size not in (1, 2):
        raise ValueError("wp and ws must both be scalars or both be pairs")
    if np.any(wp <= 0) or np.any(wp >= 1) or np.any(ws <= 0) or np.any(ws >= 1):
        raise ValueError("band edges must be in (0, 1) Nyquist units")
    if wp.size == 1:
        return "lowpass" if wp[0] < ws[0] else "highpass"
    if wp[0] < wp[1] and ws[0] < ws[1]:
        if ws[0] < wp[0] and wp[1] < ws[1]:
            return "bandpass"
        if wp[0] < ws[0] and ws[1] < wp[1]:
            return "bandstop"
    raise ValueError(f"inconsistent band edges wp={wp}, ws={ws}")


def _band_nat(btype, passb, stopb, family, gpass, gstop):
    """(selectivity nat, possibly-adjusted analog passband edges).

    Bandstop adjusts each passband edge inward (1-D golden-section on the
    continuous order, like scipy's fminbound step) — the raw edges
    over-constrain one side of the notch.
    """
    if btype == "lowpass":
        return stopb[0] / passb[0], passb
    if btype == "highpass":
        return passb[0] / stopb[0], passb
    if btype == "bandpass":
        w02 = passb[0] * passb[1]
        bw = passb[1] - passb[0]
        nats = (stopb**2 - w02) / (stopb * bw)
        return min(abs(nats)), passb
    # bandstop
    passb = passb.copy()

    def order_at(edge_idx, w):
        pb = passb.copy()
        pb[edge_idx] = w
        w02 = pb[0] * pb[1]
        bw = pb[1] - pb[0]
        nats = (stopb * bw) / (stopb**2 - w02)
        return _order_continuous(family, min(abs(nats)), gpass, gstop)

    passb[0] = _golden_min(
        lambda w: order_at(0, w), passb[0], stopb[0] - 1e-12
    )
    passb[1] = _golden_min(
        lambda w: order_at(1, w), stopb[1] + 1e-12, passb[1]
    )
    w02 = passb[0] * passb[1]
    bw = passb[1] - passb[0]
    nats = (stopb * bw) / (stopb**2 - w02)
    return min(abs(nats)), passb


def _wn_from_proto(W0: float, btype: str, passb: np.ndarray) -> np.ndarray:
    """Analog frequencies mapping to passband-normalized prototype frequency
    ``W0`` under the band transform anchored at ``passb`` (inverts the
    LP->{LP,HP,BP,BS} maps; the butter/cheby2 natural-frequency step)."""
    if btype == "lowpass":
        return np.array([W0 * passb[0]])
    if btype == "highpass":
        return np.array([passb[0] / W0])
    w02 = passb[0] * passb[1]
    bw = passb[1] - passb[0]
    if btype == "bandpass":
        # (W^2 - w02)/(bw W) = +/-W0  ->  W = -/+W0 bw/2 + sqrt((W0 bw/2)^2 + w02)
        half = W0 * bw / 2.0
        hi = half + np.sqrt(half * half + w02)
        return np.array([w02 / hi, hi])
    # bandstop: bw W/(w02 - W^2) = +/-W0 -> W0 W^2 +/- bw W - W0 w02 = 0
    disc = np.sqrt(bw * bw + 4.0 * W0 * W0 * w02)
    lo = (-bw + disc) / (2.0 * W0)
    hi = (bw + disc) / (2.0 * W0)
    return np.array([lo, hi])


def _iir_ord(family: str, wp, ws, gpass: float, gstop: float):
    if gpass <= 0 or gstop <= 0:
        raise ValueError(f"gpass/gstop must be > 0 dB, got {gpass}, {gstop}")
    if gpass >= gstop:
        raise ValueError(
            f"gpass ({gpass} dB) must be smaller than gstop ({gstop} dB)"
        )
    btype = _band_type(wp, ws)
    passb = np.tan(np.pi * np.atleast_1d(np.asarray(wp, np.float64)) / 2.0)
    stopb = np.tan(np.pi * np.atleast_1d(np.asarray(ws, np.float64)) / 2.0)
    nat, passb = _band_nat(btype, passb, stopb, family, gpass, gstop)
    order = int(np.ceil(_order_continuous(family, nat, gpass, gstop) - 1e-9))
    order = max(order, 1)

    if family == "butter":
        # -3 dB natural frequency meeting the passband spec exactly
        W0 = (10.0 ** (0.1 * gpass) - 1.0) ** (-1.0 / (2.0 * order))
        wn_analog = _wn_from_proto(W0, btype, passb)
        wn = 2.0 / np.pi * np.arctan(wn_analog)
    elif family == "cheby2":
        # stopband edge meeting the passband spec exactly
        d = (10.0 ** (0.1 * gstop) - 1.0) / (10.0 ** (0.1 * gpass) - 1.0)
        W0 = float(np.cosh(np.arccosh(np.sqrt(d)) / order))
        wn_analog = _wn_from_proto(W0, btype, passb)
        wn = 2.0 / np.pi * np.arctan(wn_analog)
    else:  # cheby1 / ellip anchor at the (bandstop-adjusted) passband edges
        wn = 2.0 / np.pi * np.arctan(passb)
    wn = np.sort(wn)
    return order, (float(wn[0]) if wn.size == 1 else wn.astype(np.float64))


def buttord(wp, ws, gpass: float, gstop: float):
    """(order, wn) of the cheapest Butterworth meeting the band spec
    (scipy.signal.buttord, digital, Nyquist units). ``wn`` is the -3 dB
    natural frequency to pass to :func:`iirfilter`/design_butterworth."""
    return _iir_ord("butter", wp, ws, gpass, gstop)


def cheb1ord(wp, ws, gpass: float, gstop: float):
    """(order, wn) for Chebyshev I (scipy.signal.cheb1ord semantics)."""
    return _iir_ord("cheby1", wp, ws, gpass, gstop)


def cheb2ord(wp, ws, gpass: float, gstop: float):
    """(order, wn) for Chebyshev II; ``wn`` is the stopband-side design
    frequency meeting the passband spec exactly (scipy.signal.cheb2ord)."""
    return _iir_ord("cheby2", wp, ws, gpass, gstop)


def ellipord(wp, ws, gpass: float, gstop: float):
    """(order, wn) for an elliptic filter via the exact degree equation
    (scipy.signal.ellipord semantics)."""
    return _iir_ord("ellip", wp, ws, gpass, gstop)


_ORDS = {
    "butter": buttord,
    "cheby1": cheb1ord,
    "cheby2": cheb2ord,
    "ellip": ellipord,
}


def iirdesign(
    wp, ws, gpass: float, gstop: float, *, ftype: str = "ellip"
) -> np.ndarray:
    """Band-spec-driven IIR design -> SOS rows (scipy.signal.iirdesign).

    Picks the minimum order for ``ftype`` via the matching *ord rule, then
    designs through :func:`iirfilter`. ``wp``/``ws`` in (0, 1) Nyquist
    units (scalars, or pairs for bandpass/bandstop specs).
    """
    if ftype not in _ORDS:
        raise ValueError(f"ftype must be one of {sorted(_ORDS)}, got {ftype!r}")
    order, wn = _ORDS[ftype](wp, ws, gpass, gstop)
    btype = _band_type(wp, ws)
    return iirfilter(
        order, wn, btype=btype, ftype=ftype, rp=gpass, rs=gstop
    )


# --- Bessel/Thomson family -----------------------------------------------------


_BESSEL_MAX_ORDER = 25  # np.roots conditioning on the reverse Bessel poly


def _bessel_zpk_proto(order: int, norm: str = "phase"):
    """Bessel analog prototype: poles = roots of the reverse Bessel
    polynomial theta_n(s), no zeros; maximally flat GROUP DELAY.

    ``norm``: 'phase' (scipy default — phase response crosses its midpoint
    at w=1, poles scaled by theta_n(0)^(-1/n)), 'delay' (unit group delay
    at DC — unscaled roots), 'mag' (-3 dB at w=1, scale found by
    bisection on the magnitude).
    """
    n = order
    if n > _BESSEL_MAX_ORDER:
        raise ValueError(
            f"bessel design supported to order {_BESSEL_MAX_ORDER} "
            f"(np.roots conditioning), got {n}"
        )
    import math

    # theta_n(s) = sum_k a_k s^k, a_k = (2n-k)! / (2^(n-k) k! (n-k)!)
    a = np.array(
        [
            math.factorial(2 * n - k)
            / (2 ** (n - k) * math.factorial(k) * math.factorial(n - k))
            for k in range(n + 1)
        ],
        np.float64,
    )
    p = np.roots(a[::-1])  # highest power first
    if norm == "phase":
        p = p / a[0] ** (1.0 / n)
    elif norm == "mag":
        # H normalized to H(0)=1; find a with |H(j a)| = 1/sqrt(2), then
        # scale poles so the -3 dB point lands at w=1
        k0 = np.real(np.prod(-p))

        def mag(w):
            return abs(k0 / np.prod(1j * w - p))

        lo, hi = 1e-6, 1e6
        for _ in range(200):
            mid = np.sqrt(lo * hi)
            if mag(mid) > 1.0 / np.sqrt(2.0):
                lo = mid
            else:
                hi = mid
        p = p / np.sqrt(lo * hi)
    elif norm != "delay":
        raise ValueError(f"norm must be phase/delay/mag, got {norm!r}")
    k = float(np.real(np.prod(-p)))  # H(0) = 1
    return np.array([], complex), p, k


def design_bessel(
    order: int, Wn, *, btype: str = "lowpass", norm: str = "phase"
) -> np.ndarray:
    """Bessel/Thomson digital filter -> SOS rows (scipy.signal.bessel).

    Linear-phase-like: maximally flat group delay in the passband (the
    bilinear transform warps it near Nyquist like scipy's). Magnitude
    parity vs scipy.signal.bessel(norm=...) in tests/test_design_spectral.
    """
    z, p, k = _bessel_zpk_proto(order, norm)
    return _zpk_band_design(z, p, k, Wn, btype)


def _zpk_band_design(z, p, k, Wn, btype: str) -> np.ndarray:
    """Shared band-transform + bilinear + SOS tail of iirfilter for a
    caller-supplied analog prototype."""
    if btype in ("lowpass", "highpass"):
        wn = float(np.squeeze(np.asarray(Wn)))
        if not 0.0 < wn < 1.0:
            raise ValueError(f"Wn must be in (0,1) of Nyquist, got {Wn}")
        warped = np.tan(np.pi * wn / 2.0)
        z, p, k = (
            _lp2lp_zpk(z, p, k, warped)
            if btype == "lowpass"
            else _lp2hp_zpk(z, p, k, warped)
        )
    elif btype in ("bandpass", "bandstop"):
        lo, hi = (float(v) for v in np.asarray(Wn).reshape(2))
        if not 0.0 < lo < hi < 1.0:
            raise ValueError(f"need 0 < low < high < 1 (Nyquist), got {Wn}")
        w1, w2 = np.tan(np.pi * lo / 2.0), np.tan(np.pi * hi / 2.0)
        wo, bw = np.sqrt(w1 * w2), w2 - w1
        z, p, k = (
            _lp2bp_zpk(z, p, k, wo, bw)
            if btype == "bandpass"
            else _lp2bs_zpk(z, p, k, wo, bw)
        )
    else:
        raise ValueError(f"unknown btype {btype!r}")
    z, p, k = _bilinear_zpk(z, p, k)
    return zpk2sos(z, p, k)


# --- notch / peak / comb biquads (scipy.signal.iirnotch/iirpeak/iircomb) -------


def _notch_peak(w0: float, Q: float, kind: str):
    if not 0.0 < w0 < 1.0:
        raise ValueError(f"w0 must be in (0, 1) Nyquist units, got {w0}")
    if Q <= 0:
        raise ValueError(f"Q must be > 0, got {Q}")
    om = np.pi * w0
    bw_half = np.tan(om / (2.0 * Q))  # tan(bw/2), bw = om/Q rad
    gain = 1.0 / (1.0 + bw_half)
    if kind == "notch":
        b = gain * np.array([1.0, -2.0 * np.cos(om), 1.0])
    else:  # peak: unity AT w0, zero at DC/Nyquist
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * np.cos(om), 2.0 * gain - 1.0])
    return b.astype(np.float64), a.astype(np.float64)


def iirnotch(w0: float, Q: float):
    """(b, a) second-order notch at ``w0`` Nyquist units, -3 dB bandwidth
    ``w0/Q`` (scipy.signal.iirnotch)."""
    return _notch_peak(w0, Q, "notch")


def iirpeak(w0: float, Q: float):
    """(b, a) second-order resonator passing only ``w0`` (scipy.signal.iirpeak)."""
    return _notch_peak(w0, Q, "peak")


def iircomb(w0: float, Q: float, *, ftype: str = "notch", pass_zero: bool = False):
    """(b, a) comb filter notching (or peaking) every harmonic of ``w0``
    (scipy.signal.iircomb semantics; ``w0`` in Nyquist units must divide 2
    to an integer number of teeth).

    ``pass_zero=False`` places notches/peaks AT the harmonics of w0;
    ``True`` shifts them to the midpoints (scipy 1.9 behavior).
    """
    if not 0.0 < w0 < 1.0:
        raise ValueError(f"w0 must be in (0, 1) Nyquist units, got {w0}")
    if Q <= 0:
        raise ValueError(f"Q must be > 0, got {Q}")
    if ftype not in ("notch", "peak"):
        raise ValueError(f"ftype must be notch or peak, got {ftype!r}")
    teeth = 2.0 / w0
    n = int(round(teeth))
    if abs(teeth - n) > 1e-9:
        raise ValueError(
            f"w0 must divide the sampling band evenly: 2/w0 = {teeth} not integer"
        )
    # Orfanidis comb: beta = tan(N bw/4); bw = w0/Q in rad (om0 = pi w0).
    # H(z) = (b0 +/- b0 z^-N)/(1 -/+ (2g-1) z^-N); the z^-N sign in b is
    # + iff pass_zero (teeth at the midpoints); a's sign tracks b for
    # notch and flips for peak.
    beta = np.tan(n * (np.pi * w0 / Q) / 4.0)
    g = 1.0 / (1.0 + beta)
    b0 = g if ftype == "notch" else 1.0 - g
    sb = 1.0 if pass_zero else -1.0
    sa = sb if ftype == "notch" else -sb
    b = np.zeros(n + 1)
    a = np.zeros(n + 1)
    b[0], b[n] = b0, sb * b0
    a[0], a[n] = 1.0, sa * (2.0 * g - 1.0)
    return b, a


# --- representation conversions (scipy.signal tf2zpk/zpk2tf/sos2*/bilinear) ----


def tf2zpk(b, a):
    """(z, p, k) from transfer-function coefficients (scipy.signal.tf2zpk;
    float64 host-side, trims leading numerator zeros into the gain)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0.0:
        raise ValueError("denominator must have a nonzero leading coefficient")
    b, a = b / a[0], a / a[0]
    bt = np.trim_zeros(b, "f")
    if bt.size == 0:
        return np.array([], complex), np.roots(a), 0.0
    k = bt[0]
    z = np.roots(bt / k)
    # leading zeros trimmed from b are zeros at the origin of the INVERSE
    # variable — scipy drops them from z (degree bookkeeping only)
    return z, np.roots(a), float(k)


def zpk2tf(z, p, k):
    """(b, a) polynomial coefficients from zeros/poles/gain
    (scipy.signal.zpk2tf; real-coefficient result for conjugate-closed
    inputs)."""
    b = k * np.poly(np.asarray(z, complex))
    a = np.poly(np.asarray(p, complex))
    if np.allclose(b.imag, 0.0, atol=1e-12):
        b = b.real
    if np.allclose(a.imag, 0.0, atol=1e-12):
        a = a.real
    return np.atleast_1d(b), np.atleast_1d(a)


def sos2tf(sos):
    """(b, a) from an SOS cascade by polynomial multiplication
    (scipy.signal.sos2tf)."""
    sos = np.asarray(sos, np.float64).reshape(-1, 6)
    b, a = np.array([1.0]), np.array([1.0])
    for row in sos:
        b = np.convolve(b, row[:3])
        a = np.convolve(a, row[3:])
    return b, a


def sos2zpk(sos):
    """(z, p, k) from an SOS cascade (scipy.signal.sos2zpk: 2 zeros/poles
    per section including the padding ones at the origin)."""
    sos = np.asarray(sos, np.float64).reshape(-1, 6)
    z, p, k = [], [], 1.0
    for row in sos:
        zi, pi, ki = tf2zpk(row[:3], row[3:])
        # keep the degree-2 bookkeeping: pad trimmed origin roots back
        z.extend(np.append(zi, np.zeros(2 - len(zi))))
        p.extend(np.append(pi, np.zeros(2 - len(pi))))
        k *= ki
    return np.asarray(z, complex), np.asarray(p, complex), float(k)


def normalize(b, a):
    """(b, a) scaled so a[0] == 1, leading numerator zeros kept
    (scipy.signal.normalize without the dimension games)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0.0:
        raise ValueError("denominator must have a nonzero leading coefficient")
    return b / a[0], a / a[0]


def bilinear(b, a, fs: float = 2.0):
    """Digital (b, a) from an ANALOG transfer function via the Tustin map
    s -> 2 fs (z-1)/(z+1) (scipy.signal.bilinear; no prewarp — warp the
    analog design frequency yourself or use the zpk pipeline which does).
    """
    z, p, k = tf2zpk(b, a)
    fs2 = 2.0 * float(fs)
    deg = len(p) - len(z)
    zd = (fs2 + z) / (fs2 - z) if len(z) else np.array([], complex)
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(deg))
    num = np.real(np.prod(fs2 - z)) if len(z) else 1.0
    kd = k * num / np.real(np.prod(fs2 - p))
    return zpk2tf(zd, pd, kd)


def gammatone(
    freq: float,
    ftype: str,
    *,
    order: int | None = None,
    numtaps: int | None = None,
    fs: float = 2.0,
):
    """Gammatone auditory filter (scipy.signal.gammatone).

    ``ftype='fir'``: sampled impulse response
    ``t^(order-1) e^(-2 pi b t) cos(2 pi f t)`` with the ERB bandwidth
    ``b = 1.019 * (24.7 + f/9.26449)`` and scipy's analytic scale
    ``2 (2 pi b)^order / ((order-1)! fs)``; defaults order=4,
    numtaps=int(0.015*fs). ``ftype='iir'``: Slaney's 4-section pole-zero
    construction (An Efficient Implementation of the Patterson-Holdsworth
    Auditory Filter Bank, 1993) flattened to (b, a), unit gain at
    ``freq``. Run with :func:`~..iir.lfilter` / ``ba_to_sos`` +
    ``sosfilt`` on device; for full filterbanks prefer the PFB
    channelizer path.
    """
    import math

    if not 0.0 < freq < fs / 2.0:
        raise ValueError(f"freq must be in (0, fs/2), got {freq}")
    erb = 24.7 + freq / 9.26449
    if ftype == "fir":
        order = 4 if order is None else int(order)
        # scipy floors the default at 15 taps for low sample rates
        numtaps = max(int(0.015 * fs), 15) if numtaps is None else int(numtaps)
        if order < 1 or numtaps < 1:
            raise ValueError("order and numtaps must be >= 1")
        bw = 1.019 * erb
        t = np.arange(numtaps) / fs
        scale = 2.0 * (2.0 * np.pi * bw) ** order / (
            math.factorial(order - 1) * fs
        )
        b = (
            scale
            * t ** (order - 1)
            * np.exp(-2.0 * np.pi * bw * t)
            * np.cos(2.0 * np.pi * freq * t)
        )
        return b, np.ones(1)
    if ftype != "iir":
        raise ValueError(f"ftype must be 'fir' or 'iir', got {ftype!r}")
    if order is not None or numtaps is not None:
        raise ValueError("order/numtaps only apply to ftype='fir'")
    T = 1.0 / fs
    w0 = 2.0 * np.pi * freq
    bw = 2.0 * np.pi * 1.019 * erb
    ec = np.exp(-bw * T)
    cs, sn = np.cos(w0 * T), np.sin(w0 * T)
    den1 = np.array([1.0, -2.0 * ec * cs, ec * ec])
    num = np.ones(1)
    den = np.ones(1)
    for ck in (
        np.sqrt(3.0 + 2.0**1.5),
        -np.sqrt(3.0 + 2.0**1.5),
        np.sqrt(3.0 - 2.0**1.5),
        -np.sqrt(3.0 - 2.0**1.5),
    ):
        num = np.polymul(num, np.array([T, -T * ec * (cs + ck * sn)]))
        den = np.polymul(den, den1)
    # unit gain at the center frequency
    z0 = np.exp(1j * w0 * T)
    h0 = np.polyval(num, z0) / np.polyval(den, z0) * z0 ** (
        len(den) - len(num)
    )
    return num / np.abs(h0), den


# --- public analog prototype / transform surface (scipy names) -----------------
#
# The classical-design pipeline above already contains all of these as its
# internal stages; the scipy-named entry points expose each stage for users
# composing their own designs.


def buttap(n: int):
    """Butterworth analog lowpass prototype (scipy.signal.buttap)."""
    return butter_zpk_proto(int(n))


def cheb1ap(n: int, rp: float):
    """Chebyshev-I analog prototype (scipy.signal.cheb1ap)."""
    return _cheby1_zpk_proto(int(n), float(rp))


def cheb2ap(n: int, rs: float):
    """Chebyshev-II analog prototype (scipy.signal.cheb2ap)."""
    return _cheby2_zpk_proto(int(n), float(rs))


def ellipap(n: int, rp: float, rs: float):
    """Elliptic analog prototype (scipy.signal.ellipap)."""
    return _ellip_zpk_proto(int(n), float(rp), float(rs))


def besselap(n: int, norm: str = "phase"):
    """Bessel analog prototype (scipy.signal.besselap)."""
    return _bessel_zpk_proto(int(n), norm)


def lp2lp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass prototype -> lowpass at wo (scipy.signal.lp2lp_zpk)."""
    return _lp2lp_zpk(np.atleast_1d(z), np.atleast_1d(p), k, float(wo))


def lp2hp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass prototype -> highpass at wo (scipy.signal.lp2hp_zpk)."""
    return _lp2hp_zpk(np.atleast_1d(z), np.atleast_1d(p), k, float(wo))


def lp2bp_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandpass (scipy.signal.lp2bp_zpk)."""
    return _lp2bp_zpk(np.atleast_1d(z), np.atleast_1d(p), k, float(wo), float(bw))


def lp2bs_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandstop (scipy.signal.lp2bs_zpk)."""
    return _lp2bs_zpk(np.atleast_1d(z), np.atleast_1d(p), k, float(wo), float(bw))


def bilinear_zpk(z, p, k, fs: float):
    """Bilinear s -> z at sample rate fs (scipy.signal.bilinear_zpk —
    the 2fs convention; the design pipeline's internal `_bilinear_zpk`
    bakes the tan prewarp instead)."""
    z = np.atleast_1d(z)
    p = np.atleast_1d(p)
    fs2 = 2.0 * float(fs)
    deg = len(p) - len(z)
    zd = (fs2 + z) / (fs2 - z)
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(deg))
    num = np.prod(fs2 - z) if len(z) else 1.0
    kd = k * np.real(num / np.prod(fs2 - p))
    return zd, pd, kd


def _tf_via_zpk(transform, b, a, *args):
    z, p, k = tf2zpk(b, a)
    return zpk2tf(*transform(z, p, k, *args))


def lp2lp(b, a, wo: float = 1.0):
    """TF lowpass prototype -> lowpass (scipy.signal.lp2lp)."""
    return _tf_via_zpk(_lp2lp_zpk, b, a, float(wo))


def lp2hp(b, a, wo: float = 1.0):
    """TF lowpass prototype -> highpass (scipy.signal.lp2hp)."""
    return _tf_via_zpk(_lp2hp_zpk, b, a, float(wo))


def lp2bp(b, a, wo: float = 1.0, bw: float = 1.0):
    """TF lowpass prototype -> bandpass (scipy.signal.lp2bp)."""
    return _tf_via_zpk(_lp2bp_zpk, b, a, float(wo), float(bw))


def lp2bs(b, a, wo: float = 1.0, bw: float = 1.0):
    """TF lowpass prototype -> bandstop (scipy.signal.lp2bs)."""
    return _tf_via_zpk(_lp2bs_zpk, b, a, float(wo), float(bw))


def tf2sos(b, a):
    """(b, a) -> SOS array (scipy.signal.tf2sos); the device filtering
    path's `ops.iir.ba_to_sos` under scipy's name."""
    from .iir import ba_to_sos

    return ba_to_sos(b, a)


def freqz_sos(sos, worN: int = 512):
    """SOS frequency response (scipy.signal.freqz_sos / sosfreqz)."""
    from .iir import sosfreqz

    return sosfreqz(sos, worN=worN)


def findfreqs(num, den, N: int, kind: str = "ba"):
    """Log-spaced angular frequencies covering an analog filter's
    interesting range (scipy.signal.findfreqs)."""
    if kind == "ba":
        ep = np.atleast_1d(np.roots(np.asarray(den, np.float64)))
        tz = np.atleast_1d(np.roots(np.asarray(num, np.float64)))
    elif kind == "zp":
        ep = np.atleast_1d(den)
        tz = np.atleast_1d(num)
    else:
        raise ValueError(f"kind must be 'ba' or 'zp', got {kind!r}")
    if ep.size == 0:
        ep = np.atleast_1d(-1000.0 + 0j)
    ez = np.concatenate(
        [
            ep[ep.imag >= 0],
            tz[(np.abs(tz) < 1e5) & (tz.imag >= 0)],
        ]
    )
    integ = (np.abs(ez) < 1e-10).astype(float)
    hi = np.round(
        np.log10(np.max(3.0 * np.abs(ez.real + integ) + 1.5 * ez.imag)) + 0.5
    )
    lo = np.round(
        np.log10(0.1 * np.min(np.abs(np.real(ez + integ)) + 2.0 * ez.imag))
        - 0.5
    )
    return np.logspace(lo, hi, int(N))


def freqs(b, a, worN=200):
    """Analog frequency response H(jw) (scipy.signal.freqs)."""
    if np.ndim(worN) == 0:
        w = findfreqs(b, a, int(worN))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    h = np.polyval(np.asarray(b, np.float64), s) / np.polyval(
        np.asarray(a, np.float64), s
    )
    return w, h


def freqs_zpk(z, p, k, worN=200):
    """Analog frequency response from zpk (scipy.signal.freqs_zpk)."""
    if np.ndim(worN) == 0:
        w = findfreqs(z, p, int(worN), kind="zp")
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    num = np.ones_like(s) * k
    for zz in np.atleast_1d(z):
        num = num * (s - zz)
    den = np.ones_like(s)
    for pp in np.atleast_1d(p):
        den = den * (s - pp)
    return w, num / den


class BadCoefficients(UserWarning):
    """Warning class for badly conditioned filter coefficients
    (scipy.signal.BadCoefficients); raised by the conversion helpers when
    root-finding hits near-singular polynomials."""
