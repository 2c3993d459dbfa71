"""Array processing: beamforming and direction finding on a ULA.

Seventh model family beside the FM chain, wideband scanner, OFDM, QAM
modem, radar and the adaptive filters: narrowband snapshots from a
uniform linear array turned into spatial spectra (Bartlett / MVDR /
MUSIC) and source bearings. North-star scope like models/radar.py — the
CUDA reference has no array processing (SURVEY.md §2: single-primitive
study) — but every stage is the framework's bread and butter: the sample
covariance is ONE (M, T)x(T, M) matmul, the scan-grid spectra are
(2M, A) matmuls, and subspace estimation rides a real-symmetric eigh.

Design choices:
- planar I/Q at every boundary; device math uses the
  REAL EMBEDDING of complex Hermitian algebra: R = Rr + jRi maps to the
  real-symmetric C(R) = [[Rr, -Ri], [Ri, Rr]] (2M, 2M), a = ai + jaq maps
  to [ai; aq], and a^H R a, R^{-1} a, eigenspaces all commute with the
  embedding. Real-symmetric eigh / Cholesky were chosen for the earlier
  accelerator, where complex eigh lowered poorly (ROADMAP queue 1, item 8
  asks whether complex eigh wins on the GPU).
- snapshot covariance, diagonal loading, forward-backward averaging and
  all three spectra are jitted, static-shaped and batched; bearing
  extraction (tiny top-K peak pick) stays on host like the other
  families' final decision stages.
- the eigendecomposition of C(R) yields each complex eigenvalue TWICE
  (pairs (v, jv) embed as orthogonal real vectors), so a K-source model
  keeps the 2(M-K) smallest eigenvectors as the embedded noise subspace —
  the projector is identical to the complex one, no phase bookkeeping.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ArrayConfig",
    "scan_angles",
    "steering",
    "synthesize",
    "sample_covariance",
    "smoothed_covariance",
    "bartlett_spectrum",
    "mvdr_spectrum",
    "mvdr_weights",
    "music_spectrum",
    "spatial_spectrum",
    "estimate_doa",
    "esprit",
    "root_music",
    "synthesize_wideband",
    "wideband_music_spectrum",
    "estimate_doa_wideband",
    "spectrum_batch",
]


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Uniform linear array and scan grid. ``spacing`` is the element
    pitch in wavelengths (0.5 = the classic half-wavelength grating-lobe
    limit); the grid spans [-90, 90] degrees broadside-relative."""

    n_sensors: int = 8
    spacing: float = 0.5
    n_grid: int = 361
    diagonal_loading: float = 1e-3  # relative to tr(R)/M

    def __post_init__(self):
        if self.n_sensors < 2:
            raise ValueError(f"need >= 2 sensors, got {self.n_sensors}")
        if not 0.0 < self.spacing <= 0.5:
            raise ValueError(
                f"spacing must be in (0, 0.5] wavelengths, got {self.spacing}"
            )
        if self.n_grid < 3:
            raise ValueError(f"n_grid must be >= 3, got {self.n_grid}")


def scan_angles(cfg: ArrayConfig) -> np.ndarray:
    """The bearing grid in degrees, inclusive of both endfires."""
    return np.linspace(-90.0, 90.0, cfg.n_grid)


def steering(cfg: ArrayConfig, angles_deg) -> tuple[np.ndarray, np.ndarray]:
    """Planar ULA steering matrix for bearings in degrees.

    Element m at position m*spacing sees phase -2*pi*spacing*m*sin(theta)
    relative to element 0 (plane wave from bearing theta). Returns
    (ai, aq), each float32 (n_sensors, n_angles), unit per-element gain.
    """
    angles = np.atleast_1d(np.asarray(angles_deg, dtype=np.float64))
    m = np.arange(cfg.n_sensors, dtype=np.float64)[:, None]
    phase = -2.0 * np.pi * cfg.spacing * m * np.sin(np.deg2rad(angles))[None, :]
    return (
        np.cos(phase).astype(np.float32),
        np.sin(phase).astype(np.float32),
    )


def synthesize(
    cfg: ArrayConfig,
    angles_deg,
    n_snapshots: int,
    snr_db: float = 10.0,
    seed: int = 0,
    coherent: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Planar (n_sensors, n_snapshots) snapshots: unit-power circular
    Gaussian sources at the given bearings plus white noise at the given
    per-source SNR. ``coherent=True`` drives every source with the SAME
    waveform (multipath) — the case forward-backward averaging helps."""
    rng = np.random.default_rng(seed)
    angles = np.atleast_1d(np.asarray(angles_deg, dtype=np.float64))
    k = angles.size
    ai, aq = steering(cfg, angles)
    a = ai.astype(np.float64) + 1j * aq.astype(np.float64)
    if coherent:
        base = (
            rng.standard_normal(n_snapshots) + 1j * rng.standard_normal(n_snapshots)
        ) / np.sqrt(2.0)
        s = np.tile(base, (k, 1))
    else:
        s = (
            rng.standard_normal((k, n_snapshots))
            + 1j * rng.standard_normal((k, n_snapshots))
        ) / np.sqrt(2.0)
    sigma = 10.0 ** (-snr_db / 20.0)
    noise = (
        rng.standard_normal((cfg.n_sensors, n_snapshots))
        + 1j * rng.standard_normal((cfg.n_sensors, n_snapshots))
    ) * (sigma / np.sqrt(2.0))
    x = a @ s + noise
    return x.real.astype(np.float32), x.imag.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("forward_backward",))
def sample_covariance(
    xi: jax.Array, xq: jax.Array, *, forward_backward: bool = False
) -> tuple[jax.Array, jax.Array]:
    """Planar sample covariance R = X X^H / T from (M, T) snapshots.

    One matmul per planar part: Rr = (Xi Xi^T + Xq Xq^T)/T,
    Ri = (Xq Xi^T - Xi Xq^T)/T. ``forward_backward=True`` averages in the
    flipped-conjugate copy J conj(R) J (persymmetric smoothing — rank
    restoration for coherent multipath at zero extra snapshots cost).
    """
    xi = xi.astype(jnp.float32)
    xq = xq.astype(jnp.float32)
    t = xi.shape[-1]
    rr = (xi @ xi.T + xq @ xq.T) / t
    ri = (xq @ xi.T - xi @ xq.T) / t
    if forward_backward:
        # J conj(R) J = flip both axes of (Rr, -Ri)
        rr = 0.5 * (rr + rr[::-1, ::-1])
        ri = 0.5 * (ri - ri[::-1, ::-1])
    return rr, ri


@functools.partial(jax.jit, static_argnames=("subarray", "forward_backward"))
def smoothed_covariance(
    xi: jax.Array,
    xq: jax.Array,
    *,
    subarray: int,
    forward_backward: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Spatially smoothed covariance: average over all length-``subarray``
    sliding subarrays (plus forward-backward by default). Restores up to
    M - subarray + 1 coherent sources where plain FB restores only rank 2;
    the returned covariance is subarray x subarray — pair it with steering
    vectors of a ``subarray``-element config. One stacked covariance
    matmul over the J shifted snapshot blocks, no loops over devices."""
    xi = jnp.asarray(xi, jnp.float32)
    xq = jnp.asarray(xq, jnp.float32)
    m = xi.shape[0]
    if not 1 < subarray <= m:
        raise ValueError(f"subarray must be in [2, {m}], got {subarray}")
    j = m - subarray + 1
    idx = jnp.arange(subarray)[None, :] + jnp.arange(j)[:, None]  # (J, L)
    bi = xi[idx]  # (J, L, T)
    bq = xq[idx]
    t = xi.shape[-1]
    rr = jnp.einsum("jlt,jkt->lk", bi, bi) + jnp.einsum("jlt,jkt->lk", bq, bq)
    ri = jnp.einsum("jlt,jkt->lk", bq, bi) - jnp.einsum("jlt,jkt->lk", bi, bq)
    rr = rr / (j * t)
    ri = ri / (j * t)
    if forward_backward:
        rr = 0.5 * (rr + rr[::-1, ::-1])
        ri = 0.5 * (ri - ri[::-1, ::-1])
    return rr, ri


def _embed(rr: jax.Array, ri: jax.Array) -> jax.Array:
    """Real embedding of a complex Hermitian matrix: [[Rr, -Ri],[Ri, Rr]].

    Symmetric iff R is Hermitian; eigenvalues are R's, each doubled."""
    return jnp.block([[rr, -ri], [ri, rr]])


def _embed_vectors(ai: jax.Array, aq: jax.Array) -> jax.Array:
    """(M, A) planar steering columns -> (2M, A) embedded real columns."""
    return jnp.concatenate([ai, aq], axis=0)


def _loaded(rr: jax.Array, loading: float) -> jax.Array:
    """Diagonal loading scaled by the mean sensor power tr(R)/M."""
    eps = loading * jnp.trace(rr) / rr.shape[0]
    return rr + eps * jnp.eye(rr.shape[0], dtype=rr.dtype)


@jax.jit
def bartlett_spectrum(
    rr: jax.Array, ri: jax.Array, ai: jax.Array, aq: jax.Array
) -> jax.Array:
    """Conventional (delay-and-sum) spatial spectrum a^H R a per bearing,
    normalized by the array gain M. One (2M, 2M)x(2M, A) matmul."""
    c = _embed(rr, ri)
    av = _embed_vectors(ai, aq)
    return jnp.sum(av * (c @ av), axis=0) / rr.shape[0]


@functools.partial(jax.jit, static_argnames=("loading",))
def mvdr_spectrum(
    rr: jax.Array,
    ri: jax.Array,
    ai: jax.Array,
    aq: jax.Array,
    *,
    loading: float = 1e-3,
) -> jax.Array:
    """Capon/MVDR spectrum 1/(a^H R^{-1} a) via a Cholesky solve on the
    diagonally loaded real embedding (one factorization, all bearings)."""
    c = _embed(_loaded(rr, loading), ri)
    av = _embed_vectors(ai, aq)
    y = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(c), av)
    return 1.0 / jnp.sum(av * y, axis=0)


@functools.partial(jax.jit, static_argnames=("loading",))
def mvdr_weights(
    rr: jax.Array,
    ri: jax.Array,
    ai: jax.Array,
    aq: jax.Array,
    *,
    loading: float = 1e-3,
) -> tuple[jax.Array, jax.Array]:
    """Distortionless weights w = R^{-1} a / (a^H R^{-1} a) for ONE look
    direction (ai, aq of shape (M,)). Returns planar (wi, wq)."""
    c = _embed(_loaded(rr, loading), ri)
    av = jnp.concatenate([ai, aq])[:, None]
    y = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(c), av)
    w = (y / jnp.sum(av * y))[:, 0]
    m = rr.shape[0]
    return w[:m], w[m:]


@functools.partial(jax.jit, static_argnames=("n_sources",))
def music_spectrum(
    rr: jax.Array,
    ri: jax.Array,
    ai: jax.Array,
    aq: jax.Array,
    *,
    n_sources: int,
) -> jax.Array:
    """MUSIC pseudospectrum 1 / ||E_n^H a||^2 on the scan grid.

    eigh runs on the real embedding; each complex eigenvalue lands twice,
    so the embedded noise subspace is the 2(M - n_sources) SMALLEST
    eigenvectors and the projector equals the complex-domain one exactly.
    Normalized by ||a||^2 = M so a flat (noise-only) spectrum sits at 1.
    """
    m = rr.shape[0]
    if not 0 < n_sources < m:
        raise ValueError(f"n_sources must be in [1, {m - 1}], got {n_sources}")
    c = _embed(rr, ri)
    _, vecs = jnp.linalg.eigh(c)  # ascending eigenvalues
    en = vecs[:, : 2 * (m - n_sources)]
    av = _embed_vectors(ai, aq)
    g = en.T @ av
    return m / jnp.sum(g * g, axis=0)


def spatial_spectrum(
    cfg: ArrayConfig,
    xi,
    xq,
    *,
    method: str = "music",
    n_sources: int = 1,
    forward_backward: bool = False,
):
    """Snapshots -> spectrum over the cfg scan grid (one device program)."""
    ai, aq = steering(cfg, scan_angles(cfg))
    rr, ri = sample_covariance(
        jnp.asarray(xi), jnp.asarray(xq), forward_backward=forward_backward
    )
    if method == "bartlett":
        return bartlett_spectrum(rr, ri, ai, aq)
    if method == "mvdr":
        return mvdr_spectrum(rr, ri, ai, aq, loading=cfg.diagonal_loading)
    if method == "music":
        return music_spectrum(rr, ri, ai, aq, n_sources=n_sources)
    raise ValueError(f"unknown method {method!r}")


def _pick_peaks(angles: np.ndarray, spectrum: np.ndarray, k: int) -> np.ndarray:
    """Top-k interior local maxima with 3-point parabolic refinement;
    falls back to the k largest samples if the surface is too flat.

    Refinement fits the parabola to the RECIPROCAL spectrum: MUSIC and
    MVDR peaks are 1/(smooth quadratic null), so the reciprocal is the
    near-exact quadratic; for Bartlett's quadratic peak the reciprocal is
    quadratic to the same second order."""
    s = np.asarray(spectrum, dtype=np.float64)
    interior = np.nonzero((s[1:-1] >= s[:-2]) & (s[1:-1] > s[2:]))[0] + 1
    if interior.size < k:
        order = np.argsort(s)[::-1]
        keep = []
        for i in order:
            if all(abs(i - j) > 1 for j in keep):
                keep.append(int(i))
            if len(keep) == k:
                break
        interior = np.asarray(sorted(keep))
    peaks = interior[np.argsort(s[interior])[::-1][:k]]
    step = angles[1] - angles[0]
    r = 1.0 / np.maximum(s, np.finfo(np.float64).tiny)
    out = []
    for p in peaks:
        if 0 < p < s.size - 1:
            denom = r[p - 1] - 2.0 * r[p] + r[p + 1]
            delta = 0.0 if denom == 0.0 else 0.5 * (r[p - 1] - r[p + 1]) / denom
            delta = float(np.clip(delta, -0.5, 0.5))
        else:
            delta = 0.0
        out.append(angles[p] + delta * step)
    return np.sort(np.asarray(out))


def estimate_doa(
    cfg: ArrayConfig,
    xi,
    xq,
    *,
    n_sources: int,
    method: str = "music",
    forward_backward: bool = False,
) -> np.ndarray:
    """Full chain: snapshots -> spectrum -> bearings (degrees, ascending).

    Spectrum runs jitted on device; the tiny top-K peak pick (with
    sub-grid parabolic refinement) runs on host like the other families'
    decision stages."""
    spec = spatial_spectrum(
        cfg,
        xi,
        xq,
        method=method,
        n_sources=n_sources,
        forward_backward=forward_backward,
    )
    return _pick_peaks(scan_angles(cfg), np.asarray(spec), n_sources)


def _subspace_complex(rr, ri, n_sources: int, which: str) -> np.ndarray:
    """Orthonormal complex basis of the signal or noise subspace.

    The heavy eigh runs on device over the real embedding; each complex
    eigenvector v lands twice as ([vr; vi], [-vi; vr]), so complexifying
    the selected real block spans exactly the complex subspace (it is
    closed under multiplication by j) and a host SVD of the tiny (M, 2K)
    block returns the orthonormal K-dim basis.
    """
    m = rr.shape[0]
    if not 0 < n_sources < m:
        raise ValueError(f"n_sources must be in [1, {m - 1}], got {n_sources}")
    _, vecs = jnp.linalg.eigh(_embed(jnp.asarray(rr), jnp.asarray(ri)))
    v = np.asarray(vecs)
    if which == "signal":
        block = v[:, 2 * (m - n_sources):]
        k = n_sources
    else:
        block = v[:, : 2 * (m - n_sources)]
        k = m - n_sources
    comp = block[:m] + 1j * block[m:]
    q = np.linalg.svd(comp, full_matrices=False)[0]
    return q[:, :k]


def esprit(
    cfg: ArrayConfig,
    xi,
    xq,
    *,
    n_sources: int,
    forward_backward: bool = False,
) -> np.ndarray:
    """Grid-free ESPRIT bearings (degrees, ascending).

    Rotational invariance of the ULA: the signal subspace restricted to
    sensors 0..M-2 maps onto sensors 1..M-1 by a K x K rotation whose
    eigenvalues are exp(-2j*pi*spacing*sin(theta)). Covariance + eigh run
    on device (real embedding); the K x K least-squares/eig is host numpy
    like the other families' decision stages.
    """
    rr, ri = sample_covariance(
        jnp.asarray(xi), jnp.asarray(xq), forward_backward=forward_backward
    )
    es = _subspace_complex(np.asarray(rr), np.asarray(ri), n_sources, "signal")
    psi = np.linalg.lstsq(es[:-1], es[1:], rcond=None)[0]
    phi = np.linalg.eigvals(psi)
    s = np.clip(-np.angle(phi) / (2.0 * np.pi * cfg.spacing), -1.0, 1.0)
    return np.sort(np.degrees(np.arcsin(s)))


def root_music(
    cfg: ArrayConfig,
    xi,
    xq,
    *,
    n_sources: int,
    forward_backward: bool = False,
) -> np.ndarray:
    """Grid-free root-MUSIC bearings (degrees, ascending).

    The MUSIC null spectrum a(z)^H En En^H a(z) is a degree-2(M-1)
    Laurent polynomial in z = exp(-2j*pi*spacing*sin(theta)); its K roots
    nearest the unit circle (from inside) are the sources. Device does
    covariance + eigh; np.roots on the tiny polynomial is host-side.
    """
    rr, ri = sample_covariance(
        jnp.asarray(xi), jnp.asarray(xq), forward_backward=forward_backward
    )
    en = _subspace_complex(np.asarray(rr), np.asarray(ri), n_sources, "noise")
    m = en.shape[0]
    pn = en @ en.conj().T
    # coefficient of z^k (k = -(M-1) .. M-1) is the k-th diagonal sum
    coefs = np.array(
        [np.trace(pn, offset=k) for k in range(m - 1, -m, -1)]
    )
    roots = np.roots(coefs)
    roots = roots[np.abs(roots) < 1.0]  # keep the inside-circle mirror
    order = np.argsort(np.abs(np.abs(roots) - 1.0))
    picked = roots[order[:n_sources]]
    s = np.clip(-np.angle(picked) / (2.0 * np.pi * cfg.spacing), -1.0, 1.0)
    return np.sort(np.degrees(np.arcsin(s)))


def synthesize_wideband(
    cfg: ArrayConfig,
    angles_deg,
    n_samples: int,
    *,
    spacing_samples: float,
    snr_db: float = 10.0,
    seed: int = 0,
) -> np.ndarray:
    """Real broadband snapshots: white Gaussian sources delayed across the
    ULA by ``m * spacing_samples * sin(theta)`` samples (exact fractional
    delays via FFT phase ramps) plus white noise. Returns (M, T) float32."""
    rng = np.random.default_rng(seed)
    angles = np.atleast_1d(np.asarray(angles_deg, dtype=np.float64))
    x = np.zeros((cfg.n_sensors, n_samples), dtype=np.float64)
    f = np.fft.rfftfreq(n_samples)
    for th in angles:
        s = rng.standard_normal(n_samples)
        sf = np.fft.rfft(s)
        tau = spacing_samples * np.sin(np.deg2rad(th))
        for m in range(cfg.n_sensors):
            x[m] += np.fft.irfft(sf * np.exp(-2j * np.pi * f * m * tau), n_samples)
    sigma = 10.0 ** (-snr_db / 20.0)
    x += sigma * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def wideband_music_spectrum(
    cfg: ArrayConfig,
    x,
    *,
    n_sources: int,
    spacing_samples: float,
    nfft: int = 256,
    hop: int | None = None,
    band: tuple[float, float] = (0.05, 0.45),
    window: str = "hann",
) -> jax.Array:
    """Incoherent wideband MUSIC: STFT each sensor, per-bin sample covariance over frames (one einsum), per-bin
    noise subspace via a BATCHED real-embedded eigh, per-bin
    frequency-scaled steering, and the normalized pseudospectra averaged
    over the band. (M, T) real snapshots -> (n_grid,) spectrum.

    ``spacing_samples`` is the element pitch expressed as the inter-sensor
    propagation delay in samples at broadside-normal incidence — the
    wideband geometry knob (cfg.spacing only has meaning at a single
    wavelength).
    """
    from ..ops.fft import stft

    m = cfg.n_sensors
    if not 0 < n_sources < m:
        raise ValueError(f"n_sources must be in [1, {m - 1}], got {n_sources}")
    if not 0.0 <= band[0] < band[1] <= 0.5:
        raise ValueError(f"band must satisfy 0 <= lo < hi <= 0.5, got {band}")
    hop = hop or nfft // 2
    s = stft(jnp.asarray(x, jnp.float32), nfft=nfft, hop=hop, window=window)
    kbins = np.arange(nfft // 2 + 1)
    keep = (kbins / nfft >= band[0]) & (kbins / nfft <= band[1])
    sel = np.nonzero(keep)[0]
    s = s[..., sel]  # drop out-of-band bins BEFORE the covariance einsums
    sr = jnp.real(s)  # (M, frames, Kb)
    si = jnp.imag(s)
    nframes = s.shape[1]
    # per-bin planar covariance: one einsum pair over frames
    rr = (
        jnp.einsum("mfk,nfk->kmn", sr, sr) + jnp.einsum("mfk,nfk->kmn", si, si)
    ) / nframes
    ri = (
        jnp.einsum("mfk,nfk->kmn", si, sr) - jnp.einsum("mfk,nfk->kmn", sr, si)
    ) / nframes
    # per-bin steering, frequency-scaled: phase_m(k) = -2*pi*(k/nfft)*
    # spacing_samples*m*sin(theta)  -> planar (Kb, 2M, A) embedded columns
    angles = scan_angles(cfg)
    marr = np.arange(m, dtype=np.float64)[:, None]
    sin_t = np.sin(np.deg2rad(angles))[None, :]
    av = np.empty((sel.size, 2 * m, angles.size), np.float32)
    for i, k in enumerate(sel):
        phase = -2.0 * np.pi * (k / nfft) * spacing_samples * marr * sin_t
        av[i, :m] = np.cos(phase)
        av[i, m:] = np.sin(phase)
    avj = jnp.asarray(av)

    def one_bin(rrk, rik, avk):
        c = _embed(rrk, rik)
        _, vecs = jnp.linalg.eigh(c)
        en = vecs[:, : 2 * (m - n_sources)]
        g = en.T @ avk
        return m / jnp.sum(g * g, axis=0)

    spec = jax.vmap(one_bin)(rr, ri, avj)  # (Kb, A)
    return jnp.mean(spec, axis=0)


def estimate_doa_wideband(
    cfg: ArrayConfig,
    x,
    *,
    n_sources: int,
    spacing_samples: float,
    **kw,
) -> np.ndarray:
    """Wideband chain: STFT-MUSIC spectrum -> host top-K peak pick."""
    spec = wideband_music_spectrum(
        cfg, x, n_sources=n_sources, spacing_samples=spacing_samples, **kw
    )
    return _pick_peaks(scan_angles(cfg), np.asarray(spec), n_sources)


def spectrum_batch(
    cfg: ArrayConfig,
    xi,
    xq,
    *,
    method: str = "music",
    n_sources: int = 1,
    mesh=None,
):
    """Batch of snapshot blocks -> (batch, n_grid) spectra — the family's
    dp story, same shape as radar.detect_batch: with ``mesh`` the batch
    rides the channel mesh axis and each device scans its blocks
    independently (no collectives)."""
    xi = jnp.asarray(xi)
    xq = jnp.asarray(xq)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.mesh import CHANNEL_AXIS

        sharding = NamedSharding(mesh, PartitionSpec(CHANNEL_AXIS))
        xi = jax.device_put(xi, sharding)
        xq = jax.device_put(xq, sharding)
    ai, aq = steering(cfg, scan_angles(cfg))

    def one(a, b):
        rr, ri = sample_covariance(a, b)
        if method == "bartlett":
            return bartlett_spectrum(rr, ri, ai, aq)
        if method == "mvdr":
            return mvdr_spectrum(rr, ri, ai, aq, loading=cfg.diagonal_loading)
        if method == "music":
            return music_spectrum(rr, ri, ai, aq, n_sources=n_sources)
        raise ValueError(f"unknown method {method!r}")

    return jax.vmap(one)(xi, xq)
