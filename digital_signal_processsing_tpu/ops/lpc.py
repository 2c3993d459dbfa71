"""Linear-predictive coding, frame-parallel on device.

Analysis (autocorrelation method + Levinson-Durbin) and synthesis (the
time-varying all-pole vocoder filter) for speech/audio codecs. The
reference CUDA study has no LPC analog; this rides the round-3
time-varying filtering surface (``ops.iir.sosfilt_tv``) and exists so a
user gets the classic frame-wise LPC pipeline without leaving the device.

Design notes:

- **Levinson-Durbin without gathers**: the order-``m`` step needs the
  reversed prefixes ``r[m-i]`` / ``a[m-i]``; rather than per-sample
  gathers, the flip is an einsum against a precomputed
  one-hot ``(p, p+1, p+1)`` constant — each recursion step is two tiny
  matvecs, batched over all frames at once in one ``lax.scan`` over order.
- **Frame-parallel synthesis**: an all-pole filter is sequential along
  time, but within a frame the coefficients are constant, so the run
  decomposes exactly into (1) a zero-initial-state pass over all frames
  SIMULTANEOUSLY (one ``lax.scan`` of ``frame_len`` steps, frames in the
  batch dims), which also emits the zero-input basis responses
  ``w_t = e0^T A^{t+1}``, (2) an O(log frame_len) repeated-squaring
  computation of each frame's state-transition matrix ``A^L`` and a
  log-depth ``associative_scan`` over frames for the true frame-entry
  states, and (3) one einsum superposing the zero-input correction.
  Wall-clock is ONE frame's recursion regardless of signal length.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _flip_onehots(p: int) -> np.ndarray:
    """flip[m-1] maps v (p+1,) -> u with u[i] = v[m-i] for 0 <= i <= m."""
    f = np.zeros((p, p + 1, p + 1), np.float32)
    for m in range(1, p + 1):
        for i in range(m + 1):
            f[m - 1, i, m - i] = 1.0
    return f


@functools.partial(jax.jit, static_argnames=())
def levinson(r: jax.Array):
    """Batched Levinson-Durbin: Toeplitz autocorrelation -> AR coefficients.

    ``r``: ``(..., p+1)`` autocorrelation lags (lag 0 first).
    Returns ``(a, k, err)``: prediction polynomial ``(..., p+1)`` with
    ``a[..., 0] == 1`` (so ``A(z) = 1 + a1 z^-1 + ...``), reflection
    coefficients ``(..., p)``, and the final prediction-error power
    ``(...,)``. Matches ``scipy.linalg.solve_toeplitz`` /
    ``librosa.lpc`` conventions: the synthesis filter is ``1/A(z)``.
    """
    r = jnp.asarray(r, jnp.float32)
    p = r.shape[-1] - 1
    batch = r.shape[:-1]
    flips = jnp.asarray(_flip_onehots(p))
    a0 = jnp.zeros(batch + (p + 1,), jnp.float32).at[..., 0].set(1.0)
    err0 = r[..., 0]

    def step(carry, fm):
        a, err = carry
        rrev = jnp.einsum("ij,...j->...i", fm, r)
        # acc = r[m] + sum_{i=1}^{m-1} a[i] r[m-i]  (a[i]=0 for i >= m)
        acc = jnp.sum(a * rrev, -1)
        k = -acc / jnp.where(err > 0, err, 1.0)
        k = jnp.where(err > 0, k, 0.0)
        arev = jnp.einsum("ij,...j->...i", fm, a)
        a = a + k[..., None] * arev
        err = err * (1.0 - k * k)
        return (a, err), k

    (a, err), ks = jax.lax.scan(step, (a0, err0), flips)
    return a, jnp.moveaxis(ks, 0, -1), err


def frame_autocorr(
    x: jax.Array,
    order: int,
    frame_len: int,
    *,
    hop: int | None = None,
    window: str = "hamming",
) -> jax.Array:
    """Windowed per-frame autocorrelation lags ``(..., F, order+1)``.

    Frame ``f`` covers ``x[..., f*hop : f*hop + frame_len]`` (standard
    short-time analysis; ``hop`` defaults to ``frame_len``).
    """
    from ..utils.layout import overlapping_frames
    from .fft import spectral_window

    if hop is None:
        hop = frame_len
    n = x.shape[-1]
    nframes = max(0, (n - frame_len) // hop + 1)
    fr = overlapping_frames(
        jnp.asarray(x, jnp.float32), nframes, hop, frame_len
    )
    if window is not None:
        fr = fr * jnp.asarray(spectral_window(window, frame_len))
    lags = [jnp.sum(fr * fr, -1)]
    for k in range(1, order + 1):
        lags.append(jnp.sum(fr[..., : frame_len - k] * fr[..., k:], -1))
    return jnp.stack(lags, -1)


def lpc(
    x: jax.Array,
    order: int,
    frame_len: int,
    *,
    hop: int | None = None,
    window: str = "hamming",
) -> tuple[jax.Array, jax.Array]:
    """Frame-wise LPC analysis: ``(a, gain)``.

    ``a``: ``(..., F, order+1)`` prediction polynomials (``a[...,0]=1``),
    ``gain``: ``(..., F)`` = sqrt(residual power), so white excitation of
    unit power through ``gain / A(z)`` reproduces each frame's spectrum.
    """
    r = frame_autocorr(x, order, frame_len, hop=hop, window=window)
    a, _, err = levinson(r)
    return a, jnp.sqrt(jnp.maximum(err, 0.0))


def _companion(a: jax.Array) -> jax.Array:
    """(..., p+1) polynomial -> (..., p, p) companion transition matrix."""
    p = a.shape[-1] - 1
    below = jnp.broadcast_to(
        jnp.eye(p, p, -1, dtype=a.dtype), a.shape[:-1] + (p, p)
    )
    return below.at[..., 0, :].set(-a[..., 1:])


def _matrix_power(m: jax.Array, n: int) -> jax.Array:
    """Batched m^n by square-and-multiply (n static)."""
    p = m.shape[-1]
    acc = jnp.broadcast_to(jnp.eye(p, dtype=m.dtype), m.shape)
    while n:
        if n & 1:
            acc = acc @ m
        n >>= 1
        if n:
            m = m @ m
    return acc


def lpc_synthesis(
    a: jax.Array,
    gain: jax.Array,
    excitation: jax.Array,
    frame_len: int,
    *,
    method: str = "auto",
) -> jax.Array:
    """Time-varying all-pole synthesis ``y = gain * e / A(z)`` with
    frame-wise coefficients and state carry-over between frames — exact
    up to f32 association for damped polynomials (the ACCURACY ENVELOPE
    below bounds every engine, including ``auto``, near the unit circle).

    ``a``: ``(..., F, p+1)``; ``gain``: ``(..., F)``;
    ``excitation``: ``(..., F*frame_len)``. Returns ``(..., F*frame_len)``.
    Identical (up to float32 association) to running the sequential
    recurrence ``y[t] = g_f e[t] - sum_i a_f[i] y[t-i]`` sample by sample.

    ``method``: ``"refine"`` = :func:`lpc_synthesis_refine` (state passing
    through the actual recurrence — the most accurate for damped
    polynomials); ``"scan"`` = the lax.scan + zero-input-basis spelling
    with the affine compose for entry states (``p`` floats per sample of
    basis traffic); ``"factored"`` = :func:`lpc_synthesis_factored` (host
    root factoring -> biquad cascade — the near-unit-circle engine; see
    its transition contract); ``"auto"`` = factored for concrete
    frame-CONSTANT sets with max pole radius >= 0.95, else refine.

    ACCURACY ENVELOPE: the frame-entry states of the ``scan`` spelling
    ride an f32 affine compose whose A^L products
    are ill-conditioned for strongly resonant polynomials — relative
    error grows from ~1e-6 at pole radius 0.8 to O(1) by radius ~0.95
    (order 12, frame 64) and overflows near the circle. LPC polynomials
    from :func:`levinson` on real signals sit well inside the envelope
    (codec practice adds bandwidth expansion precisely to keep them
    there), and ``method="refine"`` is more accurate for that damped
    case. For poles hugging the unit circle the
    direct-form frame-parallel spellings all degrade —
    ``method="factored"`` is the engine for that regime (round 5):
    measured 2e-6 -> 6e-5 rel err at radius 0.95 -> 0.999 where refine
    reads 3e-3 -> 0.56 (tests/test_lpc.py::test_factored_resonant_sweep),
    with the cascade transition contract documented on
    :func:`lpc_synthesis_factored`.
    """
    if method not in ("auto", "scan", "refine", "factored"):
        raise ValueError(f"unknown method {method!r}")
    if method == "factored":
        return lpc_synthesis_factored(a, gain, excitation, frame_len)
    if method == "auto" and not isinstance(a, jax.core.Tracer):
        # round-5: concrete FRAME-CONSTANT coefficient sets get an exact
        # host radius check (one factoring); resonant ones route to the
        # factored-sections engine — the regime where every f32
        # frame-parallel spelling of the order-p recurrence degrades
        # (ACCURACY ENVELOPE below), and where cascade-state carry equals
        # the direct form exactly (constant coefficients). Frame-VARYING
        # resonant sets are NOT silently re-routed: the cascade's state
        # carry is a different realization at coefficient jumps (measured
        # 0.76 rel err on random per-frame polynomials) — pick
        # method='factored' explicitly if its transition contract fits.
        # Traced coefficients (this wrapper is NOT jitted precisely so
        # eager callers stay concrete) keep refine + the envelope.
        a_np = np.asarray(a)
        row = _constant_frame_row(a_np)
        if row is not None and lpc_to_sections(row)[1] >= 0.95:
            from ..utils.dispatch import record_choice

            record_choice("lpc_synthesis", "factored")
            return lpc_synthesis_factored(a, gain, excitation, frame_len)
    return _lpc_synthesis_core(a, gain, excitation, frame_len, method=method)


@functools.partial(jax.jit, static_argnames=("frame_len", "method"))
def _lpc_synthesis_core(
    a: jax.Array,
    gain: jax.Array,
    excitation: jax.Array,
    frame_len: int,
    *,
    method: str,
) -> jax.Array:
    if method in ("auto", "refine"):
        # auto rides refine: for every polynomial the compose handles
        # accurately (the damped envelope above) refine matches or beats
        # it, and it cannot overflow where the compose does. Explicit
        # method="scan" keeps the compose spelling as the anchor.
        return lpc_synthesis_refine(a, gain, excitation, frame_len)
    a = jnp.asarray(a, jnp.float32)
    p = a.shape[-1] - 1
    batch = a.shape[:-2]
    nf = a.shape[-2]
    L = frame_len
    e = jnp.asarray(excitation, jnp.float32).reshape(batch + (nf, L))
    e = e * jnp.asarray(gain, jnp.float32)[..., None]

    A = _companion(a)  # (..., F, p, p)
    w0 = -a[..., 1:]  # e0^T A

    def step(carry, et):
        s, w = carry  # states (..., F, p), basis rows (..., F, p)
        y = et - jnp.einsum("...i,...i->...", a[..., 1:], s)
        s = jnp.concatenate([y[..., None], s[..., :-1]], -1)
        wout = w
        w = jnp.einsum("...i,...ij->...j", w, A)
        return (s, w), (y, wout)

    zeros = jnp.zeros(batch + (nf, p), jnp.float32)
    (s_end, _), (y0, W) = jax.lax.scan(
        step, (zeros, w0), jnp.moveaxis(e, -1, 0)
    )
    # y0/W lead with the time-step axis: (L, ..., F[, p])

    # Frame-entry states: affine recurrence s0[f] = M[f-1] s0[f-1] + z[f-1]
    # with M = A^L, z = the zero-state end state; log-depth over frames.
    M = _matrix_power(A, L)
    z = s_end  # (..., F, p)

    def compose(left, right):
        m1, z1 = left
        m2, z2 = right
        return m2 @ m1, jnp.einsum("...ij,...j->...i", m2, z1) + z2

    Mi, zi = jax.lax.associative_scan(compose, (M, z), axis=len(batch))
    del Mi
    # exclusive shift: frame 0 starts at rest
    s0 = jnp.concatenate(
        [jnp.zeros_like(zi[..., :1, :]), zi[..., :-1, :]], axis=-2
    )
    y = y0 + jnp.einsum("t...fp,...fp->t...f", W, s0)
    return jnp.moveaxis(y, 0, -1).reshape(batch + (nf * L,))


def _lpc_synth_pass(a1: jax.Array, s0: jax.Array, e: jax.Array):
    """One seeded synthesis sweep over every frame at once.

    ``a1``: ``(N, p)`` feedback coefficients, ``s0``: ``(N, p)`` entry
    states (newest output first), ``e``: ``(N, L)`` scaled excitation.
    Returns ``(y (N, L), end state (N, p))``. A ``lax.scan`` over the
    ``L`` steps with frames in the batch: each step is p multiply-subtracts
    (in the order of the sequential recurrence) plus a p-register shift,
    the data-dependent minimum for a dense feedback polynomial — no basis
    tensor, no per-step matrix work.
    """
    p = a1.shape[-1]

    def step(s, et):
        acc = et
        for j in range(p):
            acc = acc - a1[:, j] * s[:, j]
        return jnp.concatenate([acc[:, None], s[:, :-1]], -1), acc

    z, y = jax.lax.scan(step, s0, e.T)
    return y.T, z


@functools.partial(jax.jit, static_argnames=("frame_len", "sweeps"))
def lpc_synthesis_refine(
    a: jax.Array,
    gain: jax.Array,
    excitation: jax.Array,
    frame_len: int,
    *,
    sweeps: int = 2,
) -> jax.Array:
    """All-pole synthesis by zero-entry + ``sweeps`` refinement passes.

    Skips the affine compose entirely: pass 0 runs every frame from rest;
    each further sweep re-seeds frame ``f`` with frame ``f-1``'s actual
    end state and re-runs. Per sweep, entry-state errors contract by the
    frame's zero-input decay (~|pole|_max^frame_len) and exact entries
    propagate one frame forward — so for the DAMPED polynomials LPC
    analysis of real signals produces (poles well inside the circle, the
    codec-practice envelope), two sweeps reach the sequential-f32 floor
    and this path is far more accurate than the compose (see
    lpc_synthesis notes on the compose's f32 conditioning), with no
    batched (p, p) matrix work at all. NOT suitable for poles hugging the
    unit circle: |pole|^frame_len ~ 1 means errors stop contracting and
    correctness would need ~F sweeps.
    """
    a = jnp.asarray(a, jnp.float32)
    p = a.shape[-1] - 1
    batch = a.shape[:-2]
    nf = a.shape[-2]
    L = frame_len
    e = jnp.asarray(excitation, jnp.float32).reshape(batch + (nf, L))
    e = e * jnp.asarray(gain, jnp.float32)[..., None]
    ft = int(np.prod(batch, dtype=np.int64)) * nf if batch else nf
    # Frames padded to a multiple of 128 rows: every frame then sits in
    # the vectorized body of the compiled step, so its result does not
    # depend on how many frames share the call (a sharded run matches the
    # unsharded one bit for bit).
    fpad = -(-ft // 128) * 128

    def rows(v, k):
        return jnp.pad(v.reshape(ft, k), ((0, fpad - ft), (0, 0)))

    a1 = rows(a[..., 1:], p)
    e = rows(e, L)
    s0 = jnp.zeros((fpad, p), jnp.float32)
    for sweep in range(sweeps + 1):
        y, z = _lpc_synth_pass(a1, s0, e)
        if sweep == sweeps:
            break  # the last sweep's outputs are final; no re-seed needed
        # entry of frame f <- end of frame f-1, zero at each stream's head
        z = z[:ft].reshape(batch + (nf, p))
        s0 = rows(
            jnp.concatenate(
                [jnp.zeros_like(z[..., :1, :]), z[..., :-1, :]], axis=-2
            ),
            p,
        )
    return y[:ft].reshape(batch + (nf * L,))


def lpc_synthesis_ref(a, gain, excitation, frame_len):
    """Sequential float64 golden model of :func:`lpc_synthesis` (test/CPU)."""
    a = np.asarray(a, np.float64)
    g = np.asarray(gain, np.float64)
    e = np.asarray(excitation, np.float64)
    p = a.shape[-1] - 1
    nf = a.shape[-2]
    y = np.zeros(nf * frame_len)
    hist = np.zeros(p)
    for f in range(nf):
        for t in range(frame_len):
            idx = f * frame_len + t
            v = g[f] * e[idx] - np.dot(a[f, 1:], hist)
            hist = np.concatenate([[v], hist[:-1]])
            y[idx] = v
    return y


def _constant_frame_row(a: np.ndarray) -> np.ndarray | None:
    """``(..., F, p+1)`` -> the shared ``(..., 1, p+1)`` row if every frame
    carries the same coefficients, else None. The auto router only
    re-routes frame-CONSTANT resonant sets to the factored engine, where
    the cascade-state carry is exactly the direct form (a Frobenius
    power-bound radius estimate was tried and rejected: it overestimated
    0.85-radius order-8 sets past 0.95 — non-normal companion growth)."""
    row = a[..., :1, :]
    return row if bool(np.all(a == row)) else None


def lpc_to_sections(a: np.ndarray) -> tuple[np.ndarray, float]:
    """Host-side root factoring: AR polynomials -> biquad cascade rows.

    ``a``: ``(..., F, p+1)`` real, concrete (numpy-able). Returns
    ``(sos, max_radius)`` with ``sos`` of shape ``(S, ..., F, 6)`` in
    scipy layout (all-pole: b = [1, 0, 0]), S = ceil(p/2), and
    ``max_radius`` the largest pole magnitude found (the auto router's
    conditioning signal). Factoring runs in float64 via one batched
    eigendecomposition of the companion matrices; complex roots pair with
    their conjugates into (1, -2 Re r, |r|^2) sections, real roots pair
    consecutively by magnitude, an odd leftover becomes a first-order
    section. The monic section product reconstructs A(z) exactly up to
    factoring precision.
    """
    a = np.asarray(a, np.float64)
    p = a.shape[-1] - 1
    batch = a.shape[:-1]  # (..., F)
    an = a / a[..., :1]
    # batched companion eigenvalues
    comp = np.zeros(batch + (p, p))
    comp[..., 0, :] = -an[..., 1:]
    idx = np.arange(p - 1)
    comp[..., idx + 1, idx] = 1.0
    roots = np.linalg.eigvals(comp)  # (..., F, p) complex
    n_sec = -(-p // 2)
    flat = roots.reshape(-1, p)
    sos = np.zeros((flat.shape[0], n_sec, 6))
    sos[..., 0] = 1.0  # b0
    sos[..., 3] = 1.0  # a0
    tol = 1e-9
    for i, r in enumerate(flat):
        cplx = r[np.abs(r.imag) > tol * np.maximum(1.0, np.abs(r))]
        cplx = cplx[cplx.imag > 0]
        real = np.sort(r[np.abs(r.imag) <= tol * np.maximum(1.0, np.abs(r))].real)
        s = 0
        for rt in cplx:
            sos[i, s, 4] = -2.0 * rt.real
            sos[i, s, 5] = abs(rt) ** 2
            s += 1
        j = 0
        while j + 1 < real.size:
            sos[i, s, 4] = -(real[j] + real[j + 1])
            sos[i, s, 5] = real[j] * real[j + 1]
            s += 1
            j += 2
        if j < real.size:
            sos[i, s, 4] = -real[j]
            s += 1
        assert s == n_sec or (s == n_sec - 1 and real.size == 0 and p % 2), (
            s, n_sec, r,
        )
    sos = sos.reshape(batch + (n_sec, 6))
    # (..., F, S, 6) -> (S, ..., F, 6)
    sos = np.moveaxis(sos, -2, 0)
    return sos.astype(np.float32), float(np.max(np.abs(roots)))


def lpc_synthesis_factored(
    a,
    gain: jax.Array,
    excitation: jax.Array,
    frame_len: int,
) -> jax.Array:
    """All-pole synthesis through host-factored biquad sections — the
    near-unit-circle engine (round-5 VERDICT item 7 / ROADMAP candidate 2).

    Where every f32 frame-parallel spelling of the ORDER-P recurrence
    loses accuracy as poles approach the unit circle (``lpc_synthesis``
    ACCURACY ENVELOPE: A^L products ill-conditioned; refine's sweeps stop
    contracting at |pole|^L ~ 1), each factored biquad's recurrence is
    well-conditioned individually, so the cascade tracks the sequential
    float64 model within the sequential-f32 floor even at radius 0.999
    (tests/test_lpc.py::test_factored_resonant_sweep). Runs through
    :func:`ops.iir.sosfilt_tv_frames`.

    ``a`` must be CONCRETE (host-factorable), not a jit tracer.

    TRANSITION CONTRACT: frame transitions carry the cascade's PER-SECTION
    states (the standard vocoder cascade realization). For frame-constant
    coefficients this is exactly the direct form; for coefficients that
    CHANGE across frames the two realizations differ transiently at every
    jump (measured 0.76 max rel err vs the direct-form golden on random
    independent per-frame polynomials; small for slowly-varying
    envelopes). ``auto`` therefore only routes frame-constant resonant
    sets here — choose this method explicitly if the cascade contract
    fits your varying-envelope use.
    """
    from .iir import sosfilt_tv_frames

    if isinstance(a, jax.core.Tracer):
        raise TypeError(
            "lpc_synthesis_factored factors coefficients on the host — "
            "pass concrete a (outside jit), or use method='refine'"
        )
    a_np = np.asarray(a)
    row = _constant_frame_row(a_np)
    if row is not None:
        # factor one row, broadcast across frames (free view)
        sos_row, _ = lpc_to_sections(row)
        sos = np.broadcast_to(
            sos_row, sos_row.shape[:-2] + (a_np.shape[-2], 6)
        )
    else:
        sos, _ = lpc_to_sections(a_np)
    batch = np.shape(a)[:-2]
    nf = np.shape(a)[-2]
    e = jnp.asarray(excitation, jnp.float32).reshape(batch + (nf, frame_len))
    e = (e * jnp.asarray(gain, jnp.float32)[..., None]).reshape(
        batch + (nf * frame_len,)
    )
    return sosfilt_tv_frames(jnp.asarray(sos), e, frame_len)


def lpc_vocoder(
    x: jax.Array,
    order: int,
    frame_len: int,
    excitation: jax.Array | None = None,
) -> jax.Array:
    """Analyze-resynthesize round trip: ``x``'s LPC spectral envelope
    driven by ``excitation`` (pulses or noise for vocoding; the original
    prediction residual reconstructs the input). ``excitation=None`` uses
    a fixed-seed unit-variance white noise stream.
    """
    a, gain = lpc(x, order, frame_len)
    nf = a.shape[-2]
    n = nf * frame_len
    if excitation is None:
        excitation = jax.random.normal(jax.random.PRNGKey(0), x.shape[:-1] + (n,))
    return lpc_synthesis(a, gain, excitation[..., :n], frame_len)


def ar_psd(
    x: jax.Array,
    order: int,
    *,
    nfft: int = 1024,
    frame_len: int | None = None,
    hop: int | None = None,
    window: str = "rect",
):
    """AR (maximum-entropy) one-sided PSD via Levinson-Durbin.

    Fits an order-``order`` all-pole model (autocorrelation method) and
    evaluates ``gain^2 / |A(e^{j 2 pi f})|^2`` on the ``nfft//2 + 1``-point
    one-sided grid ``f = k/nfft`` (cycles/sample). Sharper than Welch for
    strongly peaked (speech/resonant) spectra at short data lengths — the
    classic parametric counterpart to ``welch_psd``. With ``frame_len``
    the estimate is frame-wise ``(..., F, nfft//2+1)``; otherwise one
    model spans the whole signal. Evaluation is a single (F, p+1) x
    (p+1, K) planar matmul against cos/sin tables — no FFT at all.
    Returns ``(f, psd)`` like the Welch family.
    """
    n = x.shape[-1]
    fl = n if frame_len is None else frame_len
    a, gain = lpc(x, order, fl, hop=hop, window=window)
    k = np.arange(nfft // 2 + 1)
    f = k / nfft
    m = np.arange(order + 1)[:, None]
    cosb = jnp.asarray(np.cos(2 * np.pi * m * f[None, :]), jnp.float32)
    sinb = jnp.asarray(np.sin(2 * np.pi * m * f[None, :]), jnp.float32)
    ar_ = a @ cosb  # Re A(e^{j w}) with the e^{-j w m} convention
    ai_ = -(a @ sinb)
    psd = (gain[..., None] ** 2) / jnp.maximum(ar_ * ar_ + ai_ * ai_, 1e-30)
    if frame_len is None:
        psd = psd[..., 0, :]
    return jnp.asarray(f), psd
