"""Adaptive FIR (system identification / equalization) — the trainable model.

The framework's gradient path: learn FIR taps theta minimizing
``mean((fir(x, theta) - d)^2)`` — classic block-LMS, spelled as jax.grad +
optax so the same code runs single-chip or sharded. The sharded train step
shards independent streams over the mesh ``ch`` axis (data parallel) and
time over ``t`` (sequence parallel); gradients are combined with ``psum``
over both axes — exactly the collective layout a production training
step uses, applied to DSP.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..parallel.mesh import CHANNEL_AXIS, TIME_AXIS


@dataclasses.dataclass
class AdaptiveFir:
    """Learnable causal FIR taps + optimizer state."""

    taps: jax.Array
    opt_state: optax.OptState
    tx: optax.GradientTransformation

    @staticmethod
    def create(num_taps: int, learning_rate: float = 1e-2) -> "AdaptiveFir":
        taps = jnp.zeros((num_taps,), jnp.float32)
        tx = optax.adam(learning_rate)
        return AdaptiveFir(taps=taps, opt_state=tx.init(taps), tx=tx)


def _fir_batched(x: jax.Array, taps: jax.Array) -> jax.Array:
    """Causal FIR of (streams, time) via conv (grad-friendly spelling)."""
    k = taps.shape[0]
    lhs = x[:, None, :]
    rhs = taps[::-1][None, None, :]
    return jax.lax.conv_general_dilated(
        lhs, rhs, (1,), ((k - 1, 0),), dimension_numbers=("NCW", "OIW", "NCW")
    )[:, 0, :]


def lms_loss(taps: jax.Array, x: jax.Array, d: jax.Array) -> jax.Array:
    y = _fir_batched(x, taps)
    return jnp.mean((y - d) ** 2)


def _lms_step_body(taps, opt_state, x, d, tx):
    """The single source of truth for the update rule: the sharded trainer
    wraps this same body, so loss/optimizer changes can never diverge
    between the single-chip and sharded paths."""
    loss, grads = jax.value_and_grad(lms_loss)(taps, x, d)
    updates, opt_state = tx.update(grads, opt_state, taps)
    return optax.apply_updates(taps, updates), opt_state, loss


@functools.partial(jax.jit, static_argnames=("tx",), donate_argnums=(0, 1))
def lms_train_step(taps, opt_state, x, d, *, tx):
    """One block-LMS step on (streams, time) float32 batches."""
    return _lms_step_body(taps, opt_state, x, d, tx)


def make_sharded_train_step(mesh, tx: optax.GradientTransformation):
    """Train step with (dp=streams over ch, sp=time over t) sharding.

    Parameters are replicated; batch is sharded (ch, t); XLA inserts the
    conv halo exchange on the time axis, and the loss/grad reduction becomes
    a psum over both mesh axes. Returns a jitted (taps, opt_state, x, d) ->
    (taps, opt_state, loss) function.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    replicated = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))

    @functools.partial(
        jax.jit,
        in_shardings=(replicated, replicated, batch_sh, batch_sh),
        out_shardings=(replicated, replicated, replicated),
    )
    def step(taps, opt_state, x, d):
        return _lms_step_body(taps, opt_state, x, d, tx)

    return step


def identify_system(
    true_taps: np.ndarray,
    *,
    num_taps: int | None = None,
    steps: int = 200,
    batch: tuple[int, int] = (8, 4096),
    lr: float = 5e-2,
    seed: int = 0,
    train_step=None,
    tx: optax.GradientTransformation | None = None,
) -> tuple[np.ndarray, float]:
    """Fit taps to match an unknown FIR from input/output pairs (test driver)."""
    rng = np.random.default_rng(seed)
    k = num_taps or true_taps.shape[0]
    tx = tx or optax.adam(lr)
    taps = jnp.zeros((k,), jnp.float32)
    opt_state = tx.init(taps)
    ht = jnp.asarray(true_taps, jnp.float32)
    loss = np.inf
    for _ in range(steps):
        x = jnp.asarray(rng.normal(size=batch), jnp.float32)
        d = _fir_batched(x, ht)
        if train_step is not None:
            taps, opt_state, loss = train_step(taps, opt_state, x, d)
        else:
            taps, opt_state, loss = lms_train_step(taps, opt_state, x, d, tx=tx)
    return np.asarray(taps), float(loss)


# --- frequency-tracking notch (round 3) ----------------------------------------
#
# Classic adaptive-notch-filter demos adapt per sample (an LMS loop on the
# notch frequency), which is irreducibly sequential. The parallel
# spelling is BLOCK-adaptive: estimate the interferer frequency per frame
# (windowed DFT peak with parabolic interpolation — all batched matmuls),
# design the per-frame notch rows in-graph, and run them through the
# time-varying SOS scan (ops.iir.sosfilt_tv_frames). Tracking latency is
# one frame instead of one sample; rejection depth matches the per-sample
# loop once locked.


def estimate_tone_frequency(
    x: jax.Array, frame_len: int, *, nfft: int | None = None
) -> jax.Array:
    """Per-frame dominant-tone frequency in Nyquist units, ``(..., F)``.

    Hann-windowed rfft magnitude peak, refined by parabolic interpolation
    on log-magnitude (sub-bin accuracy ~1e-3 of a bin for clean tones).
    """
    from ..ops import fft as _fft
    from ..utils.layout import overlapping_frames

    if nfft is None:
        nfft = frame_len
    n = x.shape[-1]
    nframes = max(0, n // frame_len)
    fr = overlapping_frames(
        jnp.asarray(x, jnp.float32), nframes, frame_len, frame_len
    )
    w = jnp.asarray(_fft.spectral_window("hann", frame_len))
    spec = jnp.abs(_fft.rfft(fr * w, n=nfft, axis=-1))
    # exclude DC and Nyquist from the peak search
    interior = spec[..., 1:-1]
    k = jnp.argmax(interior, axis=-1) + 1
    logm = jnp.log(jnp.maximum(spec, 1e-20))
    km1 = jnp.take_along_axis(logm, (k - 1)[..., None], -1)[..., 0]
    k0 = jnp.take_along_axis(logm, k[..., None], -1)[..., 0]
    kp1 = jnp.take_along_axis(logm, (k + 1)[..., None], -1)[..., 0]
    denom = km1 - 2.0 * k0 + kp1
    delta = jnp.where(
        jnp.abs(denom) > 1e-12, 0.5 * (km1 - kp1) / denom, 0.0
    )
    delta = jnp.clip(delta, -0.5, 0.5)
    return (k.astype(jnp.float32) + delta) * (2.0 / nfft)


def notch_rows(w0: jax.Array, q: float) -> jax.Array:
    """In-graph iirnotch: per-frame scipy-layout rows ``(..., 6)`` for a
    -3 dB bandwidth ``w0/q`` notch (traced twin of
    ``ops.iir_design.iirnotch``, which needs Python floats)."""
    om = jnp.pi * jnp.asarray(w0, jnp.float32)
    gain = 1.0 / (1.0 + jnp.tan(om / (2.0 * q)))
    c = jnp.cos(om)
    one = jnp.ones_like(gain)
    return jnp.stack(
        [gain, -2.0 * gain * c, gain, one, -2.0 * gain * c, 2.0 * gain - 1.0],
        -1,
    )


def tracking_notch(
    x: jax.Array, frame_len: int, *, q: float = 30.0
) -> tuple[jax.Array, jax.Array]:
    """Remove a frequency-wandering narrowband interferer.

    Estimates the dominant tone per ``frame_len`` block and applies a
    per-frame notch through the time-varying SOS kernel. Returns
    ``(cleaned, freqs)`` with ``freqs`` the per-frame estimates in
    Nyquist units. The tail past the last whole frame is filtered with
    the final frame's notch.
    """
    from ..ops import iir as _iir

    n = x.shape[-1]
    nf = n // frame_len
    if nf == 0:
        raise ValueError(f"signal shorter than one frame ({n} < {frame_len})")
    w0 = estimate_tone_frequency(x[..., : nf * frame_len], frame_len)
    rows = notch_rows(w0, q)  # (..., F, 6)
    # sosfilt_tv wants a leading section axis; cover a ragged tail by
    # repeating the last frame's row
    pad_frames = -(-n // frame_len) - nf
    if pad_frames:
        rows = jnp.concatenate(
            [rows, jnp.repeat(rows[..., -1:, :], pad_frames, axis=-2)], -2
        )
    y = _iir.sosfilt_tv_frames(rows[None], x, frame_len)
    return y, w0


# --- sample-recursive adaptive filters (round 3) -------------------------------
#
# The block-LMS trainer above is the parallel spelling (gradients
# over long blocks, batched streams). The classic SAMPLE-recursive
# algorithms below exist for the workloads that need per-sample tracking
# (echo cancellation, channel equalization with fast fading): the
# recursion is irreducibly sequential, so the answer is lax.scan with
# the BATCH of independent streams vectorized — lanes stay full even
# though time is serial. State is tiny (taps + (for RLS) a p x p inverse
# correlation), so everything stays on chip across the scan.


@functools.partial(jax.jit, static_argnames=("num_taps",))
def nlms(
    x: jax.Array,
    d: jax.Array,
    num_taps: int,
    *,
    step: float = 0.5,
    eps: float = 1e-6,
):
    """Normalized LMS: ``w += step * e * u / (eps + |u|^2)`` per sample.

    ``x``/``d``: (..., n) input and desired streams (leading axes are
    independent filters, vectorized through the scan). Returns
    ``(y, e, w)``: filter output, error stream, final taps (..., p).
    """
    xb = jnp.atleast_2d(jnp.asarray(x, jnp.float32))
    db = jnp.atleast_2d(jnp.asarray(d, jnp.float32))
    b, n = xb.shape
    w0 = jnp.zeros((b, num_taps), jnp.float32)
    u0 = jnp.zeros((b, num_taps), jnp.float32)

    def sample(carry, inp):
        w, u = carry
        xt, dt = inp
        u = jnp.concatenate([xt[:, None], u[:, :-1]], axis=1)
        y = jnp.sum(w * u, axis=1)
        e = dt - y
        norm = eps + jnp.sum(u * u, axis=1)
        w = w + step * (e / norm)[:, None] * u
        return (w, u), (y, e)

    (w, _), (ys, es) = jax.lax.scan(
        sample, (w0, u0), (xb.T, db.T)
    )
    y = ys.T.reshape(jnp.shape(x))
    e = es.T.reshape(jnp.shape(x))
    w = w if jnp.ndim(x) > 1 else w[0]
    return y, e, w


@functools.partial(jax.jit, static_argnames=("num_taps",))
def rls(
    x: jax.Array,
    d: jax.Array,
    num_taps: int,
    *,
    forget: float = 0.99,
    delta: float = 1e2,
):
    """Recursive least squares with exponential forgetting.

    Textbook P-matrix recursion (``P0 = delta * I``), batched over the
    leading axes; the per-sample P update is a rank-1 correction — a
    (p, p) outer product per stream per step, which the VPU vectorizes
    across the batch. Converges in ~2p samples where LMS needs hundreds.
    Returns ``(y, e, w)``.
    """
    xb = jnp.atleast_2d(jnp.asarray(x, jnp.float32))
    db = jnp.atleast_2d(jnp.asarray(d, jnp.float32))
    b, n = xb.shape
    w0 = jnp.zeros((b, num_taps), jnp.float32)
    u0 = jnp.zeros((b, num_taps), jnp.float32)
    p0 = jnp.broadcast_to(
        delta * jnp.eye(num_taps, dtype=jnp.float32), (b, num_taps, num_taps)
    )

    def sample(carry, inp):
        w, u, P = carry
        xt, dt = inp
        u = jnp.concatenate([xt[:, None], u[:, :-1]], axis=1)
        pu = jnp.einsum("bij,bj->bi", P, u)
        denom = forget + jnp.einsum("bi,bi->b", u, pu)
        k = pu / denom[:, None]
        y = jnp.sum(w * u, axis=1)
        e = dt - y
        w = w + k * e[:, None]
        P = (P - jnp.einsum("bi,bj->bij", k, pu)) / forget
        # float32 RLS diverges on long runs as P drifts asymmetric;
        # re-symmetrizing each step is the standard stabilization
        P = 0.5 * (P + jnp.swapaxes(P, -1, -2))
        return (w, u, P), (y, e)

    (w, _, _), (ys, es) = jax.lax.scan(sample, (w0, u0, p0), (xb.T, db.T))
    y = ys.T.reshape(jnp.shape(x))
    e = es.T.reshape(jnp.shape(x))
    w = w if jnp.ndim(x) > 1 else w[0]
    return y, e, w
