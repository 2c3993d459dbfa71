"""Farrow arbitrary-rate resampling: cubic Lagrange fractional delay.

Beyond the integer/rational polyphase family (ops/resample.py): a receiver
chain that must lock to a non-integer channel rate (BASELINE.json
configs[4]'s "polyphase resample" north star, e.g. 44.1k -> 48k or a
Doppler-corrected irrational ratio) needs output samples at arbitrary
continuous positions t_m = m / rate of the input timeline.

Shape, three decisions:

1. **Exact integer phase arithmetic.** ``rate`` is snapped once to a
   rational ``up/down`` (``Fraction.limit_denominator(1 << 16)`` — timing
   error <= 1.2e-10 of a sample per step, i.e. < 8e-3 samples across a 64M
   stream), then every output position is the integer pair
   ``(n, mu_num) = divmod(4*up + m*down, up)``. No float phase
   accumulator, no drift, and the streaming path is bit-exact with the
   one-shot path because both run the identical integer recurrence.
2. **Pointwise Farrow evaluation, not per-phase tap tables.** Each output
   is the cubic Lagrange combination of 4 neighbors,
   ``y[m] = sum_j c_j(mu_m) * x[n_m + j - 1]`` — four monotone gathers plus
   an elementwise polynomial. A polyphase tap-table spelling needs
   ``4*up`` taps (up to 2^18 for near-irrational ratios); the pointwise
   form is rate-independent.
3. **One-shot indices are trace-time constants.** For ``resample_farrow``
   the whole index/mu schedule is host-side numpy int64 (exact, unbounded);
   only the streaming path does in-graph int32 phase arithmetic (the chunk
   length is validated against the int32 envelope).

Conventions match ops/fir.py: planar ``(channels, time)`` float32 (or
``(time,)``), output m aligned so ``y[0] = x[0]`` and ``y[m] ~ x(m/rate)``.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from .fir import _as_planar

# Denominator cap for float -> rational snapping. 2^16 keeps the worst
# timing error below 1/(2*2^32) sample/step while the streaming path's
# int32 phase arithmetic still admits ~32k-sample chunks at the cap (the
# common audio ratios reduce to tiny denominators and allow multi-M chunks).
MAX_DENOMINATOR = 1 << 16


def as_rational_rate(rate) -> tuple[int, int]:
    """(up, down) for an output/input rate ratio; floats snapped exactly once.

    Accepts a positive float/int, a ``(up, down)`` pair, or a Fraction.
    """
    if isinstance(rate, tuple):
        up, down = int(rate[0]), int(rate[1])
    elif isinstance(rate, Fraction):
        up, down = rate.numerator, rate.denominator
    else:
        if not rate > 0:
            raise ValueError(f"rate must be positive, got {rate}")
        f = Fraction(float(rate)).limit_denominator(MAX_DENOMINATOR)
        up, down = f.numerator, f.denominator
    if up < 1 or down < 1:
        raise ValueError(f"rate must be positive, got {rate!r}")
    g = np.gcd(up, down)
    return int(up // g), int(down // g)


def _lagrange4(mu: jax.Array, g0, g1, g2, g3) -> jax.Array:
    """Cubic Lagrange through nodes {-1,0,1,2} evaluated at mu in [0,1).

    g0..g3 are x[n-1], x[n], x[n+1], x[n+2]. All f32 elementwise (VPU);
    the factored node products cost 5 mults + the 4 weighted adds.
    """
    a = mu - 1.0
    b = mu - 2.0
    c = mu + 1.0
    w0 = mu * a * b * jnp.float32(-1.0 / 6.0)
    w1 = a * c * b * jnp.float32(0.5)
    w2 = mu * c * b * jnp.float32(-0.5)
    w3 = mu * c * a * jnp.float32(1.0 / 6.0)
    return w0 * g0 + w1 * g1 + w2 * g2 + w3 * g3


@jax.jit
def _farrow_gather_combine(ext, n, mu_num, inv_up):
    """Gather 4 neighbors at the scheduled indices and combine (one-shot)."""
    mu = mu_num.astype(jnp.float32) * inv_up
    g0 = jnp.take(ext, n - 1, axis=-1)
    g1 = jnp.take(ext, n, axis=-1)
    g2 = jnp.take(ext, n + 1, axis=-1)
    g3 = jnp.take(ext, n + 2, axis=-1)
    return _lagrange4(mu, g0, g1, g2, g3)


def farrow_output_len(num_samples: int, rate) -> int:
    """Output length of :func:`resample_farrow` for an input of ``num_samples``."""
    up, down = as_rational_rate(rate)
    if num_samples < 4:
        return 0
    return (num_samples - 3) * up // down + 1


# Phase-matrix (matmul) path envelope: the (down+8, up) weight matrix must
# stay a reasonable constant. 1<<22 entries = 16 MB f32 — every practical
# rational rate (audio standards, chain locking) is far below this; only
# near-irrational snaps with ~2^16 numerator AND denominator exceed it.
MATMUL_MAX_PRODUCT = 1 << 22


def resample_farrow(x: jax.Array, rate, *, method: str = "auto") -> jax.Array:
    """Arbitrary-rate resample via cubic Lagrange (Farrow) interpolation.

    ``rate`` = output rate / input rate (float, Fraction, or (up, down)).
    ``y[m]`` interpolates the input at position ``m / rate`` (so
    ``y[0] == x[0]``); the last outputs stop where the 4-tap stencil runs
    out of input. Zero left-halo like every causal op here
    (gpu_utils.h:112-114's zeroed prefix): positions before x[1] blend with
    zeros via the stencil's x[n-1] tap — only y[0] is affected, and only
    when upsampling (outputs at t < 1 blend with the zero halo).

    ``method``:
    - ``matmul`` (auto default when ``up*down <= MATMUL_MAX_PRODUCT``):
      gather-free matmul spelling — input frames of ``down`` samples
      (+4-tap spill) against a banded (down+8, up) matrix holding the
      per-phase Lagrange weights; one matmul produces ``up`` outputs per
      frame.
    - ``gather`` (auto default beyond the matrix envelope): the pointwise
      spelling (any rate, exact schedule). Production arbitrary rates
      should snap within it: ``as_rational_rate(rate)`` with a smaller
      denominator changes the rate by < 1e-7 relative.

    NOTE anti-aliasing: like any pure interpolator, decimating by more than
    ~2x needs a lowpass first (compose with ops/resample.decimate or
    fir_filter); for moderate ratios the cubic kernel's own rolloff is the
    standard Farrow trade.
    """
    up, down = as_rational_rate(rate)
    xp, squeeze = _as_planar(x)
    t = xp.shape[-1]
    m_out = farrow_output_len(t, (up, down))
    if m_out <= 0:
        raise ValueError(
            f"input too short to resample: {t} samples at rate {up}/{down}"
        )
    if method == "auto":
        # beyond the periodic-matrix envelope the exact schedule runs
        # through the pointwise gather
        method = "matmul" if up * down <= MATMUL_MAX_PRODUCT else "gather"
    from ..utils.dispatch import record_choice

    record_choice("resample_farrow", method)
    if method == "matmul":
        y = _farrow_matmul(xp, up, down, m_out)
    elif method == "gather":
        # exact host-side schedule (numpy int64): ext position
        # q = 4*up + m*down, taps ext[q-1 .. q+2], ext = [0,0,0,0, x...]
        num = 4 * up + np.arange(m_out, dtype=np.int64) * down
        n_idx = (num // up).astype(np.int32)
        mu_num = (num % up).astype(np.int32)
        ext = jnp.pad(xp.astype(jnp.float32), ((0, 0), (4, 0)))
        y = _farrow_gather_combine(ext, n_idx, mu_num, jnp.float32(1.0 / up))
    else:
        raise ValueError(
            f"unknown method {method!r}; options ('auto', 'matmul', 'gather')"
        )
    return y[0] if squeeze else y


def _phase_matrix(up: int, down: int) -> np.ndarray:
    """(down+8, up) float32: K[c, r] = Lagrange weight of frame column c for
    output phase r.

    Output m = a*up + r sits at ext position num = 4*up + m*down, i.e.
    frame a's column c = 4 + (r*down)//up + (j-1) carries tap j with weight
    c_j(mu_r), mu_r = (r*down mod up)/up. Columns span [3, down+7).
    """
    k = np.zeros((down + 8, up), np.float64)
    r = np.arange(up, dtype=np.int64)
    base = 4 + (r * down) // up
    mu = ((r * down) % up).astype(np.float64) / up
    w = [
        -mu * (mu - 1) * (mu - 2) / 6,
        (mu - 1) * (mu + 1) * (mu - 2) / 2,
        -mu * (mu + 1) * (mu - 2) / 2,
        mu * (mu + 1) * (mu - 1) / 6,
    ]
    for j in range(4):
        k[base + (j - 1), r] = w[j]
    return k.astype(np.float32)


def _farrow_matmul(xp: jax.Array, up: int, down: int, m_out: int) -> jax.Array:
    from ..utils.layout import overlapping_frames

    n_frames = -(-m_out // up)
    # ext = 4-zero halo + signal + tail pad covering the last frame's spill;
    # padded columns only feed outputs >= m_out (sliced off below)
    need = n_frames * down + 8
    ext = jnp.pad(xp.astype(jnp.float32), ((0, 0), (4, 0)))
    if ext.shape[-1] < need:
        ext = jnp.pad(ext, ((0, 0), (0, need - ext.shape[-1])))
    frames = overlapping_frames(ext, n_frames, down, down + 8)
    k = jnp.asarray(_phase_matrix(up, down))
    y = jnp.einsum(
        "cfd,dr->cfr", frames, k, precision=jax.lax.Precision.HIGHEST
    )
    return y.reshape(xp.shape[0], n_frames * up)[:, :m_out]


# --- streaming ---------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FarrowState:
    """Carry for streaming Farrow resampling.

    ``tail``: last 4 raw input samples per channel (the stencil halo).
    ``phase_num``: integer numerator of the next output position relative
    to the current ext origin (ext = tail ++ chunk), in 1/up units.
    """

    tail: jax.Array  # (channels, 4) float32
    phase_num: jax.Array  # () int32


def farrow_init(rate, channels: int = 1) -> FarrowState:
    up, _ = as_rational_rate(rate)
    return FarrowState(
        tail=jnp.zeros((channels, 4), jnp.float32),
        phase_num=jnp.asarray(4 * up, jnp.int32),
    )


def farrow_max_chunk_out(chunk_len: int, rate) -> int:
    """Static output capacity of one streaming chunk (valid count <= this)."""
    up, down = as_rational_rate(rate)
    # entry phase_num >= up+1 after the first chunk and 4*up at init; the
    # capacity bound uses the smallest possible entry phase (up + 1)
    return max(((chunk_len + 1) * up - (up + 1)) // down + 1, 0)


@functools.partial(jax.jit, static_argnames=("up", "down"))
def _farrow_chunk_jit(state: FarrowState, x2d: jax.Array, up: int, down: int):
    tc = x2d.shape[-1]
    ext = jnp.concatenate([state.tail, x2d.astype(jnp.float32)], axis=-1)
    m_max = farrow_max_chunk_out(tc, (up, down))
    m = jnp.arange(m_max, dtype=jnp.int32)
    num = state.phase_num + m * down  # int32; envelope validated by caller
    # emit while the stencil fits: q + 2 <= len(ext) - 1  <=>  num <= (tc+1)*up
    count = jnp.maximum(
        ((tc + 1) * up - state.phase_num) // down + 1, 0
    ).astype(jnp.int32)
    n = jnp.clip(num // up, 1, tc + 1)
    mu = (num % up).astype(jnp.float32) * jnp.float32(1.0 / up)
    g0 = jnp.take(ext, n - 1, axis=-1)
    g1 = jnp.take(ext, n, axis=-1)
    g2 = jnp.take(ext, n + 1, axis=-1)
    g3 = jnp.take(ext, n + 2, axis=-1)
    y = jnp.where(m < count, _lagrange4(mu, g0, g1, g2, g3), 0.0)
    new_state = FarrowState(
        tail=ext[:, -4:],
        phase_num=(state.phase_num + count * down - tc * up).astype(jnp.int32),
    )
    return new_state, y, count


def farrow_chunk(
    state: FarrowState, x: jax.Array, rate
) -> tuple[FarrowState, jax.Array, jax.Array]:
    """One chunk of streaming Farrow resampling.

    Returns ``(state, y, count)``: ``y`` has the static per-chunk capacity
    (:func:`farrow_max_chunk_out`); only ``y[..., :count]`` is valid (the
    host slices — output counts necessarily vary by +-1 across chunks
    unless ``chunk_len * up % down == 0``). Valid outputs concatenated
    across chunks are BIT-exact with ``resample_farrow(method="gather")``
    on the concatenated stream: both run the identical integer phase
    recurrence and identical f32 elementwise math (the matmul path agrees
    to float rounding, ~1e-6).
    """
    up, down = as_rational_rate(rate)
    squeeze = x.ndim == 1
    x2d = x[None, :] if squeeze else x
    tc = x2d.shape[-1]
    if tc < 1:
        raise ValueError("empty chunk")
    # int32 envelope for the in-graph phase arithmetic: num reaches at most
    # (tc+1)*up + down inside the chunk. Uses the ACTUAL down — rates given
    # as explicit (up, down) pairs or Fractions bypass the
    # limit_denominator snap, so the MAX_DENOMINATOR constant would
    # under-check a caller-supplied denominator > 2^16.
    if (tc + 4) * up + down >= 2**31:
        raise ValueError(
            f"chunk of {tc} samples at rate {up}/{down} exceeds the int32 "
            f"phase envelope; use chunks <= {(2**31 - down) // up - 4} "
            "samples (or a smaller rate denominator)"
        )
    new_state, y, count = _farrow_chunk_jit(state, x2d, up, down)
    return new_state, (y[0] if squeeze else y), count


__all__ = [
    "MAX_DENOMINATOR",
    "FarrowState",
    "as_rational_rate",
    "farrow_chunk",
    "farrow_init",
    "farrow_max_chunk_out",
    "farrow_output_len",
    "resample_farrow",
]


# --- streaming (matmul spelling) ---------------------------------------------
#
# The gather chunk path above is the bit-exactness baseline. The matmul
# chunk path emits
# whole FRAMES of `up` outputs through the same banded phase matrix as the
# one-shot, carrying a (down+8)-sample input tail between chunks. All
# bookkeeping is in SAMPLES (small ints), so there is no int32 phase
# envelope; outputs match the one-shot matmul path exactly except that the
# final sub-frame (< up outputs) of the whole stream is deferred until
# enough input arrives (or the stream ends).


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FarrowMatmulState:
    """Carry for matmul-spelling streaming: a right-aligned raw-input tail.

    ``buf``: the last ``down + 8`` input samples per channel (garbage in
    the unused prefix); ``valid``: how many trailing samples are real and
    not yet consumed by emitted frames (includes the initial 4-zero halo).
    """

    buf: jax.Array  # (channels, down + 8) float32
    valid: jax.Array  # () int32


def farrow_matmul_init(rate, channels: int = 1) -> FarrowMatmulState:
    up, down = as_rational_rate(rate)
    return FarrowMatmulState(
        buf=jnp.zeros((channels, down + 8), jnp.float32),
        valid=jnp.asarray(4, jnp.int32),  # the 4-zero causal ext halo
    )


def farrow_matmul_max_out(chunk_len: int, rate) -> int:
    """Static output capacity of one matmul-spelling chunk."""
    up, down = as_rational_rate(rate)
    return ((chunk_len + down + 8 - 8) // down) * up


@functools.partial(jax.jit, static_argnames=("up", "down"))
def _farrow_matmul_chunk_jit(
    state: FarrowMatmulState, x2d: jax.Array, up: int, down: int
):
    from ..utils.layout import overlapping_frames

    c, tc = x2d.shape
    ht = down + 8
    ext = jnp.concatenate([state.buf, x2d.astype(jnp.float32)], axis=-1)
    # real samples occupy ext[:, ht - valid :]; realign so frame origins sit
    # at static hops from column 0 (one dynamic-slice copy per chunk). The
    # right pad keeps start + size inside the array — dynamic_slice CLAMPS
    # an overrunning start, which would silently misalign every frame.
    padded = jnp.pad(ext, ((0, 0), (0, ht)))
    start = (ht - state.valid).astype(jnp.int32)
    sl = jax.lax.dynamic_slice(padded, (jnp.int32(0), start), (c, tc + ht))
    a_max = (tc + ht - 8) // down
    n_avail = state.valid + tc
    a_valid = jnp.maximum((n_avail - 8) // down, 0).astype(jnp.int32)
    frames = overlapping_frames(sl, a_max, down, down + 8)
    k = jnp.asarray(_phase_matrix(up, down))
    y = jnp.einsum(
        "cfd,dr->cfr", frames, k, precision=jax.lax.Precision.HIGHEST
    ).reshape(c, a_max * up)
    m = jnp.arange(a_max * up, dtype=jnp.int32)
    y = jnp.where(m < a_valid * up, y, 0.0)
    new_state = FarrowMatmulState(
        buf=ext[:, -ht:],
        valid=(n_avail - a_valid * down).astype(jnp.int32),
    )
    return new_state, y, (a_valid * up).astype(jnp.int32)


def farrow_matmul_chunk(
    state: FarrowMatmulState, x: jax.Array, rate
) -> tuple[FarrowMatmulState, jax.Array, jax.Array]:
    """One chunk of matmul-spelling Farrow resampling.

    Returns ``(state, y, count)`` like :func:`farrow_chunk`; ``y`` has the
    static capacity :func:`farrow_matmul_max_out` and only
    ``y[..., :count]`` is valid (counts are always whole multiples of
    ``up``). Concatenated valid outputs equal
    ``resample_farrow(method="matmul")`` on the concatenated stream, up to
    the deferred final sub-frame.
    """
    up, down = as_rational_rate(rate)
    squeeze = x.ndim == 1
    x2d = x[None, :] if squeeze else x
    if x2d.shape[-1] < 1:
        raise ValueError("empty chunk")
    new_state, y, count = _farrow_matmul_chunk_jit(state, x2d, up, down)
    return new_state, (y[0] if squeeze else y), count


def farrow_matmul_flush_cap(rate) -> int:
    """Static capacity of :func:`farrow_matmul_flush`'s output."""
    up, down = as_rational_rate(rate)
    return up + (2 * up) // down + 2


@functools.partial(jax.jit, static_argnames=("up", "down"))
def _farrow_matmul_flush_jit(state: FarrowMatmulState, up: int, down: int):
    ht = down + 8
    cap = up + (2 * up) // down + 2
    r = np.arange(cap, dtype=np.int64)
    n_rel = (4 + (r * down) // up).astype(np.int32)  # same pattern as frame 0
    mu = jnp.asarray(((r * down) % up).astype(np.float32) / up)
    idx = (ht - state.valid) + jnp.asarray(n_rel)  # buf is right-aligned
    g = [jnp.take(state.buf, idx + (j - 1), axis=-1) for j in range(4)]
    y = _lagrange4(mu, *g)
    # emit while the 4-tap stencil fits the valid tail
    ok = jnp.asarray(n_rel) + 2 <= state.valid - 1
    count = jnp.sum(ok.astype(jnp.int32))
    return jnp.where(ok, y, 0.0), count


def farrow_matmul_flush(
    state: FarrowMatmulState, rate
) -> tuple[jax.Array, jax.Array]:
    """Emit the stream-end outputs the whole-frame chunks deferred.

    Returns ``(y, count)`` with ``y`` of static capacity
    :func:`farrow_matmul_flush_cap`; only ``y[..., :count]`` is valid.
    Concatenating chunk outputs + the flush reproduces the one-shot
    ``resample_farrow(method="matmul")`` on the whole stream (the flush
    itself evaluates the exact pointwise schedule on the carried tail).
    """
    up, down = as_rational_rate(rate)
    y, count = _farrow_matmul_flush_jit(state, up, down)
    return y, count
