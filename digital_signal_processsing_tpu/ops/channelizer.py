"""Polyphase filter-bank (PFB) channelizer — wideband split into N bands.

Beyond-reference framework op: the standard SDR structure that replaces N
parallel mix→filter→decimate chains with one polyphase FIR + one FFT,

    Y[k, m] = sum_j h[j] x[N·m − j] · e^{2πi k j / N}
            = N · IFFT_q( v_q[m] ),   v_q = h_q ⊛ u_q  (per-branch causal FIR)

with branch taps h_q[r] = h[rN+q] and branch inputs u_q[m] = x[Nm − q]
(the reverse-running commutator: u_0[m] = x[Nm], u_q[m] = x[(m−1)N + (N−q)]
for q ≥ 1). Bit-matches the literal mix-filter-decimate bank (the test
oracle) for every channel.

Shape: the branch FIRs are ONE dense-feature conv over block index m —
the diagonal (N in → N out) banded taps matrix keeps the conv's feature
dims full (same trick as ops/fir.py's lane-blocked convs; a grouped
depthwise conv has feature dims of 1) — and the channel transform is a
single batched length-N DFT on the minor axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .fir import design_lowpass


def branch_fir(u: jax.Array, hq: jax.Array, *, dilation: int = 1) -> jax.Array:
    """Per-phase causal FIR over block index m: ONE dense diagonal conv.

    ``u``: (batch, M, N) float32 branch signals; ``hq``: (P, N) per-phase
    taps; ``dilation`` spreads the taps over the block axis (the
    2x-oversampled bank's stride-2 branch filters, ops/pfb_os.py). A
    grouped depthwise conv has feature dims of 1 — the diagonal banded
    (N in -> N out) rhs keeps them full.
    """
    p, n = hq.shape
    eye = np.eye(n, dtype=np.float32)
    rhs = jnp.asarray(eye[None, :, :]) * hq[::-1][:, None, :]  # (P, N, N)
    return jax.lax.conv_general_dilated(
        u,
        rhs,
        window_strides=(1,),
        padding=((dilation * (p - 1), 0),),
        rhs_dilation=(dilation,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        precision=jax.lax.Precision.HIGHEST,
    )


def dft_matmul(
    re_in: jax.Array, im_in: jax.Array | None, n: int, *, sign: int = 1
) -> tuple[jax.Array, jax.Array]:
    """(..., N) @ DFT_N as two matmuls: sum_q v[q] e^{sign*2πi q k / N}.

    For small N the explicit matmul is a dense contraction over millions
    of rows, and the planar form never builds complex constants.
    """
    qk = np.outer(np.arange(n), np.arange(n)) * (2.0 * np.pi / n)
    cos = jnp.asarray(np.cos(qk), jnp.float32)
    sin = jnp.asarray(np.sin(qk) * sign, jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    if im_in is None:
        return (
            jnp.dot(re_in, cos, precision=hp),
            jnp.dot(re_in, sin, precision=hp),
        )
    re = jnp.dot(re_in, cos, precision=hp) - jnp.dot(im_in, sin, precision=hp)
    im = jnp.dot(re_in, sin, precision=hp) + jnp.dot(im_in, cos, precision=hp)
    return re, im


def design_prototype(
    n_channels: int, taps_per_phase: int = 8, *, window: str | tuple = "hamming"
) -> np.ndarray:
    """Prototype lowpass for an N-channel PFB: cutoff at the channel edge."""
    return design_lowpass(
        n_channels * taps_per_phase, 1.0 / n_channels, window=window
    )


@functools.partial(jax.jit, static_argnames=("n_channels", "method"))
def pfb_channelize(
    x: jax.Array,
    n_channels: int,
    taps: jax.Array | None = None,
    *,
    method: str = "auto",
) -> jax.Array:
    """Split a real stream into N complex baseband channels at rate fs/N.

    ``x``: (time,) float32, length a multiple of ``n_channels``. Returns
    (n_channels, time // n_channels) complex64 — channel k centered at
    normalized frequency k/N cycles/sample (k > N/2 are the negative
    frequencies, as in an FFT).
    """
    n = n_channels
    if x.ndim != 1:
        raise ValueError(f"expected a flat (time,) stream, got shape {x.shape}")
    t = x.shape[0]
    if t % n != 0:
        raise ValueError(f"stream length {t} not a multiple of n_channels {n}")
    if taps is None:
        taps = jnp.asarray(design_prototype(n))
    k = taps.shape[0]
    p = -(-k // n)  # taps per phase
    h = jnp.pad(taps.astype(jnp.float32), (0, p * n - k))

    hq = h.reshape(p, n)  # hq[r, q] = h[rN + q]
    if method not in ("auto", "composed"):
        raise ValueError(
            f"unknown method {method!r}; options ('auto', 'composed')"
        )
    from ..utils.dispatch import record_choice

    record_choice("pfb_channelize", "composed")
    m = t // n
    xp = x.astype(jnp.float32).reshape(m, n)
    # reverse-running commutator: u[:, 0] = xp[:, 0]; u[m, q] = xp[m-1, N-q]
    rev = xp[:, ::-1]
    u = jnp.concatenate(
        [
            xp[:, :1],
            jnp.pad(rev[:-1, : n - 1], ((1, 0), (0, 0))),
        ],
        axis=1,
    )
    # per-branch causal FIR, then the channel transform (see helpers)
    v = branch_fir(u[None, :, :], hq)[0]  # (M, N)
    re, im = dft_matmul(v, None, n)  # Y[m, k] = sum_q v e^{+2πi qk/N}
    return jax.lax.complex(re, im).T  # (N, M)


@functools.partial(jax.jit, static_argnames=())
def pfb_synthesize(
    channels: jax.Array,
    taps: jax.Array | None = None,
) -> jax.Array:
    """Inverse of :func:`pfb_channelize`: N complex basebands -> wideband.

    The synthesis (transmultiplexer / TX) bank:

        x[n] = sum_k sum_m Y[k, m] g[n - mN] e^{2πi k n / N}

    i.e. channel IFFT across k, per-phase interpolation FIR with the
    gain-compensated prototype, plain phase interleave. For channel signals
    bandlimited inside their band this reconstructs them to prototype
    accuracy (~60 dB with the default prototype; verified by the
    synthesize->analyze round trip in tests/test_channelizer.py). NOTE: the
    critically-sampled analysis->synthesis round trip of a FULL-band signal
    is aliasing-limited (~12 dB) — that direction needs an oversampled
    bank, not a better prototype.

    ``channels``: (N, M) complex64 -> (N*M,) complex64 wideband.
    """
    n, m = channels.shape
    if taps is None:
        taps = jnp.asarray(design_prototype(n))
    k = taps.shape[0]
    p = -(-k // n)
    g = jnp.pad(taps.astype(jnp.float32) * n, (0, p * n - k)).reshape(p, n)

    # s[m, p] = sum_k Y[k, m] e^{+2πi k p / N} — DFT matmul, like the
    # analysis direction (XLA's batched small FFT lowers poorly)
    yi = jnp.real(channels).astype(jnp.float32).T  # (M, N)
    yq = jnp.imag(channels).astype(jnp.float32).T
    s_re, s_im = dft_matmul(yi, yq, n)
    v = branch_fir(jnp.stack([s_re, s_im]), g)  # (2, M, N)
    return jax.lax.complex(v[0].reshape(-1), v[1].reshape(-1))


@functools.partial(jax.jit, static_argnames=())
def pfb_synthesize_planar(
    ch_i: jax.Array,
    ch_q: jax.Array,
    taps: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """:func:`pfb_synthesize` with planar I/Q in and out (PJRT-portable)."""
    y = pfb_synthesize(
        jax.lax.complex(ch_i.astype(jnp.float32), ch_q.astype(jnp.float32)),
        taps,
    )
    return jnp.real(y).astype(jnp.float32), jnp.imag(y).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("n_channels",))
def pfb_channelize_planar(
    x: jax.Array,
    n_channels: int,
    taps: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """:func:`pfb_channelize` returning (I, Q) float32 planes.

    Keeps the transform complex on device and splits it before anything
    crosses the host boundary (like the receiver chain's planar entry
    points).
    """
    y = pfb_channelize(x, n_channels, taps)
    return jnp.real(y).astype(jnp.float32), jnp.imag(y).astype(jnp.float32)


def pfb_stream_init(n_channels: int, taps_len: int | None = None) -> jax.Array:
    """Zero carry for :func:`pfb_channelize_chunk`: the last
    ``ceil(taps/N)`` input BLOCKS (the analysis filter's memory)."""
    p = -(-(taps_len or 8 * n_channels) // n_channels)
    return jnp.zeros((p * n_channels,), jnp.float32)


@functools.partial(jax.jit, static_argnames=("n_channels",))
def pfb_channelize_chunk(
    state: jax.Array,
    x: jax.Array,
    n_channels: int,
    taps: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """One chunk of the analysis bank with carried raw-sample blocks.

    Halo-recompute across time (the same strategy as the chain's stream
    API): prepend the carried blocks, channelize, drop their output
    columns. Chunked output is bit-close to one-shot on the concatenated
    stream (float conv ordering only). Chunk length must be a multiple of
    ``n_channels``.
    """
    n = n_channels
    halo = state.shape[0]
    taps_len = 8 * n if taps is None else taps.shape[0]
    need = -(-taps_len // n) * n
    if halo != need:
        raise ValueError(
            f"carried state holds {halo} samples but these taps need {need} "
            f"(pfb_stream_init(n_channels, taps_len={taps_len}))"
        )
    ext = jnp.concatenate([state, x.astype(jnp.float32)])
    y = pfb_channelize(ext, n, taps)[:, halo // n :]
    new_state = ext[ext.shape[0] - halo :]
    return new_state, y


@functools.partial(jax.jit, static_argnames=("n_channels",))
def pfb_channelize_chunk_planar(
    state: jax.Array,
    x: jax.Array,
    n_channels: int,
    taps: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """:func:`pfb_channelize_chunk` returning (state, I, Q) float32 —
    the streaming path stays usable on PJRT backends without complex
    host transfer (same caveat as the one-shot planar wrappers)."""
    state, y = pfb_channelize_chunk(state, x, n_channels, taps)
    return state, jnp.real(y).astype(jnp.float32), jnp.imag(y).astype(jnp.float32)


__all__ = [
    "pfb_channelize",
    "pfb_channelize_planar",
    "pfb_synthesize",
    "pfb_synthesize_planar",
    "pfb_stream_init",
    "pfb_channelize_chunk",
    "pfb_channelize_chunk_planar",
    "branch_fir",
    "dft_matmul",
    "design_prototype",
]
