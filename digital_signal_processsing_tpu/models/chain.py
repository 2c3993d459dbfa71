"""The flagship model: a multi-channel FM receiver chain.

BASELINE.json's north-star pipeline ("full chain: overlap-save FIR +
polyphase decimate + FM demod, 16 channels sharded across hosts"): complex
baseband in, per-channel audio out —

    IQ (C, T) complex64
      -> frequency translate (per-channel LO)
      -> channel-select FIR lowpass (overlap-save)
      -> polyphase decimate by D
      -> FM quadrature discriminator
      -> audio FIR lowpass

Everything is jit-compatible and shape-static; the sharded path shards
channels over the mesh's ``ch`` axis and time over ``t`` (GSPMD inserts the
conv halo exchanges; the hand-written collective version of the scan stage
lives in parallel/sharded_scan.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.demod import fm_demodulate, oscillator_bank
from ..ops.fir import design_lowpass, fir_direct, fir_filter
from ..ops.resample import decimate


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    channels: int = 16
    decimation: int = 8
    channel_taps: int = 257  # channel-select lowpass (overlap-save regime)
    audio_taps: int = 63  # post-demod audio lowpass (direct regime)
    fm_gain: float = 1.0
    # fuse channel-select + anti-alias + downsample into ONE polyphase
    # decimating FIR (the classic channelizer frontend): identical
    # selectivity, and with the lane-blocked decimating conv the 257
    # channel taps ride the same banded window as the default 64. False keeps
    # the explicit two-stage pipeline (BASELINE.json names both stages, so
    # that is the reference shape and the default).
    fused_frontend: bool = False
    # lock the audio output to a NON-INTEGER rate ratio (output/input of the
    # post-decimation audio rate): e.g. input 2.048 MS/s, decimation 8 ->
    # 256 kS/s audio, audio_resample=44100/256000 locks to 44.1 kHz. None
    # keeps the integer-decimated rate. Applied as a cubic-Lagrange Farrow
    # stage (ops/farrow.py) after the audio lowpass; float ratios are
    # snapped once to an exact rational (see farrow.as_rational_rate).
    audio_resample: float | tuple[int, int] | None = None

    def lo_frequencies(self) -> np.ndarray:
        """Default LO comb: evenly spaced channels in (-0.4, 0.4) cyc/sample."""
        return np.linspace(-0.4, 0.4, self.channels, dtype=np.float32)


class DspChain:
    """Stateless receiver chain; taps designed once at construction."""

    def __init__(self, config: ChainConfig = ChainConfig()):
        self.config = config
        c = config
        self.channel_taps = jnp.asarray(
            design_lowpass(c.channel_taps, 0.8 / c.decimation)
        )
        self.audio_taps = jnp.asarray(design_lowpass(c.audio_taps, 0.5))
        self.lo = jnp.asarray(c.lo_frequencies())

    @functools.partial(jax.jit, static_argnums=0)
    def __call__(
        self,
        iq: jax.Array,
        t0: jax.Array | int = 0,
        lo_freqs: jax.Array | None = None,
    ) -> jax.Array:
        """(channels, T) complex64 -> (channels, T // decimation) float32.

        ``t0`` is the global index of the first sample — the LO phase must be
        absolute so time-sharded shards (parallel/pipeline.py) mix coherently.
        ``lo_freqs`` overrides the per-channel LO comb (a channel-sharded run
        passes only its shard's rows).
        """
        c = self.config
        # per-channel LO mix: factored oscillator bank (ops/demod.py) —
        # O(sqrt(T)) transcendentals and exact phase at any t0 (the naive
        # f32 phase f*(t0+n) degrades past n ~ 2^24 f). Complex constants
        # (1j) and f->c converts are unimplemented on some PJRT backends;
        # build complex values with lax.complex throughout.
        t = iq.shape[-1]
        lo_f = self.lo if lo_freqs is None else lo_freqs
        lo_cos, lo_sin = oscillator_bank(lo_f, t, t0)
        lo = jax.lax.complex(lo_cos, lo_sin)
        mixed = iq * lo
        if c.fused_frontend:
            # one polyphase decimating FIR does select + anti-alias + drop
            di = decimate(jnp.real(mixed), c.decimation, taps=self.channel_taps)
            dq = decimate(jnp.imag(mixed), c.decimation, taps=self.channel_taps)
        else:
            # channel-select lowpass on I and Q planes (auto crossover:
            # the lane-blocked direct conv at 257 taps)
            fi = fir_filter(jnp.real(mixed), self.channel_taps)
            fq = fir_filter(jnp.imag(mixed), self.channel_taps)
            # polyphase decimate both planes (own anti-alias taps)
            di = decimate(fi, c.decimation)
            dq = decimate(fq, c.decimation)
        # FM discriminator + audio lowpass
        audio = fm_demodulate(jax.lax.complex(di, dq), gain=c.fm_gain)
        audio = fir_direct(audio, self.audio_taps)
        if c.audio_resample is not None:
            from ..ops.farrow import resample_farrow

            audio = resample_farrow(audio, c.audio_resample)
        return audio

    @functools.partial(jax.jit, static_argnums=0)
    def forward_planar(
        self,
        i: jax.Array,
        q: jax.Array,
        t0: jax.Array | int = 0,
        lo_freqs: jax.Array | None = None,
    ) -> jax.Array:
        """Forward from separate I/Q float32 planes.

        Stages two real planes and forms the complex baseband on device;
        the on-device math is identical to :meth:`__call__`.
        """
        return self(
            jax.lax.complex(i.astype(jnp.float32), q.astype(jnp.float32)),
            t0=t0,
            lo_freqs=lo_freqs,
        )

    def example_input(self, t: int = 1 << 16, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        shape = (self.config.channels, t)
        return (
            rng.normal(size=shape) + 1j * rng.normal(size=shape)
        ).astype(np.complex64)

    def example_planar_input(
        self, t: int = 1 << 16, seed: int = 0
    ) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        shape = (self.config.channels, t)
        return (
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
        )


@dataclasses.dataclass
class ChainStreamState:
    """Carry for chunked chain processing: the raw I/Q halo + global offset.

    The same halo-recompute strategy as the time-sharded chain
    (parallel/pipeline.py), applied across time instead of across chips:
    keep the last ``chain_halo`` raw samples, prepend them to the next
    chunk, drop the halo's outputs. Chunked output matches the one-shot
    chain on the concatenated stream (float32 scan-ordering noise only).
    """

    tail_i: jax.Array  # (channels, halo) float32
    tail_q: jax.Array  # (channels, halo) float32
    t0: jax.Array  # () int32 — absolute index of the next chunk's sample 0


jax.tree_util.register_dataclass(
    ChainStreamState, data_fields=["tail_i", "tail_q", "t0"], meta_fields=[]
)


def chain_stream_init(chain: DspChain) -> ChainStreamState:
    from ..parallel.pipeline import chain_halo

    c = chain.config
    halo = chain_halo(chain)
    z = jnp.zeros((c.channels, halo), jnp.float32)
    return ChainStreamState(tail_i=z, tail_q=z, t0=jnp.asarray(0, jnp.int32))


@functools.partial(jax.jit, static_argnums=0)
def chain_stream_chunk(
    chain: DspChain,
    state: ChainStreamState,
    i: jax.Array,
    q: jax.Array,
) -> tuple[ChainStreamState, jax.Array]:
    """One chunk of the receiver chain with carried raw-sample halo.

    ``i``/``q``: (channels, chunk_t) float32 planes, chunk_t a multiple of
    the decimation. Returns audio (channels, chunk_t // decimation) aligned
    with the one-shot chain's output for the same absolute offsets (the LO
    uses the carried global ``t0``, so chunked mixing stays phase-coherent).
    """
    c = chain.config
    d = c.decimation
    t_loc = i.shape[-1]
    halo = state.tail_i.shape[-1]
    ext_i = jnp.concatenate([state.tail_i, i.astype(jnp.float32)], axis=-1)
    ext_q = jnp.concatenate([state.tail_q, q.astype(jnp.float32)], axis=-1)
    out = chain.forward_planar(ext_i, ext_q, t0=state.t0 - halo)
    new_state = ChainStreamState(
        tail_i=ext_i[:, t_loc:],
        tail_q=ext_q[:, t_loc:],
        t0=state.t0 + t_loc,
    )
    return new_state, out[:, halo // d :]
