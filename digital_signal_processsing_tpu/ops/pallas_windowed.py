"""Windowed moving-average kernel for NVIDIA GPUs (Pallas, Triton route).

The causal box filter of the reference's scan family
(hillis_steele_averager.cu:87-100) is a windowed difference of the
per-channel prefix sum:

    wsum[f, c] = S[f, c] - S[f - k, c],   out = trunc(wsum / k)

GPU blocks run in no order, so no sum is carried from one program to the
next. Each program owns a segment of ``seg_tiles * tile`` frames instead:

1. it sums the ``k`` frames just before its segment (the halo), read
   straight from global memory, where the neighbouring program has just
   brought them into L2;
2. it walks its segment tile by tile, keeping the running window sum in
   registers: for the difference signal ``d[f] = x[f] - x[f - k]`` the
   window sum is ``carry + cumsum(d)``, and the carry grows by ``sum(d)``.

The stream is read once from memory (the ``x[f - k]`` rows are re-read from
cache) and written once, int16 in and int16 out. Every window sum is exact
in int32, since ``|wsum| <= 65535 * 32768 < 2**31``. Tiles are loaded as
flat runs of samples, whose offsets are affine in the program id, so that
Triton vectorizes the loads; they are viewed as (frames, channels) only for
the per-channel scan. ``seed`` is the left halo of a stream that continues an earlier
one (the streaming and sharded callers): the ``k * channels`` samples that
precede ``x``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..utils import layout
from ..utils.numerics import MAX_EXACT_WINDOW

# Widest channel count the kernel takes; a (tile, channels) register tile
# needs at least one frame per row.
MAX_CHANNELS = 128
# Samples in one register tile (tile frames x channels), and warps per
# program: the fastest of 512-4096 samples x 2/4/8 warps at 64M stereo,
# k = 16 and 1024, on an H100.
TILE_ELEMS = 1024
NUM_WARPS = 4


def windowed_supported(window: int, channels: int) -> bool:
    """True iff the kernel runs this (window, channels) configuration.

    Triton tiles have power-of-two sides, so ``channels`` must be one.
    """
    return (
        1 <= channels <= MAX_CHANNELS
        and channels & (channels - 1) == 0
        and 1 <= window <= MAX_EXACT_WINDOW
    )


def _geometry(frames: int, window: int, channels: int, tile_elems: int):
    """(tile frames, tiles per program, grid) for a stream of ``frames``."""
    tile = max(tile_elems // channels, 1)
    halo_tiles = layout.cdiv(window, tile)
    total_tiles = max(layout.cdiv(frames, tile), 1)
    # The halo is re-read by every program: keep it under ~1/8 of the
    # segment's loads, but leave at least ~4 programs per SM of an H100.
    seg_tiles = max(4 * halo_tiles, 4)
    seg_tiles = max(min(seg_tiles, total_tiles // 528), 1)
    return tile, seg_tiles, layout.cdiv(total_tiles, seg_tiles)


def _kernel(*refs, window, channels, n, tile, seg_tiles, seeded):
    if seeded:
        seed_ref, x_ref, o_ref = refs
    else:
        x_ref, o_ref = refs
    te = tile * channels
    halo = window * channels
    base = pl.program_id(0) * (seg_tiles * te)  # first sample of the segment
    iota = lax.broadcasted_iota(jnp.int32, (te,), 0)

    def load(start):
        """Samples ``start + iota`` as (tile, channels) int32; zero (or the
        seed) before the stream. The offsets stay affine in ``iota`` so
        that the loads vectorize."""
        offs = start + iota
        m = (offs >= 0) & (offs < n)
        v = plgpu.load(x_ref.at[offs], mask=m, other=0).astype(jnp.int32)
        if seeded:
            sm = (offs < 0) & (offs >= -halo)
            v = v + plgpu.load(
                seed_ref.at[offs + halo], mask=sm, other=0
            ).astype(jnp.int32)
        return v.reshape(tile, channels)

    def halo_step(i, acc):
        start = base - halo + i * te
        in_halo = (start + iota < base).reshape(tile, channels)
        return acc + jnp.sum(jnp.where(in_halo, load(start), 0), axis=0)

    carry = lax.fori_loop(
        0, layout.cdiv(halo, te), halo_step, jnp.zeros((channels,), jnp.int32)
    )

    def tile_step(t, carry):
        start = base + t * te
        d = load(start) - load(start - halo)
        wsum = jnp.cumsum(d, axis=0) + carry[None, :]
        offs = start + iota
        # Masked lanes lie past the end, where the interpreter drops them.
        plgpu.store(
            o_ref.at[offs],
            lax.div(wsum, window).astype(jnp.int16).reshape(te),
            mask=offs < n,
        )
        return carry + jnp.sum(d, axis=0)

    lax.fori_loop(0, seg_tiles, tile_step, carry)


@functools.partial(
    jax.jit,
    static_argnames=("window", "channels", "tile_elems", "interpret"),
)
def windowed_average_pallas(
    x: jax.Array,
    window: int,
    channels: int = 1,
    *,
    seed: jax.Array | None = None,
    tile_elems: int = TILE_ELEMS,
    interpret: bool = False,
) -> jax.Array:
    """Causal moving average of a flat interleaved int16 stream (GPU kernel).

    Bit-exact with ``golden.moving_average_golden`` for window <= 65535.
    ``seed``: the ``window * channels`` samples before ``x`` (zeros at the
    start of a stream). ``tile_elems``: samples per register tile (tests
    shrink it to reach many tiles and programs at small sizes).
    ``interpret``: run the kernel in the Pallas interpreter, which is how
    it is tested off the GPU.
    """
    layout.validate_window(window, MAX_EXACT_WINDOW)
    if not windowed_supported(window, channels):
        raise ValueError(
            f"channels must be a power of two in 1..{MAX_CHANNELS}, got {channels}"
        )
    n = x.shape[0]
    if n % channels:
        raise ValueError(f"stream length {n} not a multiple of channels {channels}")
    if seed is not None and seed.shape != (window * channels,):
        raise ValueError(
            f"seed must be the {window * channels} samples before the stream, "
            f"got shape {seed.shape}"
        )
    if n == 0:
        return x
    tile, seg_tiles, grid = _geometry(n // channels, window, channels, tile_elems)
    operands = [x] if seed is None else [seed.astype(jnp.int16), x]
    return pl.pallas_call(
        functools.partial(
            _kernel,
            window=window,
            channels=channels,
            n=n,
            tile=tile,
            seg_tiles=seg_tiles,
            seeded=seed is not None,
        ),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int16),
        grid=(grid,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=2),
        interpret=interpret,
        name="windowed_average",
    )(*operands)


__all__ = ["windowed_average_pallas", "windowed_supported", "MAX_CHANNELS"]
