"""The windowed Pallas-Triton averager, off the GPU.

The kernel runs here in the Pallas interpreter (``interpret=True``) and is
lowered for CUDA without a card, which checks that every operation has a
Triton lowering. Compiling it for the card happens only there:
``python chip_smoke.py`` (phases A and A'), and the ``gpu`` test below.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digital_signal_processsing_tpu.golden import moving_average_golden
from digital_signal_processsing_tpu.ops.pallas_windowed import (
    MAX_CHANNELS,
    TILE_ELEMS,
    windowed_average_pallas,
    windowed_supported,
)
from tests.conftest import make_interleaved


def kernel(x, window, channels, **kw):
    return np.asarray(
        windowed_average_pallas(jnp.asarray(x), window, channels, interpret=True, **kw)
    )


@pytest.mark.parametrize("channels", [1, 2, 4, 16, 128])
@pytest.mark.parametrize("window", [1, 3, 100, 4097, 65535])
def test_windows_and_channels(rng, window, channels):
    x = make_interleaved(rng, max(64, 6000 // channels), channels)
    np.testing.assert_array_equal(
        kernel(x, window, channels), moving_average_golden(x, window, channels)
    )


@pytest.mark.parametrize(
    "n",
    [
        TILE_ELEMS - 2,
        TILE_ELEMS,
        TILE_ELEMS + 2,
        4 * TILE_ELEMS * 3,  # whole segments of four tiles
        4 * TILE_ELEMS * 3 + 2,
        2,
    ],
)
def test_lengths_on_and_off_block_boundaries(rng, n):
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    np.testing.assert_array_equal(kernel(x, 5, 2), moving_average_golden(x, 5, 2))


@pytest.mark.parametrize("tile_elems", [16, 64, 256])
def test_halo_wider_than_a_block(rng, tile_elems):
    # a halo of many tiles, on streams of many programs
    x = make_interleaved(rng, 3000, 2)
    got = kernel(x, 700, 2, tile_elems=tile_elems)
    np.testing.assert_array_equal(got, moving_average_golden(x, 700, 2))


@pytest.mark.parametrize("window", [1, 2, 1024, 65535])
def test_all_int16_min(window):
    # the most negative window sums: truncation toward zero, exact int32
    x = np.full(4096, -32768, dtype=np.int16)
    np.testing.assert_array_equal(
        kernel(x, window, 2), moving_average_golden(x, window, 2)
    )


@pytest.mark.parametrize("window,channels,cut", [(16, 2, 1000), (300, 4, 64), (9, 1, 3)])
def test_seeded_halo_continues_stream(rng, window, channels, cut):
    # seed = the window*channels samples before x (zeros before the stream)
    x = make_interleaved(rng, 2000, channels)
    want = moving_average_golden(x, window, channels)
    c = cut * channels
    seed = np.concatenate([np.zeros(window * channels, np.int16), x[:c]])
    seed = seed[-window * channels :]
    np.testing.assert_array_equal(
        kernel(x[c:], window, channels, seed=seed), want[c:]
    )


def test_seed_shape_and_channels_validated(rng):
    x = make_interleaved(rng, 100, 2)
    with pytest.raises(ValueError, match="seed"):
        kernel(x, 4, 2, seed=np.zeros(3, np.int16))
    with pytest.raises(ValueError, match="power of two"):
        kernel(make_interleaved(rng, 100, 6), 4, 6)
    with pytest.raises(ValueError, match="multiple of channels"):
        kernel(x[:5], 4, 2)
    assert kernel(x[:0], 4, 2).shape == (0,)
    assert not windowed_supported(4, 2 * MAX_CHANNELS)
    assert not windowed_supported(4, 3)
    assert windowed_supported(65535, MAX_CHANNELS)


@pytest.mark.parametrize("window,channels", [(16, 2), (1024, 2), (65535, 1), (7, 128)])
@pytest.mark.parametrize("seeded", [False, True])
def test_lowers_for_cuda_through_triton(window, channels, seeded):
    # every operation of the kernel has a Triton lowering; the program is
    # one Triton custom call with the grid and warps the wrapper chose
    n = channels * (1 << 16)
    x = jax.ShapeDtypeStruct((n,), jnp.int16)
    if seeded:
        s = jax.ShapeDtypeStruct((window * channels,), jnp.int16)
        fn = jax.jit(lambda v, s: windowed_average_pallas(v, window, channels, seed=s))
        args = (x, s)
    else:
        fn = jax.jit(functools.partial(windowed_average_pallas, window=window,
                                       channels=channels))
        args = (x,)
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "num_warps = 4" in text
    assert text.count("xla.gpu.triton") == 1


@pytest.mark.gpu
def test_kernel_on_gpu(gpu_device, rng):
    x = jax.device_put(make_interleaved(rng, 1 << 20, 2), gpu_device)
    got = np.asarray(windowed_average_pallas(x, 1024, 2))
    np.testing.assert_array_equal(got, moving_average_golden(np.asarray(x), 1024, 2))
