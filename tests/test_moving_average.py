"""Averager parity: every engine bit-exact against the golden oracle.

The test strategy the reference lacks (SURVEY.md §4): all engines are
checked against the CPU golden model, not against each other, across the
regime envelope (window 1..big, channels 1/2/4, lengths that don't divide
tiles evenly, full int16 dynamic range including INT16_MIN). The windowed
GPU kernel runs here in the Pallas interpreter.
"""

import numpy as np
import pytest

from digital_signal_processsing_tpu.golden import (
    cumsum_per_channel_golden,
    moving_average_golden,
)
from digital_signal_processsing_tpu.ops import moving_average
from digital_signal_processsing_tpu.ops.moving_average import auto_method
from digital_signal_processsing_tpu.ops.pallas_windowed import (
    windowed_average_pallas,
)
from digital_signal_processsing_tpu.ops.scan_xla import cumsum_interleaved_xla
from digital_signal_processsing_tpu.utils.dispatch import last_choice
from tests.conftest import make_interleaved


def _kernel(x, window, channels, **kw):
    return windowed_average_pallas(x, window, channels, interpret=True, **kw)


def run_engine(engine, x, window, channels):
    if engine == "kernel":
        return _kernel(x, window, channels)
    if engine == "kernel_small_tiles":
        # many programs, each walking several tiles after its halo
        return _kernel(x, window, channels, tile_elems=64)
    if engine == "kernel_zero_seed":
        seed = np.zeros(window * channels, np.int16)
        return _kernel(x, window, channels, seed=seed)
    return moving_average(x, window, channels, method=engine)


ENGINES = [
    "kernel",
    "kernel_small_tiles",
    "kernel_zero_seed",
    "xla_scan",
    "xla_direct",
    "auto",
]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("window", [1, 3, 16])
def test_parity_small(rng, engine, channels, window):
    x = make_interleaved(rng, 1000, channels)
    want = moving_average_golden(x, window, channels)
    got = np.asarray(run_engine(engine, x, window, channels))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ["kernel", "kernel_small_tiles", "xla_scan"])
@pytest.mark.parametrize("window", [500, 5000])
def test_parity_large_window(rng, engine, window):
    x = make_interleaved(rng, 8000, 2)
    want = moving_average_golden(x, window, 2)
    got = np.asarray(run_engine(engine, x, window, 2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 127, 128, 129, 32768, 32769, 70000])
def test_parity_awkward_lengths(rng, n):
    # Lengths around tile (1024 samples) and segment boundaries.
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    want = moving_average_golden(x, 4, 1)
    got = np.asarray(_kernel(x, 4, 1))
    np.testing.assert_array_equal(got, want)


def test_parity_multi_tile_carry(rng):
    # every program walks several tiles: the register carry must cycle
    x = make_interleaved(rng, 60000, 2)
    want = moving_average_golden(x, 700, 2)
    got = np.asarray(_kernel(x, 700, 2, tile_elems=256))
    np.testing.assert_array_equal(got, want)


def test_parity_halo_spans_tile_boundary(rng):
    # window*channels far wider than a tile: the halo loop runs many steps
    x = make_interleaved(rng, 40000, 2)
    want = moving_average_golden(x, 16000, 2)
    got = np.asarray(_kernel(x, 16000, 2))
    np.testing.assert_array_equal(got, want)


def test_int16_min_saturation_regime():
    x = np.full(50000, -32768, dtype=np.int16)
    want = moving_average_golden(x, 1024, 1)
    got = np.asarray(_kernel(x, 1024, 1))
    np.testing.assert_array_equal(got, want)


def test_auto_dispatch(rng):
    # off the GPU, auto is the XLA scan
    x = make_interleaved(rng, 2000, 2)
    for w in (2, 64):
        np.testing.assert_array_equal(
            np.asarray(moving_average(x, w, 2, method="auto")),
            moving_average_golden(x, w, 2),
        )
        assert last_choice("moving_average") == "xla_scan"


def test_direct_rejects_big_window(rng):
    # the removed kernel ladder's names are unknown methods
    x = make_interleaved(rng, 100, 1)
    for method in ("direct", "scan", "scan_hillis", "scan_mxu", "windowed"):
        with pytest.raises(ValueError, match="unknown method"):
            moving_average(x, 1000, 1, method=method)


def test_window_beyond_exact_bound_rejected(rng):
    x = make_interleaved(rng, 100, 1)
    with pytest.raises(ValueError, match="65535"):
        moving_average(x, 70000, 1, method="xla_scan")
    with pytest.raises(ValueError, match="65535"):
        _kernel(x, 70000, 1)


def test_unknown_method(rng):
    with pytest.raises(ValueError, match="unknown method"):
        moving_average(make_interleaved(rng, 10, 1), 2, 1, method="warp")


@pytest.mark.parametrize("n", [100001, 7])
def test_cumsum_pallas_property(rng, n):
    # Inclusive scan == int32 modular cumsum, awkward length.
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    got = np.asarray(cumsum_interleaved_xla(x))
    want = np.cumsum(x.astype(np.int64)).astype(np.int32)  # modular reference
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames", [700, 701])
@pytest.mark.parametrize("channels", [2, 4, 128])
def test_cumsum_pallas_segmented(rng, frames, channels):
    # Interleaved segmented scan == per-channel golden cumsum (mod 2^32).
    x = make_interleaved(rng, frames, channels)
    got = np.asarray(cumsum_interleaved_xla(x, channels))
    want = cumsum_per_channel_golden(x, channels).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_scan_rejects_non_divisor_channels(rng):
    # Triton tiles have power-of-two sides: the kernel refuses 3 channels
    x = make_interleaved(rng, 30, 3)
    with pytest.raises(ValueError, match="power of two"):
        _kernel(x, 4, 3)


def test_auto_falls_back_for_odd_channels(rng):
    # channels=3 is outside the kernel: auto must take the XLA scan, on a
    # GPU as well as here
    assert auto_method(10, 3, "gpu") == "xla_scan"
    x = make_interleaved(rng, 999, 3)
    got = np.asarray(moving_average(x, 10, 3, method="auto"))
    np.testing.assert_array_equal(got, moving_average_golden(x, 10, 3))


def test_two_pass_fallback_large_halo(rng):
    # 128 channels with a halo of many tiles: still bit-exact
    channels, window = 128, 600
    x = make_interleaved(rng, 2000, channels)
    want = moving_average_golden(x, window, channels)
    got = np.asarray(_kernel(x, window, channels))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels,window", [(2, 16), (2, 1024), (4, 7), (2, 5000)])
def test_packed_windowed_parity(rng, channels, window):
    # the int32 pair-packed transport must match golden bit-exactly
    x = make_interleaved(rng, 256 * 100 // channels, channels)
    want = moving_average_golden(x, window, channels)
    got = np.asarray(moving_average(x.view(np.int32), window, channels))
    np.testing.assert_array_equal(got.view(np.int16), want)


def test_packed_windowed_rejects_odd_shapes(rng):
    # 3 pairs = 6 samples is not a whole number of 4-channel frames
    with pytest.raises(ValueError, match="multiple of channels"):
        moving_average(np.zeros(3, np.int32), 4, 4)
    with pytest.raises(ValueError, match="device method"):
        moving_average(np.zeros(4, np.int32), 4, 2, method="golden")


def test_moving_average_dispatches_packed_input(rng):
    # int32 input = the documented pair view: the output pair view must
    # round-trip to the int16 answer, through the engine auto picks
    w, c = 64, 2
    x = make_interleaved(rng, 1 << 15, c)
    want = moving_average_golden(x, w, c)
    got32 = np.asarray(moving_average(x.view(np.int32), w, c))
    assert got32.dtype == np.int32
    assert last_choice("moving_average") == "xla_scan"
    np.testing.assert_array_equal(got32.view(np.int16), want)


def test_moving_average_packed_unpack_fallback(rng):
    # channels that the kernel cannot tile still give the right answer
    w, c = 16, 6
    x = make_interleaved(rng, 1536, c)
    got32 = np.asarray(moving_average(x.view(np.int32), w, c))
    np.testing.assert_array_equal(
        got32.view(np.int16), moving_average_golden(x, w, c)
    )


def test_packed_seeded_matches_unseeded_suffix(rng):
    # the seed path: running the second half seeded with the first half's
    # trailing window*channels samples must reproduce the one-shot half
    w, c = 300, 2
    x = make_interleaved(rng, 1 << 14, c)
    want = moving_average_golden(x, w, c)
    half = x.shape[0] // 2
    seed = x[half - w * c : half]
    got = np.asarray(_kernel(x[half:], w, c, seed=seed))
    np.testing.assert_array_equal(got, want[half:])
