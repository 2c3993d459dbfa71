"""matmul-factorized DFT: parity with numpy FFT and the direct conv."""

import numpy as np
import pytest

from digital_signal_processsing_tpu.ops.fft_mxu import (
    dft_factored,
    overlap_save_mxu,
    pick_factored_nfft,
)


@pytest.mark.parametrize("n1,n2", [(128, 72), (128, 3), (64, 64), (128, 576)])
def test_dft_matches_numpy(rng, n1, n2):
    n = n1 * n2
    x = rng.normal(size=(2, n)).astype(np.float32)
    fr, fi = dft_factored(x, None, n1=n1)
    want = np.fft.fft(x.astype(np.float64), axis=-1)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(np.asarray(fr) - want.real)) / scale < 1e-5
    assert np.max(np.abs(np.asarray(fi) - want.imag)) / scale < 1e-5
    # inverse round trip
    br, bi = dft_factored(fr, fi, n1=n1, inverse=True)
    assert np.max(np.abs(np.asarray(br) - x)) < 1e-4
    assert np.max(np.abs(np.asarray(bi))) < 1e-4


def test_dft_rejects_unaligned():
    with pytest.raises(ValueError, match="128"):
        dft_factored(np.zeros((1, 100), np.float32), None)


def test_overlap_save_mxu_matches_direct(rng):
    from digital_signal_processsing_tpu.ops.fir import fir_direct

    x = rng.normal(size=(2, 50_000)).astype(np.float32)
    for k, block in [(1025, 8192), (257, 2048), (4097, 32768)]:
        h = rng.normal(size=k).astype(np.float32) / np.sqrt(k)
        got = np.asarray(overlap_save_mxu(x, h, block=block))
        want = np.asarray(fir_direct(x, h))
        scale = np.max(np.abs(want))
        assert np.max(np.abs(got - want)) / scale < 1e-4, k


def test_overlap_save_mxu_traced_taps(rng):
    # traced taps compute the frequency response on device (same DFT)
    import jax

    from digital_signal_processsing_tpu.ops.fir import fir_direct

    x = rng.normal(size=20_000).astype(np.float32)
    h = rng.normal(size=513).astype(np.float32) / 20

    got = np.asarray(
        jax.jit(lambda v, t: overlap_save_mxu(v, t, block=4096))(x, h)
    )
    want = np.asarray(fir_direct(x, h))
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 1e-4


def test_fir_filter_auto_uses_mxu_engine(rng):
    from digital_signal_processsing_tpu.ops.fir import fir_filter
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    x = rng.normal(size=30_000).astype(np.float32)
    fir_filter(x, np.ones(257, np.float32) / 257)
    assert last_choice("fir_filter") == "direct"
    h = rng.normal(size=8193).astype(np.float32) / 91
    y = np.asarray(fir_filter(x, h))
    assert last_choice("fir_filter") == "overlap_save"
    from digital_signal_processsing_tpu.ops.fir import fir_direct

    want = np.asarray(fir_direct(x, h))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-4


def test_pick_factored_nfft():
    assert pick_factored_nfft(9000) == 9088
    assert pick_factored_nfft(9216) == 9216


def test_fused_matches_composed_and_traced_fallback(rng):
    # the explicit dense-DFT engine matches cuFFT-style overlap-save; traced
    # taps take the same auto route as concrete ones
    import jax

    from digital_signal_processsing_tpu.ops.fft_mxu import overlap_save_mxu
    from digital_signal_processsing_tpu.ops.fir import fir_filter, fir_overlap_save
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    x = rng.normal(size=(2, 30_000)).astype(np.float32)
    h = rng.normal(size=8193).astype(np.float32) / 91
    a = np.asarray(fir_overlap_save(x, h, block=24448))
    b = np.asarray(overlap_save_mxu(x, h, block=24448))
    assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 1e-5
    jax.jit(lambda v, t: fir_filter(v, t))(x, h).block_until_ready()
    assert last_choice("fir_filter") == "overlap_save"


def test_fused_nfft_cap(rng):
    from digital_signal_processsing_tpu.ops.fir import fir_direct, fir_filter

    # the removed fused engine's name is an unknown method
    with pytest.raises(ValueError, match="unknown FIR method"):
        fir_filter(np.zeros(4096, np.float32), np.ones(8192, np.float32),
                   method="overlap_save_fused")
    x = rng.normal(size=60_000).astype(np.float32)
    h = rng.normal(size=8192).astype(np.float32) / 91
    y = np.asarray(fir_filter(x, h))
    want = np.asarray(fir_direct(x, h))
    assert np.max(np.abs(y - want)) / np.max(np.abs(want)) < 1e-4


def test_fused3_long_taps_match_scipy(rng):
    # long taps through the explicit dense-DFT overlap-save engine
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.fir import fir_filter

    x = rng.normal(size=(2, 120_000)).astype(np.float32)
    h = (rng.normal(size=16_384) / 128).astype(np.float32)
    got = np.asarray(fir_filter(x, h, method="overlap_save_mxu"))
    want = sps.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64))
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < 1e-4, err


def test_fused3_block_alignment_rejected(rng):
    from digital_signal_processsing_tpu.ops.fft_mxu import _pick_large_factor

    # a length with no balanced 128-multiple split is rejected up front
    # (65537 is prime); checked on the host, nothing is allocated
    with pytest.raises(ValueError, match="factorization"):
        _pick_large_factor(128 * 128 * 65537)
    with pytest.raises(ValueError, match="16384"):
        _pick_large_factor(128 * 127)


def test_auto_dispatch_long_taps_stay_fused(rng):
    # k past the crossover routes to overlap-save on jnp.fft
    import scipy.signal as sps

    from digital_signal_processsing_tpu.ops.fir import fir_filter
    from digital_signal_processsing_tpu.utils.dispatch import last_choice

    x = rng.normal(size=(2, 100_000)).astype(np.float32)
    h = (rng.normal(size=16_384) / 128).astype(np.float32)
    got = np.asarray(fir_filter(x, h))
    assert last_choice("fir_filter") == "overlap_save"
    want = sps.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64))
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < 1e-4, err
