"""Seeded fuzz regression: random configs across every averager/FIR path.

A trimmed, deterministic version of the 180-config fuzz campaign that found
zero failures at round 1 — kept in CI so the property survives refactors.
"""

import numpy as np
import pytest

from digital_signal_processsing_tpu.golden import moving_average_golden
from digital_signal_processsing_tpu.ops import moving_average
from digital_signal_processsing_tpu.ops.fir import fir_direct
from digital_signal_processsing_tpu.ops.pallas_windowed import (
    windowed_average_pallas,
)
from digital_signal_processsing_tpu.ops.streaming import (
    moving_average_chunk,
    moving_average_init,
)

CHANNELS = [1, 2, 4, 8, 32, 128]


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_averager_paths(seed):
    rng = np.random.default_rng(1000 + seed)
    c = CHANNELS[rng.integers(len(CHANNELS))]
    frames = int(rng.integers(1, 4000))
    n = frames * c
    w = int(rng.integers(1, 2500))
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    want = moving_average_golden(x, w, c)

    for m in ("auto", "xla_direct", "xla_scan"):
        np.testing.assert_array_equal(
            np.asarray(moving_average(x, w, c, method=m)), want, err_msg=m
        )
    got = np.asarray(windowed_average_pallas(x, w, c, interpret=True))
    np.testing.assert_array_equal(got, want, err_msg="kernel")
    if c % 2 == 0:
        got = np.asarray(moving_average(x.view(np.int32), w, c))
        np.testing.assert_array_equal(got.view(np.int16), want)
    if frames > 2:
        cut = int(rng.integers(1, frames)) * c
        st = moving_average_init(w, c)
        st, y1 = moving_average_chunk(st, x[:cut], w, c)
        st, y2 = moving_average_chunk(st, x[cut:], w, c)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(y1), np.asarray(y2)]), want
        )
        # the same split through the seeded kernel
        k1 = windowed_average_pallas(x[:cut], w, c, interpret=True)
        tail = np.concatenate([np.zeros(w * c, np.int16), x[:cut]])[-w * c :]
        k2 = windowed_average_pallas(x[cut:], w, c, seed=tail, interpret=True)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(k1), np.asarray(k2)]), want
        )


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_fir(seed):
    rng = np.random.default_rng(2000 + seed)
    c = int(rng.integers(1, 5))
    t = int(rng.integers(10, 4000))
    k = int(rng.integers(1, 500))
    x = rng.normal(size=(c, t)).astype(np.float32)
    h = rng.normal(size=k).astype(np.float32)
    want = np.stack(
        [np.convolve(r.astype(np.float64), h.astype(np.float64))[:t] for r in x]
    )
    got = np.asarray(fir_direct(x, h))
    scale = np.max(np.abs(want)) + 1e-9
    assert np.max(np.abs(got - want)) / scale < 2e-4
