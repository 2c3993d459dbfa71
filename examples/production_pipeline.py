"""Round-2 feature tour: design -> filter -> resample -> serve, at scale.

Demonstrates the production-scale paths added in round 2:
- true-minimax FIR design (design_remez) driving the auto-crossover filter
- IIR cascade at production length (the XLA associative scan)
- arbitrary-rate Farrow resampling (44.1 kHz from a 48 kHz stream)
- blocked Hilbert envelope
- dispatch observability (which kernel did `auto` pick?)

Runs on CPU in ~a minute; sizes are trimmed for the smoke test — scale T
up on real hardware.
"""

import numpy as np

import jax

from digital_signal_processsing_tpu.ops import fir, iir
from digital_signal_processsing_tpu.ops.farrow import (
    farrow_output_len,
    resample_farrow,
)
from digital_signal_processsing_tpu.ops.fft import envelope
from digital_signal_processsing_tpu.utils.dispatch import choices

T = 1 << 17  # trimmed for the CPU smoke test
rng = np.random.default_rng(0)
t = np.arange(T)
x = (
    np.sin(2 * np.pi * 0.01 * t)
    + 0.3 * np.sin(2 * np.pi * 0.23 * t)
    + 0.05 * rng.normal(size=T)
).astype(np.float32)

# 1. equiripple channel filter, applied through the auto crossover
h = fir.design_remez(201, [0, 0.05, 0.09, 1.0], [1, 0])
y = np.asarray(fir.fir_filter(x, h))
hf_in = np.abs(np.diff(x)).mean()
hf_out = np.abs(np.diff(y)).mean()
ok = hf_out < 0.3 * hf_in  # the passband tone keeps its own (small) slope
print(f"remez lowpass: HF {hf_in:.4f} -> {hf_out:.4f} "
      f"({'PASS' if ok else 'MISS'})")

# 2. IIR cascade at production length: auto -> XLA associative scan
sos = iir.design_butterworth(4, 0.1)
z = np.asarray(iir.sosfilt(sos, x))
print(f"sosfilt dispatched: {choices().get('sosfilt')} "
      f"({'PASS' if choices().get('sosfilt') == 'xla_scan' else 'MISS'})")

# 3. lock the stream to 44.1 kHz from 48 kHz (non-integer ratio)
rate = (147, 160)
y44 = np.asarray(resample_farrow(y, rate))
want_len = farrow_output_len(T, rate)
print(f"farrow 48k->44.1k: {y44.shape[0]} samples "
      f"({'PASS' if y44.shape[0] == want_len else 'MISS'}), "
      f"method={choices().get('resample_farrow')}")

# 4. envelope of the filtered narrowband signal
env = np.asarray(envelope(y))
mid = env[5000:-5000]
ok = abs(float(np.median(mid)) - 1.0) < 0.1
print(f"hilbert envelope median {np.median(mid):.3f} "
      f"({'PASS' if ok else 'MISS'})")

print("dispatch table:", choices())
print("done" if jax.default_backend() else "")
