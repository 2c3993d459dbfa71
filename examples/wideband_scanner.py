"""Scan a wideband capture: PFB channelize, demodulate everything at once.

Runs on CPU or GPU:  python examples/wideband_scanner.py
On a multi-device mesh the same call scales with no code changes:
feed a time-sharded input (see models/wideband.py docstring).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from digital_signal_processsing_tpu.models import WidebandConfig, WidebandFmReceiver


def main() -> None:
    n = 32  # channels across the captured band
    rx = WidebandFmReceiver(WidebandConfig(n_channels=n, audio_taps=33, squelch=0.2))

    # synthesize a band with two active FM stations (channels 5 and 19)
    t = n * 4096
    idx = np.arange(t)
    x = 0.01 * np.random.default_rng(0).normal(size=t)
    for k, f_msg in [(5, 0.002), (19, 0.0035)]:
        msg = np.sin(2 * np.pi * f_msg * idx)
        x += np.cos(2 * np.pi * (k / n) * idx + 0.1 / n * 2 * np.pi * np.cumsum(msg))
    x = x.astype(np.float32)

    audio = np.asarray(rx(x))
    power = np.mean(audio[:, 256:] ** 2, axis=1)
    live = np.nonzero(power > 1e-9)[0]
    print(f"wideband: {t} samples -> {audio.shape} audio; live channels: {live}")
    for k in live:
        a = audio[k, 256:] - audio[k, 256:].mean()
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        print(f"  channel {k:2d}: strongest audio bin {int(np.argmax(spec))}")


if __name__ == "__main__":
    main()
