"""Pulse-Doppler radar: compress a CPI, map range-Doppler, CFAR-detect.

Runs on CPU or GPU:  python examples/radar_rangedoppler.py

Synthesizes a coherent processing interval with three moving targets in
noise, runs the full models.radar chain (batched matched filter →
slow-time Doppler FFT → exact-edge CA-CFAR) and prints where the detector
fired versus the truth.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from digital_signal_processsing_tpu.models import RadarConfig, radar


def main() -> None:
    cfg = RadarConfig(
        n_pulses=64,
        n_range=4096,
        pulse_len=256,
        guard=(2, 3),
        train=(4, 10),
        pfa=1e-6,
    )
    # (range bin, doppler in cycles/PRI, amplitude)
    targets = [(500, 0.20, 1.0), (1800, -0.31, 0.5), (3000, 0.05, 0.25)]
    i, q = radar.synthesize(cfg, targets, noise_power=0.05, seed=42)

    det, power, thresh = radar.detect(cfg, i, q)
    det = np.asarray(det)
    power = np.asarray(power)

    print(f"CPI {cfg.n_pulses}x{cfg.n_range} -> map {power.shape}, "
          f"{int(det.sum())} detection cells")
    hits = 0
    for rbin, fd, amp in targets:
        row = cfg.n_pulses // 2 + round(fd * cfg.n_pulses)
        ok = bool(det[row, rbin])
        hits += ok
        snr = 10 * np.log10(power[row, rbin] / np.median(power))
        print(f"  truth r={rbin:4d} fd={fd:+.2f} amp={amp:.2f}: "
              f"{'DETECTED' if ok else 'MISS'} (cell SNR {snr:.1f} dB)")
    assert hits == len(targets)

    # detections cluster around the truth cells
    rows, cols = np.nonzero(det)
    print(f"  detection extent: doppler rows {rows.min()}..{rows.max()}, "
          f"range bins {cols.min()}..{cols.max()}")


if __name__ == "__main__":
    main()
