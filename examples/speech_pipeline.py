"""Speech analysis and resynthesis — the round-3 surface in one pipeline.

Synthesize a vowel-like "voice", then: track its pitch cepstrally,
extract the LPC spectral envelope frame-by-frame, resynthesize at a
DIFFERENT pitch (the classic vocoder), and clean a frequency-wandering
interferer with the block-adaptive tracking notch riding the
time-varying SOS kernel.

Runs on CPU or GPU:  python examples/speech_pipeline.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from digital_signal_processsing_tpu.models import adaptive
from digital_signal_processsing_tpu.ops import cepstrum, lpc


def make_voice(sr: int, n: int, f0: float) -> np.ndarray:
    """Pulse train through two formant resonators — a cartoon vowel."""
    from scipy.signal import lfilter  # synthesis only; analysis is ours

    pulses = np.zeros(n)
    pulses[:: int(sr / f0)] = 1.0
    formants = np.poly(
        [
            0.97 * np.exp(1j * 2 * np.pi * 700 / sr),
            0.97 * np.exp(-1j * 2 * np.pi * 700 / sr),
            0.95 * np.exp(1j * 2 * np.pi * 1800 / sr),
            0.95 * np.exp(-1j * 2 * np.pi * 1800 / sr),
        ]
    ).real
    return lfilter([1.0], formants, pulses).astype(np.float32)


def main() -> None:
    sr, n = 16000, 48000
    voice = make_voice(sr, n, f0=120.0)

    # 1. cepstral pitch (Noll's method on the device FFT path)
    f0 = float(np.asarray(cepstrum.cepstral_pitch(voice, fs=sr)))
    print(f"cepstral pitch estimate: {f0:.1f} Hz (true 120)")
    assert abs(f0 - 120.0) < 5.0

    # 2. LPC envelope + pitch-shifted vocoder resynthesis
    order, frame = 12, 320
    a, gain = lpc.lpc(voice, order, frame)
    nf = np.asarray(a).shape[0]
    excitation = np.zeros(nf * frame, np.float32)
    excitation[:: int(sr / 180.0)] = np.sqrt(frame)  # new pitch: 180 Hz
    shifted = np.asarray(
        lpc.lpc_synthesis(a, gain / np.sqrt(frame), excitation, frame)
    )
    f0_new = float(
        np.asarray(cepstrum.cepstral_pitch(shifted, fs=sr))
    )
    print(f"vocoded pitch: {f0_new:.1f} Hz (target 180)")
    assert abs(f0_new - 180.0) < 8.0

    # 3. the formant envelope survived the pitch shift
    spec = np.abs(np.fft.rfft(shifted * np.hanning(shifted.size)))
    freqs = np.linspace(0, sr / 2, spec.size)
    floor = np.median(spec[freqs > 4000])
    for formant in (700.0, 1800.0):
        band = spec[(freqs > formant - 120) & (freqs < formant + 120)]
        print(f"formant {formant:.0f} Hz: {20*np.log10(band.max()/floor):.1f} dB above floor")
        assert band.max() > 10 * floor

    # 4. frequency-tracking notch removes a swept interferer
    t = np.arange(n)
    sweep = 4.0 * np.sin(np.cumsum(np.pi * (0.12 + 0.2 * t / n)))
    corrupted = (voice + sweep).astype(np.float32)
    cleaned, track = adaptive.tracking_notch(corrupted, 512, q=30.0)
    cleaned = np.asarray(cleaned)
    resid_in = np.mean((corrupted - voice) ** 2)
    resid_out = np.mean((cleaned[1024:] - voice[1024:]) ** 2)
    print(
        f"interferer suppression: {10*np.log10(resid_in/resid_out):.1f} dB "
        f"(tracked {track[0]:.3f} -> {track[-1]:.3f} Nyquist)"
    )
    assert resid_out < 0.12 * resid_in

    print("speech pipeline OK")


if __name__ == "__main__":
    main()
