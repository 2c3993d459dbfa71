"""Time-stretch and pitch-shift a WAV through the phase vocoder.

Runs on CPU or GPU:  python examples/audio_timestretch.py [in.wav]

Without an argument it synthesizes a two-tone test signal, writes it to a
temp WAV, then produces three outputs via the framework's WAV codec and
the STFT-engine phase vocoder: 2x slower (same pitch), 2x faster (same
pitch), and up a fifth (same duration, Farrow-resampled).
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from digital_signal_processsing_tpu.io.wav import read_wav, write_wav
from digital_signal_processsing_tpu.ops.phase_vocoder import (
    pitch_shift,
    time_stretch,
)


def main() -> None:
    if len(sys.argv) > 1:
        path = sys.argv[1]
    else:
        t = np.arange(2 * 44100)
        tone = 0.4 * np.sin(2 * np.pi * 440 / 44100 * t) + 0.2 * np.sin(
            2 * np.pi * 660 / 44100 * t
        )
        path = str(Path(tempfile.gettempdir()) / "vocoder_in.wav")
        write_wav(path, (tone * 32767).astype(np.int16), 44100, 1)
    header, samples = read_wav(path)
    x = samples.astype(np.float32) / 32768.0
    print(f"in: {path} ({x.size} samples @ {header.sample_rate} Hz)")
    outdir = Path(tempfile.gettempdir())
    for name, y in (
        ("slow2x", time_stretch(x, 0.5)),
        ("fast2x", time_stretch(x, 2.0)),
        ("fifth_up", pitch_shift(x, 1.5)),
    ):
        y = np.asarray(y)
        out = outdir / f"vocoder_{name}.wav"
        write_wav(
            str(out),
            np.clip(y * 32767, -32768, 32767).astype(np.int16),
            header.sample_rate,
            1,
        )
        print(f"  {name}: {y.size} samples -> {out}")


if __name__ == "__main__":
    main()
