"""Demodulate a synthetic multi-channel FM capture with the flagship chain.

Runs on CPU or GPU:  python examples/fm_receiver.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from digital_signal_processsing_tpu.models import ChainConfig, DspChain


def synth_fm_capture(cfg: ChainConfig, t: int, message_freqs, seed=0):
    """Complex baseband with one FM station per chain channel."""
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    lo = cfg.lo_frequencies()
    iq = 0.02 * (rng.normal(size=(cfg.channels, t)) + 1j * rng.normal(size=(cfg.channels, t)))
    for ch, (f_lo, f_msg) in enumerate(zip(lo, message_freqs)):
        msg = np.sin(2 * np.pi * f_msg * n)
        phase = 2 * np.pi * f_lo * n + 0.05 * 2 * np.pi * np.cumsum(msg)
        iq[ch] += np.exp(1j * phase)
    return iq.astype(np.complex64)


def main() -> None:
    cfg = ChainConfig(channels=8, decimation=8, channel_taps=129, audio_taps=33)
    chain = DspChain(cfg)
    t = 1 << 16
    msg_freqs = np.linspace(0.0005, 0.004, cfg.channels)
    iq = synth_fm_capture(cfg, t, msg_freqs)

    # planar entry point (complex64 host transfer is not portable)
    audio = np.asarray(chain.forward_planar(iq.real.copy(), iq.imag.copy()))
    print(f"chain: {iq.shape} complex in -> {audio.shape} float audio out")

    for ch in range(cfg.channels):
        a = audio[ch, 200:] - audio[ch, 200:].mean()
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        peak = np.argmax(spec)
        expect = round(msg_freqs[ch] * cfg.decimation * a.size)
        ok = "ok" if abs(peak - expect) <= 1 else "MISS"
        print(f"  channel {ch}: message bin {peak} (expected {expect}) {ok}")


if __name__ == "__main__":
    main()
