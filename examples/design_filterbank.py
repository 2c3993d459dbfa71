"""Design a near-perfect-reconstruction filter bank BY GRADIENT DESCENT.

The 2x-oversampled PFB's reconstruction error is an ordinary differentiable
JAX function of its prototype filter, so optax optimizes the filter through
the bank itself — no filter-bank theory required at the call site.

Runs on CPU or GPU:  python examples/design_filterbank.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from digital_signal_processsing_tpu.ops.fir import design_lowpass
from digital_signal_processsing_tpu.ops.pfb_os import (
    design_pr_prototype,
    pfb_analyze_os,
    pfb_synthesize_os,
)


def roundtrip_snr(h, n, rng):
    import jax.numpy as jnp

    d = n // 2
    k = np.asarray(h).size
    x = rng.normal(size=d * 4096).astype(np.float32)
    yi, yq = pfb_analyze_os(x, n, jnp.asarray(h, jnp.float32))
    rec = np.asarray(
        pfb_synthesize_os(yi, yq, n, jnp.asarray(np.asarray(h) * d, jnp.float32))
    )
    a = rec[k:]
    b = x[: a.size]
    g = 2 * k
    err = a[g:-g] - b[g:-g]
    return 10 * np.log10(np.sum(b[g:-g] ** 2) / np.sum(err**2))


def main() -> None:
    n, p = 8, 8
    rng = np.random.default_rng(0)

    h_sinc = design_lowpass(p * n, 1.0 / n)
    snr_sinc = roundtrip_snr(h_sinc, n, rng)
    print(f"windowed-sinc prototype : full-band round trip {snr_sinc:5.1f} dB")

    h_opt = design_pr_prototype(n, p, steps=400)
    snr_opt = roundtrip_snr(h_opt, n, rng)
    print(f"gradient-designed        : full-band round trip {snr_opt:5.1f} dB")
    assert snr_opt > 40, "designer failed to converge"


if __name__ == "__main__":
    main()
