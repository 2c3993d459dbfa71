"""digital_signal_processsing_tpu — a DSP framework on JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference CUDA study ``SherTheCoder/digital_signal_processsing`` (see
SURVEY.md): multi-channel causal moving-average / box-FIR filtering over
interleaved int16 audio, recast as a windowed Pallas-Triton GPU kernel with
fused windowed difference and plain-XLA spellings, plus the wider signal
chain the north-star scope demands (general FIR via overlap-save, FFT,
polyphase resampling, FM/AM demodulation, adaptive LMS filtering) sharded
over device meshes with ``shard_map`` + collective carry/halo exchange.

Subpackage map (reference analog in parentheses — file:line cites are into
/root/reference):

- ``io``       WAV codec (wav_header.h:9-84) — NumPy and native C++ paths.
- ``golden``   bit-exact NumPy golden models (profilable_moving_averager.cpp:14-37).
- ``ops``      single-device ops: XLA spellings + the windowed GPU kernel
               (basics/*.cu kernels, C9-C16 in SURVEY §2).
- ``parallel`` mesh sharding: time-block scan carry exchange, overlap-save
               halo exchange (the multi-device layer the reference lacks).
- ``harness``  phase-split profiling + CSV schema + sweep driver
               (benchmark.h, gpu_utils.h:162-232, run_benchmarks.py).
- ``models``   the averager variant zoo and the flagship DSP chain.
- ``utils``    numerics (truncating division, int32 modular-scan argument),
               layout/halo helpers (gpu_utils.h:67-160 analog).
- ``compat``   scipy.signal drop-in namespace: every public scipy.signal
               callable under its scipy name and signature, delegating to
               the package's engines (see tests/test_compat_facade.py).
"""

__version__ = "0.1.0"

__all__ = [
    "io",
    "golden",
    "ops",
    "parallel",
    "harness",
    "models",
    "utils",
    "compat",
]
