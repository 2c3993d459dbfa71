"""The averager variant zoo: the reference's nine binaries as one registry.

Maps every reference executable (SURVEY.md §0 census) to the method of
``ops.moving_average`` that stands for it here, with the correspondence
recorded. Used by docs and the sweep; `run_variant` is the single entry
point.

| reference binary (basics/)            | zoo key       | realization here |
|---------------------------------------|---------------|------------------|
| profilable_moving_averager.cpp        | golden_cpu    | NumPy oracle (+ native C++ baseline binary) |
| profilable_parallel_averager.cu       | xla_direct    | lax.reduce_window (compiler-scheduled O(k)) |
| profilable_sm_averager.cu             | direct        | the same reduce_window: XLA tiles it |
| profilable_sm_vload2.cu               | direct        | same — XLA picks the vector width |
| profilable_sm_vload4.cu               | direct        | same |
| hillis_steele_averager.cu             | scan_hillis   | jnp.cumsum + windowed difference |
| hillis_steele_vloaded_averager.cu     | scan_hillis   | same |
| blelloch_scan_averager.cu             | scan          | ``auto``: the windowed GPU kernel on a GPU, else the cumsum |
| blelloch_scan_vloaded_averager.cu     | scan          | same |

The shared-memory, vectorized-load and in-block scan rungs are spellings
of one algorithm that XLA (or the windowed kernel, ops/pallas_windowed.py)
schedules itself, so they map onto the method that does their work.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VariantInfo:
    key: str
    method: str  # ops.moving_average method name
    reference_files: tuple[str, ...]
    work: str  # asymptotic work per element
    regime: str  # where it wins


AVERAGER_ZOO: dict[str, VariantInfo] = {
    v.key: v
    for v in [
        VariantInfo(
            "golden_cpu",
            "golden",
            ("basics/profilable_moving_averager.cpp",),
            "O(1) sliding",
            "host baseline / semantic oracle",
        ),
        VariantInfo(
            "xla_direct",
            "xla_direct",
            ("basics/profilable_parallel_averager.cu",),
            "O(k)",
            "tiny windows, zero kernel-engineering",
        ),
        VariantInfo(
            "direct",
            "xla_direct",
            (
                "basics/profilable_sm_averager.cu",
                "basics/profilable_sm_vload2.cu",
                "basics/profilable_sm_vload4.cu",
            ),
            "O(k)",
            "small windows (memory-latency regime, README.md:10-12)",
        ),
        VariantInfo(
            "scan_hillis",
            "xla_scan",
            (
                "basics/hillis_steele_averager.cu",
                "basics/hillis_steele_vloaded_averager.cu",
            ),
            "O(n) work, compiler-chosen scan",
            "ladder rung: the plain prefix-sum spelling",
        ),
        VariantInfo(
            "scan",
            "auto",
            (
                "basics/blelloch_scan_averager.cu",
                "basics/blelloch_scan_vloaded_averager.cu",
            ),
            "O(n) work, one pass",
            "every window; the flagship",
        ),
        VariantInfo(
            "xla_scan",
            "xla_scan",
            (),
            "compiler-chosen scan",
            "correctness anchor / any channel count",
        ),
    ]
}


def run_variant(key: str, x, window: int, channels: int = 1, **kw):
    from ..ops import moving_average

    if key not in AVERAGER_ZOO:
        raise KeyError(f"unknown variant {key!r}; options {sorted(AVERAGER_ZOO)}")
    return moving_average(x, window, channels, method=AVERAGER_ZOO[key].method, **kw)
