"""CSV logger with the reference's exact 14-column schema.

Schema from gpu_utils.h:196-199 (kept verbatim so downstream tooling/plots
written against the reference's CSVs work unchanged):

    Algorithm,MemoryMode,N_Samples,Grade,BlockSize,H2D_ms,Compute_ms,D2H_ms,
    Total_ms,Init_ms,ColdStart_Total_ms,Bandwidth_GBs,Throughput_MSs,
    ColdStart_MSs

Differences from the reference, by design (SURVEY.md §7 "defects not to
replicate"): ONE canonical filename (the reference's binaries wrote
``benchmark_data.csv`` while its logger default and sweep banner said
``benchmark_results.csv`` — gpu_utils.h:172 vs run_benchmarks.py:115).
Append-mode with header-on-create is kept (gpu_utils.h:188) so interrupted
sweeps keep prior rows. ``MemoryMode`` carries the device staging mode
(``device_put`` vs ``donated``) in place of Standard/Unified.
"""

from __future__ import annotations

from pathlib import Path

from .profile import ProfileResult

DEFAULT_CSV = "benchmark_results.csv"

CSV_COLUMNS = (
    "Algorithm,MemoryMode,N_Samples,Grade,BlockSize,H2D_ms,Compute_ms,D2H_ms,"
    "Total_ms,Init_ms,ColdStart_Total_ms,Bandwidth_GBs,Throughput_MSs,"
    "ColdStart_MSs"
)


class CsvLogger:
    """Append-mode CSV logger (CsvLogger analog, gpu_utils.h:162-232)."""

    def __init__(self, path: str | Path = DEFAULT_CSV):
        self.path = Path(path)
        if not self.path.exists() or self.path.stat().st_size == 0:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(CSV_COLUMNS + "\n")

    def log(
        self,
        algorithm: str,
        memory_mode: str,
        num_samples: int,
        grade: int,
        block_size: int,
        result: ProfileResult,
        bytes_per_sample: int,
    ) -> None:
        r = result.averaged()
        row = (
            f"{algorithm},{memory_mode},{num_samples},{grade},{block_size},"
            f"{r.h2d_ms:.4f},{r.compute_ms:.4f},{r.d2h_ms:.4f},"
            f"{r.total_ms:.4f},{r.initialization_ms:.4f},{r.cold_total_ms:.4f},"
            f"{r.bandwidth_gbs(num_samples, bytes_per_sample):.4f},"
            f"{r.throughput_msps(num_samples):.4f},"
            f"{r.cold_throughput_msps(num_samples):.4f}"
        )
        with self.path.open("a") as f:
            f.write(row + "\n")
