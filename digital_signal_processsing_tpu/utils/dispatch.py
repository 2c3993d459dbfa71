"""Auto-dispatch observability: which kernel did `method='auto'` pick?

The public ops (moving_average, sosfilt, iir_first_order, fir_filter) hide
a method ladder behind an ``auto`` policy whose fallbacks are bit-exact but
differ in perf class by 3x+ (e.g. the windowed GPU kernel -> the XLA scan
for a channel count the kernel cannot tile). A silent fallback in a user pipeline reads as a
regression with no diff to point at. This module gives the dispatchers one
place to record their choice so users (and perf tests) can observe it:

- ``last_choice(op)`` returns the most recent method an op dispatched to;
- ``choices()`` snapshots the whole table;
- set env ``DSP_LOG_DISPATCH=1`` to also print each choice to stderr
  (only when it CHANGES for an op, so hot loops don't spam).

Python-level and trace-time only: recording happens when the dispatcher
runs (first call per jit cache entry), never inside compiled code.
"""

from __future__ import annotations

import os
import sys
import threading

_lock = threading.Lock()
_choices: dict[str, str] = {}


def record_choice(op: str, method: str) -> None:
    """Called by dispatchers after resolving ``auto`` (or an explicit method)."""
    with _lock:
        changed = _choices.get(op) != method
        _choices[op] = method
    if changed and os.environ.get("DSP_LOG_DISPATCH"):
        print(f"[dsp dispatch] {op} -> {method}", file=sys.stderr)


def last_choice(op: str) -> str | None:
    """Most recent method dispatched for ``op`` (None if never called)."""
    with _lock:
        return _choices.get(op)


def choices() -> dict[str, str]:
    """Snapshot of every op's most recent dispatch choice."""
    with _lock:
        return dict(_choices)


__all__ = ["record_choice", "last_choice", "choices"]
