"""Public moving-average API: one function, the engines behind it.

The reference ships nine binaries, one per implementation strategy
(SURVEY.md §0); a framework ships one op with a ``method`` switch and an
``auto`` policy.

Methods:
- ``auto``            the windowed GPU kernel (ops/pallas_windowed.py)
                      where the backend has it, else ``xla_scan``
- ``xla_scan``        jnp.cumsum + windowed difference (ops/scan_xla.py)
- ``xla_direct``      lax.reduce_window O(k) sum (ops/direct_xla.py)
- ``golden``          NumPy oracle (host; for tests/debugging)

All are bit-exact against the golden model for window <= 65535.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..golden import moving_average_golden
from ..utils import backend, layout
from ..utils.dispatch import record_choice
from ..utils.numerics import MAX_EXACT_WINDOW
from .direct_xla import moving_average_reduce_window
from .pallas_windowed import windowed_average_pallas, windowed_supported
from .scan_xla import moving_average_xla

METHODS = ("auto", "xla_scan", "xla_direct", "golden")


def auto_method(window: int, channels: int, platform: str | None = None) -> str:
    """What ``method='auto'`` runs on ``platform`` (default: this backend)."""
    if backend.has_engine(backend.TRITON, platform) and windowed_supported(
        window, channels
    ):
        return "windowed"
    return "xla_scan"


def moving_average(
    x,
    window: int,
    channels: int = 1,
    *,
    method: str = "auto",
) -> jax.Array | np.ndarray:
    """Causal multi-channel moving average of a flat interleaved int16 stream.

    out[f, c] = trunc(sum(x[max(f-window+1,0)..f, c]) / window), frames
    interleaved as in the source stream. Semantics are bit-exact with the
    reference CPU model (profilable_moving_averager.cpp:14-37) for
    window <= 65535.

    An int32 ``x`` is read as the little-endian PAIR view of the int16
    stream (``np.ndarray.view(np.int32)``, as io/dataset.py's
    ``packed=True`` loaders emit it); it is unpacked on the device and the
    output is returned in the same pair view.
    """
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; options {METHODS}")
    if getattr(x, "dtype", None) == np.int32:
        if method == "golden":
            raise ValueError("packed (int32 pair-view) input needs a device method")
        x16 = jax.lax.bitcast_convert_type(jnp.asarray(x), jnp.int16).reshape(-1)
        y16 = moving_average(x16, window, channels, method=method)
        return jax.lax.bitcast_convert_type(y16.reshape(-1, 2), jnp.int32)
    if x.shape[0] % channels != 0:
        raise ValueError(
            f"stream length {x.shape[0]} not a multiple of channels {channels}"
        )
    if method != "golden":
        layout.validate_window(window, MAX_EXACT_WINDOW)
    if method == "auto":
        method = auto_method(window, channels)
    record_choice("moving_average", method)
    if method == "golden":
        return moving_average_golden(np.asarray(x), window, channels)
    if method == "windowed":
        return windowed_average_pallas(jnp.asarray(x), window, channels)
    if method == "xla_scan":
        return moving_average_xla(x, window, channels)
    return moving_average_reduce_window(x, window, channels)


__all__ = ["moving_average", "auto_method", "METHODS", "MAX_EXACT_WINDOW"]
