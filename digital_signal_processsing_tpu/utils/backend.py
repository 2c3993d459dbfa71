"""Which engines the running JAX backend has — the one place that knows.

Every dispatcher that can choose between a hand-written kernel and plain
XLA asks this module, never ``jax.default_backend()`` itself:

- ``gpu``: Pallas kernels through the Triton route, and XLA;
- any other backend (``cpu`` among them): XLA only.

Kernels run in the Pallas interpreter only when a test asks for it
explicitly; no production path does. A kernel that the backend
offers but fails to compile raises: nothing here routes around it.
"""

from __future__ import annotations

import jax

TRITON = "triton"
XLA = "xla"

ENGINES: dict[str, tuple[str, ...]] = {
    "gpu": (TRITON, XLA),
    "cpu": (XLA,),
}


def engines(backend: str | None = None) -> tuple[str, ...]:
    """Engines of ``backend`` (default: the running one), fastest first."""
    return ENGINES.get(backend or jax.default_backend(), (XLA,))


def has_engine(engine: str, backend: str | None = None) -> bool:
    return engine in engines(backend)


__all__ = ["ENGINES", "TRITON", "XLA", "engines", "has_engine"]
