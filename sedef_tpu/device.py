"""The one place that decides whether the program runs on an accelerator.

Every backend decision (device gap DPs, the mesh aligner, stage-1 device
ops, the benchmark) asks ``accelerator()`` instead of comparing backend
names itself.
"""

from __future__ import annotations

import jax


def accelerator() -> jax.Device | None:
    """The first GPU device of the default backend, or None on the CPU
    backend."""
    dev = jax.devices()[0]
    return dev if dev.platform == "gpu" else None
