"""SEDEFDBG debug channel (reference analog: the ``dprn`` macro,
common.h:33-47 — compiled out under NDEBUG and gated at runtime by the
SEDEFDBG environment variable).  Here it is always compiled but costs one
cached boolean check when off."""

from __future__ import annotations

import os
import sys

_ON = bool(os.environ.get("SEDEFDBG", ""))


def dprn(fmt: str, *args) -> None:
    """Debug print to stderr, active only when SEDEFDBG is set."""
    if _ON:
        print(fmt.format(*args) if args else fmt, file=sys.stderr,
              flush=True)


def compilation_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.cache/jax``
    (ignored by git)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".cache", "jax"))


def enable_compilation_cache() -> None:
    """Persistent XLA compilation cache for the entry points (CLI, bench,
    chip_smoke.py, tests): warm runs skip compiling each (batch, size
    class) shape again.  The only place that sets the cache; safe to call
    more than once, before first backend use."""
    import jax

    d = compilation_cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
