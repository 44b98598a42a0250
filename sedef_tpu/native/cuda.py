"""Loader for the CUDA gap-DP kernel (``gap_dp.cu``), called from JAX
through the XLA foreign function interface.

The shared library is built from the committed source with ``nvcc`` into
``<checkout>/.cache/cuda`` (ignored by git) at first use, or ahead of time
with ``python -m sedef_tpu.native.build --cuda``.  A failed build or load
raises: there is no silent switch to another path.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

HERE = pathlib.Path(__file__).parent
SRC = HERE / "gap_dp.cu"
OUT_DIR = HERE.parent.parent / ".cache" / "cuda"
LIB = OUT_DIR / "libsedef_gap_dp.so"
TARGET = "sedef_gap_dp"
# device bytes of direction-matrix scratch one call may hold: one slot of
# S_q * S_t bytes per resident block, reused by the block's next problem
SCRATCH_BUDGET = 8 << 30

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def build(verbose: bool = False) -> pathlib.Path:
    """Compile gap_dp.cu for Hopper (sm_90a) into ``LIB``."""
    import jax.ffi

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=OUT_DIR)
    os.close(fd)
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, str(SRC)]
    if verbose:
        print(" ".join(cmd))
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB


def load():
    """Build if stale, load, and register the FFI target (once)."""
    global _lib
    with _lock:
        if _lib is None:
            import jax.ffi

            if (not LIB.exists()
                    or LIB.stat().st_mtime < SRC.stat().st_mtime):
                build()
            lib = ctypes.CDLL(str(LIB))
            jax.ffi.register_ffi_target(
                TARGET, jax.ffi.pycapsule(lib.SedefGapDp), platform="CUDA")
            _lib = lib
    return _lib


def slot_bytes(S_q: int, S_t: int) -> int:
    """Scratch bytes for one problem of class (S_q, S_t): every row's
    in-band lanes widened to 8-lane bounds (``gap_dp.cu``)."""
    n = S_q * S_t + 16 * (S_q + S_t)
    return -(-n // 8) * 8


def gap_dp_cuda(qseq, tgt, ql, tl, match: int = 5, mis: int = -4,
                gapo: int = 40, gape: int = 1):
    """Fill + traceback of a size-class batch on the GPU.  Same arguments
    and packed-op result as ``ops.wavefront.wavefront_cigar_scan``."""
    import jax
    import jax.numpy as jnp

    load()
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    slot = slot_bytes(S_q, S_t)
    n_slots = max(1, min(B, SCRATCH_BUDGET // slot))
    call = jax.ffi.ffi_call(TARGET, (
        jax.ShapeDtypeStruct((B, -(-(S_q + S_t - 1) // 4)), jnp.uint8),
        jax.ShapeDtypeStruct((n_slots, slot), jnp.uint8)))
    ops, _ = call(jnp.asarray(qseq, jnp.int8), jnp.asarray(tgt, jnp.int8),
                  jnp.asarray(ql, jnp.int32), jnp.asarray(tl, jnp.int32),
                  match=np.int32(match), mis=np.int32(mis),
                  gapo=np.int32(gapo), gape=np.int32(gape))
    return ops
