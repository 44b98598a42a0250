"""Build the native libraries:

    python -m sedef_tpu.native.build           # libsedef_native.so (g++)
    python -m sedef_tpu.native.build --cuda    # CUDA gap-DP kernel (nvcc)
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).parent


def build(verbose: bool = True, sanitize: bool = False) -> pathlib.Path:
    """Build the native runtime.  ``sanitize=True`` is the reference's
    ``make sanitize`` analog (Makefile:46-49): an AddressSanitizer build
    (libsedef_native_asan.so) that the memory-safety test loads in a
    subprocess with libasan LD_PRELOADed."""
    src = HERE / "native.cc"
    if sanitize:
        out = HERE / "libsedef_native_asan.so"
        cmd = ["g++", "-std=c++17", "-O1", "-g", "-fPIC", "-shared",
               "-fsanitize=address", "-fno-omit-frame-pointer",
               str(src), "-o", str(out)]
    else:
        out = HERE / "libsedef_native.so"
        cmd = ["g++", "-std=c++17", "-O3", "-fPIC", "-shared",
               "-march=native", "-fopenmp-simd", "-funroll-loops",
               str(src), "-o", str(out)]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return out


if __name__ == "__main__":
    if "--cuda" in sys.argv:
        from .cuda import build as build_cuda
        out = build_cuda(verbose=True)
    else:
        out = build(sanitize="--sanitize" in sys.argv)
    print("built", out)
    sys.exit(0)
