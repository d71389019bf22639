"""Build a CUDA source of ``kajo_tpu_torch/csrc`` into a shared library at
first use, and load it with ctypes.

The sources have a plain C interface (no PyTorch headers), so ``nvcc`` builds
one in seconds. The library goes to ``build/kernels/`` at the root of the
checkout, under a name that carries a hash of the source and the flags: a
changed source builds anew, an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: no multiply-add contraction, so every float operation rounds
# as the plain PyTorch twin's does and the two agree to the last bit on the
# card (fast math and FMA are later, measured optimisations)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.insert(0, os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` with NVCC_FLAGS goes
    (the name hashes the source, the headers of ``csrc/`` and the flags)."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / source).read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` unless its library exists, then load it.
    Raises RuntimeError with the compiler's output when the build fails.
    ptxas' register and spill report goes beside the library, as ``.log``."""
    so = library_path(source)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
