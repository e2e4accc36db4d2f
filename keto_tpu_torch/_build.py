"""Build and load the port's CUDA kernels.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles ``csrc/check_kernels.cu`` into ``build/kernels/`` at the root of
the checkout (a directory ``.gitignore`` lists) the first time a kernel is
launched; the library has a plain C interface and is loaded with
``ctypes``. Nothing is built when the package is imported, and nothing but
the repository's own sources is read. A built library is reused while its
source is unchanged (the file name carries the source's hash).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "check_kernels.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds nvcc took in this process (0.0 when a built library was reused)
build_seconds = 0.0

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
#: C signature of every entry point in csrc/check_kernels.cu
_SIGNATURES = {
    "keto_seed": [_P, _I64, _I64, _I32, _I32, _P, _P, _P],
    "keto_pull": [_P, _I64, _I32, _P, _I64, _I64, _P, _P, _I32, _P, _P],
    "keto_commit": [_P, _P, _I64, _P, _P],
    "keto_close": [_P, _P],
    "keto_answer_pack": [_P, _I64, _I64, _I64, _I64, _I32, _P, _P, _P, _I32, _P, _P, _P],
}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libketo_check_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library built from the current source
    exists. Returns its path; raises with nvcc's output on failure."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(tmp), str(SOURCE),
    ]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    build_seconds = time.monotonic() - t0
    if verbose:
        print(proc.stderr.strip())
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = handle
    return _lib
