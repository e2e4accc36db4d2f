"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers they include) is
compiled with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -c`` (one nvcc process
per source, all started together), and the objects are linked into one
shared library in ``build/kernels/`` at the root of the checkout (a
directory ``.gitignore`` lists) the first time a kernel is launched. The
library has a plain C interface and is loaded with ``ctypes``. Nothing is
built when the package is imported, and nothing but the repository's own
sources is read. A built library is reused while no source changed: its
file name carries one hash over every source's and header's name and
bytes and the compiler flags. Every run on a fresh checkout builds cold;
``chip_smoke.py`` times that build beside one nvcc over every source.
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds nvcc took in this process (0.0 when a built library was reused)
build_seconds = 0.0

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
#: C signature of every entry point in csrc/*.cu
_SIGNATURES = {
    "keto_seed": [_P, _I64, _I64, _I32, _I32, _P, _P, _P, _P],
    "keto_pull": [_P, _P, _P, _P, _I32, _P, _P, _I32, _P],
    "keto_check_run": [_P, _P, _P, _P, _I32, _P, _P, _I32, _I32, _I32, _I32, _I32, _P, _P, _I32,
                       _P, _I32, _I32, _I32, _I32, _P, _P, _P, _I32, _P, _P],
    "keto_answer_pack": [_P, _I64, _I64, _I64, _I64, _I32, _P, _P, _P, _I32, _P, _P, _P],
    "keto_label_step": [_P, _I32, _P, _I32, _I64, _P, _I64, _I32, _I32, _P, _P],
    "keto_label_witness": [_P, _I32, _P, _I32, _I64, _P, _P, _I64, _I32, _I32, _P, _P],
    "keto_sweep_run": [_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _I32,
                       _I32, _I64, _P, _I64, _P],
    "keto_covered": [_P, _I32, _I32, _P, _I32, _I32, _I32, _P, _P, _I32, _I32, _P],
    "keto_slot_set": [_P, _I32, _I32, _I64, _I32, _P],
    "keto_radix_tile": [],
    "keto_radix_hist": [_P, _I64, _P, _P],
    "keto_radix_pass": [_P, _P, _I64, _I32, _P, _P, _P, _P, _P, _P],
    "keto_list_fixpoint": [_P, _P, _P, _I32, _P, _P, _P, _I32, _I32, _P, _P, _I32, _I32, _I32, _P,
                           _P],
    "keto_shard_answer": [_P, _I64, _I32, _I64, _I64, _I64, _I64, _I32, _P, _P, _P, _I32, _P, _P,
                          _P],
    "keto_pair_gather": [_P, _I64, _I32, _I32, _P, _I64, _P, _P],
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


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return BUILD_DIR / f"libketo_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library built from the current sources
    exists. Returns its path; raises with nvcc's output on failure."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.monotonic()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, obj, proc in jobs:
        stdout, stderr = proc.communicate()
        logs.append(f"{src.name}:\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)], capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    build_seconds = time.monotonic() - t0
    if verbose:
        print("\n".join(logs).strip())
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
