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

The host half of a check (the interner with its bulk resolve,
``keto_tpu_torch/native/ingest.cpp``, and the pack walk,
``keto_tpu_torch/native/pack.cpp``: copies of the reference's) is C++ built
with ``g++`` (``host_build``), never nvcc, into ``build/native/`` the first
time ``host_lib()`` is called, with the reference Makefile's flags
(``-O3 -std=c++20 -fPIC -Wall -Wextra -shared``, ``-lpthread``): one object
a source, compiled together, linked into one library whose name carries a
hash over the sources and the flags. A file lock in ``build/native/``
serialises the processes that reach the first build together (test
workers); the library is written to a pid-tagged file and moved into place.
A failed build or load raises.
"""

from __future__ import annotations

import ctypes
import fcntl
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

NATIVE_SRC = _PKG / "native"
HOST_BUILD_DIR = _PKG.parent / "build" / "native"
#: the host compiler; g++ 11 or later (-std=c++20's heterogeneous lookups)
CXX = "g++"
HOST_COMPILE_FLAGS = ["-O3", "-std=c++20", "-fPIC", "-Wall", "-Wextra"]
HOST_LINK_FLAGS = ["-shared", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_host_lib: Optional[ctypes.CDLL] = None
#: seconds nvcc took in this process (0.0 when a built library was reused)
build_seconds = 0.0
#: seconds g++ took in this process (0.0 when a built library was reused)
host_build_seconds = 0.0

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


_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_STR = ctypes.c_char_p
_PU32 = ctypes.POINTER(ctypes.c_uint32)
#: (restype, argtypes) of every entry point of native/*.cpp that the port
#: calls: the interner's row, columnar and UCS4 column-bundle builds, the
#: chunk-fed stream builder, the resolves and the pack walk
_HOST_SIGNATURES = {
    "graph_build": (_P, [_STR, _I64, _PI64, _I64]),
    "graph_build_columnar": (_P, [_I64, _PI64, _PU8, _PI64] + [_STR, _PI64, _PI64] * 5
                             + [_PI64, _I64]),
    "graph_build_ucs4": (_P, [_I64, _PI64, _PU8, _PI64] + [_PU32, _I64] * 5 + [_PI64, _I64]),
    "stream_build_new": (_P, [_PI64, _I64, _I64]),
    "stream_build_feed": (_I64, [_P, _STR, _I64, _I64]),
    "stream_build_finish": (_P, [_P]),
    "stream_build_abort": (None, [_P]),
    "graph_free": (None, [_P]),
    "graph_num_sets": (_I64, [_P]),
    "graph_num_leaves": (_I64, [_P]),
    "graph_num_edges": (_I64, [_P]),
    "graph_num_obj_codes": (_I64, [_P]),
    "graph_num_rel_codes": (_I64, [_P]),
    "graph_edges": (None, [_P, _PI64, _PI64]),
    "graph_release_edges": (None, [_P]),
    "graph_keys": (None, [_P, _PI64, _PI64, _PI64, _PU8]),
    "graph_resolve_set": (_I64, [_P, _I64, _STR, _I64, _STR, _I64]),
    "graph_resolve_leaf": (_I64, [_P, _STR, _I64]),
    "graph_resolve_queries": (_I64, [_P, _STR, _I64, _I64, _PI64, _PI64]),
    "graph_obj_code": (_I64, [_P, _STR, _I64]),
    "graph_rel_code": (_I64, [_P, _STR, _I64]),
    "graph_obj_str": (_P, [_P, _I64, _PI64]),
    "graph_rel_str": (_P, [_P, _I64, _PI64]),
    "graph_leaf_str": (_P, [_P, _I64, _PI64]),
    "keto_pack_walk": (_P, [_PI64, _PI32, _I64, _I64, _I64, _PI64, _PI64, _I64, _PI64, _I64,
                            _I64]),
    "keto_pack_n_seeds": (_I64, [_P]),
    "keto_pack_fetch": (None, [_P, _PI64, _PI64, _PU8]),
    "keto_pack_free": (None, [_P]),
    "keto_sink_gather": (_P, [_PI64, _PI32, _PI64, _I64]),
    "keto_gather_n": (_I64, [_P]),
    "keto_gather_fetch": (None, [_P, _PI32, _PI64]),
    "keto_gather_free": (None, [_P]),
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


def host_sources() -> list[Path]:
    return sorted(NATIVE_SRC.glob("*.cpp"))


def host_library_path() -> Path:
    h = hashlib.sha256(" ".join([CXX, *HOST_COMPILE_FLAGS, *HOST_LINK_FLAGS]).encode())
    for src in host_sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return HOST_BUILD_DIR / f"libketo_host_{h.hexdigest()[:16]}.so"


def compiler_version() -> str:
    """The first line of ``CXX --version``, or why it could not be read."""
    try:
        out = subprocess.run([CXX, "--version"], capture_output=True, text=True, timeout=30)
    except OSError as e:
        return f"{CXX}: {e}"
    return (out.stdout or out.stderr).strip().split("\n")[0]


def host_build() -> Path:
    """Compile the host library unless one built from the current sources
    and flags exists. Returns its path; raises with the compiler's output
    and version on failure."""
    global host_build_seconds
    out = host_library_path()
    if out.exists():
        return out
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(HOST_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tag = f"{out.stem}.{os.getpid()}"
        t0 = time.monotonic()
        jobs = []
        for src in host_sources():
            obj = HOST_BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [CXX, *HOST_COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)
            except OSError as e:
                raise RuntimeError(f"{CXX} could not be started: {e}") from e
            jobs.append((src, obj, proc))
        logs, failed = [], []
        for src, obj, proc in jobs:
            stdout, stderr = proc.communicate()
            logs.append(f"{src.name}:\n{stdout}{stderr}")
            if proc.returncode != 0:
                failed.append(src.name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = None
        if not failed:
            link = subprocess.run([CXX, "-o", str(tmp), *(str(obj) for _, obj, _ in jobs),
                                   *HOST_LINK_FLAGS], capture_output=True, text=True)
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        if failed or link.returncode != 0:
            tmp.unlink(missing_ok=True)
            what = f"failed on {failed}" if failed else f"link failed ({link.returncode})"
            raise RuntimeError(
                f"{CXX} {what} ({compiler_version()}):\n" + "\n".join(logs)
                + ("" if link is None else f"\n{link.stdout}{link.stderr}")
            )
        os.replace(tmp, out)
        host_build_seconds = time.monotonic() - t0
    return out


def host_lib() -> ctypes.CDLL:
    """The loaded host library (interner, bulk resolve, pack walk), built on
    first use, every entry point in ``_HOST_SIGNATURES`` declared."""
    global _host_lib
    if _host_lib is None:
        with _lock:
            if _host_lib is None:
                handle = ctypes.CDLL(str(host_build()))
                for name, (restype, argtypes) in _HOST_SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _host_lib = handle
    return _host_lib
