"""Build the port's CUDA kernels into one shared library, at first use.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are then linked into one
library with a plain C interface, loaded with :mod:`ctypes`.  The library
lands in ``build/kernels/`` at the root of the checkout, under a name that
hashes the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "beehive_checksum16": [_P, _I64, _I64, _I64, _I64, _P, _P, _P, _P],
    "beehive_rs_encode": [_P, _I64, _I64, _I64, ctypes.c_int, ctypes.c_int,
                          _P, _P, _I64, _P],
}

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbeehive_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it is already built; returns
    its path.  Compiler output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept beside it as ``<lib>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}"
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        objs.append(obj)
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = lib.with_name(f"{lib.name}.{tag}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".so.log").write_text("\n".join(log))
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every entry point's
    argument types declared (pointers and the stream as ``c_void_p``)."""
    with _lock:
        if "lib" not in _loaded:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded["lib"] = lib
        return _loaded["lib"]


def build_log() -> str:
    """What the compiler said about each kernel when the library was
    built ('' when it was built by another process)."""
    log = library_path().with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
