"""Build and load the package's CUDA kernels (route (b): ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``).

Each ``csrc/<name>.cu`` compiles at first use into ``build/kernels/`` at the
repository root (listed in ``.gitignore``), named by a hash of its sources and
flags so an edited source rebuilds. Nothing here runs at import: the CPU
tests import every module on machines that have no ``nvcc``.

Every C entry point takes pointers and the stream as ``void*`` and ints as
``int``, launches on the given stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v"]

P, I = ctypes.c_void_p, ctypes.c_int
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # .cu and the shared .cuh headers
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for csrc/<name>.cu unless its library is built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish(name: str, job) -> None:
    proc, log, tmp, out = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {rc}):\n"
                           + out.with_suffix(".log").read_text())
    os.replace(tmp, out)


def build(names) -> float:
    """Compile every named source that is not built yet, one nvcc each, all
    started together. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():  # wait for every nvcc, even after a failure
        if job is not None:
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/shared-memory report) for a built source."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use, with
    ``argtypes`` set from ``signatures`` ({function: [ctypes types]})."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, args in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
