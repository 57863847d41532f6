"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout (a
directory ``.gitignore`` lists), where ``<hash>`` covers the source, the
shared headers ``csrc/*.cuh`` and the flags: an edited source rebuilds, an unchanged one loads the library
already built. Nothing here runs at import time: ``nvcc`` is needed only
when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}
#: seconds each library took to build in this process (0.0 when loaded
#: from an earlier build); read by chip_smoke.py's build phase
BUILD_SECONDS: dict = {}
#: nvcc's -Xptxas -v report per library, from its build (kept beside the
#: library as ``<name>-<hash>.ptxas``)
PTXAS_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):       # shared by the sources
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library exists. Returns
    (library, temporary output, process, start time), or None."""
    out = library_path(name)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        log = out.with_suffix(".ptxas")
        if log.exists():
            PTXAS_LOG.setdefault(name, log.read_text())
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, tmp, proc, time.monotonic()


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` in ``names`` that has no library of
    the same source and flags yet: one nvcc each, all started together.
    Returns {name: library path}; raises if any build fails, after every
    nvcc it started has ended."""
    jobs = {}
    try:
        for name in names:
            jobs[name] = _start(name)
        for name, job in jobs.items():
            if job is None:
                continue
            out, tmp, proc, t0 = job
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{stdout}\n"
                                   f"{stderr}")
            out.with_suffix(".ptxas").write_text(stderr)
            os.replace(tmp, out)
            BUILD_SECONDS[name] = time.monotonic() - t0
            PTXAS_LOG[name] = stderr
    finally:
        for job in jobs.values():
            if job is not None and job[2].poll() is None:
                job[2].kill()
                job[2].wait()
    return {name: library_path(name) for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists. Returns the library path."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
