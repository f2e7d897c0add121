"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each csrc/<name>.cu has a plain C interface. At first use it is compiled
for sm_90a into _build/<name>-<hash>.so inside the package (git-ignored),
the hash taken over the source and every header in csrc/ (the generated
fq_tables.cuh among them), so a changed source or header builds anew and
an unchanged one loads the library already there. build_all starts one nvcc per source, all at
once. A failed build raises; nothing falls back to the plain path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("sha256_pairs", "fq_mont", "fq_points")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    """A source of csrc/ did not build: no compiler, or the compiler failed."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    if found is None:
        raise KernelCompileError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{name}-{digest}.so"


def log_path(name: str) -> Path:
    """nvcc's output (ptxas register/spill report) of the last build."""
    return library_path(name).with_suffix(".log")


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(log_path(name), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        raise KernelCompileError(f"nvcc failed for {name}.cu (rc={rc}):\n"
                           + log_path(name).read_text())
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every source that has no library yet, in parallel."""
    jobs = {name: _start(name) for name in names}
    for name, job in jobs.items():
        _finish(name, job)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
