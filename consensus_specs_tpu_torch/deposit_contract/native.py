"""ctypes bridge to the native deposit-tree accumulator (port of
consensus_specs_tpu/deposit_contract/native.py).

Loads, building on first use, csrc/deposit_tree.cpp: the C++ counterpart
of the upstream EVM deposit contract (validator_registration.v.py:
69-140). The Python model (contract.py) remains the behavioral oracle;
`NativeDepositTree` must agree with it byte for byte.

Host code, built with `g++ -O3 -shared -fPIC` into the package's
git-ignored _build/deposit_tree-<hash>.so, the hash taken over the source
and the flags (as ops/_nvcc.py keys the CUDA libraries): a changed source
builds anew, an unchanged one loads the library already there. The
compiler writes a file of its own process id, renamed into place, so
concurrent first uses do not collide. A failed build raises
KernelCompileError with the compiler's output; nothing turns the native
path off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._nvcc import BUILD, CSRC, KernelCompileError

SOURCE = CSRC / "deposit_tree.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"deposit_tree-{digest}.so"


def build() -> Path:
    """The library's path, compiling it first if it is not there."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelCompileError("g++ not found: the native deposit tree needs it")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelCompileError(f"g++ failed for {SOURCE.name} (rc={proc.returncode}):\n"
                               + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.dt_new.restype = ctypes.c_void_p
    lib.dt_free.argtypes = [ctypes.c_void_p]
    lib.dt_count.restype = ctypes.c_uint64
    lib.dt_count.argtypes = [ctypes.c_void_p]
    lib.dt_deposit.restype = ctypes.c_int
    lib.dt_deposit.argtypes = [ctypes.c_void_p] + [ctypes.c_char_p] * 3 + [ctypes.c_uint64]
    lib.dt_deposit_batch.restype = ctypes.c_int
    lib.dt_deposit_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.dt_root.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _lib = lib
    return lib


def available() -> bool:
    """True once the library is built and loaded. A failed build raises:
    this never reads False."""
    _load()
    return True


class NativeDepositTree:
    """Same surface as contract.DepositContract's accumulator core."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.dt_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dt_free(self._h)
            self._h = None

    @property
    def deposit_count(self) -> int:
        return int(self._lib.dt_count(self._h))

    def deposit(self, pubkey: bytes, withdrawal_credentials: bytes,
                signature: bytes, value_gwei: int) -> None:
        if (len(pubkey), len(withdrawal_credentials), len(signature)) != (48, 32, 96):
            raise ValueError("a deposit is a 48-byte pubkey, 32-byte credentials "
                             "and a 96-byte signature")
        rc = self._lib.dt_deposit(self._h, pubkey, withdrawal_credentials,
                                  signature, value_gwei)
        assert rc == 0, f"native deposit rejected (rc={rc})"

    def deposit_batch(self, pubkeys: np.ndarray, wcs: np.ndarray,
                      sigs: np.ndarray, values: np.ndarray) -> None:
        """Column batches: [n,48]/[n,32]/[n,96] uint8 + [n] uint64."""
        n = pubkeys.shape[0]
        shapes = [np.shape(a) for a in (pubkeys, wcs, sigs, values)]
        if shapes != [(n, 48), (n, 32), (n, 96), (n,)]:
            raise ValueError(f"deposit columns of shapes {shapes}")
        values = np.ascontiguousarray(values, dtype=np.uint64)
        rc = self._lib.dt_deposit_batch(
            self._h, n,
            np.ascontiguousarray(pubkeys, np.uint8).tobytes(),
            np.ascontiguousarray(wcs, np.uint8).tobytes(),
            np.ascontiguousarray(sigs, np.uint8).tobytes(),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        assert rc == 0, f"native batch deposit rejected (rc={rc})"

    def get_deposit_root(self) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.dt_root(self._h, out)
        return out.raw
