"""Lazy-built native substrate (ctypes around substrate.c).

Builds with the system C compiler on first use; callers fall back to the
numpy implementations when no compiler is available.  The numpy paths remain
the KAT oracle — tests assert byte equality between the two.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "substrate.c")
_SO = os.path.join(_HERE, "_substrate.so")

_lib = None
_tried = False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            cmd = ["cc", "-O3", "-march=native", "-funroll-loops",
                   "-shared", "-fPIC", "-o", _SO, _SRC]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except subprocess.CalledProcessError:
                # -march=native unsupported on some toolchains
                subprocess.run(
                    ["cc", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
                    check=True, capture_output=True)
        lib = ctypes.CDLL(_SO)
        lib.gpqhe_surf_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]
        lib.gpqhe_shake.argtypes = [
            ctypes.c_int, ctypes.c_uint8,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
        lib.gpqhe_keccak_f1600.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def surf_blocks(seed: np.ndarray, start: int, nblocks: int) -> np.ndarray | None:
    """nblocks*8 stream bytes for counters start+1..start+nblocks, or None."""
    lib = get_lib()
    if lib is None:
        return None
    seed = np.ascontiguousarray(seed, dtype=np.uint32)
    out = np.empty(nblocks * 8, dtype=np.uint8)
    lib.gpqhe_surf_blocks(
        seed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_uint64(start), ctypes.c_uint64(nblocks),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def shake(rate: int, suffix: int, data: bytes, outlen: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    inp = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(outlen, dtype=np.uint8)
    lib.gpqhe_shake(
        rate, suffix,
        inp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), outlen)
    return out.tobytes()
