"""JAX-free copy of `sonic_tpu/native.py`, changed only in `_find_lib`:
the port compiles `native/pairing.cpp` for the machine it runs on instead
of loading the committed library.

Original docstring:

ctypes bindings for the native (C++) pairing library.

Build with `make -C native` (repo root). Falls back gracefully: callers use
`pairing_product_is_one`, which dispatches to C++ when the shared library
is present and to the pure-Python tower otherwise. Set SONIC_TPU_NO_NATIVE=1
to force the Python path (used by tests to cross-check both).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    """Build `native/pairing.cpp` for this host at first use and return the
    library's path (None when the source or a C++ compiler is missing).

    The committed `native/libsonic_pairing.so` was built with -march=native
    on another machine and may die with SIGILL here, so it is never loaded.
    The build goes to `sonic_tpu_torch/_build/`, named by a hash of the
    source and flags; a file lock keeps concurrent processes from building
    it twice."""
    import fcntl
    import hashlib
    import shutil
    import subprocess

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(here, "native", "pairing.cpp")
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if not os.path.exists(src) or cxx is None:
        return None
    flags = ["-O3", "-fPIC", "-std=c++17", "-shared"]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(build, exist_ok=True)
    out = os.path.join(build, f"libsonic_pairing-{digest[:16]}.so")
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run([cxx, *flags, "-o", tmp, src], check=True)
            os.replace(tmp, out)
    return out


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SONIC_TPU_NO_NATIVE"):
        return None
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.sonic_pairing_product_is_one.restype = ctypes.c_int
        lib.sonic_pairing_product_is_one.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
        ]
        lib.sonic_g1_msm.restype = None
        lib.sonic_g1_msm.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        if lib.sonic_native_ok() != 1:
            return None
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def _fq_words(v: int) -> list[int]:
    return [(v >> (64 * i)) & ((1 << 64) - 1) for i in range(6)]


def g1_msm_native(points, scalars):
    """Host Pippenger MSM over G1 affine tuples with int scalars.

    Returns the affine tuple (or None for infinity), or the sentinel
    `NotImplemented` when the native library is absent (so callers can
    fall back to the Python golden MSM)."""
    lib = get_lib()
    if lib is None:
        return NotImplemented
    n = len(points)
    pts = np.zeros(n * 12, np.uint64)
    inf = np.zeros(n, np.uint8)
    sc = np.zeros(n * 4, np.uint64)
    mask = (1 << 64) - 1
    for i, (p, s) in enumerate(zip(points, scalars)):
        if p is None or s == 0:
            inf[i] = 1
            continue
        pts[i * 12 : i * 12 + 6] = _fq_words(p[0])
        pts[i * 12 + 6 : i * 12 + 12] = _fq_words(p[1])
        for w in range(4):
            sc[i * 4 + w] = (s >> (64 * w)) & mask
    out = np.zeros(12, np.uint64)
    out_inf = np.zeros(1, np.uint8)
    lib.sonic_g1_msm(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        inf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_inf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if out_inf[0]:
        return None
    x = sum(int(w) << (64 * i) for i, w in enumerate(out[:6]))
    y = sum(int(w) << (64 * i) for i, w in enumerate(out[6:]))
    return (x, y)


def pairing_product_is_one_native(pairs) -> bool | None:
    """Native prod e(P_i, Q_i) == 1 check; None if the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(pairs)
    g1 = np.zeros(n * 12, np.uint64)
    g1_inf = np.zeros(n, np.uint8)
    g2 = np.zeros(n * 24, np.uint64)
    g2_inf = np.zeros(n, np.uint8)
    for i, (p, q) in enumerate(pairs):
        if p is None:
            g1_inf[i] = 1
        else:
            g1[i * 12 : i * 12 + 6] = _fq_words(p[0])
            g1[i * 12 + 6 : i * 12 + 12] = _fq_words(p[1])
        if q is None:
            g2_inf[i] = 1
        else:
            (x0, x1), (y0, y1) = q
            g2[i * 24 : i * 24 + 6] = _fq_words(x0)
            g2[i * 24 + 6 : i * 24 + 12] = _fq_words(x1)
            g2[i * 24 + 12 : i * 24 + 18] = _fq_words(y0)
            g2[i * 24 + 18 : i * 24 + 24] = _fq_words(y1)
    res = lib.sonic_pairing_product_is_one(
        g1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        g1_inf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        g2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        g2_inf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.c_int(n),
    )
    return bool(res)
