"""Build and load the port's CUDA kernels (`csrc/*.cu`).

At first use, `nvcc` compiles every `.cu` file of `csrc/` for sm_90a into
one shared library with a plain C interface, in `sonic_tpu_torch/_build/`
(git-ignored), named by a hash of the sources and flags, so an edit
rebuilds it. The library is loaded with ctypes; each C entry returns
`cudaGetLastError()` after its launch and the Python wrapper raises on a
nonzero code. Nothing here runs at import time: the CPU tests import every
module on machines without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD = os.path.join(HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def build() -> str:
    """Compile csrc/ if its hash changed; return the library's path. The
    compiler's output (ptxas register and spill counts) goes to a .log
    file beside the library."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    os.makedirs(BUILD, exist_ok=True)
    out = os.path.join(BUILD, f"libsonic_kernels-{h.hexdigest()[:16]}.so")
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                capture_output=True,
                text=True,
            )
            with open(out[:-3] + ".log", "w") as log:
                log.write(res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
            os.replace(tmp, out)
    return out


def build_log() -> str:
    with open(build()[:-3] + ".log") as f:
        return f.read()


def lib():
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(build())
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        so.sonic_mont_mul.restype = i
        so.sonic_mont_mul.argtypes = [vp, vp, vp, ll, i, ll, ll, vp]
        so.sonic_bucket_acc.restype = i
        so.sonic_bucket_acc.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        _LIB = so
    return _LIB
