"""The openings' division: the wrapper of CUDA kernel 4.

The kernel is `csrc/poly_div.cu`. For M instances of one Laurent span,
coefficients (M, D, 16) at `offset`, and points zs (M, 16), one call gives
each f_j(z_j) and the quotient (f_j(X) - f_j(z_j)) / (X - z_j), (M, D - 1,
16) at the same offset, in four launches whatever M and D. It was added
because the plain version (`poly/laurent.py`: `evaluate_batched` and
`_div_linear`, the JAX package's jnp) costs two Fermat ladders of 417
dependent kernel-1 launches and a log-depth prefix sum of whole-array
passes a call, and was the largest idle span of every proof.

`laurent.div_by_linear` and `laurent.div_by_linear_batched` launch it for
CUDA tensors and take the plain version for CPU ones: every CPU caller,
the tests included, runs the plain version. `launches` counts the calls.
"""
from __future__ import annotations

import functools
import math

import torch

from ..fields.limb import FR

launches = 0  # kernel-4 calls (four launches each)

BLOCK = 128  # chunks a block of the kernel: csrc/poly_div.cu BLOCK
NCONST = 10  # an instance's constants in the scratch: csrc/poly_div.cu NCONST
FILL_THREADS = 1024  # chunk threads an SM is given before the chunks grow
MIN_CHUNK, MAX_FILL_CHUNK = 16, 32


def chunk_len(M: int, D: int, sms: int) -> int:
    """K, the coefficients of one chunk, from the call's shape: at least
    16, so that a chunk's own recurrence outweighs its share of the
    in-block scans; long enough that a thread of the carry pass takes at
    most K blocks of chunks (sqrt(D) / BLOCK); and, up to 32, as long as
    M D / K chunk threads still give each of the `sms` SMs FILL_THREADS
    (on an H100, 32 beat 16 and 46-64 at the helper's M = 64 and 16, and
    16 beat 32 at M = 1, where the chunks do not fill the card)."""
    scan = math.isqrt(max(D - 1, 0) // (BLOCK * BLOCK)) + 1
    fill = min(MAX_FILL_CHUNK, M * D // (sms * FILL_THREADS))
    return max(MIN_CHUNK, scan, fill)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(name: str, x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if x.device != dev or x.dtype != torch.int64 or x.shape[-1] != FR.nlimbs:
        raise ValueError(f"div_by_linear kernel: {name} {tuple(x.shape)} {x.dtype} on {x.device}; "
                         f"int64 (..., {FR.nlimbs}) limbs on {dev} expected")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def divide(offset: int, coeffs: torch.Tensor, zs: torch.Tensor, fz: torch.Tensor | None = None):
    """Kernel 4 on CUDA tensors: coeffs (M, D, 16), zs (M, 16) -> (fz (M,
    16), quotients (M, D - 1, 16)), canonical Montgomery form. With `fz`
    (M, 16) given, it is taken as f_j(z_j) instead of being computed. The
    f_j(z_j) is subtracted at X^0 where that lies inside the span."""
    global launches
    from .. import kernels

    dev = coeffs.device
    if dev.type != "cuda":
        raise ValueError(f"div_by_linear kernel: coefficients on {dev}; a CUDA device expected")
    if coeffs.dim() != 3:
        raise ValueError(f"div_by_linear kernel: coefficients {tuple(coeffs.shape)}; (M, D, 16) expected")
    M, D = coeffs.shape[:2]
    if D < 1:
        raise ValueError("div_by_linear kernel: no coefficient to divide")
    coeffs = _aligned("coefficients", coeffs, dev)
    zs = _aligned("points", zs, dev)
    if tuple(zs.shape) != (M, FR.nlimbs):
        raise ValueError(f"div_by_linear kernel: points {tuple(zs.shape)}; ({M}, {FR.nlimbs}) expected")
    if fz is not None:
        fz = _aligned("f(z)", fz, dev)
        if tuple(fz.shape) != (M, FR.nlimbs):
            raise ValueError(f"div_by_linear kernel: f(z) {tuple(fz.shape)}; ({M}, {FR.nlimbs}) expected")
    K = chunk_len(M, D, _sms(dev.index if dev.index is not None else torch.cuda.current_device()))
    T = -(-D // K)
    fz_out = torch.empty((M, FR.nlimbs), dtype=torch.int64, device=dev)
    w = torch.empty((M, D - 1, FR.nlimbs), dtype=torch.int64, device=dev)
    # each chunk's value, each block's value and the instance's constants, 8 words each
    scratch = torch.empty((M * (T + -(-T // BLOCK) + NCONST) * 8,), dtype=torch.int32, device=dev)
    rc = kernels.lib().sonic_poly_div(
        coeffs.data_ptr(), zs.data_ptr(), 0 if fz is None else fz.data_ptr(), fz_out.data_ptr(),
        w.data_ptr(), scratch.data_ptr(), M, D, K, offset, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"div_by_linear kernel launch failed: CUDA error {rc}")
    launches += 1
    return fz_out, w
