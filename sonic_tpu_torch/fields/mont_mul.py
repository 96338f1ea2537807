"""Montgomery multiply: the wrapper of CUDA kernel 1 and its plain version.

Port of `sonic_tpu/fields/pallas_mul.py` (`_mont_mul_kernel`, launched by
`mont_mul`). The kernel is `csrc/mont_mul.cu`; its field arithmetic lives in
`csrc/field.cuh`, which the bucket kernel inlines too.

`mont_mul` dispatches on the device of its operands: CPU tensors take
`mont_mul_plain`, CUDA tensors launch the kernel at any batch size (the
TPU's MIN_BATCH / `wants_pallas` policy is gone) or raise. There is no
fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

import math

import torch

from . import limb
from .limb import FieldSpec

launches = 0


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """a*b*R^-1 mod N in plain torch (int64 column sums, packed carries):
    t = a*b, m = (t mod R) N' mod R, (t + m N) / R and one conditional
    subtract, the TPU kernel's steps. The last carry handles T2 = t + m N
    and T2 - N R together; whichever is >= 0 and < N R gives the result."""
    L = spec.nlimbs
    t = limb._carry(limb._conv(a, b), 2 * L, 2)
    m = limb._carry(limb._conv_const(t[..., :L], spec.toeplitz("nprime", L, t.device)), L, 2)
    mn = limb._conv_const(m, spec.toeplitz("mod", 2 * L, t.device))
    t2 = mn + t
    shifted = t2 - spec.mod_shifted(t.device)
    low, nonneg = limb._signed_low(torch.stack([t2, shifted]), 2)
    return torch.where(nonneg[1].unsqueeze(-1), low[1, ..., L:], low[0, ..., L:])


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery product of broadcastable (..., L) int64 limb tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(a, b, spec)
    return _launch(a, b, spec)


def _launch(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    global launches
    from .. import kernels

    L = spec.nlimbs
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"mont_mul: dtypes {a.dtype}, {b.dtype}; int64 limbs expected")
    if a.shape[-1] != L or b.shape[-1] != L:
        raise ValueError(f"mont_mul: last dims {a.shape[-1]}, {b.shape[-1]}; {L} expected")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    n = math.prod(shape[:-1])
    if n == 0:
        return out

    def operand(x):
        # a single element is read with stride 0 instead of being expanded
        if x.numel() == L:
            return x.contiguous(), 0
        return x.expand(shape).contiguous(), L

    (a_, sa), (b_, sb) = operand(a), operand(b)
    rc = kernels.lib().sonic_mont_mul(
        a_.data_ptr(),
        b_.data_ptr(),
        out.data_ptr(),
        n,
        L,
        sa,
        sb,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {rc}")
    launches += 1
    return out

