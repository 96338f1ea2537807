"""Number-theoretic transform over Fr, in PyTorch.

Port of `sonic_tpu/poly/ntt.py`: the radix-2 transform (`_ntt_jit`) and
`poly_mul_ntt`. Fr - 1 = 2^32 * odd, so power-of-two sizes up to 2^32 work.
Each butterfly stage is one batched Fr multiply (kernel 1 on CUDA) plus an
add and a sub over all N/2 pairs. The four-step split (`_FOUR_STEP_MIN`)
existed to keep XLA programs small and is left out.

Coefficients are (N, ..., L): trailing batch axes ride along.
"""
from __future__ import annotations

import torch

from ..fields import constants as C
from ..fields import limb
from ..fields.limb import FR

_TWIDDLE_CACHE: dict = {}


def _bit_reverse_perm(n: int) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n)
    rev = torch.zeros(n, dtype=torch.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def root_of_unity(logn: int) -> int:
    """Primitive 2^logn-th root of unity in Fr (host int)."""
    assert logn <= C.R_TWO_ADICITY
    return pow(C.ROOT_OF_UNITY_2_32, 1 << (C.R_TWO_ADICITY - logn), C.R_MOD)


def _twiddles(n: int, inverse: bool, device) -> torch.Tensor:
    """(N/2, L) Montgomery ladder w^0 .. w^(N/2 - 1), cached per size/device."""
    key = (n, inverse, torch.device(device))
    tw = _TWIDDLE_CACHE.get(key)
    if tw is None:
        w = root_of_unity(n.bit_length() - 1)
        if inverse:
            w = pow(w, -1, C.R_MOD)
        tw = limb.powers(FR.from_int(w, device=device), FR, max(n // 2, 1))
        _TWIDDLE_CACHE[key] = tw
    return tw


def _ntt(a: torch.Tensor, tw: torch.Tensor, n: int) -> torch.Tensor:
    rest = a.shape[1:]
    a = a[_bit_reverse_perm(n).to(a.device)]
    m = 1
    while m < n:
        v = a.reshape((n // (2 * m), 2, m) + rest)
        even, odd = v[:, 0], v[:, 1]
        twid = tw[:: n // (2 * m)][:m]  # w_{2m}^j, (m, L)
        twid = twid.reshape((1, m) + (1,) * (len(rest) - 1) + (C.FR_LIMBS,))
        t = limb.mul(odd, twid, FR)
        upper = limb.add(even, t, FR)
        lower = limb.sub(even, t, FR)
        a = torch.stack([upper, lower], 1).reshape((n,) + rest)
        m *= 2
    return a


def ntt(coeffs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order NTT along axis 0 of (N, ..., L) Montgomery coefficients, N a
    power of two; the inverse includes the 1/N scaling."""
    n = coeffs.shape[0]
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    if n == 1:
        return coeffs
    out = _ntt(coeffs, _twiddles(n, inverse, coeffs.device), n)
    if inverse:
        out = limb.mul(out, FR.from_int(pow(n, -1, C.R_MOD), device=out.device), FR)
    return out


def poly_mul_ntt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of coefficient arrays (Da, ..., L) x (Db, ..., L) ->
    (Da + Db - 1, ..., L)."""
    out_len = a.shape[0] + b.shape[0] - 1
    n = 1
    while n < out_len:
        n *= 2

    def padded(x):
        return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])], 0)

    fc = limb.mul(ntt(padded(a)), ntt(padded(b)), FR)
    return ntt(fc, inverse=True)[:out_len]
