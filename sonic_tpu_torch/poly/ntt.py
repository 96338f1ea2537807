"""Number-theoretic transform over Fr, in PyTorch.

Port of `sonic_tpu/poly/ntt.py`: the radix-2 transform (`_ntt_jit`,
`ntt_batched`) and `poly_mul_ntt`. Fr - 1 = 2^32 * odd, so power-of-two
sizes up to 2^32 work. Each butterfly stage is one batched Fr multiply
(kernel 1 on CUDA) plus an add and a sub over all N/2 pairs. The
reference's four-step split (`_FOUR_STEP_MIN`) kept XLA programs small;
here a product whose radix-2 transform would exceed `budget.STEP_BYTES`
at `budget.COEFF_BYTES` a coefficient takes a four-step split instead
(`_four_step`), run in batches of columns and then of rows, so that it
holds its whole arrays and one batch's temporaries: t(X, y) at n = 2^20
is a transform of 2^23, ~24 GiB in one radix-2 piece. Both give the
same Montgomery integers (exact arithmetic, canonical form).

Coefficients are (N, ..., L): trailing batch axes ride along.
"""
from __future__ import annotations

import math

import torch

from .. import budget
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


def ntt_batched(coeffs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order NTT along axis 0 of (N, ..., L) Montgomery coefficients, N a
    power of two. Does NOT apply the inverse's 1/N scaling (the sharded
    four-step transform's sub-transforms leave it to their caller)."""
    n = coeffs.shape[0]
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    if n == 1:
        return coeffs
    return _ntt(coeffs, _twiddles(n, inverse, coeffs.device), n)


def ntt(coeffs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order NTT along axis 0 of (N, ..., L) Montgomery coefficients, N a
    power of two; the inverse includes the 1/N scaling."""
    n = coeffs.shape[0]
    out = ntt_batched(coeffs, inverse)
    if inverse and n > 1:
        out = limb.mul(out, FR.from_int(pow(n, -1, C.R_MOD), device=out.device), FR)
    return out


def _twiddle_block(n: int, R: int, lo: int, hi: int, inverse: bool, device) -> torch.Tensor:
    """(R, hi - lo, L): w_N^(k1 n2) (w_N^-1 for the inverse) for k1 < R,
    lo <= n2 < hi, by power ladders: w_N^n2 for the columns, then their
    powers down the rows."""
    w = root_of_unity(n.bit_length() - 1)
    if inverse:
        w = pow(w, -1, C.R_MOD)
    col = limb.mul(limb.powers(FR.from_int(w, device=device), FR, hi - lo),
                   FR.from_int(pow(w, lo, C.R_MOD), device=device), FR)
    return limb.powers(col, FR, R)


def _four_step(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order NTT along axis 0 of (N, ..., L), N = R C a power of two,
    without the inverse's 1/N scaling, by the four-step split: x[C n1 +
    n2] at [n1, n2] of an (R, C) view; length-R transforms down the
    columns, each [k1, n2] times w_N^(k1 n2); length-C transforms along the
    rows, X[k1 + R k2] at [k2, k1] of a (C, R) view, which is the output in
    order. Columns, then rows, go in batches whose transforms take half
    the step at `budget.COEFF_BYTES` a coefficient; the other half holds
    the whole arrays (the input, the twiddled columns, the output)."""
    n, rest = x.shape[0], x.shape[1:]
    R = 1 << ((n.bit_length() - 1) // 2)
    Cc = n // R
    unit = budget.COEFF_BYTES * math.prod(rest[:-1])  # a coefficient of every trailing instance
    ones = (1,) * (len(rest) - 1)
    view = x.reshape((R, Cc) + rest)
    mid = torch.empty_like(view)  # [k1, n2]
    per = max(1, budget.STEP_BYTES // 2 // (unit * R))
    for lo in range(0, Cc, per):
        hi = min(Cc, lo + per)
        tw = _twiddle_block(n, R, lo, hi, inverse, x.device)
        mid[:, lo:hi] = limb.mul(ntt_batched(view[:, lo:hi], inverse),
                                 tw.reshape((R, hi - lo) + ones + (C.FR_LIMBS,)), FR)
        del tw
    del view
    out = x.new_empty((Cc, R) + rest)  # [k2, k1]
    per = max(1, budget.STEP_BYTES // 2 // (unit * Cc))
    for lo in range(0, R, per):
        hi = min(R, lo + per)
        out[:, lo:hi] = ntt_batched(mid[lo:hi].transpose(0, 1), inverse)
    return out.reshape((n,) + rest)


def poly_mul_ntt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of coefficient arrays (Da, ..., L) x (Db, ..., L) ->
    (Da + Db - 1, ..., L): radix-2 transforms, or four-step ones when the
    transform's length N is more than the step budget takes at
    `budget.COEFF_BYTES` a coefficient."""
    out_len = a.shape[0] + b.shape[0] - 1
    n = 1
    while n < out_len:
        n *= 2

    def padded(x):
        return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])], 0)

    if budget.COEFF_BYTES * n <= budget.STEP_BYTES:
        fc = limb.mul(ntt(padded(a)), ntt(padded(b)), FR)
        return ntt(fc, inverse=True)[:out_len]
    fa = _four_step(padded(a))
    fc = limb.mul(fa, _four_step(padded(b)), FR)
    del fa
    out = _four_step(fc, inverse=True)[:out_len]
    return limb.mul(out, FR.from_int(pow(n, -1, C.R_MOD), device=out.device), FR)
