"""Multi-rank NTT: the four-step (transpose) algorithm over a mesh.

Port of `sonic_tpu/parallel/ntt_sharded.py`. Decompose N = R x C and view
the coefficients as an (R, C) matrix, a[C n1 + n2] at [n1, n2]:

  step 1  length-R NTTs down the columns   -- rank r holds C/D columns
  step 2  twiddle [k1, n2] by w_N^(k1 n2)  -- elementwise, local
  step 3  rows to ranks                    -- ONE all_to_all_single
  step 4  length-C NTTs along the rows     -- rank r holds R/D rows
  output  X[k1 + R k2] at [k2, k1]

Every rank holds the whole input (SPMD), so step 1 reads its columns with
no communication. The inverse runs the same steps with w^-1 and folds the
1/N scaling into the twiddles. `ntt_sharded` gathers the output in order
on every rank. The product keeps the spectra sharded: a rank's output
block of the forward transforms, [k2, k1] for its k1, is exactly its
column block of the (C, R) view of the spectrum, so the pointwise
product and the inverse (with R and C swapped) need no communication
before the inverse's own all_to_all; one all_gather ends it.

The output equals `poly/ntt.ntt` / `poly_mul_ntt` bit for bit, as the
same Montgomery integers.
"""
from __future__ import annotations

import torch

from ..fields import constants as C
from ..fields import limb
from ..fields.limb import FR
from ..poly import ntt as base
from .mesh import all_gather_rows, all_to_all_rows

_WN_CACHE: dict = {}


def _wn_table(n: int, inverse: bool, device) -> torch.Tensor:
    """(N, L) Montgomery ladder w_N^0 .. w_N^(N-1) (w_N^-k / N for the
    inverse), cached per size and device."""
    key = (n, inverse, torch.device(device))
    tab = _WN_CACHE.get(key)
    if tab is None:
        w = base.root_of_unity(n.bit_length() - 1)
        if inverse:
            w = pow(w, -1, C.R_MOD)
        tab = limb.powers(FR.from_int(w, device=device), FR, n)
        if inverse:
            tab = limb.mul(tab, FR.from_int(pow(n, -1, C.R_MOD), device=device), FR)
        _WN_CACHE[key] = tab
    return tab


def _split_rc(n: int) -> tuple[int, int]:
    """N = R C, both powers of two, R = 2^(floor(log2 N / 2))."""
    r = 1 << ((n.bit_length() - 1) // 2)
    return r, n // r


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def splittable(out_len: int, world: int) -> bool:
    """Whether the four-step split N = R x C of N = the power of two at or
    above out_len has world | R and world | C."""
    r, c = _split_rc(_next_pow2(out_len))
    return r % world == 0 and c % world == 0


def _four_step(x: torch.Tensor, R: int, Cc: int, mesh, inverse: bool) -> torch.Tensor:
    """This rank's column block (R, C/D, L) of the (R, C) view -> its row
    block of the transform, (C, R/D, L): [k2, i] = X[k1 + R k2] with
    k1 = r R/D + i."""
    D, r = mesh.size(), mesh.get_local_rank()
    cl, L = Cc // D, x.shape[-1]
    a = base.ntt_batched(x, inverse)  # (R, C/D, L): [k1, n2 - r C/D]
    k1 = torch.arange(R)[:, None]
    n2 = torch.arange(cl)[None, :] + r * cl
    tw = _wn_table(R * Cc, inverse, x.device)[((k1 * n2) % (R * Cc)).to(x.device)]
    a = all_to_all_rows(limb.mul(a, tw, FR), mesh)  # chunk s from rank s: its columns of my rows
    a = a.reshape(D, R // D, cl, L).permute(0, 2, 1, 3).reshape(Cc, R // D, L)
    return base.ntt_batched(a, inverse)


def _my_columns(coeffs: torch.Tensor, R: int, Cc: int, mesh) -> torch.Tensor:
    cl = Cc // mesh.size()
    r = mesh.get_local_rank()
    return coeffs.reshape(R, Cc, coeffs.shape[-1])[:, r * cl : (r + 1) * cl]


def _gather_in_order(block: torch.Tensor, mesh) -> torch.Tensor:
    """Row blocks (C, R/D, L) of every rank -> the in-order (R C, L)."""
    full = all_gather_rows(block.transpose(0, 1), mesh)  # (R, C, L): [k1, k2]
    return full.transpose(0, 1).reshape(-1, block.shape[-1])


def ntt_sharded(coeffs: torch.Tensor, mesh, inverse: bool = False) -> torch.Tensor:
    """In-order NTT of (N, L) Montgomery coefficients (N a power of two,
    the inverse scaled by 1/N) with the transforms split over the mesh;
    every rank passes the same coeffs and gets the same (N, L) back."""
    n = coeffs.shape[0]
    if n & (n - 1) or not splittable(n, mesh.size()):
        raise ValueError(f"ntt_sharded: N={n} does not four-step split over {mesh.size()} ranks")
    R, Cc = _split_rc(n)
    block = _four_step(_my_columns(coeffs, R, Cc, mesh), R, Cc, mesh, inverse)
    return _gather_in_order(block, mesh)


def poly_mul_ntt_sharded(a: torch.Tensor, b: torch.Tensor, mesh) -> torch.Tensor:
    """Full product (Da, L) x (Db, L) -> (Da + Db - 1, L): two sharded
    forward transforms, the pointwise product on each rank's block, one
    sharded inverse; the same result on every rank."""
    out_len = a.shape[0] + b.shape[0] - 1
    n = _next_pow2(out_len)
    if not splittable(n, mesh.size()):
        raise ValueError(f"poly_mul_ntt_sharded: N={n} does not four-step split over {mesh.size()} ranks")
    R, Cc = _split_rc(n)

    def spectrum(x):
        x = torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])], 0)
        return _four_step(_my_columns(x, R, Cc, mesh), R, Cc, mesh, False)

    fc = limb.mul(spectrum(a), spectrum(b), FR)  # (C, R/D, L): the (C, R) view's columns
    return _gather_in_order(_four_step(fc, Cc, R, mesh, True), mesh)[:out_len]
