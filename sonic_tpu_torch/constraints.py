"""Constraint system -> polynomials, in PyTorch.

Port of `sonic_tpu/constraints.py` (the single-proof builders; the batch
builders wait for `prove_batch`, ROADMAP). The prover only ever needs
r(X,1), r(X,y), s(X,y), s(u,Y), t(X,y) and k(y), so each is built directly
as a dense univariate from the assignment and weights with power ladders
and weighted sums.

Exponent layout (Constraints.hs):
  r'(X,Y) = sum_i a_i X^i Y^i + b_i X^-i Y^-i + c_i X^-(i+n) Y^-(i+n)
            + sum_{i=1..4} c_{n+i} X^-(2n+i) Y^-(2n+i)        [blinding]
  s(X,Y)  = sum_i u_i(Y) X^-i + v_i(Y) X^i + w_i(Y) X^(i+n)
  u_i(Y)  = sum_q Y^(n+q) wL[q,i];  v_i analogous (wR)
  w_i(Y)  = -Y^i - Y^-i + sum_q Y^(n+q) wO[q,i]
  k(Y)    = sum_q cs_q Y^(n+q)
  t(X,Y)  = r(X,1) (r(X,Y) + s(X,Y)) - k(Y)
"""
from __future__ import annotations

import dataclasses

import torch

from .circuit import ArithCircuit, Assignment
from .fields import limb
from .fields.limb import FR
from .poly.laurent import Laurent


@dataclasses.dataclass(frozen=True)
class DeviceCircuit:
    """Montgomery limb tensors: wL/wR/wO (Q, n, L), cs (Q, L)."""

    wL: torch.Tensor
    wR: torch.Tensor
    wO: torch.Tensor
    cs: torch.Tensor

    @property
    def n(self) -> int:
        return self.wL.shape[1]

    @property
    def q(self) -> int:
        return self.wL.shape[0]

    @classmethod
    def from_host(cls, circuit: ArithCircuit, device=None) -> "DeviceCircuit":
        w = circuit.weights
        return cls(
            wL=FR.from_int([list(r) for r in w.wL], device=device),
            wR=FR.from_int([list(r) for r in w.wR], device=device),
            wO=FR.from_int([list(r) for r in w.wO], device=device),
            cs=FR.from_int(list(circuit.cs), device=device),
        )


@dataclasses.dataclass(frozen=True)
class DeviceAssignment:
    aL: torch.Tensor  # (n, L)
    aR: torch.Tensor
    aO: torch.Tensor

    @property
    def n(self) -> int:
        return self.aL.shape[0]

    @classmethod
    def from_host(cls, a: Assignment, device=None) -> "DeviceAssignment":
        return cls(
            aL=FR.from_int(list(a.aL), device=device),
            aR=FR.from_int(list(a.aR), device=device),
            aO=FR.from_int(list(a.aO), device=device),
        )


def r_x1_poly(assignment: DeviceAssignment, cns) -> Laurent:
    """Blinded r'(X, 1): dense over exponents [-(2n+4), n].

    cns: (4, L) blinding scalars c_{n+1..n+4} (Protocol.hs:58-62)."""
    a = assignment
    zero = a.aL.new_zeros((1, a.aL.shape[-1]))
    coeffs = torch.cat([cns.flip(0), a.aO.flip(0), a.aR.flip(0), zero, a.aL], 0)
    return Laurent(-(2 * a.n + 4), coeffs)


def r_at_y(r1: Laurent, y) -> Laurent:
    """r'(X, y) from r'(X, 1): every term of r' is (coeff) X^e Y^e, so
    substituting Y = y scales the X^e coefficient by y^e."""
    pows = limb.powers(y, FR, r1.length)
    scale = limb.mul(pows, limb.pow_int(y, FR, r1.offset), FR)
    return Laurent(r1.offset, limb.mul(r1.coeffs, scale, FR))


def _weighted(yq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_q yq[q] * w[q, i]: yq (Q, ..., L), w (Q, n, L) -> (..., n, L)."""
    batch = yq.dim() - 2
    w = w.reshape((w.shape[0],) + (1,) * batch + w.shape[1:])
    return limb.sum_mod(limb.mul(yq.unsqueeze(-2), w, FR), FR, axis=0)


def _s_at_y_coeffs(circuit: DeviceCircuit, y) -> torch.Tensor:
    """y (..., L) -> s(X, y) coefficients (..., 3n+1, L) at offset -n."""
    n, q = circuit.n, circuit.q
    ypows = limb.powers(y, FR, n + q + 1)  # y^0 .. y^(n+q)
    yq = ypows[n + 1 :]  # y^(n+1) .. y^(n+q)
    u = _weighted(yq, circuit.wL)
    v = _weighted(yq, circuit.wR)
    w0 = _weighted(yq, circuit.wO)
    ypos = ypows[1 : n + 1].movedim(0, -2)  # y^1 .. y^n
    yneg = limb.powers(limb.inv(y, FR), FR, n + 1)[1:].movedim(0, -2)
    w = limb.sub(w0, limb.add(ypos, yneg, FR), FR)
    zero = u.new_zeros(u.shape[:-2] + (1, u.shape[-1]))
    return torch.cat([u.flip(-2), zero, v, w], -2)


def s_at_y(circuit: DeviceCircuit, y) -> Laurent:
    """s(X, y): dense over exponents [-n, 2n] (Constraints.hs:34-53 with
    Y := y fused in)."""
    return Laurent(-circuit.n, _s_at_y_coeffs(circuit, y))


def s_at_y_batched(circuit: DeviceCircuit, ys: torch.Tensor) -> torch.Tensor:
    """s(X, y_j) for ys (M, L) -> coefficient batch (M, 3n+1, L) at the
    common offset -n, built in one pass for the hsc helper."""
    return _s_at_y_coeffs(circuit, ys)


def s_at_u_of_y(circuit: DeviceCircuit, u) -> Laurent:
    """s(u, Y) as a polynomial in Y: dense over exponents [-n, n+Q] (the hsc
    protocol's C-polynomial, Signature.hs:48-52)."""
    n = circuit.n
    upows = limb.powers(u, FR, 2 * n + 1)  # u^0 .. u^2n
    uneg = limb.powers(limb.inv(u, FR), FR, n + 1)[1:]  # u^-1 .. u^-n
    upos = upows[1 : n + 1]
    uhi = upows[n + 1 : 2 * n + 1]  # u^(n+1) .. u^2n
    # Y^(n+q) coefficients: sum_i wL[q,i] u^-i + wR[q,i] u^i + wO[q,i] u^(i+n)
    terms = limb.add(
        limb.add(limb.mul(circuit.wL, uneg, FR), limb.mul(circuit.wR, upos, FR), FR),
        limb.mul(circuit.wO, uhi, FR),
        FR,
    )
    cq = limb.sum_mod(terms, FR, axis=1)  # (q, L)
    neg_uhi = limb.neg(uhi, FR)  # -u^(n+i), i = 1..n
    zero = cq.new_zeros((1, cq.shape[-1]))
    # ascending Y exponents: -n..-1 -> -u^(2n)..-u^(n+1); 0; 1..n; n+1..n+q
    coeffs = torch.cat([neg_uhi.flip(0), zero, neg_uhi, cq], 0)
    return Laurent(-n, coeffs)


def k_at_y(circuit: DeviceCircuit, n: int, y):
    """k(y) = sum_q cs_q y^(n+q) (Constraints.hs:67-68)."""
    yq = limb.powers(y, FR, n + circuit.q + 1)[n + 1 :]
    return limb.sum_mod(limb.mul(circuit.cs, yq, FR), FR, axis=0)
