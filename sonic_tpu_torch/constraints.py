"""Constraint system -> polynomials, in PyTorch.

Port of `sonic_tpu/constraints.py`. The prover only ever needs r(X,1),
r(X,y), s(X,y), s(u,Y), t(X,y) and k(y), so each is built directly as a
dense univariate from the assignment and weights with power ladders and
weighted sums. Every builder takes leading batch axes, so the proof-batch
builders (`r_x1_batch`, `s_at_y_batch`, ...) are the code the single-proof
forms call too: circuits stacked by `stack_circuits` along a leading proof
axis (B, ...) go through it with no loop over B.

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
import math

import numpy as np
import torch

from . import budget
from .circuit import ArithCircuit, Assignment
from .device import resolve
from .fields import constants as C
from .fields import limb
from .fields.limb import FR
from .poly.laurent import Laurent
from .utils.trace import span


@dataclasses.dataclass(frozen=True)
class DeviceCircuit:
    """Montgomery limb tensors: wL/wR/wO (Q, n, L), cs (Q, L); stacked
    circuits carry a leading proof axis (B, Q, n, L), (B, Q, L)."""

    wL: torch.Tensor
    wR: torch.Tensor
    wO: torch.Tensor
    cs: torch.Tensor

    @property
    def n(self) -> int:
        return self.wL.shape[-2]

    @property
    def q(self) -> int:
        return self.wL.shape[-3]

    @classmethod
    def from_host(cls, circuit: ArithCircuit, device=None) -> "DeviceCircuit":
        """`device=None` is the card. The weight matrices go up through
        `_weights`, the same limbs as `FR.from_int`'s."""
        device = resolve(device)
        w = circuit.weights
        return cls(
            wL=_weights(w.wL, device),
            wR=_weights(w.wR, device),
            wO=_weights(w.wO, device),
            cs=FR.from_int(list(circuit.cs), device=device),
        )


def _weights(rows, device) -> torch.Tensor:
    """A (Q, n) weight matrix of Python ints -> (Q, n, L) Montgomery limbs,
    equal to `FR.from_int`'s. A matrix of ints in [0, 2^63) (the random
    circuits' 0/1 weights) goes up as one int64 array, split into
    standard-form limbs and taken to Montgomery form (`limb.to_mont`,
    kernel 1 on the card) a row at a time; any other goes through
    `FR.from_int`, whose Python loop costs ~0.66 us a weight (201 M
    weights at n = 2^20, q = 64)."""
    try:
        a = np.array(rows, dtype=np.int64)
    except (OverflowError, ValueError, TypeError):
        a = None
    if a is None or a.ndim != 2 or bool((a < 0).any()):
        return FR.from_int([list(r) for r in rows], device=device)
    a = torch.from_numpy(a).to(device)
    out = torch.empty(a.shape + (FR.nlimbs,), dtype=torch.int64, device=device)
    shifts = torch.arange(0, 64, C.LIMB_BITS, device=device)
    for q in range(a.shape[0]):
        std = a.new_zeros((a.shape[1], FR.nlimbs))
        std[:, : shifts.numel()] = (a[q, :, None] >> shifts) & C.LIMB_MASK
        out[q] = limb.to_mont(std, FR)
    return out


@dataclasses.dataclass(frozen=True)
class DeviceAssignment:
    aL: torch.Tensor  # (n, L)
    aR: torch.Tensor
    aO: torch.Tensor

    @property
    def n(self) -> int:
        return self.aL.shape[-2]

    @classmethod
    def from_host(cls, a: Assignment, device=None) -> "DeviceAssignment":
        """`device=None` is the card."""
        device = resolve(device)
        return cls(
            aL=FR.from_int(list(a.aL), device=device),
            aR=FR.from_int(list(a.aR), device=device),
            aO=FR.from_int(list(a.aO), device=device),
        )


@span("sonic.poly.build")
def r_x1_batch(assignments: DeviceAssignment, cns: torch.Tensor) -> torch.Tensor:
    """Blinded r'(X, 1) coefficients at offset -(2n+4): assignments
    (..., n, L) and blinding (..., 4, L) -> (..., 3n+5, L); stacked
    assignments (B, n, L) give the proof batch (B, 3n+5, L)."""
    a = assignments
    zero = a.aL.new_zeros(a.aL.shape[:-2] + (1, a.aL.shape[-1]))
    return torch.cat([cns.flip(-2), a.aO.flip(-2), a.aR.flip(-2), zero, a.aL], -2)


def r_x1_poly(assignment: DeviceAssignment, cns) -> Laurent:
    """Blinded r'(X, 1): dense over exponents [-(2n+4), n].

    cns: (4, L) blinding scalars c_{n+1..n+4} (Protocol.hs:58-62)."""
    return Laurent(-(2 * assignment.n + 4), r_x1_batch(assignment, cns))


@span("sonic.poly.build")
def r_at_y_batch(coeffs: torch.Tensor, ys: torch.Tensor, offset: int) -> torch.Tensor:
    """r'(X, y) coefficients from r'(X, 1)'s: coeffs (..., D, L) at
    exponents offset.. and ys (..., L) -> coeff * y^e, (..., D, L)."""
    pows = limb.powers(ys, FR, coeffs.shape[-2]).movedim(0, -2)
    scale = limb.mul(pows, limb.pow_int(ys, FR, offset).unsqueeze(-2), FR)
    return limb.mul(coeffs, scale, FR)


def r_at_y(r1: Laurent, y) -> Laurent:
    """r'(X, y) from r'(X, 1): every term of r' is (coeff) X^e Y^e, so
    substituting Y = y scales the X^e coefficient by y^e."""
    return Laurent(r1.offset, r_at_y_batch(r1.coeffs, y, r1.offset))


def _weighted(yq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_q yq[q] * w[..., q, i]: yq (Q, *B, *M, L), w (*B, Q, n, L) ->
    (*B, *M, n, L), B the circuit's batch axes, M more batch axes of y.
    The products are formed as many q at a time as the step budget holds
    at `budget.PRODUCT_BYTES` a product (at least one q; all 64 at once
    held 32 GiB a weight matrix at n = 2^16), each slice summed and added
    to the running sum: sums mod N are exact, so the result does not
    depend on the slicing."""
    w = w.movedim(-3, 0)  # (Q, *B, n, L)
    nb = w.dim() - 3
    w = w.reshape(w.shape[: 1 + nb] + (1,) * (yq.dim() - 2 - nb) + w.shape[-2:])
    yq = yq.unsqueeze(-2)
    Q = yq.shape[0]
    per = budget.per_step(budget.PRODUCT_BYTES
                          * math.prod(torch.broadcast_shapes(yq.shape[1:-1], w.shape[1:-1])))
    acc = None
    for lo in range(0, max(Q, 1), per):
        part = limb.sum_mod(limb.mul(yq[lo : lo + per], w[lo : lo + per], FR), FR, axis=0)
        acc = part if acc is None else limb.add(acc, part, FR)
    return acc


def s_at_y_batch(circuits: DeviceCircuit, ys: torch.Tensor) -> torch.Tensor:
    """s(X, y) coefficients at offset -n: ys (*B, *M, L) for a circuit (or
    a stack) with batch axes B -> (*B, *M, 3n+1, L). Stacked circuits and
    ys (B, L) give the proof batch; ys (B, m, L) the m helper polynomials
    of each proof."""
    n, q = circuits.n, circuits.q
    ypows = limb.powers(ys, FR, n + q + 1)  # y^0 .. y^(n+q)
    yq = ypows[n + 1 :]  # y^(n+1) .. y^(n+q)
    u = _weighted(yq, circuits.wL)
    v = _weighted(yq, circuits.wR)
    w0 = _weighted(yq, circuits.wO)
    ypos = ypows[1 : n + 1].movedim(0, -2)  # y^1 .. y^n
    yneg = limb.powers(limb.inv(ys, FR), FR, n + 1)[1:].movedim(0, -2)
    w = limb.sub(w0, limb.add(ypos, yneg, FR), FR)
    zero = u.new_zeros(u.shape[:-2] + (1, u.shape[-1]))
    return torch.cat([u.flip(-2), zero, v, w], -2)


@span("sonic.poly.build")
def s_at_y(circuit: DeviceCircuit, y) -> Laurent:
    """s(X, y): dense over exponents [-n, 2n] (Constraints.hs:34-53 with
    Y := y fused in)."""
    return Laurent(-circuit.n, s_at_y_batch(circuit, y))


# the hsc helper's m polynomials s(X, y_j) of one circuit, ys (m, L) ->
# (m, 3n+1, L) at the common offset -n, built in one pass
s_at_y_batched = s_at_y_batch


@span("sonic.poly.s_uY")
def s_at_u_batch(circuits: DeviceCircuit, us: torch.Tensor) -> torch.Tensor:
    """s(u, Y) coefficients at offset -n: us (*B, L) for a circuit (or a
    stack) with batch axes B -> (*B, 2n+q+1, L). The Y^(n+q) coefficients
    are formed as many q at a time as the step budget holds at
    `budget.PRODUCT_BYTES` a (q, i) term (at least one q; all 64 at once
    held ~34 GB at n = 2^20), each q's own sum over i whatever the
    slicing."""
    n = circuits.n

    def rows(p):  # (k, *B, L) -> (*B, 1, k, L), to meet (*B, Q, n, L) weights
        return p.movedim(0, -2).unsqueeze(-3)

    upows = limb.powers(us, FR, 2 * n + 1)  # u^0 .. u^2n
    uneg = limb.powers(limb.inv(us, FR), FR, n + 1)[1:]  # u^-1 .. u^-n
    upos = upows[1 : n + 1]
    uhi = upows[n + 1 : 2 * n + 1]  # u^(n+1) .. u^2n
    # Y^(n+q) coefficients: sum_i wL[q,i] u^-i + wR[q,i] u^i + wO[q,i] u^(i+n)
    per = budget.per_step(budget.PRODUCT_BYTES * math.prod(circuits.wL.shape[:-3]) * n)
    cq = []
    for lo in range(0, max(circuits.q, 1), per):
        w = [t[..., lo : lo + per, :, :] for t in (circuits.wL, circuits.wR, circuits.wO)]
        terms = limb.add(
            limb.add(limb.mul(w[0], rows(uneg), FR), limb.mul(w[1], rows(upos), FR), FR),
            limb.mul(w[2], rows(uhi), FR),
            FR,
        )
        cq.append(limb.sum_mod(terms, FR, axis=-2))  # (*B, k, L)
        del terms
    cq = cq[0] if len(cq) == 1 else torch.cat(cq, -2)  # (*B, q, L)
    neg_uhi = limb.neg(uhi, FR).movedim(0, -2)  # -u^(n+i), i = 1..n
    zero = cq.new_zeros(cq.shape[:-2] + (1, cq.shape[-1]))
    # ascending Y exponents: -n..-1 -> -u^(2n)..-u^(n+1); 0; 1..n; n+1..n+q
    return torch.cat([neg_uhi.flip(-2), zero, neg_uhi, cq], -2)


def s_at_u_of_y(circuit: DeviceCircuit, u) -> Laurent:
    """s(u, Y) as a polynomial in Y: dense over exponents [-n, n+Q] (the hsc
    protocol's C-polynomial, Signature.hs:48-52)."""
    return Laurent(-circuit.n, s_at_u_batch(circuit, u))


@span("sonic.poly.build")
def k_at_y(circuit: DeviceCircuit, n: int, y):
    """k(y) = sum_q cs_q y^(n+q) (Constraints.hs:67-68); batched over the
    circuit's leading axes and y's."""
    yq = limb.powers(y, FR, n + circuit.q + 1)[n + 1 :]
    return limb.sum_mod(limb.mul(circuit.cs.movedim(-2, 0), yq, FR), FR, axis=0)


# stacked cs (B, Q, L) and ys (B, L) -> (B, L) k(y_b)
k_at_y_batch = k_at_y


def stack_circuits(circuits: list[DeviceCircuit]) -> DeviceCircuit:
    """B shape-identical circuits -> one DeviceCircuit with a leading proof
    axis on every tensor ((B, Q, n, L) weights, (B, Q, L) cs)."""
    return DeviceCircuit(*(torch.stack([getattr(c, f) for c in circuits]) for f in ("wL", "wR", "wO", "cs")))


def stack_assignments(assignments: list[DeviceAssignment]) -> DeviceAssignment:
    return DeviceAssignment(*(torch.stack([getattr(a, f) for a in assignments]) for f in ("aL", "aR", "aO")))
