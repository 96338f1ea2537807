"""Structured reference string, in PyTorch.

Port of `sonic_tpu/srs.py`: the device record with `from_host`, the
verifier-mode `SRS.new`, and the h-row reads of pcV. Each (negative,
positive) power table pair is ONE G1 Affine batch indexed by exponent + d,
so a commit or opening reads a contiguous slice:

    g_x[e + d]  = g^(x^e)            e in [-d, d]
    g_ax[e + d] = g^(alpha x^e)      e in [-d, d]; the e = 0 row is the point
                  at infinity: g^alpha is deliberately omitted (SRS.hs:38-39)

The G2 side stays on the host: pcV reads only h^(x^(-d+max)), h^alpha and
h^(alpha x). Under `from_host` they come from the host SRS's G2 lists;
under `new(h_mode="verifier")` they are computed from the trapdoor. The
full device G2 tables (h_mode="full") wait for ROADMAP item 12.
"""
from __future__ import annotations

import dataclasses

import torch

from . import golden
from . import golden_protocol as gp
from .curve.group import Affine, g1
from .device import resolve
from .fields import limb
from .fields.limb import FQ, FR


@dataclasses.dataclass(frozen=True)
class SRS:
    """Device SRS: g tables are G1 Affine batches of 2d+1 rows (row =
    exponent + d); h_x / h_ax are host lists of G2 affine points with the
    same row index, or None in verifier mode, where `h_rows` holds the
    few rows pcV reads."""

    d: int
    g_x: Affine
    g_ax: Affine
    h_x: list | None = None
    h_ax: list | None = None
    h_rows: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def new(cls, d: int, x: int, alpha: int, h_mode: str = "verifier",
            n_hints=(), device=None) -> "SRS":
        """Trusted setup from the trapdoor (x, alpha), G1 tables on `device`.

        The 2(2d+1) exponent scalars of both tables go through ONE batched
        255-step double-and-add ladder and ONE batched affine conversion.
        Only h_mode="verifier" exists: pcV reads h^(x^(-d+max)) for max in
        {n, d}, h^alpha and h^(alpha x), computed here on the host from the
        trapdoor for every circuit size in `n_hints` (the trapdoor is not
        kept, so a missing size raises later). `device=None` is the card."""
        if h_mode != "verifier":
            raise ValueError(
                f"h_mode {h_mode!r}: only 'verifier' is ported; the device G2 "
                "tables wait for fixed_base_mul and Fq2 (ROADMAP)"
            )
        device = resolve(device)
        x_m = FR.from_int(x, device=device)
        alpha_m = FR.from_int(alpha, device=device)
        pos = limb.powers(x_m, FR, d + 1)  # x^0 .. x^d
        neg = limb.powers(limb.inv(x_m, FR), FR, d + 1)[1:]  # x^-1 .. x^-d
        exps = torch.cat([neg.flip(0), pos], 0)  # x^-d .. x^d
        g_aexps = limb.mul(exps, alpha_m, FR)
        g_aexps[d] = 0  # g^alpha is omitted: scalar 0 -> infinity
        scalars = limb.from_mont(torch.cat([exps, g_aexps], 0), FR)
        gen = g1.from_affine(g1.generator(device))
        aff = g1.to_affine(g1.scalar_mul(gen, scalars))
        rows = 2 * d + 1

        def part(lo):
            return Affine(aff.x[lo : lo + rows], aff.y[lo : lo + rows], aff.inf[lo : lo + rows])

        srs = cls(d, part(0), part(rows))
        P = gp.P
        for maxm in set(n_hints) | {d}:
            e = -d + maxm
            srs.h_rows[("x", e)] = golden.g2_mul(golden.G2_GEN, pow(x, e, P))
        srs.h_rows[("x", 0)] = golden.G2_GEN
        for e in (0, 1):
            srs.h_rows[("ax", e)] = golden.g2_mul(golden.G2_GEN, alpha * pow(x, e, P) % P)
        return srs

    @classmethod
    def from_host(cls, srs: gp.SRS, device=None) -> "SRS":
        """Upload a host (golden) SRS: G1 tables to `device` (None: the
        card), G2 rows kept as host lists."""
        device = resolve(device)

        def rows(neg, pos, hole_at_zero):
            return list(reversed(neg)) + ([None] if hole_at_zero else []) + list(pos)

        def g1_rows(pts):
            return Affine(
                FQ.from_int([p[0] if p else 0 for p in pts], device=device),
                FQ.from_int([p[1] if p else 0 for p in pts], device=device),
                torch.tensor([p is None for p in pts], dtype=torch.bool, device=device),
            )

        return cls(
            d=srs.d,
            g_x=g1_rows(rows(srs.g_neg_x, srs.g_pos_x, False)),
            g_ax=g1_rows(rows(srs.g_neg_ax, srs.g_pos_ax, True)),
            h_x=rows(srs.h_neg_x, srs.h_pos_x, False),
            h_ax=rows(srs.h_neg_ax, srs.h_pos_ax, False),
        )

    # -- verifier elements ------------------------------------------------------

    def h_x_at(self, e: int):
        """h^(x^e) as a host affine point (pcV's h^(x^(-d+max)))."""
        key = ("x", e)
        if key not in self.h_rows:
            if self.h_x is None:
                raise ValueError(
                    f"SRS(h_mode='verifier') holds no h^(x^{e}) row; "
                    "regenerate with this circuit size in n_hints"
                )
            self.h_rows[key] = self.h_x[e + self.d]
        return self.h_rows[key]

    def h_ax_at(self, e: int):
        key = ("ax", e)
        if key not in self.h_rows:
            if self.h_ax is None:
                raise ValueError(f"SRS(h_mode='verifier') holds no h^(alpha x^{e}) row")
            self.h_rows[key] = self.h_ax[e + self.d]
        return self.h_rows[key]
