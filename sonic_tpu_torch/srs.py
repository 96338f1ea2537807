"""Structured reference string, in PyTorch.

Port of `sonic_tpu/srs.py`. Each (negative, positive) power table pair is
ONE Affine batch indexed by exponent + d, so a commit or opening reads a
contiguous slice:

    g_x[e + d]  = g^(x^e)            e in [-d, d]
    g_ax[e + d] = g^(alpha x^e)      e in [-d, d]; the e = 0 row is the point
                  at infinity: g^alpha is deliberately omitted (SRS.hs:38-39)
    h_x, h_ax   = the same over G2 (h_ax HAS the e = 0 row, SRS.hs:40-41)

Generation: powers of x by log-depth ladders (limb.powers), then each table
is a fixed-base windowed multiply (msm/fixed_base.py) and a batched affine
conversion, a chunk of rows at a time within the step budget. With a mesh, every rank computes the powers
and builds its slice of each table's rows; the slices are gathered, so
every rank holds the whole tables (commits read arbitrary windows of rows).
Each step is logged with its seconds under SONIC_TPU_LOG (utils/log.py).
"""
from __future__ import annotations

import dataclasses

import torch

from . import golden
from . import golden_protocol as gp
from .curve.group import Affine, g1, g2
from .device import resolve
from .fields import limb
from .fields.limb import FR
from .msm.fixed_base import chunk_rows, fixed_base_mul
from .utils.log import get_logger, phase_timer


def _rows(tab: Affine, lo: int, hi: int) -> Affine:
    return Affine(tab.x[lo:hi], tab.y[lo:hi], tab.inf[lo:hi])


@dataclasses.dataclass(frozen=True)
class SRS:
    """Device SRS: g tables are G1 Affine batches and h tables G2 Affine
    batches of 2d+1 rows (row = exponent + d). In verifier mode h_x / h_ax
    are None and `h_rows` holds the few rows pcV reads; otherwise `h_rows`
    caches the rows read so far."""

    d: int
    g_x: Affine
    g_ax: Affine
    h_x: Affine | None = None
    h_ax: Affine | None = None
    h_rows: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def new(cls, d: int, x: int, alpha: int, h_mode: str = "full", n_hints=(),
            device=None, mesh=None) -> "SRS":
        """Trusted setup from the trapdoor (x, alpha), tables on `device`
        (None: the card). With `mesh` (a 1-D DeviceMesh, parallel/mesh.py),
        every rank calls it with the same arguments, builds its share of
        each table's 2d+1 rows and gets the same whole SRS back.

        h_mode:
          "full"     - all four tables (the reference's SRS record,
                       SRS.hs:11-22; needed by to_host and full checkpoints).
          "verifier" - the G1 tables only: pcV reads h^(x^(-d+max)) for max
                       in {n, d}, h^alpha and h^(alpha x), computed here on
                       the host from the trapdoor for every circuit size in
                       `n_hints` (the trapdoor is not kept, so a missing
                       size raises later)."""
        if h_mode not in ("full", "verifier"):
            raise ValueError(f"unknown h_mode {h_mode!r}")
        device = resolve(device)
        log = get_logger("srs")
        rows = 2 * d + 1
        with phase_timer(log, "srs.powers", d=d):
            x_m = FR.from_int(x, device=device)
            alpha_m = FR.from_int(alpha, device=device)
            pos = limb.powers(x_m, FR, d + 1)  # x^0 .. x^d
            neg = limb.powers(limb.inv(x_m, FR), FR, d + 1)[1:]  # x^-1 .. x^-d
            exps = torch.cat([neg.flip(0), pos], 0)  # x^-d .. x^d
            aexps = limb.mul(exps, alpha_m, FR)
            g_aexps = aexps.clone()
            g_aexps[d] = 0  # g^alpha is omitted: scalar 0 -> infinity
            scalars = limb.from_mont(torch.cat([exps, g_aexps, aexps], 0), FR)
            _fence(log, scalars)

        def tables(group, sc):
            with phase_timer(log, f"srs.{group.name}", rows=rows):
                t = _tables(group, sc, rows, mesh)
                _fence(log, t.x)
            return _rows(t, 0, rows), _rows(t, rows, 2 * rows)

        g_x, g_ax = tables(g1, scalars[: 2 * rows])
        if h_mode == "full":
            h_x, h_ax = tables(g2, torch.cat([scalars[:rows], scalars[2 * rows :]], 0))
            return cls(d, g_x, g_ax, h_x, h_ax)
        srs = cls(d, g_x, g_ax)
        P = gp.P
        for maxm in set(n_hints) | {d}:
            e = -d + maxm
            srs.h_rows[("x", e)] = golden.g2_mul(golden.G2_GEN, pow(x, e, P))
        srs.h_rows[("x", 0)] = golden.G2_GEN
        for e in (0, 1):
            srs.h_rows[("ax", e)] = golden.g2_mul(golden.G2_GEN, alpha * pow(x, e, P) % P)
        return srs

    # -- host interop -------------------------------------------------------------

    @classmethod
    def from_host(cls, srs: gp.SRS, device=None) -> "SRS":
        """Upload a host (golden) SRS, all four tables, to `device` (None:
        the card)."""
        device = resolve(device)

        def rows(group, neg, pos, hole_at_zero):
            pts = list(reversed(neg)) + ([None] if hole_at_zero else []) + list(pos)
            return group.from_host(pts, device)

        return cls(
            d=srs.d,
            g_x=rows(g1, srs.g_neg_x, srs.g_pos_x, False),
            g_ax=rows(g1, srs.g_neg_ax, srs.g_pos_ax, True),
            h_x=rows(g2, srs.h_neg_x, srs.h_pos_x, False),
            h_ax=rows(g2, srs.h_neg_ax, srs.h_pos_ax, False),
        )

    def to_host(self) -> gp.SRS:
        """Download to the host (golden) representation: for pairing checks,
        the pinned digest and serialization round trips."""
        if self.h_x is None:
            raise ValueError(
                "SRS(h_mode='verifier') has no full h tables; generate "
                "with h_mode='full' for host interop/serialization"
            )
        d = self.d
        g_x, g_ax = g1.to_host(self.g_x), g1.to_host(self.g_ax)
        h_x, h_ax = g2.to_host(self.h_x), g2.to_host(self.h_ax)

        def neg(tab):  # exponents -1 .. -d
            return tab[d - 1 :: -1] if d else []

        return gp.SRS(
            d=d,
            g_neg_x=neg(g_x),
            g_pos_x=g_x[d:],
            h_neg_x=neg(h_x),
            h_pos_x=h_x[d:],
            g_neg_ax=neg(g_ax),
            g_pos_ax=g_ax[d + 1 :],
            h_neg_ax=neg(h_ax),
            h_pos_ax=h_ax[d:],
        )

    # -- verifier elements ----------------------------------------------------------
    # pcV touches only a handful of distinct h rows (h^(x^(-d+max)) for max
    # in {n, d}, h^alpha, h^(alpha x)) but is called 3m+4 times per verify;
    # each row is read from the device once and kept in `h_rows`.

    def h_x_at(self, e: int):
        """h^(x^e) as a host affine point (pcV's h^(x^(-d+max)))."""
        key = ("x", e)
        if key not in self.h_rows:
            if self.h_x is None:
                raise ValueError(
                    f"SRS(h_mode='verifier') holds no h^(x^{e}) row; "
                    "regenerate with this circuit size in n_hints"
                )
            self.h_rows[key] = _g2_row_to_host(self.h_x, e + self.d)
        return self.h_rows[key]

    def h_ax_at(self, e: int):
        key = ("ax", e)
        if key not in self.h_rows:
            if self.h_ax is None:
                raise ValueError(f"SRS(h_mode='verifier') holds no h^(alpha x^{e}) row")
            self.h_rows[key] = _g2_row_to_host(self.h_ax, e + self.d)
        return self.h_rows[key]


def _fence(log, t: torch.Tensor) -> None:
    """Wait for the card before a logged phase ends (only when logging)."""
    if log.mode not in ("", "0", "off", "none") and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _affine_rows(group, scalars: torch.Tensor) -> Affine:
    """s_i * generator in affine form for standard-form scalars (N, L):
    `fixed_base_mul` and one batched `to_affine` a chunk of rows at a time
    (`fixed_base.chunk_rows`), so neither holds more than a chunk's
    temporaries; affine rows do not depend on the chunking."""
    step = chunk_rows(group)
    parts = [group.to_affine(fixed_base_mul(group, scalars[i : i + step]))
             for i in range(0, scalars.shape[0], step)]
    return parts[0] if len(parts) == 1 else Affine(*(torch.cat(a) for a in zip(*parts)))


def _tables(group, scalars: torch.Tensor, rows: int, mesh) -> Affine:
    """Two tables' standard-form scalars, rows one table after the other
    (2 rows, L) -> their affine points (2 rows,). With `mesh`, each rank
    multiplies its slice of each table's rows (zero scalars pad them to a
    multiple of the world size and give infinity rows, cut off after the
    gather)."""
    if mesh is None:
        return _affine_rows(group, scalars)
    from .parallel.mesh import all_gather_rows, shard_rows

    L = scalars.shape[-1]
    two = scalars.reshape(2, rows, L)
    mine = torch.cat([shard_rows(two[0], mesh), shard_rows(two[1], mesh)], 0)  # (2 per, L)
    per = mine.shape[0] // 2
    aff = _affine_rows(group, mine)
    coord = aff.x.shape[1:]
    k = aff.x[0].numel()
    flat = torch.cat([aff.x.reshape(2 * per, k), aff.y.reshape(2 * per, k),
                      aff.inf.reshape(2 * per, 1).long()], 1)
    got = all_gather_rows(flat.reshape(1, 2, per, 2 * k + 1), mesh)  # (world, 2, per, 2k+1)
    got = got.transpose(0, 1).reshape(2, -1, 2 * k + 1)[:, :rows].reshape(2 * rows, 2 * k + 1)
    return Affine(got[:, :k].reshape((2 * rows,) + coord),
                  got[:, k : 2 * k].reshape((2 * rows,) + coord), got[:, 2 * k].bool())


def _g2_row_to_host(tab: Affine, idx: int):
    return g2.to_host(_rows(tab, idx, idx + 1))[0]


def g1_row_to_host(tab: Affine, idx: int):
    return g1.to_host(_rows(tab, idx, idx + 1))[0]
