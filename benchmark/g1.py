"""BLS12-381 G1 in plain Python integers, for the reference: affine
points as (x, y) tuples, None for infinity, and multiples of the
generator g from a table of fixed-base windows.

Constants: draft-irtf-cfrg-pairing-friendly-curves, BLS12-381 (curve
y^2 = x^3 + 4 over Fq, generator of the order-r subgroup).
"""
from __future__ import annotations

Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
G = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
WINDOW = 8  # bits a window of the generator's table


def add(p, q):
    """p + q, affine."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return x3, (lam * (x1 - x3) - y1) % Q


def on_curve(p) -> bool:
    return p is None or (p[1] * p[1] - p[0] ** 3 - 4) % Q == 0


class FixedBase:
    """table[k][j] = j 2^(WINDOW k) g, so e g is one addition a window."""

    def __init__(self):
        self.table = []
        base = G
        for _ in range(-(-R.bit_length() // WINDOW)):
            row = [None, base]
            for _ in range(2, 1 << WINDOW):
                row.append(add(row[-1], base))
            self.table.append(row)
            base = add(row[-1], base)

    def mul(self, e: int):
        """(e mod r) g."""
        e %= R
        acc = None
        for k, row in enumerate(self.table):
            j = (e >> (WINDOW * k)) & ((1 << WINDOW) - 1)
            if j:
                acc = add(acc, row[j])
        return acc
