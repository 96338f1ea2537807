"""Canonical serialization and SRS checkpoints, in PyTorch.

The Fr/G1/G2 codecs and the proof codec are a JAX-free copy of
`sonic_tpu/serial.py` (its lines 28-224, unchanged). `save_srs` and
`load_srs` are rewritten for torch tensors and keep the reference's file
layout, so a checkpoint written by either package loads in the other.

Encodings (ZCash/IETF convention):

  Fr: 32-byte little-endian.
  Fq: 48-byte big-endian (inside point encodings).
  G1 compressed: 48 bytes; MSB flags: bit7 compressed=1, bit6 infinity,
     bit5 y-sign (lexicographically largest y).
  G2 compressed: 96 bytes (c1 limb first, same flags on the first byte).

SRS checkpoint: a numpy .npz of the device tables as the reference stores
them (16-bit limbs in uint32, G1 coordinates (rows, 24), G2 (rows, 2, 24),
inf flags bool), plus `h_rows_json` for a verifier-mode SRS.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

from .device import resolve
from .fields.constants import Q_MOD, R_MOD
from . import golden_protocol as gp


def fr_to_bytes(v: int) -> bytes:
    return int(v % R_MOD).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= R_MOD:
        raise ValueError("Fr encoding out of range")
    return v


def _y_is_large(y: int) -> bool:
    return y > (Q_MOD - 1) // 2


def g1_to_bytes(p) -> bytes:
    """Compressed G1 (48 bytes)."""
    if p is None:
        out = bytearray(48)
        out[0] = 0b1100_0000
        return bytes(out)
    x, y = p
    out = bytearray(int(x).to_bytes(48, "big"))
    out[0] |= 0b1000_0000
    if _y_is_large(y):
        out[0] |= 0b0010_0000
    return bytes(out)


def _sqrt_fq(a: int) -> int | None:
    """Square root in Fq (q % 4 == 3 -> a^((q+1)/4))."""
    r = pow(a, (Q_MOD + 1) // 4, Q_MOD)
    return r if r * r % Q_MOD == a % Q_MOD else None


def g1_from_bytes(b: bytes):
    if len(b) != 48:
        raise ValueError("G1 encoding must be 48 bytes")
    flags = b[0]
    if not flags & 0b1000_0000:
        raise ValueError("only compressed encodings supported")
    if flags & 0b0100_0000:
        return None
    x = int.from_bytes(bytes([flags & 0b0001_1111]) + b[1:], "big")
    y = _sqrt_fq((x * x * x + 4) % Q_MOD)
    if y is None:
        raise ValueError("invalid G1 x-coordinate")
    if _y_is_large(y) != bool(flags & 0b0010_0000):
        y = Q_MOD - y
    return (x, y)


def g2_to_bytes(p) -> bytes:
    """Compressed G2 (96 bytes, c1 || c0 big-endian)."""
    if p is None:
        out = bytearray(96)
        out[0] = 0b1100_0000
        return bytes(out)
    (x0, x1), (y0, y1) = p
    out = bytearray(int(x1).to_bytes(48, "big") + int(x0).to_bytes(48, "big"))
    out[0] |= 0b1000_0000
    if (y1, y0) > (Q_MOD - y1 if y1 else 0, (Q_MOD - y0) % Q_MOD):
        # lexicographic sign on (c1, c0)
        out[0] |= 0b0010_0000
    return bytes(out)


def _fq2_sqrt(a):
    """Square root in Fq2 via the complex method (q % 4 == 3)."""
    from .golden import fq2_mul, fq2_inv

    a0, a1 = a
    if a1 == 0:
        r = _sqrt_fq(a0)
        if r is not None:
            return (r, 0)
        # sqrt of non-residue: a0 = -(b^2) -> sqrt = b*u
        r = _sqrt_fq((-a0) % Q_MOD)
        return (0, r) if r is not None else None
    alpha = (a0 * a0 + a1 * a1) % Q_MOD  # norm
    s = _sqrt_fq(alpha)
    if s is None:
        return None
    delta = (a0 + s) * pow(2, -1, Q_MOD) % Q_MOD
    x0 = _sqrt_fq(delta)
    if x0 is None:
        delta = (a0 - s) * pow(2, -1, Q_MOD) % Q_MOD
        x0 = _sqrt_fq(delta)
        if x0 is None:
            return None
    x1 = a1 * pow(2 * x0, -1, Q_MOD) % Q_MOD
    return (x0, x1)


def g2_from_bytes(b: bytes):
    if len(b) != 96:
        raise ValueError("G2 encoding must be 96 bytes")
    flags = b[0]
    if not flags & 0b1000_0000:
        raise ValueError("only compressed encodings supported")
    if flags & 0b0100_0000:
        return None
    x1 = int.from_bytes(bytes([flags & 0b0001_1111]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:], "big")
    from .golden import fq2_mul, fq2_add, fq2_sqr

    x = (x0, x1)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), (4, 4))
    y = _fq2_sqrt(rhs)
    if y is None:
        raise ValueError("invalid G2 x-coordinate")
    y0, y1 = y
    large = (y1, y0) > ((Q_MOD - y1) % Q_MOD, (Q_MOD - y0) % Q_MOD)
    if large != bool(flags & 0b0010_0000):
        y = ((Q_MOD - y0) % Q_MOD, (Q_MOD - y1) % Q_MOD)
    return ((x0, x1), y)


# ---------------------------------------------------------------------------
# Proof serialization
# ---------------------------------------------------------------------------


def proof_to_bytes(proof: gp.Proof) -> bytes:
    """Flat binary proof encoding (length-prefixed hsc sections)."""
    head = b"".join(
        [
            g1_to_bytes(proof.pr_r),
            g1_to_bytes(proof.pr_t),
            fr_to_bytes(proof.pr_a),
            g1_to_bytes(proof.pr_wa),
            fr_to_bytes(proof.pr_b),
            g1_to_bytes(proof.pr_wb),
            g1_to_bytes(proof.pr_wt),
            fr_to_bytes(proof.pr_s),
        ]
    )
    hsc = proof.pr_hsc
    m = len(hsc.hsc_s)
    body = [struct.pack("<I", m)]
    for cm, (s, w) in hsc.hsc_s:
        body += [g1_to_bytes(cm), fr_to_bytes(s), g1_to_bytes(w)]
    for s2, w2, q in hsc.hsc_w:
        body += [fr_to_bytes(s2), g1_to_bytes(w2), g1_to_bytes(q)]
    body += [
        g1_to_bytes(hsc.hsc_qv),
        g1_to_bytes(hsc.hsc_c),
        fr_to_bytes(hsc.hsc_u),
        fr_to_bytes(hsc.hsc_v),
    ]
    return head + b"".join(body)


def proof_from_bytes(data: bytes) -> gp.Proof:
    off = 0

    def take(n):
        nonlocal off
        chunk = data[off : off + n]
        off += n
        return chunk

    pr_r = g1_from_bytes(take(48))
    pr_t = g1_from_bytes(take(48))
    pr_a = fr_from_bytes(take(32))
    pr_wa = g1_from_bytes(take(48))
    pr_b = fr_from_bytes(take(32))
    pr_wb = g1_from_bytes(take(48))
    pr_wt = g1_from_bytes(take(48))
    pr_s = fr_from_bytes(take(32))
    (m,) = struct.unpack("<I", take(4))
    hsc_s = []
    for _ in range(m):
        cm = g1_from_bytes(take(48))
        s = fr_from_bytes(take(32))
        w = g1_from_bytes(take(48))
        hsc_s.append((cm, (s, w)))
    hsc_w = []
    for _ in range(m):
        s2 = fr_from_bytes(take(32))
        w2 = g1_from_bytes(take(48))
        q = g1_from_bytes(take(48))
        hsc_w.append((s2, w2, q))
    qv = g1_from_bytes(take(48))
    c = g1_from_bytes(take(48))
    u = fr_from_bytes(take(32))
    v = fr_from_bytes(take(32))
    return gp.Proof(
        pr_r, pr_t, pr_a, pr_wa, pr_b, pr_wb, pr_wt, pr_s,
        gp.HscProof(hsc_s, hsc_w, qv, c, u, v),
    )


# ---------------------------------------------------------------------------
# SRS checkpoint (device tables as raw uint32 arrays)
# ---------------------------------------------------------------------------


def save_srs(path: str, srs) -> None:
    """Checkpoint a device SRS to <path> (numpy .npz container).

    A full SRS saves all four tables; a verifier-mode SRS saves the two G1
    tables plus its h-row cache as JSON, everything pcV will ever read.
    Table bytes are stored uncompressed: curve coordinates are high-entropy.
    """
    arrays = {"d": srs.d}
    names = ("g_x", "g_ax") if srs.h_x is None else ("g_x", "g_ax", "h_x", "h_ax")
    for name in names:
        tab = getattr(srs, name)
        arrays[f"{name}_x"] = tab.x.cpu().numpy().astype(np.uint32)
        arrays[f"{name}_y"] = tab.y.cpu().numpy().astype(np.uint32)
        arrays[f"{name}_inf"] = tab.inf.cpu().numpy()
    if srs.h_x is None:
        rows = [{"kind": kind, "e": e, "point": pt} for (kind, e), pt in srs.h_rows.items()]
        arrays["h_rows_json"] = np.frombuffer(json.dumps(rows).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_srs(path: str, device=None):
    """A checkpoint of either package -> the port's SRS on `device` (None:
    the card)."""
    from .curve.group import Affine
    from .srs import SRS

    device = resolve(device)

    def tensor(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    with np.load(path) as z:
        d = int(z["d"])
        full = "h_x_x" in z
        names = ("g_x", "g_ax", "h_x", "h_ax") if full else ("g_x", "g_ax")
        tabs = {
            name: Affine(
                tensor(z[f"{name}_x"]),
                tensor(z[f"{name}_y"]),
                torch.from_numpy(np.asarray(z[f"{name}_inf"], bool)).to(device),
            )
            for name in names
        }
        if full:
            return SRS(d, **tabs)
        srs = SRS(d, tabs["g_x"], tabs["g_ax"])
        for row in json.loads(bytes(z["h_rows_json"]).decode()):
            pt = row["point"]
            if pt is not None:
                # JSON turns tuples into lists; pcV compares against host
                # tuple points, so restore ((x0,x1),(y0,y1)) exactly.
                pt = (tuple(pt[0]), tuple(pt[1]))
            srs.h_rows[(row["kind"], int(row["e"]))] = pt
    return srs
