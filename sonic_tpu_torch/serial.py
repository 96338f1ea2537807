"""JAX-free copy of the Fr/G1 codecs and the proof codec of
`sonic_tpu/serial.py` (its lines 28-76 and 151-224, unchanged). The G2
codecs and the SRS checkpoints wait for ROADMAP items 12 and 14; ROADMAP
item 16 (a lazy `sonic_tpu/__init__`) removes the copy.

Encodings (ZCash/IETF convention):

  Fr: 32-byte little-endian.
  Fq: 48-byte big-endian (inside point encodings).
  G1 compressed: 48 bytes; MSB flags: bit7 compressed=1, bit6 infinity,
     bit5 y-sign (lexicographically largest y).
"""
from __future__ import annotations

import struct

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
