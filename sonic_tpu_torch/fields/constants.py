"""JAX-free copy of `sonic_tpu/fields/constants.py`. Below this docstring the code is
the original's, line for line; its relative imports resolve inside the port.

`sonic_tpu/__init__.py` imports jax whenever any of its submodules is
imported, and `sonic_tpu/` stays as it is, so the port carries its own
copy of this host module.

Original docstring:

BLS12-381 curve and field constants.

The reference (sdiehl/sonic) works over BLS12-381 via the Haskell `pairing`
package (`src/Sonic/SRS.hs:9`, `src/Sonic/Protocol.hs:15`). These constants are
the standard BLS12-381 parameters (draft-irtf-cfrg-pairing-friendly-curves);
matching them exactly is required for bit-exact parity with the reference's
group elements.

Limb layout for the TPU path: field elements are little-endian vectors of
16-bit limbs stored in uint32 lanes. 16-bit limbs are chosen so that a
limb-product fits exactly in a uint32 (no native 64-bit integer multiply on
TPU), and column sums of hi/lo-split partial products stay far below 2^32.
"""

# ---------------------------------------------------------------------------
# Field moduli
# ---------------------------------------------------------------------------

# Scalar field Fr (255 bits) — the field the reference's polynomials live in.
R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Base field Fq (381 bits) — curve coordinates.
Q_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# BLS parameter t: q and r are derived from it; |t| is also the optimal-ate
# Miller loop count. t is negative for BLS12-381.
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

# 2-adicity of r-1: r - 1 = 2^32 * odd. Enables radix-2 NTT up to 2^32.
R_TWO_ADICITY = 32
# Generator of Fr* (smallest): 7.  Root of unity of order 2^32:
R_MULT_GEN = 7
ROOT_OF_UNITY_2_32 = pow(7, (R_MOD - 1) >> 32, R_MOD)

# ---------------------------------------------------------------------------
# Curve equations: G1: y^2 = x^3 + 4 over Fq;  G2: y^2 = x^3 + 4(u+1) over Fq2
# ---------------------------------------------------------------------------
CURVE_B = 4
CURVE_B2 = (4, 4)  # 4*(u+1) = 4 + 4u in Fq2 (c0, c1)

# Standard generators (matching the Haskell `pairing` package's `gen`,
# used for every SRS element: reference src/Sonic/SRS.hs:33-41).
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,  # c0
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,  # c1
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# ---------------------------------------------------------------------------
# Limb parameters (TPU representation)
# ---------------------------------------------------------------------------
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

FR_LIMBS = 16   # 16 * 16 = 256 bits >= 255
FQ_LIMBS = 24   # 24 * 16 = 384 bits >= 381

FR_BITS = 255
FQ_BITS = 381

# Montgomery radices R = 2^(16*L)
FR_MONT_R = 1 << (LIMB_BITS * FR_LIMBS)
FQ_MONT_R = 1 << (LIMB_BITS * FQ_LIMBS)

FR_MONT_R2 = FR_MONT_R * FR_MONT_R % R_MOD
FQ_MONT_R2 = FQ_MONT_R * FQ_MONT_R % Q_MOD

# N' = -N^{-1} mod R (for separated Montgomery REDC)
FR_MONT_NPRIME = (-pow(R_MOD, -1, FR_MONT_R)) % FR_MONT_R
FQ_MONT_NPRIME = (-pow(Q_MOD, -1, FQ_MONT_R)) % FQ_MONT_R


def int_to_limbs(v: int, nlimbs: int) -> list[int]:
    """Little-endian 16-bit limb decomposition of a nonnegative int."""
    assert v >= 0
    out = [(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(nlimbs)]
    assert v >> (LIMB_BITS * nlimbs) == 0, "value does not fit in limbs"
    return out


def limbs_to_int(limbs) -> int:
    """Inverse of int_to_limbs; accepts any iterable of ints."""
    v = 0
    for i, limb in enumerate(limbs):
        v += int(limb) << (LIMB_BITS * i)
    return v
