// The G1 group law on the card, shared by the port's MSM kernels.
//
// BLS12-381 G1, y^2 = x^3 + 4 over Fq, in homogeneous projective
// coordinates (X : Y : Z), infinity = (0 : 1 : 0), with the complete
// Renes-Costello-Batina 2016 formulas (eprint 2015/1060, a = 0, 3b = 12),
// step for step as curve/group.py's GroupOps: every field value stays
// canonical, so each formula gives the plain version's integers exactly.
// A point is three arrays of 12 Montgomery words (field.cuh); load_fq reads
// them from the port's limb layout, field.cuh's store_limbs writes them back.
#pragma once

#include "field.cuh"

namespace {

constexpr int NW = Fq::N;      // 12 words
constexpr int LIMBS = 2 * NW;  // 24 limbs of 16 bits

__device__ __forceinline__ void set_one(uint32_t* z) {
#pragma unroll
  for (int j = 0; j < NW; ++j) z[j] = c_fq_one[j];
}

// 12 words from three 16-byte loads
__device__ __forceinline__ void load_words(uint32_t* w, const uint4* __restrict__ p) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 v = __ldg(p + k);
    w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z, w[4 * k + 3] = v.w;
  }
}

// 12 words from one element of 24 int64 limbs (16-byte aligned), read as
// twelve 16-byte limb pairs, one word a pair
__device__ __forceinline__ void load_fq(uint32_t* w, const int64_t* __restrict__ src) {
  const longlong2* v = reinterpret_cast<const longlong2*>(src);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const longlong2 l = v[j];
    w[j] = (uint32_t)l.x | ((uint32_t)l.y << 16);
  }
}

// The common end of RCB16 algorithms 7 and 8 (a = 0, 3b = 12), as in
// curve/group.py: from t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, t3 = X1 Y2 + X2 Y1,
// t4 = Y1 Z2 + Y2 Z1, y3 = X1 Z2 + X2 Z1 to (px : py : pz). Clobbers its inputs.
__device__ __forceinline__ void rcb_finish(uint32_t* px, uint32_t* py, uint32_t* pz, uint32_t* t0,
                                           uint32_t* t1, uint32_t* t2, uint32_t* t3,
                                           uint32_t* t4, uint32_t* y3) {
  uint32_t m0[NW], m1[NW], z3[NW];
  // t0 = 3 t0
  add_mod<Fq>(m0, t0, t0);
  add_mod<Fq>(t0, m0, t0);
  // t2 = 12 t2
  add_mod<Fq>(m0, t2, t2);
  add_mod<Fq>(m1, m0, m0);
  add_mod<Fq>(m0, m1, m1);
  add_mod<Fq>(t2, m0, m1);
  add_mod<Fq>(z3, t1, t2);
  sub_mod<Fq>(t1, t1, t2);
  // y3 = 12 y3
  add_mod<Fq>(m0, y3, y3);
  add_mod<Fq>(m1, m0, m0);
  add_mod<Fq>(m0, m1, m1);
  add_mod<Fq>(y3, m0, m1);
  // x3 = t3 t1 - t4 y3; y3' = t1 z3 + y3 t0; z3' = z3 t4 + t0 t3
  mont_mul<Fq>(m0, t3, t1);
  mont_mul<Fq>(m1, t4, y3);
  sub_mod<Fq>(px, m0, m1);
  mont_mul<Fq>(m0, t1, z3);
  mont_mul<Fq>(m1, y3, t0);
  add_mod<Fq>(py, m0, m1);
  mont_mul<Fq>(m0, z3, t4);
  mont_mul<Fq>(m1, t0, t3);
  add_mod<Fq>(pz, m0, m1);
}

// RCB16 complete mixed addition (algorithm 8, group.py add_mixed):
// (px : py : pz) += (qx, qy), in place; 11 products.
__device__ __forceinline__ void add_mixed(uint32_t* px, uint32_t* py, uint32_t* pz,
                                          const uint32_t* qx, const uint32_t* qy) {
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], y3[NW], u[NW], v[NW];
  add_mod<Fq>(u, px, py);
  add_mod<Fq>(v, qx, qy);
  mont_mul<Fq>(t3, v, u);
  mont_mul<Fq>(t0, px, qx);
  mont_mul<Fq>(t1, py, qy);
  add_mod<Fq>(u, t0, t1);
  sub_mod<Fq>(t3, t3, u);  // X1 Y2 + X2 Y1
  mont_mul<Fq>(u, qy, pz);
  add_mod<Fq>(t4, u, py);  // Y2 Z1 + Y1
  mont_mul<Fq>(u, qx, pz);
  add_mod<Fq>(y3, u, px);  // X2 Z1 + X1
  copy<NW>(t2, pz);
  rcb_finish(px, py, pz, t0, t1, t2, t3, t4, y3);
}

// RCB16 complete addition (algorithm 7, group.py add):
// (px : py : pz) += (qx : qy : qz), in place; 12 products.
__device__ __forceinline__ void add_full(uint32_t* px, uint32_t* py, uint32_t* pz,
                                         const uint32_t* qx, const uint32_t* qy,
                                         const uint32_t* qz) {
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], y3[NW], u[NW], v[NW];
  mont_mul<Fq>(t0, px, qx);
  mont_mul<Fq>(t1, py, qy);
  mont_mul<Fq>(t2, pz, qz);
  add_mod<Fq>(u, px, py);
  add_mod<Fq>(v, qx, qy);
  mont_mul<Fq>(t3, u, v);
  add_mod<Fq>(u, t0, t1);
  sub_mod<Fq>(t3, t3, u);  // X1 Y2 + X2 Y1
  add_mod<Fq>(u, py, pz);
  add_mod<Fq>(v, qy, qz);
  mont_mul<Fq>(t4, u, v);
  add_mod<Fq>(u, t1, t2);
  sub_mod<Fq>(t4, t4, u);  // Y1 Z2 + Y2 Z1
  add_mod<Fq>(u, px, pz);
  add_mod<Fq>(v, qx, qz);
  mont_mul<Fq>(y3, u, v);
  add_mod<Fq>(u, t0, t2);
  sub_mod<Fq>(y3, y3, u);  // X1 Z2 + X2 Z1
  rcb_finish(px, py, pz, t0, t1, t2, t3, t4, y3);
}

// RCB16 complete doubling (algorithm 9, a = 0, group.py double):
// (px : py : pz) = 2 (px : py : pz), in place; 8 products. Infinity stays.
__device__ __forceinline__ void dbl(uint32_t* px, uint32_t* py, uint32_t* pz) {
  uint32_t t0[NW], t1[NW], t2[NW], xy[NW], z3[NW], y3[NW], m0[NW], m1[NW];
  mont_mul<Fq>(t0, py, py);
  mont_mul<Fq>(t1, py, pz);
  mont_mul<Fq>(t2, pz, pz);
  mont_mul<Fq>(xy, px, py);
  // z3 = 8 t0
  add_mod<Fq>(z3, t0, t0);
  add_mod<Fq>(z3, z3, z3);
  add_mod<Fq>(z3, z3, z3);
  // t2 = 12 t2
  add_mod<Fq>(m0, t2, t2);
  add_mod<Fq>(m1, m0, m0);
  add_mod<Fq>(m0, m1, m1);
  add_mod<Fq>(t2, m0, m1);
  add_mod<Fq>(y3, t0, t2);
  // t0 = t0 - 3 t2
  add_mod<Fq>(m0, t2, t2);
  add_mod<Fq>(m0, m0, t2);
  sub_mod<Fq>(t0, t0, m0);
  // x3 = t2 z3; z3' = t1 z3; y3' = x3 + t0 y3; x3' = 2 t0 xy
  mont_mul<Fq>(px, t2, z3);
  mont_mul<Fq>(pz, t1, z3);
  mont_mul<Fq>(m0, t0, y3);
  add_mod<Fq>(py, px, m0);
  mont_mul<Fq>(m0, t0, xy);
  add_mod<Fq>(px, m0, m0);
}

}  // namespace
