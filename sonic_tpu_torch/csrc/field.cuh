// BLS12-381 field arithmetic shared by the port's CUDA kernels.
//
// Fr (255 bits) in 8 and Fq (381 bits) in 12 little-endian 32-bit words,
// Montgomery form with R = 2^256 and 2^384: the same R, and so the same
// Montgomery integers, as the 16-bit limbs of the Python side
// (fields/limb.py). Kernels read int64 tensors of 16-bit limbs and regroup
// pairs of limbs into one word (load_limbs / store_limbs), or read tables
// the wrapper packed into 32-bit words already.
//
// mont_mul is CIOS (coarsely integrated operand scanning) written as PTX
// carry chains: each row a*b_i is two chains, the low halves of the word
// products (mad.lo.cc / madc.lo.cc) into t[0..N-1] and the high halves
// (mad.hi.cc / madc.hi.cc) into t[1..N], and the reduction by m*p the
// same, so a product issues 4 N^2 multiply-adds (2 N^2 word products, each
// a lo and a hi half) and no separate carry arithmetic. add_mod / sub_mod
// are add.cc / addc.cc and sub.cc / subc.cc chains. The carry flag lives
// only inside one chain of back-to-back asm statements. Every loop has a
// compile-time trip count and is unrolled, so operands stay in registers.
#pragma once

#include <cstdint>

// static: each .cu gets its own copy (no relocatable device code).
static __constant__ uint32_t c_fr_mod[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
static __constant__ uint32_t c_fq_mod[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// R mod q: the Montgomery one of Fq (y of the point at infinity).
static __constant__ uint32_t c_fq_one[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

// n0 = -N^-1 mod 2^32
struct Fr {
  static constexpr int N = 8;
  static constexpr uint32_t n0 = 0xffffffffu;
  static __device__ __forceinline__ const uint32_t* mod() { return c_fr_mod; }
};
struct Fq {
  static constexpr int N = 12;
  static constexpr uint32_t n0 = 0xfffcfffdu;
  static __device__ __forceinline__ const uint32_t* mod() { return c_fq_mod; }
};

// -- PTX carry-chain primitives ------------------------------------------------

namespace ptx {
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
}  // namespace ptx

// -- layout ----------------------------------------------------------------------

// (..., 2N) int64 limbs of 16 bits -> N words
template <int N>
__device__ __forceinline__ void load_limbs(uint32_t* w, const int64_t* src) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    w[j] = (uint32_t)src[2 * j] | ((uint32_t)src[2 * j + 1] << 16);
}

// N words -> 2N int64 limbs, as 16-byte stores (dst must be 16-byte aligned)
template <int N>
__device__ __forceinline__ void store_limbs(int64_t* dst, const uint32_t* w) {
  longlong2* d = reinterpret_cast<longlong2*>(dst);
#pragma unroll
  for (int j = 0; j < N; ++j)
    d[j] = make_longlong2((long long)(w[j] & 0xffffu), (long long)(w[j] >> 16));
}

template <int N>
__device__ __forceinline__ void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = a[j];
}

// -- arithmetic --------------------------------------------------------------------

// r = x - p if x >= p (x given as N words plus a top word), else x
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t* r, const uint32_t* x, uint32_t top) {
  constexpr int N = F::N;
  const uint32_t* p = F::mod();
  uint32_t d[N];
  d[0] = ptx::sub_cc(x[0], p[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = ptx::subc_cc(x[j], p[j]);
  // top - borrow is 0 when top is 0 and x >= p; a nonzero top means x > p
  const uint32_t hi = ptx::subc(top, 0);
  const bool take = (hi == 0) | (top != 0);
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = take ? d[j] : x[j];
}

// r = a * b * R^-1 mod p, canonical for canonical a, b (r may alias a or b)
template <class F>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  const uint32_t* p = F::mod();
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b[i];
    // t += a * b_i: low halves into t[0..N-1], high halves into t[1..N]
    t[0] = ptx::mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = ptx::madc_lo_cc(a[j], bi, t[j]);
    t[N] = ptx::addc_cc(t[N], 0);
    t[N + 1] = ptx::addc(t[N + 1], 0);
    t[1] = ptx::mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j + 1] = ptx::madc_hi_cc(a[j], bi, t[j + 1]);
    t[N + 1] = ptx::addc(t[N + 1], 0);
    // t += m * p with m = t_0 n0 mod 2^32, which clears t[0]; then t >>= 32
    const uint32_t m = t[0] * F::n0;
    t[0] = ptx::mad_lo_cc(m, p[0], t[0]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j] = ptx::madc_lo_cc(m, p[j], t[j]);
    t[N] = ptx::addc_cc(t[N], 0);
    t[N + 1] = ptx::addc(t[N + 1], 0);
    t[1] = ptx::mad_hi_cc(m, p[0], t[1]);
#pragma unroll
    for (int j = 1; j < N; ++j) t[j + 1] = ptx::madc_hi_cc(m, p[j], t[j + 1]);
    t[N + 1] = ptx::addc(t[N + 1], 0);
#pragma unroll
    for (int j = 0; j <= N; ++j) t[j] = t[j + 1];
    t[N + 1] = 0;
  }
  reduce_once<F>(r, t, t[N]);  // t < 2p
}

// r = a + b mod p (2p < R, so the sum fits N words plus a carry)
template <class F>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t s[N];
  s[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) s[j] = ptx::addc_cc(a[j], b[j]);
  const uint32_t top = ptx::addc(0, 0);
  reduce_once<F>(r, s, top);
}

// r = a - b mod p
template <class F>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  const uint32_t* p = F::mod();
  uint32_t d[N];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) d[j] = ptx::subc_cc(a[j], b[j]);
  const uint32_t mask = ptx::subc(0, 0);  // all ones when the difference went negative
  r[0] = ptx::add_cc(d[0], p[0] & mask);
#pragma unroll
  for (int j = 1; j < N - 1; ++j) r[j] = ptx::addc_cc(d[j], p[j] & mask);
  r[N - 1] = ptx::addc(d[N - 1], p[N - 1] & mask);
}

// r = -a mod p (0 stays 0)
template <class F>
__device__ __forceinline__ void neg_mod(uint32_t* r, const uint32_t* a) {
  uint32_t zero[F::N];
#pragma unroll
  for (int j = 0; j < F::N; ++j) zero[j] = 0;
  sub_mod<F>(r, zero, a);
}
