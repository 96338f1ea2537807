// BLS12-381 field arithmetic shared by the port's CUDA kernels.
//
// Fr (255 bits) in 8 and Fq (381 bits) in 12 little-endian 32-bit words,
// Montgomery form with R = 2^256 and 2^384: the same R, and so the same
// Montgomery integers, as the 16-bit limbs of the Python side
// (fields/limb.py). Kernels read int64 tensors of 16-bit limbs and regroup
// pairs of limbs into one word in registers (load_limbs / store_limbs).
//
// mont_mul is CIOS (coarsely integrated operand scanning) with 64-bit
// accumulators: word products of two 32-bit words plus two 32-bit addends
// never exceed 2^64 - 1. Every loop has a compile-time trip count and is
// unrolled, so operands stay in registers.
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

// (..., 2N) int64 limbs of 16 bits -> N words
template <int N>
__device__ __forceinline__ void load_limbs(uint32_t* w, const int64_t* src) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    w[j] = (uint32_t)src[2 * j] | ((uint32_t)src[2 * j + 1] << 16);
}

template <int N>
__device__ __forceinline__ void store_limbs(int64_t* dst, const uint32_t* w) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    dst[2 * j] = (int64_t)(w[j] & 0xffffu);
    dst[2 * j + 1] = (int64_t)(w[j] >> 16);
  }
}

template <int N>
__device__ __forceinline__ void copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = a[j];
}

// r = x - p if x >= p (x given as N words plus a top word), else x
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t* r, const uint32_t* x, uint32_t top) {
  constexpr int N = F::N;
  const uint32_t* p = F::mod();
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t t = (uint64_t)x[j] - p[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  bool take = top != 0 || borrow == 0;
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
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * F::n0;
    s = (uint64_t)m * p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  reduce_once<F>(r, t, t[N]);  // t < 2p
}

// r = a + b mod p (2p < R, so the sum fits N words plus a carry)
template <class F>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  reduce_once<F>(r, s, (uint32_t)c);
}

// r = a - b mod p
template <class F>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  constexpr int N = F::N;
  const uint32_t* p = F::mod();
  uint32_t d[N];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint64_t t = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  uint32_t mask = 0u - borrow;  // add p back when the difference went negative
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)d[j] + (p[j] & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// r = -a mod p (0 stays 0)
template <class F>
__device__ __forceinline__ void neg_mod(uint32_t* r, const uint32_t* a) {
  uint32_t zero[F::N];
#pragma unroll
  for (int j = 0; j < F::N; ++j) zero[j] = 0;
  sub_mod<F>(r, zero, a);
}
