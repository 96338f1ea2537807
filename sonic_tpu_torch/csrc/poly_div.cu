// Kernel 4: the openings' division, f(z) and (f(X) - f(z)) / (X - z), over
// a batch of M instances of one Laurent span.
//
// Replaces no Pallas kernel: the JAX package divides in jnp
// (sonic_tpu/poly/laurent.py div_by_linear, div_by_linear_batched), and the
// port ran the same plain torch (poly/laurent.py keeps it as the plain
// version): f(z) as a power ladder, products and a halving tree of sums,
// z^offset through a Fermat inverse, and the quotient in closed form,
// w_{D-2-j} = z^j sum_{k<=j} c_{D-1-k} z^-k, through a second Fermat
// inverse, two power ladders and a Hillis-Steele prefix sum of ~log2 D
// rounds. Each inverse is 417 dependent kernel-1 launches on a few
// elements, each round of the prefix sum reads and writes the whole array,
// so a division call was ~900 launches and ~20 passes over its
// coefficients. It was added because the divisions were the largest idle
// span of every proof.
//
// What it computes, for each instance m with coefficients c_0 .. c_{D-1}
// at exponents offset .. offset + D - 1 and its point z (canonical
// Montgomery Fr, 16 int64 limbs an element):
//   fz_m = z^offset sum_i c_i z^i (z^offset through 1/z when offset is
//        negative, and 1/0 = 0 as in the plain version's inv(0) = 0);
//   the quotient w_0 .. w_{D-2} of chat = c - fz_m X^const_pos
//        (const_pos = -offset; no change when it lies outside [0, D)), by
//        the top-down recurrence w_{D-2} = chat_{D-1}, w_{i-1} = chat_i +
//        z w_i: the integers of laurent._div_linear_seq, which the closed
//        form equals wherever z != 0. The recurrence needs no 1/z, so
//        z = 0 is exact too.
//
// What bounds it on an H100: device-memory bytes. Each coefficient is read
// and each quotient coefficient written at 128 B (the port's int64 16-bit
// limbs), and costs one Fr product-and-add a pass: at 3.35 TB/s the
// bytes take a few times longer than the card's integer multiply-adds.
//
// Design: the recurrence is linear with a constant multiplier, so it is
// scanned in chunks of K consecutive coefficients (the wrapper picks K
// from M and D: poly/div.py chunk_len), and the chunks in blocks of BLOCK,
// a thread a chunk. With Z = z^K, a chunk's value h_t = sum_{k<K} c_{tK+k}
// z^k and a block's A_b = sum_k h_{bB+k} Z^k, everything above a chunk
// folds into its carry-in cin_t = sum_{u>t} h'_u Z^(u-t-1). Four
// launches a call, whatever M and D:
//   1. chunk_kernel, a block of chunks of one instance: each thread runs
//      Horner top-down over its chunk (h_t, to a scratch of 32 B a chunk).
//      The blocks of a first row compute each instance's constants
//      (Z^(2^s), z^offset through a binary-Euclid 1/z, z^(const_pos mod
//      K)), a warp an instance, beside the chunks.
//   2. block_kernel, a block of chunks: an in-block Hillis-Steele scan of
//      the h_t with multipliers Z^(2^s) gives A_b.
//   3. carry_kernel, a block an instance: the same scan over the A_b, a
//      thread to R = ceil(blocks / BLOCK) of them (one or two at the
//      shapes the prover runs), gives fhat(z) = sum_t h_t Z^t and so fz = z^offset
//      fhat(z). Thread 0 folds d = fz z^(const_pos mod K) out of the chunk
//      that holds X^0 (h'_ts = h_ts - d) and its block's A_b, the scan runs
//      again, and each block's carry-in replaces its A_b.
//   4. quotient_kernel, a block of chunks: the in-block scan again, of the
//      h'_t with the block's carry-in folded into its top chunk, gives each
//      chunk's cin_t; each thread runs the recurrence down its chunk from
//      cin_t, subtracting fz at X^0, and writes each quotient coefficient
//      once.
// So the coefficients are read twice and the quotient written once, with
// no host synchronisation, and every pass but the carries spreads over
// the whole card: the serial work is the constants' (beside pass 1) and
// the carry pass's few dozen dependent products.
// Passes 1 and 4 stage their chunks through shared memory STAGE
// coefficients a thread at a time (Tile below), so every load and store
// of the coefficients is a whole warp on one thread's consecutive 512
// bytes. Every field operation is field.cuh's, on canonical values, so
// every output is canonical.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int FW = Fr::N;            // 8 words an element
constexpr int FL = 2 * FW;           // 16 limbs an element
constexpr int BLOCK = 128;           // chunks a block, threads of every kernel: poly/div.py BLOCK
constexpr int LEVELS = 7;            // log2(BLOCK): rounds of an in-block scan
constexpr int STAGE = 4;             // coefficients of a thread's chunk staged a round
constexpr int ROW = STAGE * FW + 1;  // a thread's words in the tile, padded off the banks
// an instance's constants, 8 words each: Z^(2^s) at s = 0 .. LEVELS (Z^BLOCK
// last), then z^offset and z^(const_pos mod K)
constexpr int C_ZO = LEVELS + 1, C_ZRR = LEVELS + 2, NCONST = LEVELS + 3;

// R mod r, the Montgomery one of Fr, and R^3 mod r
static __constant__ uint32_t c_fr_one[FW] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};
static __constant__ uint32_t c_fr_r3[FW] = {
    0x439b73afu, 0xc62c1807u, 0x8cf06990u, 0x1b3e0d18u,
    0xc7b5f418u, 0x73d13c71u, 0xc8db33e9u, 0x6e2a5bb9u};

__device__ __forceinline__ void set_one(uint32_t* x) {
#pragma unroll
  for (int j = 0; j < FW; ++j) x[j] = c_fr_one[j];
}

__device__ __forceinline__ void set_zero(uint32_t* x) {
#pragma unroll
  for (int j = 0; j < FW; ++j) x[j] = 0;
}

// 8 words from one element of 16 int64 limbs (16-byte aligned), eight
// 16-byte limb pairs
__device__ __forceinline__ void load_fr(uint32_t* w, const int64_t* __restrict__ src) {
  const longlong2* v = reinterpret_cast<const longlong2*>(src);
#pragma unroll
  for (int j = 0; j < FW; ++j) {
    const longlong2 l = __ldg(v + j);
    w[j] = (uint32_t)l.x | ((uint32_t)l.y << 16);
  }
}

// the scratch holds 8 words an element, as two 16-byte words
__device__ __forceinline__ void load_words(uint32_t* w, const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint4 q = v[k];
    w[4 * k] = q.x, w[4 * k + 1] = q.y, w[4 * k + 2] = q.z, w[4 * k + 3] = q.w;
  }
}

__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t* w) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int k = 0; k < 2; ++k) v[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// acc = acc * m + x
__device__ __forceinline__ void horner_step(uint32_t* acc, const uint32_t* m, const uint32_t* x) {
  mont_mul<Fr>(acc, acc, m);
  add_mod<Fr>(acc, acc, x);
}

// r = a^e (e = 0 gives one), square and multiply from the top bit
__device__ void pow_u64(uint32_t* r, const uint32_t* a, unsigned long long e) {
  uint32_t acc[FW];
  set_one(acc);
  for (int b = 63 - __clzll((long long)e); b >= 0; --b) {
    mont_mul<Fr>(acc, acc, acc);
    if ((e >> b) & 1ull) mont_mul<Fr>(acc, acc, a);
  }
  copy<FW>(r, acc);
}

// Helpers of inv_fr on plain 8-word integers below 2^256.
__device__ __forceinline__ bool is_one(const uint32_t* x) {
  uint32_t rest = 0;
#pragma unroll
  for (int j = 1; j < FW; ++j) rest |= x[j];
  return x[0] == 1u && rest == 0u;
}

__device__ __forceinline__ bool geq(const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int j = FW - 1; j >= 0; --j)
    if (a[j] != b[j]) return a[j] > b[j];
  return true;
}

// a -= b for a >= b
__device__ __forceinline__ void sub_plain(uint32_t* a, const uint32_t* b) {
  long long borrow = 0;
#pragma unroll
  for (int j = 0; j < FW; ++j) {
    const long long d = (long long)a[j] - b[j] + borrow;
    a[j] = (uint32_t)d;
    borrow = d >> 32;
  }
}

// x = x / 2 mod r for x < r: (x + r) / 2 when x is odd (x + r < 2^256)
__device__ __forceinline__ void half_mod(uint32_t* x) {
  if (x[0] & 1u) {
    unsigned long long carry = 0;
#pragma unroll
    for (int j = 0; j < FW; ++j) {
      const unsigned long long t = (unsigned long long)x[j] + c_fr_mod[j] + carry;
      x[j] = (uint32_t)t;
      carry = t >> 32;
    }
  }
#pragma unroll
  for (int j = 0; j < FW - 1; ++j) x[j] = __funnelshift_r(x[j], x[j + 1], 1);
  x[FW - 1] >>= 1;
}

__device__ __forceinline__ void shr1(uint32_t* x) {
#pragma unroll
  for (int j = 0; j < FW - 1; ++j) x[j] = __funnelshift_r(x[j], x[j + 1], 1);
  x[FW - 1] >>= 1;
}

// r = 1/a in Montgomery form, 0 for a = 0 (as a^(r-2) gives): the binary
// extended Euclidean algorithm on the integer a R gives (a R)^-1, and one
// product by R^3 turns it into a^-1 R. Some 560 steps of shifts and
// subtractions, against the 417 dependent products of a Fermat ladder.
__device__ void inv_fr(uint32_t* r, const uint32_t* a) {
  uint32_t u[FW], v[FW], x1[FW], x2[FW];
  copy<FW>(u, a);
  bool zero = true;
#pragma unroll
  for (int j = 0; j < FW; ++j) {
    zero = zero && a[j] == 0u;
    v[j] = c_fr_mod[j];
    x1[j] = 0;
    x2[j] = 0;
  }
  if (zero) {
    set_zero(r);
    return;
  }
  x1[0] = 1;
  while (!is_one(u) && !is_one(v)) {
    while (!(u[0] & 1u)) {
      shr1(u);
      half_mod(x1);
    }
    while (!(v[0] & 1u)) {
      shr1(v);
      half_mod(x2);
    }
    if (geq(u, v)) {
      sub_plain(u, v);
      sub_mod<Fr>(x1, x1, x2);
    } else {
      sub_plain(v, u);
      sub_mod<Fr>(x2, x2, x1);
    }
  }
  mont_mul<Fr>(r, is_one(u) ? x1 : x2, c_fr_r3);
}

// A block's staged coefficients: for each thread p, `count[p]` (at most
// STAGE) consecutive elements from element `first[p]` of a limb array, as
// words, element e of thread p at w[p * ROW + e * FW]. Loaded and stored
// by the whole block, consecutive threads on consecutive 16-byte limb
// pairs, so that a warp moves one thread's 512 bytes at once: the chunks
// lie K coefficients apart, and a thread reading or writing its own would
// touch 32 lines a warp instruction, 16 bytes of each (a store of the
// quotient that way ran at a fifth of the card's bandwidth).
struct Tile {
  uint32_t w[BLOCK * ROW];
  long long first[BLOCK];
  int count[BLOCK];
};

__device__ __forceinline__ void tile_load(Tile& s, const int64_t* __restrict__ src) {
  for (int q = threadIdx.x; q < BLOCK * STAGE * FW; q += BLOCK) {
    const int p = q / (STAGE * FW), u = q - p * (STAGE * FW);
    if (u < s.count[p] * FW) {
      const longlong2 l = __ldg(reinterpret_cast<const longlong2*>(src + (size_t)s.first[p] * FL) + u);
      s.w[p * ROW + u] = (uint32_t)l.x | ((uint32_t)l.y << 16);
    }
  }
}

__device__ __forceinline__ void tile_store(int64_t* __restrict__ dst, const Tile& s) {
  for (int q = threadIdx.x; q < BLOCK * STAGE * FW; q += BLOCK) {
    const int p = q / (STAGE * FW), u = q - p * (STAGE * FW);
    if (u < s.count[p] * FW) {
      const uint32_t v = s.w[p * ROW + u];
      reinterpret_cast<longlong2*>(dst + (size_t)s.first[p] * FL)[u] =
          make_longlong2((long long)(v & 0xffffu), (long long)(v >> 16));
    }
  }
}

// In-block suffix scan over the BLOCK threads: a becomes S_k = sum_{j>=k}
// a_j P^(j-k), cin S_{k+1} (0 for the last thread); pw[s] = P^(2^s), the
// multiplier of round s (shared or global memory), sx the block's shared
// words, [word][thread]. Every thread of the block calls it.
__device__ void suffix_scan(uint32_t* a, uint32_t* cin, uint32_t* sx, const uint32_t* pw) {
  const int i = threadIdx.x;
#pragma unroll
  for (int j = 0; j < FW; ++j) sx[j * BLOCK + i] = a[j];
  __syncthreads();
  uint32_t P[FW], y[FW];
  for (int s = 0; s < LEVELS; ++s) {
    const int step = 1 << s;
    const bool has = i + step < BLOCK;
    if (has) {
#pragma unroll
      for (int j = 0; j < FW; ++j) y[j] = sx[j * BLOCK + i + step];
    }
    __syncthreads();
    if (has) {
      load_words(P, pw + s * FW);
      horner_step(y, P, a);  // S(i + step) P^step + S(i): the two halves joined
      copy<FW>(a, y);
#pragma unroll
      for (int j = 0; j < FW; ++j) sx[j * BLOCK + i] = a[j];
    }
    __syncthreads();
  }
  if (i + 1 < BLOCK) {
#pragma unroll
    for (int j = 0; j < FW; ++j) cin[j] = sx[j * BLOCK + i + 1];
  } else {
    set_zero(cin);
  }
  __syncthreads();  // every thread has read sx before it is written again
}

// pw[s] = x^(2^s), s < LEVELS (one thread)
__device__ void square_table(uint32_t* pw, const uint32_t* x) {
  uint32_t p[FW];
  copy<FW>(p, x);
  for (int s = 0; s < LEVELS; ++s) {
    store_words(pw + s * FW, p);
    mont_mul<Fr>(p, p, p);
  }
}

// An instance's constants (NCONST elements of 8 words at k).
__device__ void instance_consts(uint32_t* k, const int64_t* z_limbs, int K, long long offset,
                                long long const_pos) {
  uint32_t z[FW], r[FW];
  load_fr(z, z_limbs);
  pow_u64(r, z, (unsigned long long)K);
  for (int s = 0; s <= LEVELS; ++s) {
    store_words(k + s * FW, r);
    mont_mul<Fr>(r, r, r);
  }
  if (offset < 0) {
    inv_fr(r, z);
    pow_u64(r, r, (unsigned long long)(-offset));
  } else {
    pow_u64(r, z, (unsigned long long)offset);
  }
  store_words(k + C_ZO * FW, r);
  pow_u64(r, z, (unsigned long long)(const_pos >= 0 ? const_pos % K : 0));
  store_words(k + C_ZRR * FW, r);
}

// The chunk of a thread of passes 1, 2 and 4: instance m, chunk t.
struct Chunk {
  long long m, t, lo, hi;
  bool active;
  __device__ Chunk(long long m_, long long D, long long T, int K) {
    m = m_;
    t = (long long)blockIdx.x * BLOCK + threadIdx.x;
    active = t < T;
    lo = active ? t * K : 0;
    hi = active ? min(lo + K, D) : 0;
  }
};

// grid (at least the blocks of chunks, M + 1): row 0 the constants, a warp
// an instance (lane 0: the inverse's loops branch on the data, and lanes of
// one warp on different instances would take every lane's branches),
// dispatched first so that they run beside the chunks; row m + 1 instance
// m's chunks. h: (M, T) chunk values; consts: (M, NCONST).
__global__ void __launch_bounds__(BLOCK)
chunk_kernel(const int64_t* __restrict__ c, const int64_t* __restrict__ zs, uint32_t* __restrict__ h,
             uint32_t* __restrict__ consts, long long M, long long D, long long T, int K, long long offset) {
  if (blockIdx.y == 0) {
    const long long m = ((long long)blockIdx.x * BLOCK + threadIdx.x) / 32;
    if (threadIdx.x % 32 == 0 && m < M)
      instance_consts(consts + (size_t)m * NCONST * FW, zs + m * FL, K, offset, -offset);
    return;
  }
  if ((long long)blockIdx.x * BLOCK >= T) return;
  __shared__ Tile s;
  const int i = threadIdx.x;
  const Chunk ch(blockIdx.y - 1, D, T, K);
  uint32_t z[FW], acc[FW], x[FW];
  load_fr(z, zs + ch.m * FL);
  set_zero(acc);
  // rounds of STAGE coefficients, from the top of the chunk down
  for (long long top = ch.hi; top > ch.hi - K; top -= STAGE) {
    const long long bottom = max(ch.lo, top - STAGE);
    s.first[i] = ch.m * D + bottom;
    s.count[i] = (int)max(0ll, top - bottom);
    __syncthreads();
    tile_load(s, c);
    __syncthreads();
    for (int e = s.count[i] - 1; e >= 0; --e) {
#pragma unroll
      for (int j = 0; j < FW; ++j) x[j] = s.w[i * ROW + e * FW + j];
      horner_step(acc, z, x);
    }
  }
  if (ch.active) store_words(h + (size_t)(ch.m * T + ch.t) * FW, acc);
}

// grid (blocks of chunks, M): each block's value A_b = sum_k h_{bB+k} Z^k
// into ab (M, NB)
__global__ void __launch_bounds__(BLOCK)
block_kernel(const uint32_t* __restrict__ h, uint32_t* __restrict__ ab, const uint32_t* __restrict__ consts,
             long long D, long long T, int K) {
  __shared__ uint32_t sx[FW * BLOCK];
  const Chunk ch(blockIdx.y, D, T, K);
  uint32_t a[FW], cin[FW];
  if (ch.active) {
    load_words(a, h + (size_t)(ch.m * T + ch.t) * FW);
  } else {
    set_zero(a);
  }
  suffix_scan(a, cin, sx, consts + (size_t)ch.m * NCONST * FW);
  if (threadIdx.x == 0) store_words(ab + (size_t)(ch.m * gridDim.x + blockIdx.x) * FW, a);
}

// sum_{b in [start, end)} ab_b ZB^(b - start), top-down (0 for an empty range)
__device__ void range_value(uint32_t* acc, const uint32_t* abm, long long start, long long end,
                            const uint32_t* ZB) {
  set_zero(acc);
  uint32_t x[FW];
  for (long long b = end - 1; b >= start; --b) {
    load_words(x, abm + (size_t)b * FW);
    horner_step(acc, ZB, x);
  }
}

// a block an instance, over its NB block values
__global__ void __launch_bounds__(BLOCK)
carry_kernel(uint32_t* __restrict__ h, uint32_t* __restrict__ ab, const uint32_t* __restrict__ consts,
             const int64_t* __restrict__ fz_in, int64_t* __restrict__ fz_out, long long D, long long T,
             long long NB, int K, long long const_pos) {
  __shared__ uint32_t sx[FW * BLOCK];
  __shared__ __align__(16) uint32_t pw[FW * LEVELS];
  const long long m = blockIdx.x;
  const int i = threadIdx.x;
  const long long R = (NB + BLOCK - 1) / BLOCK;
  const long long start = min(i * R, NB), end = min(start + R, NB);
  const uint32_t* km = consts + (size_t)m * NCONST * FW;
  uint32_t* hm = h + (size_t)m * T * FW;
  uint32_t* abm = ab + (size_t)m * NB * FW;
  uint32_t ZB[FW], a0[FW], a[FW], cin[FW];
  load_words(ZB, km + LEVELS * FW);  // Z^BLOCK
  if (i == 0) {
    uint32_t ZR[FW];
    pow_u64(ZR, ZB, (unsigned long long)R);
    square_table(pw, ZR);
  }
  range_value(a0, abm, start, end, ZB);
  copy<FW>(a, a0);
  suffix_scan(a, cin, sx, pw);
  const bool fold = 0 <= const_pos && const_pos < D;
  const long long ts = fold ? const_pos / K : 0, bs = ts / BLOCK;
  if (i == 0) {
    uint32_t fz[FW];
    if (fz_in) {
      load_fr(fz, fz_in + m * FL);
    } else {
      load_words(fz, km + C_ZO * FW);
      mont_mul<Fr>(fz, fz, a);  // a = S_0 = fhat(z)
    }
    store_limbs<FW>(fz_out + m * FL, fz);
    if (fold) {
      // d = fz z^(const_pos - ts K) out of chunk ts, and d Z^(ts - bs BLOCK) out of its block
      uint32_t d[FW], x[FW], p[FW];
      load_words(d, km + C_ZRR * FW);
      mont_mul<Fr>(d, d, fz);
      load_words(x, hm + (size_t)ts * FW);
      sub_mod<Fr>(x, x, d);
      store_words(hm + (size_t)ts * FW, x);
      for (int s = 0; s < LEVELS; ++s) {
        if ((ts - bs * BLOCK) >> s & 1) {
          load_words(p, km + s * FW);
          mont_mul<Fr>(d, d, p);
        }
      }
      load_words(x, abm + (size_t)bs * FW);
      sub_mod<Fr>(x, x, d);
      store_words(abm + (size_t)bs * FW, x);
    }
  }
  if (fold) {
    __syncthreads();  // the folded block value is visible to its owner
    if (i == bs / R) range_value(a0, abm, start, end, ZB);
    copy<FW>(a, a0);
    suffix_scan(a, cin, sx, pw);
  }
  // each block's carry-in in place of its value, top-down
  uint32_t x[FW];
  for (long long b = end - 1; b >= start; --b) {
    load_words(x, abm + (size_t)b * FW);
    store_words(abm + (size_t)b * FW, cin);
    horner_step(cin, ZB, x);
  }
}

// grid (blocks of chunks, M); ab now holds each block's carry-in
__global__ void __launch_bounds__(BLOCK)
quotient_kernel(const int64_t* __restrict__ c, const int64_t* __restrict__ zs,
                const uint32_t* __restrict__ h, const uint32_t* __restrict__ ab,
                const uint32_t* __restrict__ consts, const int64_t* __restrict__ fz,
                int64_t* __restrict__ w, long long D, long long T, int K, long long const_pos) {
  __shared__ Tile s;
  __shared__ uint32_t sx[FW * BLOCK];
  const int i = threadIdx.x;
  const Chunk ch(blockIdx.y, D, T, K);
  const uint32_t* km = consts + (size_t)ch.m * NCONST * FW;
  uint32_t z[FW], acc[FW], x[FW], f[FW], cb[FW];
  load_fr(z, zs + ch.m * FL);
  load_words(cb, ab + (size_t)(ch.m * gridDim.x + blockIdx.x) * FW);
  // the block's top chunk takes the carry-in from above: v_top += Z cb
  const long long top_chunk = min((long long)BLOCK, T - (long long)blockIdx.x * BLOCK) - 1;
  if (ch.active) {
    load_words(acc, h + (size_t)(ch.m * T + ch.t) * FW);
  } else {
    set_zero(acc);
  }
  if (i == top_chunk) {
    load_words(x, km);
    mont_mul<Fr>(x, x, cb);
    add_mod<Fr>(acc, acc, x);
  }
  suffix_scan(acc, x, sx, km);
  if (i == top_chunk) copy<FW>(x, cb);
  copy<FW>(acc, x);  // w_{hi-1} = cin_t
  const bool here = ch.active && ch.lo <= const_pos && const_pos < ch.hi;
  if (here) load_fr(f, fz + ch.m * FL);
  for (long long top = ch.hi; top > ch.hi - K; top -= STAGE) {
    const long long bottom = max(ch.lo, top - STAGE);
    const int n = (int)max(0ll, top - bottom);
    s.first[i] = ch.m * D + bottom;
    s.count[i] = n;
    __syncthreads();
    tile_load(s, c);
    __syncthreads();
    // in place: the slot of c_j takes w_j, then w_{j-1} = chat_j + z w_j
    for (int e = n - 1; e >= 0; --e) {
      const long long j = bottom + e;
      uint32_t* slot = s.w + i * ROW + e * FW;
#pragma unroll
      for (int k = 0; k < FW; ++k) x[k] = slot[k], slot[k] = acc[k];
      if (j > ch.lo) {
        if (here && j == const_pos) sub_mod<Fr>(x, x, f);
        horner_step(acc, z, x);
      }
    }
    __syncthreads();
    s.first[i] = ch.m * (D - 1) + bottom;  // w_j for j <= D - 2 only
    s.count[i] = (int)max(0ll, min(top, D - 1) - bottom);
    __syncthreads();
    tile_store(w, s);
    __syncthreads();
  }
}

}  // namespace

// coeffs (M, D, 16) and zs (M, 16) int64 limbs; fz_in (M, 16) or null (then
// fz is computed); fz_out (M, 16); w (M, D - 1, 16); scratch: M (T + NB +
// NCONST) elements of 8 words, T = ceil(D / K), NB = ceil(T / BLOCK).
// Every pointer 16-byte aligned.
extern "C" int sonic_poly_div(const void* coeffs, const void* zs, const void* fz_in, void* fz_out, void* w,
                              void* scratch, long long M, long long D, int K, long long offset,
                              void* stream) {
  if (M < 0 || M >= 65535 || D < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const long long T = (D + K - 1) / K, NB = (T + BLOCK - 1) / BLOCK;
  if (NB >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  uint32_t* h = (uint32_t*)scratch;
  uint32_t* ab = h + (size_t)M * T * FW;
  uint32_t* consts = ab + (size_t)M * NB * FW;
  const unsigned nb = (unsigned)NB;
  const auto* c = (const int64_t*)coeffs;
  const auto* z = (const int64_t*)zs;
  const unsigned warps = (unsigned)((M * 32 + BLOCK - 1) / BLOCK);  // the constants' blocks
  chunk_kernel<<<dim3(nb > warps ? nb : warps, (unsigned)M + 1), BLOCK, 0, st>>>(c, z, h, consts, M, D, T, K,
                                                                               offset);
  block_kernel<<<dim3(nb, (unsigned)M), BLOCK, 0, st>>>(h, ab, consts, D, T, K);
  carry_kernel<<<(unsigned)M, BLOCK, 0, st>>>(h, ab, consts, (const int64_t*)fz_in, (int64_t*)fz_out, D, T,
                                               NB, K, -offset);
  quotient_kernel<<<dim3(nb, (unsigned)M), BLOCK, 0, st>>>(c, z, h, ab, consts, (const int64_t*)fz_out,
                                                           (int64_t*)w, D, T, K, -offset);
  return (int)cudaGetLastError();
}
