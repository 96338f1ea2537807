// Kernel 2: Pippenger bucket accumulation for G1 with signed digits.
//
// Replaces the TPU kernel sonic_tpu/msm/pallas_acc.py:_acc_kernel (launched
// by _acc_pallas under accumulate_pallas / accumulate_batched_pallas). It
// computes what pippenger._accumulate_buckets_scatter computes, and is
// exactly equal, bucket for bucket, to msm/bucket_acc.py:accumulate_plain.
//
// Inputs: points xs, ys (K, T, 24) int64 Montgomery Fq limbs and infs
// (K, T) uint8, shared by M digit sets digits (M, K, T, W) int32.
// Output: out (3, M, K, W, B, 24) int64, the x, y, z planes of the
// projective bucket grid in the JAX package's limb layout.
//
// What bounds it on an H100: integer multiply-adds. Each (point, window)
// pair costs one RCB16 complete mixed addition, 11 Fq Montgomery products
// (11 * 288 32-bit multiply-adds) plus 15 adds/subs, against 576 bytes of
// bucket read and written, so it is compute bound; with one thread per
// (MSM, lane, window) it is also latency bound unless the wrapper asks for
// enough threads (pippenger.py sizes K so that M*K*W is about 2^15).
//
// Design (simple and right first): one thread per (m, k, w). The thread
// sets its B buckets to infinity (0 : R mod q : 0) in device memory, then
// walks t = 0 .. T-1 in order: it reads bucket |d|, forms +-P (y -> q - y
// for d < 0), applies the mixed addition of group.py:_add_mixed_impl
// step for step with field.cuh's mont_mul inlined, and writes the bucket
// back. Walking each lane in the plain version's order gives bit-equal
// grids. Bucket 0 collects the digit-0 points and is never read; an
// infinity point leaves its bucket as it is. Threads of one (m, k) are
// neighbours, so they read the same point (a broadcast) and neighbouring
// digits. Left for later work: sorting by bucket, shared-memory tiles,
// packed 32-bit buckets, wgmma.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int NW = Fq::N;      // 12 words
constexpr int LIMBS = 2 * NW;  // 24 limbs of 16 bits

// RCB16 complete mixed addition, a = 0, 3b = 12 (group.py _add_mixed_impl,
// pallas_acc.py _add_mixed_panel): (px : py : pz) += (qx, qy), in place.
__device__ __forceinline__ void add_mixed(uint32_t* px, uint32_t* py, uint32_t* pz,
                                          const uint32_t* qx, const uint32_t* qy) {
  uint32_t sxy_p[NW], sxy_q[NW], t0[NW], t1[NW], t2[NW], t3[NW], t4[NW];
  uint32_t yz[NW], xz[NW], u01[NW], y3[NW], z3[NW], m0[NW], m1[NW];
  add_mod<Fq>(sxy_p, px, py);
  add_mod<Fq>(sxy_q, qx, qy);
  mont_mul<Fq>(t0, px, qx);
  mont_mul<Fq>(t1, py, qy);
  mont_mul<Fq>(t3, sxy_q, sxy_p);
  mont_mul<Fq>(yz, qy, pz);
  mont_mul<Fq>(xz, qx, pz);
  add_mod<Fq>(u01, t0, t1);
  add_mod<Fq>(t4, yz, py);
  add_mod<Fq>(y3, xz, px);
  sub_mod<Fq>(t3, t3, u01);  // X1 Y2 + X2 Y1
  // t0 = 3 t0
  add_mod<Fq>(m0, t0, t0);
  add_mod<Fq>(t0, m0, t0);
  // t2 = 12 pz
  add_mod<Fq>(m0, pz, pz);
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

__global__ void __launch_bounds__(128)
bucket_acc_kernel(const int64_t* __restrict__ xs, const int64_t* __restrict__ ys,
                  const uint8_t* __restrict__ infs, const int32_t* __restrict__ digits,
                  int64_t* __restrict__ out, int M, int K, int T, int W, int B) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)M * K * W;
  if (tid >= total) return;
  const int w = (int)(tid % W);
  const long long mk = tid / W;  // m * K + k
  const int k = (int)(mk % K);
  const size_t plane = (size_t)total * B * LIMBS;
  int64_t* bx = out + (size_t)tid * B * LIMBS;  // bucket (m, k, w, 0)
  int64_t* by = bx + plane;
  int64_t* bz = by + plane;

  uint32_t zero[NW], one[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    zero[j] = 0;
    one[j] = c_fq_one[j];
  }
  for (int b = 0; b < B; ++b) {
    store_limbs<NW>(bx + b * LIMBS, zero);
    store_limbs<NW>(by + b * LIMBS, one);
    store_limbs<NW>(bz + b * LIMBS, zero);
  }

  const int32_t* dig = digits + mk * T * W + w;
  for (int t = 0; t < T; ++t) {
    const long long pt = (long long)k * T + t;
    const int d = dig[(long long)t * W];
    const int bi = d < 0 ? -d : d;
    if (infs[pt]) continue;  // the wrapper checks |d| < B
    uint32_t qx[NW], qy[NW], px[NW], py[NW], pz[NW];
    load_limbs<NW>(qx, xs + pt * LIMBS);
    load_limbs<NW>(qy, ys + pt * LIMBS);
    if (d < 0) neg_mod<Fq>(qy, qy);
    int64_t* cx = bx + bi * LIMBS;
    int64_t* cy = by + bi * LIMBS;
    int64_t* cz = bz + bi * LIMBS;
    load_limbs<NW>(px, cx);
    load_limbs<NW>(py, cy);
    load_limbs<NW>(pz, cz);
    add_mixed(px, py, pz, qx, qy);
    store_limbs<NW>(cx, px);
    store_limbs<NW>(cy, py);
    store_limbs<NW>(cz, pz);
  }
}

}  // namespace

extern "C" int sonic_bucket_acc(const void* xs, const void* ys, const void* infs,
                                const void* digits, void* out, int M, int K, int T,
                                int W, int B, void* stream) {
  const long long total = (long long)M * K * W;
  if (total == 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  bucket_acc_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)xs, (const int64_t*)ys, (const uint8_t*)infs,
      (const int32_t*)digits, (int64_t*)out, M, K, T, W, B);
  return (int)cudaGetLastError();
}
