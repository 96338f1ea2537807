// Kernel 3: the G1 MSM tail, from bucket sums to finished MSMs.
//
// Replaces no Pallas kernel: the JAX package's tail is plain jnp,
// sonic_tpu/msm/pippenger.py _bucket_weighted_sum and _window_combine, and
// the port ran it as plain torch over the field layer (msm/tail.py keeps
// that version as the plain twin). It was added because that tail is bound
// by launch cost: one window combine is a serial chain of ~c W group ops,
// ~301 at c = 6, W = 44, each two kernel-1 launches and some thirty field
// adds of ~38 torch ops, so ~150,000 launches of a few microseconds each
// while the card waits for the host; the weighted sum is ten batched group
// ops a call. Two entries, each one launch:
//
//   sonic_bucket_weighted_sum: bucket sums (R, B) -> (R,), row r the sum
//     over b of b * bucket[r, b], R = M W rows. One thread a row keeps a
//     running suffix sum: for b = B-1 .. 1, run += bucket_b, acc += run,
//     2 (B - 1) complete additions in registers. The plain twin groups the
//     same sum as a scan and a tree, so the two agree as group elements
//     (after to_affine), not in projective form.
//   sonic_window_combine: window totals (R, W) -> (R,), row r the sum over
//     w of totals[r, w] << (c w), by Horner's rule from window W-1: for
//     w = W-2 .. 0, c doublings and one complete addition, as the plain
//     twin does with the same formulas (group.cuh) on canonical values, so
//     the two agree bit for bit in projective form.
//
// Inputs and outputs are the port's layout: x, y, z each (R, K, 24) int64
// 16-bit limbs (K = B or W), read as 16-byte limb pairs; out (3, R, 24)
// int64, the x, y, z planes. Every pointer 16-byte aligned.
//
// What bounds it on an H100: the latency of one serial chain, not the
// card's multiply-add rate. A combine row is 258 doublings and 43
// additions at c = 6, W = 44: 2,580 dependent Fq products in one thread;
// R = 263 rows are ~680 K products, ~0.023 ms at the card's IMAD peak, but
// the chain cannot be split (each doubling needs the last), so the time is
// the chain's length times a product's latency. A weighted-sum row is 64
// dependent additions.
//
// Why one thread a row: the rows are independent and each one is a
// dependent chain whose state (two or three points, 36 words each) fits
// in registers. One thread a row keeps the whole chain in registers with
// no synchronisation and no memory traffic but its inputs and one output.
// Splitting a row over threads (a tree over the windows, say) would need
// more doublings and shared-memory exchanges for a chain that is short
// beside the launches it replaces. Blocks of 32 threads spread the few
// warps (R = 263 is 9 warps) over as many SMs.
#include <cuda_runtime.h>

#include "group.cuh"

namespace {

constexpr int TAIL_THREADS = 32;

__device__ __forceinline__ void load_point_limbs(uint32_t* px, uint32_t* py, uint32_t* pz,
                                                 const int64_t* __restrict__ x,
                                                 const int64_t* __restrict__ y,
                                                 const int64_t* __restrict__ z, size_t at) {
  load_fq(px, x + at);
  load_fq(py, y + at);
  load_fq(pz, z + at);
}

__device__ __forceinline__ void store_point_limbs(int64_t* __restrict__ out, long long R, long long r,
                                                  const uint32_t* px, const uint32_t* py,
                                                  const uint32_t* pz) {
  const size_t plane = (size_t)R * LIMBS;
  int64_t* o = out + (size_t)r * LIMBS;
  store_limbs<NW>(o, px);
  store_limbs<NW>(o + plane, py);
  store_limbs<NW>(o + 2 * plane, pz);
}

__global__ void __launch_bounds__(TAIL_THREADS)
weighted_sum_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                    const int64_t* __restrict__ z, int64_t* __restrict__ out, long long R, int B) {
  const long long r = (long long)blockIdx.x * TAIL_THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t row = (size_t)r * B * LIMBS;
  uint32_t rx[NW], ry[NW], rz[NW], ax[NW], ay[NW], az[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) rx[j] = rz[j] = ax[j] = az[j] = 0;
  set_one(ry);
  set_one(ay);
  for (int b = B - 1; b >= 1; --b) {
    uint32_t qx[NW], qy[NW], qz[NW];
    load_point_limbs(qx, qy, qz, x, y, z, row + (size_t)b * LIMBS);
    add_full(rx, ry, rz, qx, qy, qz);
    add_full(ax, ay, az, rx, ry, rz);
  }
  store_point_limbs(out, R, r, ax, ay, az);
}

__global__ void __launch_bounds__(TAIL_THREADS)
window_combine_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                      const int64_t* __restrict__ z, int64_t* __restrict__ out, long long R, int W,
                      int c) {
  const long long r = (long long)blockIdx.x * TAIL_THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t row = (size_t)r * W * LIMBS;
  uint32_t px[NW], py[NW], pz[NW];
  load_point_limbs(px, py, pz, x, y, z, row + (size_t)(W - 1) * LIMBS);
  for (int w = W - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) dbl(px, py, pz);
    uint32_t qx[NW], qy[NW], qz[NW];
    load_point_limbs(qx, qy, qz, x, y, z, row + (size_t)w * LIMBS);
    add_full(px, py, pz, qx, qy, qz);
  }
  store_point_limbs(out, R, r, px, py, pz);
}

unsigned blocks(long long R) { return (unsigned)((R + TAIL_THREADS - 1) / TAIL_THREADS); }

}  // namespace

// x, y, z: bucket sums (R, B, 24) int64 each; out (3, R, 24) int64
extern "C" int sonic_bucket_weighted_sum(const void* x, const void* y, const void* z, void* out,
                                         long long R, int B, void* stream) {
  if (R < 0 || B < 1) return (int)cudaErrorInvalidValue;
  if (R > 0)
    weighted_sum_kernel<<<blocks(R), TAIL_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)z, (int64_t*)out, R, B);
  return (int)cudaGetLastError();
}

// x, y, z: window totals (R, W, 24) int64 each; out (3, R, 24) int64; 1 <= c <= 16
extern "C" int sonic_window_combine(const void* x, const void* y, const void* z, void* out,
                                    long long R, int W, int c, void* stream) {
  if (R < 0 || W < 1 || c < 1 || c > 16) return (int)cudaErrorInvalidValue;
  if (R > 0)
    window_combine_kernel<<<blocks(R), TAIL_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)x, (const int64_t*)y, (const int64_t*)z, (int64_t*)out, R, W, c);
  return (int)cudaGetLastError();
}
