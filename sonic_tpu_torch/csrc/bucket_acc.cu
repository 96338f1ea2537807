// Kernel 2: Pippenger bucket sums for G1 with signed digits, lane-free.
//
// Replaces the TPU kernel sonic_tpu/msm/pallas_acc.py:_acc_kernel (launched
// by _acc_pallas under accumulate_pallas / accumulate_batched_pallas),
// together with the lane fold after it (sonic_tpu/msm/pippenger.py
// _fold_lanes): the output is the folded grid, bucket (m, w, b) = the sum
// of sign(d) P_n over the n with |digits[m, n, w]| = b, bucket 0 = infinity.
// Exactly equal, bucket for bucket and in projective form, to
// msm/bucket_acc.py:bucket_sums_plain on the same plan.
//
// Inputs (msm/bucket_acc.py:make_plan builds them with torch index code):
//   pts      (N, 24) uint32: x then y, 12 Montgomery words each, 96 B a
//            point, so a point is six 16-byte loads;
//   ent, key (E,) int32: every (m, n, w) with d != 0 and P_n finite, as
//            n * 2 + (d < 0), sorted stably by key = (m W + w) B + |d|;
//   slot0    (C,) int32: the first partial slot of each chunk of S entries;
//   rounds   of merge offsets, each (G + 1,) int32: group g of a round is
//            its input's [off[g], off[g+1]); the last round has one group
//            per bucket.
// Output: out (3, M, W, B, 24) int64, the x, y, z planes in the port's
// limb layout; partials (P, 36) uint32 are scratch.
//
// What bounds it on an H100: integer multiply-adds. An RCB16 mixed
// addition is 11 Fq products, 11 * 2 * 12^2 word products of 32 x 32 -> 64
// bits, each a lo and a hi multiply-add, against 96 B of point read from
// L2, so the bound is the card's IMAD rate times the plan's E entries.
//
// Design:
//   - Work ordered by bucket: one thread per chunk walks its S entries
//     once and keeps the running sum of the current bucket in registers.
//     The first entry of a bucket sets it to (x, +-y, 1); each further one
//     is one mixed addition; when the key changes or the chunk ends, the
//     sum goes out as one partial (144 B). So a bucket costs one write,
//     not a bucket read and write per point; digit-0 pairs and points at
//     infinity are not in the plan and cost nothing.
//   - No lanes, so no K-fold grid for the tail. Enough threads whatever M:
//     the wrapper asks sonic_bucket_sums_fill for the scan kernel's
//     resident threads on this card (SMs x blocks per SM at its register
//     count, from the occupancy API) and cuts the plan into that many
//     chunks: one full wave.
//   - Deterministic merge, no atomics: a second kernel sums a bucket's
//     partials in slot order with the complete projective addition. A
//     bucket cut into many chunks (one MSM over many points has few
//     buckets and long runs) would make that a long serial chain on few
//     threads, so the merge runs in rounds: each round sums pairs of
//     consecutive partials of one bucket, one thread a pair, and the last
//     round, one thread a bucket, writes the output layout.
//   - The point table is packed into 32-bit words once per call (both G1
//     tables of the main path, ~28,754 rows, are ~2.8 MB: L2-resident),
//     and field.cuh's arithmetic is PTX carry chains.
#include <cuda_runtime.h>

#include "group.cuh"

namespace {

constexpr int SCAN_THREADS = 128;
constexpr int MERGE_THREADS = 128;

// +-P for plan entry e = n * 2 + (d < 0)
__device__ __forceinline__ void load_point(uint32_t* x, uint32_t* y, const uint4* __restrict__ pts,
                                           int e) {
  const uint4* p = pts + (size_t)(e >> 1) * 6;
  load_words(x, p);
  load_words(y, p + 3);
  if (e & 1) neg_mod<Fq>(y, y);
}

// partial slot: x, y, z words, 144 B = 9 x 16 B
__device__ __forceinline__ void store_partial(uint4* __restrict__ parts, int slot, const uint32_t* x,
                                              const uint32_t* y, const uint32_t* z) {
  uint4* p = parts + (size_t)slot * 9;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = make_uint4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
    p[3 + k] = make_uint4(y[4 * k], y[4 * k + 1], y[4 * k + 2], y[4 * k + 3]);
    p[6 + k] = make_uint4(z[4 * k], z[4 * k + 1], z[4 * k + 2], z[4 * k + 3]);
  }
}

__device__ __forceinline__ void load_partial(uint32_t* x, uint32_t* y, uint32_t* z,
                                             const uint4* __restrict__ parts, int slot) {
  const uint4* p = parts + (size_t)slot * 9;
  load_words(x, p);
  load_words(y, p + 3);
  load_words(z, p + 6);
}

// Phase 1: chunk j walks plan entries [j S, min((j + 1) S, E)).
__global__ void __launch_bounds__(SCAN_THREADS)
bucket_scan_kernel(const uint4* __restrict__ pts, const int32_t* __restrict__ ent,
                   const int32_t* __restrict__ key, const int32_t* __restrict__ slot0,
                   uint4* __restrict__ parts, long long E, int S, int C) {
  const int j = blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (j >= C) return;
  const long long i0 = (long long)j * S;
  const long long i1 = min(i0 + S, E);
  int slot = slot0[j];
  int cur = key[i0];
  uint32_t px[NW], py[NW], pz[NW];
  load_point(px, py, pts, ent[i0]);
  set_one(pz);
  for (long long i = i0 + 1; i < i1; ++i) {
    const int k = key[i];
    uint32_t qx[NW], qy[NW];
    load_point(qx, qy, pts, ent[i]);
    if (k != cur) {
      store_partial(parts, slot++, px, py, pz);
      cur = k;
      copy<NW>(px, qx);
      copy<NW>(py, qy);
      set_one(pz);
    } else {
      add_mixed(px, py, pz, qx, qy);
    }
  }
  store_partial(parts, slot, px, py, pz);
}

// Phase 2, one merge round: group g = the sum of src[off[g] .. off[g+1])
// in order (infinity if empty), written as a partial to dst or, in the last
// round (dst null, one group per bucket), as bucket g of the output.
__global__ void __launch_bounds__(MERGE_THREADS)
bucket_merge_kernel(const uint4* __restrict__ src, const int32_t* __restrict__ off,
                    uint4* __restrict__ dst, int64_t* __restrict__ out, int G) {
  const int g = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (g >= G) return;
  const int lo = off[g], hi = off[g + 1];
  uint32_t px[NW], py[NW], pz[NW];
  if (lo == hi) {
#pragma unroll
    for (int j = 0; j < NW; ++j) px[j] = pz[j] = 0;
    set_one(py);
  } else {
    load_partial(px, py, pz, src, lo);
    for (int p = lo + 1; p < hi; ++p) {
      uint32_t qx[NW], qy[NW], qz[NW];
      load_partial(qx, qy, qz, src, p);
      add_full(px, py, pz, qx, qy, qz);
    }
  }
  if (dst != nullptr) {
    store_partial(dst, g, px, py, pz);
    return;
  }
  const size_t plane = (size_t)G * LIMBS;
  int64_t* o = out + (size_t)g * LIMBS;
  store_limbs<NW>(o, px);
  store_limbs<NW>(o + plane, py);
  store_limbs<NW>(o + 2 * plane, pz);
}

}  // namespace

extern "C" int sonic_bucket_scan(const void* pts, const void* ent, const void* key,
                                 const void* slot0, void* parts, long long E, int S, int C,
                                 void* stream) {
  if (C > 0)
    bucket_scan_kernel<<<(C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0,
                         (cudaStream_t)stream>>>((const uint4*)pts, (const int32_t*)ent,
                                                 (const int32_t*)key, (const int32_t*)slot0,
                                                 (uint4*)parts, E, S, C);
  return (int)cudaGetLastError();
}

// dst null: the last round, into out (3, G, 24) int64
extern "C" int sonic_bucket_merge(const void* src, const void* off, void* dst, void* out, int G,
                                  void* stream) {
  if (G > 0)
    bucket_merge_kernel<<<(G + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS, 0,
                          (cudaStream_t)stream>>>((const uint4*)src, (const int32_t*)off,
                                                  (uint4*)dst, (int64_t*)out, G);
  return (int)cudaGetLastError();
}

// Threads of the scan kernel resident on the whole card at once (SMs x
// blocks per SM at its register count), or minus a CUDA error code.
extern "C" long long sonic_bucket_sums_fill(int device) {
  int sms = 0, blocks = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bucket_scan_kernel,
                                                        SCAN_THREADS, 0);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)sms * blocks * SCAN_THREADS;
}
