// Kernel 1: batched Montgomery multiplication over Fr or Fq.
//
// Replaces the TPU kernel sonic_tpu/fields/pallas_mul.py:_mont_mul_kernel
// (launched by mont_mul). Same result, a*b*R^-1 mod N canonical, for every
// element of a flat batch; exactly equal to fields/mont_mul.py:mont_mul_plain.
//
// What bounds it on an H100: device-memory bytes. The port's field layout
// is int64 16-bit limbs, so an Fq product reads 2 * 192 B and writes 192 B
// (576 B; Fr 384 B) for 2 * 12^2 word products: at 3.35 TB/s and the
// card's integer multiply-add rate the bytes take several times longer
// than the multiplies, so the kernel is as fast as its loads and stores.
//
// Design: a block of T threads owns T consecutive elements. Its tiles of a
// and b are contiguous in memory; the block copies them with one 16-byte
// load per thread per step (neighbouring threads on neighbouring addresses:
// every sector is used whole), and each 16-byte load is one limb pair, so
// it lands in shared memory already packed as one 32-bit word, transposed
// to [word][element] with a padded row so that the compute phase reads
// without bank conflicts. Each thread then runs the PTX carry-chain CIOS of
// field.cuh on its element and writes its result words back to shared
// memory, and the block stores the output tile as 16-byte stores, again
// coalesced. Plain vector loads, not cp.async or a bulk TMA copy: the
// tile is used once, the conversion to words happens on the way in, and
// nothing is left to overlap inside one block; many resident blocks per SM
// hide the latency instead. A broadcast operand (stride 0, e.g. from_mont's
// 1) is read by every thread straight from global memory, where it is one
// cached line.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int THREADS = 128;

// Row length of a transposed tile: a multiple of 32 plus a pad chosen so
// that the 32 words one warp writes per step fall in distinct banks.
template <int N>
constexpr int ROW = THREADS + (N == 8 ? 4 : 3);

// Copy ne elements of 2N int64 limbs (16-byte aligned) into s[word][element].
template <int N>
__device__ __forceinline__ void tile_load(uint32_t* s, const int64_t* src, int ne) {
  const longlong2* v = reinterpret_cast<const longlong2*>(src);
  for (int q = threadIdx.x; q < ne * N; q += THREADS) {
    const longlong2 l = v[q];
    s[(q % N) * ROW<N> + q / N] = (uint32_t)l.x | ((uint32_t)l.y << 16);
  }
}

template <int N>
__device__ __forceinline__ void tile_store(int64_t* dst, const uint32_t* s, int ne) {
  longlong2* v = reinterpret_cast<longlong2*>(dst);
  for (int q = threadIdx.x; q < ne * N; q += THREADS) {
    const uint32_t w = s[(q % N) * ROW<N> + q / N];
    v[q] = make_longlong2((long long)(w & 0xffffu), (long long)(w >> 16));
  }
}

template <class F>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, long long n, long long sa, long long sb) {
  constexpr int N = F::N;
  constexpr int LD = ROW<N>;
  __shared__ uint32_t ta[N * LD], tb[N * LD];
  const long long e0 = (long long)blockIdx.x * THREADS;
  const int ne = (int)min((long long)THREADS, n - e0);
  const int i = threadIdx.x;
  if (sa) tile_load<N>(ta, a + e0 * 2 * N, ne);
  if (sb) tile_load<N>(tb, b + e0 * 2 * N, ne);
  __syncthreads();
  uint32_t x[N], y[N], r[N];
  if (i < ne) {
    if (sa) {
#pragma unroll
      for (int j = 0; j < N; ++j) x[j] = ta[j * LD + i];
    } else {
      load_limbs<N>(x, a);
    }
    if (sb) {
#pragma unroll
      for (int j = 0; j < N; ++j) y[j] = tb[j * LD + i];
    } else {
      load_limbs<N>(y, b);
    }
    mont_mul<F>(r, x, y);
  }
  __syncthreads();  // every thread has read ta: reuse it for the output tile
  if (i < ne) {
#pragma unroll
    for (int j = 0; j < N; ++j) ta[j * LD + i] = r[j];
  }
  __syncthreads();
  tile_store<N>(out + e0 * 2 * N, ta, ne);
}

}  // namespace

// a, b: 16-byte aligned int64 limbs; sa, sb: element strides in limbs,
// 2N (contiguous) or 0 (one broadcast element).
extern "C" int sonic_mont_mul(const void* a, const void* b, void* out, long long n,
                              int limbs, long long sa, long long sb, void* stream) {
  if ((sa != 0 && sa != limbs) || (sb != 0 && sb != limbs)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (limbs == 16) {
    mont_mul_kernel<Fr><<<blocks, THREADS, 0, s>>>(
        (const int64_t*)a, (const int64_t*)b, (int64_t*)out, n, sa, sb);
  } else if (limbs == 24) {
    mont_mul_kernel<Fq><<<blocks, THREADS, 0, s>>>(
        (const int64_t*)a, (const int64_t*)b, (int64_t*)out, n, sa, sb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
