// Kernel 1: batched Montgomery multiplication over Fr or Fq.
//
// Replaces the TPU kernel sonic_tpu/fields/pallas_mul.py:_mont_mul_kernel
// (launched by mont_mul). Same result, a*b*R^-1 mod N canonical, for every
// element of a flat batch; exactly equal to fields/mont_mul.py:mont_mul_plain.
//
// What bounds it on an H100: integer multiply-add throughput. One Fq
// product is 2 * 12 * 12 32-bit multiply-adds (CIOS) for 2 * 192 bytes in
// and 192 bytes out as int64 limbs, about 1 multiply-add per 2 bytes, so a
// large batch is bound by the IMAD rate and, at the int64-limb layout,
// close to memory bandwidth too.
//
// Design: one thread per element. The thread regroups its 16-bit int64
// limbs into 32-bit words in registers, runs the fully unrolled CIOS loop
// of field.cuh with the modulus in constant memory, and writes canonical
// 16-bit limbs back. Broadcast operands are read with a stride of 0
// elements, so the wrapper never expands a constant such as from_mont's 1.
// Not done yet: shared-memory tiles, a packed 32-bit layout and PTX carry
// chains (madc.hi.cc), which later work can add.
#include <cuda_runtime.h>

#include "field.cuh"

template <class F>
__global__ void __launch_bounds__(128)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, long long n, long long sa, long long sb) {
  constexpr int N = F::N;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[N], y[N], r[N];
  load_limbs<N>(x, a + i * sa);
  load_limbs<N>(y, b + i * sb);
  mont_mul<F>(r, x, y);
  store_limbs<N>(out + i * 2 * N, r);
}

extern "C" int sonic_mont_mul(const void* a, const void* b, void* out, long long n,
                              int limbs, long long sa, long long sb, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (limbs == 16) {
    mont_mul_kernel<Fr><<<blocks, threads, 0, s>>>(
        (const int64_t*)a, (const int64_t*)b, (int64_t*)out, n, sa, sb);
  } else if (limbs == 24) {
    mont_mul_kernel<Fq><<<blocks, threads, 0, s>>>(
        (const int64_t*)a, (const int64_t*)b, (int64_t*)out, n, sa, sb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
