// The complex float32 FFT of the complex chain's demodulators, shared by K17
// (fm_demod_c.cu, 2048 points a symbol) and K19 (am_demod_c.cu, 256 points,
// 32 symbols a CTA): an in-place radix-2 decimation-in-time FFT of whole
// rows held in shared memory, every thread of the CTA taking part.
//
// The rows enter in bit-reversed order (the caller stores value i of a row
// at bit_reverse(i)), so the transform leaves them in natural order.  Stage
// s joins pairs `half` = 2^(s-1) apart with the twiddle e^{-2 pi i j / 2^s}
// = tw[j * N / 2^s], from one table of the N/2 twiddles e^{-2 pi i k / N}
// that the host computes in float64 and rounds to float32 (no sinf or cosf
// in the kernel, no table in local memory: it is read through L2 and L1).
// A butterfly is t = w * b, (a + t, a - t), in float32 with separate
// products and sums (the build passes -fmad=false).

#pragma once

#include <cuda_runtime.h>

namespace nrsc5 {

__device__ __forceinline__ int bit_reverse(int i, int log2n) {
  return (int)(__brev((unsigned)i) >> (32 - log2n));
}

// `rows` rows of 2^LOG2N points at x (row r at x + r * 2^LOG2N); every
// thread of the CTA calls it, `tid` of `nthreads`.  Ends with a barrier.
template <int LOG2N>
__device__ __forceinline__ void fft_rows(float2* x, int rows,
                                         const float2* __restrict__ tw,
                                         int tid, int nthreads) {
  constexpr int N = 1 << LOG2N;
  constexpr int HALF_N = N / 2;
  __syncthreads();
#pragma unroll 1
  for (int s = 1; s <= LOG2N; ++s) {
    const int half = 1 << (s - 1);
    const int step = N >> s;  // twiddle index stride
    for (int b = tid; b < rows * HALF_N; b += nthreads) {
      const int r = b / HALF_N, bb = b % HALF_N;
      const int j = bb & (half - 1);
      const int i0 = r * N + ((bb >> (s - 1)) << s) + j;
      const int i1 = i0 + half;
      const float2 w = __ldg(tw + j * step);
      const float2 a = x[i0], v = x[i1];
      const float2 t = make_float2(w.x * v.x - w.y * v.y,
                                   w.x * v.y + w.y * v.x);
      x[i0] = make_float2(a.x + t.x, a.y + t.y);
      x[i1] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }
}

}  // namespace nrsc5
