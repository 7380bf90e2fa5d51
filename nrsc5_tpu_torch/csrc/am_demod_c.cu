// K19: the complex chain's two-pass AM demodulation of one L1 block per
// station — derotation ramp, 32 x 270-sample slice, shaped 14-sample
// cyclic-prefix fold, the roll into the FFT input and a 256-point complex
// FFT per symbol (pass 1); the pilot's unwrapped-phase regression; the same
// again at the corrected phase and angle (pass 2); the magnitude sums of
// pass 1 for the coarse CFO search.
//
// Replaces the JAX device functions nrsc5_tpu/ops/acquire.py:371
// _am_process with :288 _am_fold_fft (reached from acquire_am /
// acquire_am_fine, inside the lax.scan of
// nrsc5_tpu/pipeline/scan_chain_am.py:48-49), for all stations of a
// dispatch at once; the window slice of scan_chain.py's _window is folded
// in (each station's window is read straight from its buffer).
//
// samples [S, n_samples] complex64, per station offset, samperr, cfo
// int32, prev_angle f32, phase complex64 ->
//   spectra [S, 32, 256] complex64 (pass 2), mag_sums [S, 256] f32,
//   phase_out [S] complex64, prev_angle_out [S] f32, keep [S] int32
//   angle   = prev_angle - 2pi cfo
//   phase0  = normalize(phase * e^{-i (135 - samperr) angle / 256})
//   x[n]    = window[start(samperr) + n] * p0 e^{i (angle/256) n}
//   y[sym, i] = w[i] x[sym, i] + w[256 + i] x[sym, 256 + i]  (i < 14),
//             = x[sym, i] otherwise;  rolled by 121: z[(i + 121) mod 256]
//   spectra[sym, m] = FFT(z[sym])[(m + 128) mod 256]
// pass 1 at (p0, angle) = (phase0, angle); from its pilot column (bin 128)
//   P: dphi_k = arg(P_{k+1} conj P_k), y_k = arg P_0 + dphi_0 + ... +
//   dphi_{k-1}, x_k = 270 (k - 15.5), slope = sum(x y) / sum(x x),
//   angle2 = angle - 256 slope, corr = e^{i(-mean(y) + slope 32 270 / 2 -
//   0.06)} (the reference's empirical -0.06, src/acquire.c:236-239);
//   mag_sums[m] = sum_sym |spectra1[sym, m]|;
// pass 2 at (phase0 corr, angle2); phase_out = normalize(phase0 corr
//   e^{i (angle2/256) 8640}), prev_angle_out = angle2 + 2pi cfo, keep =
//   270 + 135 - samperr.
// In float32 (-fmad=false); the FFT (fft_c.cuh) is radix 2 with
// float64-rounded twiddles, so the spectra differ from cuFFT's and
// pocketfft's by their summation order only.
//
// Bound on the H100: device-memory bytes.  A block at 16 stations reads 1.1
// MB of samples (pass 2 reads them again, from L2) and writes 1.05 MB of
// spectra and 16 KB of magnitude sums: 0.00065 ms at 3.35 TB/s; two
// passes of 32 256-point FFTs a station are 6.6 MFLOP for 16 stations,
// 0.0001 ms at the float32 rate.  So the kernel is bound by its latency.
//
// Design: one CTA of 256 threads per station, both passes in it (pass 2
// depends on pass 1's pilot, and no other CTA needs it): the 32 x 256
// points (64 KB of dynamic shared memory) are filled by thread t with
// point t of every symbol (and, for t < 14, the cyclic-prefix tail that
// folds onto it), stored at the bit-reversed rolled index, transformed by
// eight radix-2 stages over the 32 rows, and written with the fftshift as
// an index offset.  Between the passes warp 0 fits the pilot: a lane a
// symbol takes its phase step's atan2, lane 0 the ordered sums, while the
// other warps' threads sum their bin's magnitudes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_c.cuh"

namespace {

constexpr int LOG2_FFT = 8;
constexpr int FFT = 1 << LOG2_FFT;
constexpr int CP = 14;
constexpr int FFTCP = FFT + CP;
constexpr int NSYM = 32;
constexpr int NSAMP = NSYM * FFTCP;         // 8640
constexpr int WINDOW = FFTCP * (NSYM + 1);  // 8910
constexpr int ROLL = (FFT - CP) / 2;        // 121
constexpr int THREADS = 256;
constexpr int SMEM = NSYM * FFT * (int)sizeof(float2);  // 64 KB

__device__ __forceinline__ long long dynamic_start(long long start,
                                                   long long dim,
                                                   long long size) {
  if (start < 0) start += dim;
  return start < 0 ? 0 : (start > dim - size ? dim - size : start);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cexp(float t) {
  float s, c;
  sincosf(t, &s, &c);
  return make_float2(c, s);
}

__device__ __forceinline__ float2 normalize(float2 a) {
  const float d = hypotf(a.x, a.y);
  return make_float2(a.x / d, a.y / d);
}

// one pass: fold, roll and transform all 32 symbols at (p0, angle) into
// buf (natural order; the fftshift is the reader's)
__device__ __forceinline__ void fold_fft(float2* buf, const float2* src,
                                         const float* shape,
                                         const float2* tw, float2 p0,
                                         float angle, int tid) {
  const float a = angle / (float)FFT;
  const int j = (tid + ROLL) & (FFT - 1);
  const int dst = nrsc5::bit_reverse(j, LOG2_FFT);
  const bool tail = tid < CP;
  for (int k = 0; k < NSYM; ++k) {
    const int n = k * FFTCP + tid;
    float2 y = cmul(__ldg(src + n), cmul(p0, cexp(a * (float)n)));
    if (tail) {
      const int nt = n + FFT;
      const float2 t = cmul(__ldg(src + nt), cmul(p0, cexp(a * (float)nt)));
      const float wa = shape[tid], wb = shape[FFT + tid];
      y = make_float2(wa * y.x + wb * t.x, wa * y.y + wb * t.y);
    }
    buf[k * FFT + dst] = y;
  }
  nrsc5::fft_rows<LOG2_FFT>(buf, NSYM, tw, tid, THREADS);
}

__global__ void __launch_bounds__(THREADS) am_demod_c_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float2* __restrict__ phase,
    const int* __restrict__ samperr, const float* __restrict__ prev_angle,
    const int* __restrict__ cfo, const float* __restrict__ shape,
    const float2* __restrict__ twiddle, float two_pi,
    float2* __restrict__ spectra, float* __restrict__ mag_sums,
    float2* __restrict__ phase_out, float* __restrict__ prev_angle_out,
    int* __restrict__ keep) {
  extern __shared__ float2 buf[];  // [NSYM][FFT]
  __shared__ float dphi[NSYM], fit[2];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;

  const int se = samperr[s];
  const float cf = (float)cfo[s];
  const float angle = prev_angle[s] - two_pi * cf;
  const long long win = dynamic_start(offset[s], n_samples, WINDOW);
  const long long sl = dynamic_start(se, WINDOW, NSAMP);
  const float2* src = samples + (long long)s * n_samples + win + sl;
  const float th0 = (-(float)(FFTCP / 2 - se) * angle) / (float)FFT;
  const float2 phase0 = normalize(cmul(phase[s], cexp(th0)));

  // pass 1, then the pilot fit on warp 0 beside the magnitude sums
  fold_fft(buf, src, shape, twiddle, phase0, angle, tid);
  if (tid < 32) {
    const float2 p = buf[tid * FFT];  // bin 128 after the shift
    const float2 q = buf[(tid < NSYM - 1 ? tid + 1 : tid) * FFT];
    dphi[tid] = atan2f(q.y * p.x - q.x * p.y, q.x * p.x + q.y * p.y);
    __syncwarp();
    if (tid == 0) {
      float y = atan2f(p.y, p.x), c = 0.0f;
      float sxy = 0.0f, sxx = 0.0f, sy = 0.0f;
      for (int k = 0; k < NSYM; ++k) {
        if (k) c = c + dphi[k - 1];
        const float yk = y + c;
        const float xk = (float)FFTCP * ((float)k - 15.5f);
        sxy = sxy + xk * yk;
        sxx = sxx + xk * xk;
        sy = sy + yk;
      }
      const float slope = sxy / sxx;
      fit[0] = angle - slope * (float)FFT;
      fit[1] = (-(sy / (float)NSYM) + slope * (float)NSYM * (float)FFTCP
                / 2.0f) - 0.06f;
    }
  }
  {
    const int m = tid, src_bin = (m + FFT / 2) & (FFT - 1);
    float acc = 0.0f;
    for (int k = 0; k < NSYM; ++k) {
      const float2 v = buf[k * FFT + src_bin];
      acc = acc + hypotf(v.x, v.y);
    }
    mag_sums[(long long)s * FFT + m] = acc;
  }
  __syncthreads();
  const float angle2 = fit[0];
  const float2 p0c = cmul(phase0, cexp(fit[1]));

  // pass 2
  fold_fft(buf, src, shape, twiddle, p0c, angle2, tid);
  float2* dst = spectra + (long long)s * NSYM * FFT;
  for (int k = 0; k < NSYM; ++k)
    dst[k * FFT + tid] = buf[k * FFT + ((tid + FFT / 2) & (FFT - 1))];
  if (tid == 0) {
    phase_out[s] = normalize(
        cmul(p0c, cexp(angle2 / (float)FFT * (float)NSAMP)));
    prev_angle_out[s] = angle2 + two_pi * cf;
    keep[s] = FFTCP + (FFTCP / 2 - se);
  }
}

}  // namespace

extern "C" int am_demod_c(const void* samples, long long n_samples,
                          const void* offset, const void* phase,
                          const void* samperr, const void* prev_angle,
                          const void* cfo, const void* shape,
                          const void* twiddle, float two_pi, void* spectra,
                          void* mag_sums, void* phase_out,
                          void* prev_angle_out, void* keep, int n_stations,
                          void* stream) {
  if (n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      am_demod_c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  am_demod_c_kernel<<<n_stations, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, (const int*)offset,
      (const float2*)phase, (const int*)samperr, (const float*)prev_angle,
      (const int*)cfo, (const float*)shape, (const float2*)twiddle, two_pi,
      (float2*)spectra, (float*)mag_sums, (float2*)phase_out,
      (float*)prev_angle_out, (int*)keep);
  return (int)cudaGetLastError();
}
