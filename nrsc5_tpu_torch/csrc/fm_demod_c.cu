// K17: the complex chain's FM demodulation of one L1 block per station —
// ingest conjugation, derotation ramp, 32 x 2160-sample slice, shaped
// cyclic-prefix fold, a 2048-point complex FFT per symbol and the
// fftshift.
//
// Replaces the JAX device function nrsc5_tpu/ops/acquire.py:176 _demod
// (reached from acquire_fm / acquire_fm_fine, :222 and :260, inside the
// lax.scan of nrsc5_tpu/pipeline/scan_chain.py:149-184), for all stations
// of a dispatch at once; the window slice of scan_chain.py's _window is
// folded in (each station's window is read straight from its buffer, at
// the start lax.dynamic_slice clamps it to).
//
// samples [S, n_samples] complex64 (unconjugated), per station offset,
// samperr, cfo int32, angle f32, phase complex64 ->
//   spectra [S, 32, 2048] complex64, phase_out [S] complex64, keep [S] int32
//   half    = 1080 - samperr
//   phase0  = normalize(phase * e^{-i half angle / 2048}
//                             * e^{i 2pi/2048 ((cfo half) mod 2048)})
//   x[n]    = conj(window[start(samperr) + n]) * phase0
//             * e^{i (angle/2048 n - 2pi/2048 ((cfo n) mod 2048))}
//   y[sym, i] = w[i] x[sym, i] + w[2048 + i] x[sym, 2048 + i]   (i < 112)
//             = x[sym, i]                                        (otherwise)
//   spectra[sym, m] = FFT(y[sym])[(m + 1024) mod 2048]
//   phase_out = normalize(phase0 e^{i (angle/2048 69120 - 2pi/2048 ((cfo
//               69120) mod 2048))}), keep = 2160 + half
// in float32; the integer CFO's products by exact integer arithmetic, a
// floor mod for negative CFOs (an AND with 2047: the FFT length is a power
// of two).  The FFT (fft_c.cuh) is radix 2 with float64-rounded twiddles,
// so the spectra differ from cuFFT's and pocketfft's by their summation
// order only: within a small multiple of float32's epsilon of each row's
// largest magnitude.
//
// Bound on the H100: device-memory bytes.  A block reads 553 KB of samples
// and writes 524 KB of spectra a station, 17.2 MB for 16 stations: 0.0051
// ms at 3.35 TB/s.  The FFT's 5 N log2 N = 0.11 MFLOP a symbol, 58 MFLOP
// for 16 stations, is 0.0009 ms at the float32 rate.
//
// Design: one CTA of 256 threads per (symbol, station), 512 CTAs for 16
// stations.  Thread t loads samples t, t + 256, ... of the symbol's first
// 2048 (coalesced 8-byte loads), threads t < 112 also its cyclic-prefix
// tail 2048 + t, which folds onto its own sample t, so no sample crosses
// threads; each ramp is one sincosf.  The folded point i goes to shared
// memory (16 KB) at bit_reverse(i), eleven radix-2 stages follow, and the
// fftshift is an index offset of the coalesced store.  phase0 is formed by
// thread 0 while the others load; the symbol-0 CTA also writes phase_out
// and keep.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_c.cuh"

namespace {

constexpr int LOG2_FFT = 11;
constexpr int FFT = 1 << LOG2_FFT;
constexpr int CP = 112;
constexpr int FFTCP = FFT + CP;
constexpr int NSYM = 32;
constexpr int NSAMP = NSYM * FFTCP;         // 69120
constexpr int WINDOW = FFTCP * (NSYM + 1);  // 71280
constexpr int THREADS = 256;
constexpr int PER_THREAD = FFT / THREADS;   // 8

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// lax.dynamic_slice's start: a negative start counts from the end, then
// the start is clamped so that the slice lies inside the axis
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

__global__ void __launch_bounds__(THREADS) fm_demod_c_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float2* __restrict__ phase,
    const int* __restrict__ samperr, const float* __restrict__ angle,
    const int* __restrict__ cfo, const float* __restrict__ shape,
    const float2* __restrict__ twiddle, float two_pi_over_fft,
    float2* __restrict__ spectra, float2* __restrict__ phase_out,
    int* __restrict__ keep) {
  __shared__ float2 buf[FFT];
  __shared__ float2 p0_s;
  const int sym = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;

  const int se = samperr[s];
  const int cf = cfo[s];
  const float ang = angle[s];
  const float ang_fft = ang / (float)FFT;
  const long long win = dynamic_start(offset[s], n_samples, WINDOW);
  const long long sl = dynamic_start(se, WINDOW, NSAMP);
  const float2* src = samples + (long long)s * n_samples + win + sl
                      + (long long)sym * FFTCP;

  // the samples first: their addresses need only offset and samperr
  const bool tail = tid < CP;
  float2 x[PER_THREAD], xt = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) x[k] = __ldg(src + tid + THREADS * k);
  if (tail) xt = __ldg(src + FFT + tid);

  if (tid == 0) {
    const int half = FFTCP / 2 - se;
    const float th1 = (-(float)half * ang) / (float)FFT;
    const float th2 = two_pi_over_fft * (float)floor_mod(cf * half, FFT);
    const float2 p0 = normalize(cmul(cmul(phase[s], cexp(th1)), cexp(th2)));
    p0_s = p0;
    if (sym == 0) {
      const float th = ang_fft * (float)NSAMP
                       - two_pi_over_fft * (float)floor_mod(cf * NSAMP, FFT);
      phase_out[s] = normalize(cmul(p0, cexp(th)));
      keep[s] = FFTCP + half;
    }
  }
  __syncthreads();
  const float2 p0 = p0_s;
  const int n0 = sym * FFTCP;

#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + THREADS * k;
    const int n = n0 + i;
    const float ra = ang_fft * (float)n
                     - two_pi_over_fft * (float)((cf * n) & (FFT - 1));
    float2 y = cmul(make_float2(x[k].x, -x[k].y), cmul(p0, cexp(ra)));
    if (k == 0 && tail) {
      const int nt = n + FFT;
      const float rt = ang_fft * (float)nt
                       - two_pi_over_fft * (float)((cf * nt) & (FFT - 1));
      const float2 t = cmul(make_float2(xt.x, -xt.y), cmul(p0, cexp(rt)));
      const float wa = shape[i], wb = shape[FFT + i];
      y = make_float2(wa * y.x + wb * t.x, wa * y.y + wb * t.y);
    }
    buf[nrsc5::bit_reverse(i, LOG2_FFT)] = y;
  }
  nrsc5::fft_rows<LOG2_FFT>(buf, 1, twiddle, tid, THREADS);

  float2* dst = spectra + ((long long)s * NSYM + sym) * FFT;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int m = tid + THREADS * k;
    dst[m] = buf[(m + FFT / 2) & (FFT - 1)];
  }
}

}  // namespace

extern "C" int fm_demod_c(const void* samples, long long n_samples,
                          const void* offset, const void* phase,
                          const void* samperr, const void* angle,
                          const void* cfo, const void* shape,
                          const void* twiddle, float two_pi_over_fft,
                          void* spectra, void* phase_out, void* keep,
                          int n_stations, void* stream) {
  if (n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  dim3 grid(NSYM, n_stations);
  fm_demod_c_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, (const int*)offset,
      (const float2*)phase, (const int*)samperr, (const float*)angle,
      (const int*)cfo, (const float*)shape, (const float2*)twiddle,
      two_pi_over_fft, (float2*)spectra, (float2*)phase_out, (int*)keep);
  return (int)cudaGetLastError();
}
