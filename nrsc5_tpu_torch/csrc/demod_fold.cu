// K2: acquire demodulation of one L1 block per station — derotation ramp,
// 32 x 2160-sample slice and shaped cyclic-prefix fold.
//
// Replaces the JAX device function nrsc5_tpu/ops/acquire_rc.py:demod_rc
// (lines 73-111) up to its DFT, for all stations of a dispatch at once; the
// window slice of nrsc5_tpu/pipeline/scan_chain_rc.py:281-282 is folded in
// (each station's window is read straight from its sample buffer).
//
// samples [S, n_samples, 2] f32, per station offset/samperr/cfo int32,
// angle f32, phase [2] f32 ->
//   folded [S, 32, 2048, 2] bf16, phase_out [S, 2] f32, keep [S] int32
//   n       = sym*2160 + i                       (i < 2160)
//   ramp[n] = phase0 * e^{i(angle/2048*n - 2pi/2048*((cfo*n) mod 2048))}
//   x[n]    = samples[start(offset) + start(samperr) + n] * ramp[n]
//   folded[sym, i] = w[i]*x[sym,i] + w[2048+i]*x[sym,2048+i]   (i < 112)
//                  = x[sym, i]                                 (otherwise)
//   each folded value computed in f32 and rounded to bf16
//
// Bound on the H100: device-memory bytes.  Per station it reads 553 KB of
// samples and writes 262 KB (0.0039 ms for 16 stations at 3.35 TB/s).  The
// arithmetic stays in f32 in the reference's order (the build passes
// -fmad=false, so no FMA contraction): negative integer CFOs take a floor
// mod (an AND with 2047: the FFT length is a power of two), and the window
// and slice starts are placed as lax.dynamic_slice places them (negative
// from the end, then clamped).  Each output value is rounded to nearest,
// ties to even (__floats2bfloat162_rn, as torch's .to(bfloat16) rounds);
// the output is the DFT kernel's operand (csrc/dft_bf16.cu reads it as
// [S*32, 4096], re and im interleaved).
//
// Design: one CTA of 256 threads per (symbol, station).  The symbol's
// 2160 samples are 1080 pairs: thread p takes pairs p, p + 256, ..., p +
// 768 (the symbol's first 2048 samples), and threads 0..55 also take pair
// 1024 + p, the cyclic-prefix tail that folds onto their own first pair, so
// no sample crosses threads.  A pair is one 16-byte load where the
// station's window is 16-byte aligned (else two 8-byte loads) and one
// 8-byte store of two bf16x2.  Each ramp takes one sincosf (one range
// reduction for both).  The station's phase0 — a complex exponential, a
// product and a normalize — is computed once per CTA by thread 0 into
// shared memory while the other threads load their samples and take their
// ramps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FFT = 2048;
constexpr int CP = 112;
constexpr int FFTCP = FFT + CP;
constexpr int NSYM = 32;
constexpr int NSAMP = NSYM * FFTCP;       // 69120
constexpr int WINDOW = FFTCP * (NSYM + 1);  // 71280

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
  return make_float2(cosf(t), sinf(t));
}

__device__ __forceinline__ float2 normalize(float2 a) {
  float d = sqrtf(a.x * a.x + a.y * a.y + 1e-20f);
  return make_float2(a.x / d, a.y / d);
}

constexpr int THREADS = 256;
constexpr int PAIRS = FFT / 2 / THREADS;  // 4 pairs a thread in [0, 2048)
constexpr int TAIL_PAIRS = CP / 2;        // 56 pairs in [2048, 2160)

__device__ __forceinline__ float2 cexp_ramp(float ang_fft, float two_pi_fft,
                                            int cf, int n) {
  const float ra = ang_fft * (float)n
                   - two_pi_fft * (float)((cf * n) & (FFT - 1));
  float s, c;
  sincosf(ra, &s, &c);
  return make_float2(c, s);
}

__global__ void __launch_bounds__(THREADS) demod_fold_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float2* __restrict__ phase,
    const int* __restrict__ samperr, const float* __restrict__ angle,
    const int* __restrict__ cfo, const float* __restrict__ shape,
    float two_pi_over_fft, __nv_bfloat162* __restrict__ folded,
    float2* __restrict__ phase_out, int* __restrict__ keep) {
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
  const long long base = (long long)s * n_samples + win + sl;
  const float2* src = samples + base + (long long)sym * FFTCP;
  const int n0 = sym * FFTCP;

  // the samples and their ramps (without phase0)
  const bool tail = tid < TAIL_PAIRS;
  float2 x[PAIRS + 1][2], r[PAIRS + 1][2];
  if ((reinterpret_cast<uintptr_t>(samples + base) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 0; k <= PAIRS; ++k) {
      if (k == PAIRS && !tail) break;
      const float4 v = __ldg(src4 + tid + THREADS * k);
      x[k][0] = make_float2(v.x, v.y);
      x[k][1] = make_float2(v.z, v.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k <= PAIRS; ++k) {
      if (k == PAIRS && !tail) break;
      x[k][0] = __ldg(src + 2 * (tid + THREADS * k));
      x[k][1] = __ldg(src + 2 * (tid + THREADS * k) + 1);
    }
  }
#pragma unroll
  for (int k = 0; k <= PAIRS; ++k) {
    if (k == PAIRS && !tail) break;
    const int n = n0 + 2 * (tid + THREADS * k);
    r[k][0] = cexp_ramp(ang_fft, two_pi_over_fft, cf, n);
    r[k][1] = cexp_ramp(ang_fft, two_pi_over_fft, cf, n + 1);
  }

  // phase0: the sample-clock phasor moved to this block's symbol start
  if (tid == 0) {
    const int adj_i = FFTCP / 2 - se;
    const float adj = (float)adj_i;
    const float th0 = -adj * ang / (float)FFT
                      + two_pi_over_fft * (float)floor_mod(cf * adj_i, FFT);
    const float2 p0 = normalize(cmul(phase[s], cexp(th0)));
    p0_s = p0;
    if (sym == 0) {
      const float th = ang_fft * (float)NSAMP
                       - two_pi_over_fft * (float)floor_mod(cf * NSAMP, FFT);
      phase_out[s] = normalize(cmul(p0, cexp(th)));
      keep[s] = FFTCP + (FFTCP / 2 - se);
    }
  }
  __syncthreads();
  const float2 p0 = p0_s;

  float2 y[PAIRS][2];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) y[k][h] = cmul(x[k][h], cmul(p0, r[k][h]));
  if (tail) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * tid + h;
      const float2 t = cmul(x[PAIRS][h], cmul(p0, r[PAIRS][h]));
      const float wa = shape[i], wb = shape[FFT + i];
      y[0][h] = make_float2(wa * y[0][h].x + wb * t.x,
                            wa * y[0][h].y + wb * t.y);
    }
  }
  __nv_bfloat162* dst = folded + ((long long)s * NSYM + sym) * FFT;
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    __align__(8) __nv_bfloat162 o[2] = {
        __floats2bfloat162_rn(y[k][0].x, y[k][0].y),
        __floats2bfloat162_rn(y[k][1].x, y[k][1].y)};
    reinterpret_cast<uint2*>(dst)[tid + THREADS * k] =
        *reinterpret_cast<const uint2*>(o);
  }
}

}  // namespace

extern "C" int demod_fold(const void* samples, long long n_samples,
                          const void* offset, const void* phase,
                          const void* samperr, const void* angle,
                          const void* cfo, const void* shape,
                          float two_pi_over_fft, void* folded,
                          void* phase_out, void* keep, int n_stations,
                          void* stream) {
  dim3 grid(NSYM, n_stations);
  demod_fold_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, (const int*)offset,
      (const float2*)phase, (const int*)samperr, (const float*)angle,
      (const int*)cfo, (const float*)shape, two_pi_over_fft,
      (__nv_bfloat162*)folded, (float2*)phase_out, (int*)keep);
  return (int)cudaGetLastError();
}
