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
// samples and writes 262 KB; the sincos per sample is ~40 flops, far under
// the card's f32 rate.  Design: one thread per folded output sample, float2
// loads and stores on neighbouring addresses.  The per-station scalars
// (phase0, phase_out, keep) are recomputed by each thread that needs them
// instead of a second launch.  Arithmetic stays in f32 in the reference's
// order (the build passes -fmad=false, so no FMA contraction): negative
// integer CFOs take a floor mod, and the window and slice starts are placed
// as lax.dynamic_slice places them (negative from the end, then clamped).
// The output is the DFT kernel's operand (csrc/dft_bf16.cu reads it as
// [S*32, 4096], re and im interleaved): each f32 value rounded to nearest,
// ties to even (__floats2bfloat162_rn, as torch's .to(bfloat16) rounds), so
// no f32 fold is stored or rounded in a second pass.

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

__global__ void demod_fold_kernel(const float2* __restrict__ samples,
                                  long long n_samples,
                                  const int* __restrict__ offset,
                                  const float2* __restrict__ phase,
                                  const int* __restrict__ samperr,
                                  const float* __restrict__ angle,
                                  const int* __restrict__ cfo,
                                  const float* __restrict__ shape,
                                  float two_pi_over_fft,
                                  __nv_bfloat162* __restrict__ folded,
                                  float2* __restrict__ phase_out,
                                  int* __restrict__ keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // bin-order index
  const int sym = blockIdx.y;
  const int s = blockIdx.z;
  if (i >= FFT) return;

  const int se = samperr[s];
  const int cf = cfo[s];
  const float ang = angle[s];

  // phase0: the sample-clock phasor moved to this block's symbol start
  const int adj_i = FFTCP / 2 - se;
  const float adj = (float)adj_i;
  const float th0 = -adj * ang / (float)FFT
                    + two_pi_over_fft * (float)floor_mod(cf * adj_i, FFT);
  const float2 p0 = normalize(cmul(phase[s], cexp(th0)));

  const long long win = dynamic_start(offset[s], n_samples, WINDOW);
  const long long sl = dynamic_start(se, WINDOW, NSAMP);
  const float2* src = samples + (long long)s * n_samples + win + sl;

  auto x_at = [&](int n) {
    const float ra = (ang / (float)FFT) * (float)n
                     - two_pi_over_fft * (float)floor_mod(cf * n, FFT);
    return cmul(src[n], cmul(p0, cexp(ra)));
  };

  const int n = sym * FFTCP + i;
  float2 y = x_at(n);
  if (i < CP) {
    const float2 t = x_at(n + FFT);
    const float wa = shape[i], wb = shape[FFT + i];
    y = make_float2(wa * y.x + wb * t.x, wa * y.y + wb * t.y);
  }
  folded[((long long)s * NSYM + sym) * FFT + i] =
      __floats2bfloat162_rn(y.x, y.y);

  if (i == 0 && sym == 0) {
    const float th = (ang / (float)FFT) * (float)NSAMP
                     - two_pi_over_fft * (float)floor_mod(cf * NSAMP, FFT);
    phase_out[s] = normalize(cmul(p0, cexp(th)));
    keep[s] = FFTCP + (FFTCP / 2 - se);
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
  dim3 block(256);
  dim3 grid(FFT / 256, NSYM, n_stations);
  demod_fold_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, (const int*)offset,
      (const float2*)phase, (const int*)samperr, (const float*)angle,
      (const int*)cfo, (const float*)shape, two_pi_over_fft,
      (__nv_bfloat162*)folded, (float2*)phase_out, (int*)keep);
  return (int)cudaGetLastError();
}
