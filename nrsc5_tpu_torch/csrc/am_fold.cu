// K12: the two-pass AM acquire of one L1 block per station — derotation
// ramp, 32 x 270-sample slice, shaped 14-sample cyclic-prefix fold and the
// roll into the FFT input; in pass 2 first the pilot-phase regression.
//
// Replaces the JAX device functions
// nrsc5_tpu/pipeline/scan_chain_am_rc.py:59 _am_fold_fft_rc, :84
// _am_process_rc and :114 acquire_am_fine_rc up to each of their two DFTs
// (the 256-point DFT stays a matmul outside the kernel), for all stations
// of a dispatch at once; the window slice of scan_chain_am_rc.py:269 is
// folded in (each station's window is read straight from its buffer).
//
// samples [S, n_samples, 2] f32; per station offset, samperr_fb, cfo int32,
// prev_angle f32, phase [2] f32 ->
//   samperr = 135 + samperr_fb, angle = prev_angle - 2pi*cfo,
//   phase0  = normalize(phase * e^{i(-(135 - samperr)*angle/256)})
//   x[n]    = window[start(samperr) + n] * (p0 * e^{i (angle/256) n})
//   folded[sym, j] = y[sym, (j - 121) mod 256], y[i] = w[i] x[i] +
//                    w[256 + i] x[256 + i] (i < 14), else x[i]
// pass 1 (pilot == nullptr): p0 = phase0, writes folded.
// pass 2 (pilot = pass 1's spectra [S, 32, 256, 2]): from the pilot column
//   (bin 128), dphi_i = arg(P_{i+1} conj P_i), y_i = arg P_0 + dphi_0 + ...
//   + dphi_{i-1}, slope = sum(x_i y_i) / sum(x_i^2) with x_i = 270 (i -
//   15.5), angle2 = angle - 256 slope, p0 = phase0 * e^{i(-mean(y) +
//   slope*32*270/2 - 0.06)}; folds with (p0, angle2) and writes folded,
//   phase_out = normalize(p0 e^{i (angle2/256) 8640}), prev_angle_out =
//   angle2 + 2pi*cfo, keep = 405 - samperr.
// Sums run from the first term to the last, as the plain version's do;
// the build passes -fmad=false, so no FMA contraction.
//
// Bound on the H100: device-memory bytes.  A pass at 16 stations reads 1.1
// MB of samples (and 32 pilot values a station) and writes 1.05 MB (about
// 0.00065 ms at 3.35 TB/s).  Design: one CTA per (symbol, station), one
// thread per output bin; the roll is an index offset, not a copy.  In pass
// 2 each CTA's first warp fits the pilot phase of its station (32 values)
// into shared memory before the fold, rather than a second launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FFT = 256;
constexpr int CP = 14;
constexpr int FFTCP = FFT + CP;
constexpr int NSYM = 32;
constexpr int NSAMP = NSYM * FFTCP;         // 8640
constexpr int WINDOW = FFTCP * (NSYM + 1);  // 8910
constexpr int ROLL = (FFT - CP) / 2;        // 121
constexpr int CENTER = FFT / 2;
constexpr float TWO_PI = 6.283185307179586f;

__device__ __forceinline__ long long dynamic_start(long long start,
                                                   long long dim,
                                                   long long size) {
  if (start < 0) start += dim;
  return start < 0 ? 0 : (start > dim - size ? dim - size : start);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cexp(float t) {
  return make_float2(cosf(t), sinf(t));
}

__device__ __forceinline__ float2 normalize(float2 a) {
  const float d = sqrtf(a.x * a.x + a.y * a.y + 1e-20f);
  return make_float2(a.x / d, a.y / d);
}

__global__ void am_fold_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float2* __restrict__ phase,
    const int* __restrict__ samperr_fb, const float* __restrict__ prev_angle,
    const int* __restrict__ cfo, const float* __restrict__ shape,
    const float2* __restrict__ pilot, float2* __restrict__ folded,
    float2* __restrict__ phase_out, float* __restrict__ prev_angle_out,
    int* __restrict__ keep) {
  __shared__ float dphi[NSYM];  // dphi_0..30; [31] holds arg P_0
  __shared__ float2 fit_p0;     // pass 2's phase0b
  __shared__ float fit_angle;   // pass 2's angle2
  const int j = threadIdx.x;    // output bin
  const int sym = blockIdx.x;
  const int s = blockIdx.y;

  const int samperr = FFTCP / 2 + samperr_fb[s];
  const float cf = (float)cfo[s];
  const float angle = prev_angle[s] - TWO_PI * cf;
  const float adj = (float)(FFTCP / 2 - samperr);
  const float2 phase0 = normalize(cmul(phase[s], cexp((-adj * angle) / 256.0f)));

  float2 p0 = phase0;
  float ang = angle;
  if (pilot != nullptr) {
    const float2* col = pilot + (long long)s * NSYM * FFT + CENTER;
    if (j < NSYM - 1) {
      const float2 d = cmul_conj(col[(j + 1) * FFT], col[j * FFT]);
      dphi[j] = atan2f(d.y, d.x);
    } else if (j == NSYM - 1) {
      const float2 a = col[0];
      dphi[NSYM - 1] = atan2f(a.y, a.x);
    }
    __syncthreads();
    if (j == 0) {
      const float a0 = dphi[NSYM - 1];
      float cs = 0.0f, sxy = 0.0f, sxx = 0.0f, sy = 0.0f;
      for (int i = 0; i < NSYM; ++i) {
        if (i > 0) cs = cs + dphi[i - 1];
        const float y = a0 + cs;
        const float x = (float)FFTCP * ((float)i - 15.5f);
        sxy = i ? sxy + x * y : x * y;
        sxx = i ? sxx + x * x : x * x;
        sy = i ? sy + y : y;
      }
      const float slope = sxy / sxx;
      fit_angle = angle - slope * (float)FFT;
      const float mean = sy / (float)NSYM;
      const float t =
          (-mean + ((slope * (float)NSYM) * (float)FFTCP) / 2.0f) - 0.06f;
      fit_p0 = cmul(phase0, cexp(t));
    }
    __syncthreads();
    p0 = fit_p0;
    ang = fit_angle;
  }

  const long long win = dynamic_start(offset[s], n_samples, WINDOW);
  const long long sl = dynamic_start(samperr, WINDOW, NSAMP);
  const float2* src = samples + (long long)s * n_samples + win + sl;
  const float step = ang / (float)FFT;
  auto x_at = [&](int n) {
    return cmul(src[n], cmul(p0, cexp(step * (float)n)));
  };

  const int i = (j - ROLL + FFT) % FFT;  // index before the roll
  const int n = sym * FFTCP + i;
  float2 y = x_at(n);
  if (i < CP) {
    const float2 t = x_at(n + FFT);
    const float wa = shape[i], wb = shape[FFT + i];
    y = make_float2(wa * y.x + wb * t.x, wa * y.y + wb * t.y);
  }
  folded[((long long)s * NSYM + sym) * FFT + j] = y;

  if (pilot != nullptr && j == 0 && sym == 0) {
    phase_out[s] = normalize(cmul(p0, cexp(step * (float)NSAMP)));
    prev_angle_out[s] = ang + TWO_PI * cf;
    keep[s] = FFTCP + (FFTCP / 2 - samperr);
  }
}

}  // namespace

extern "C" int am_fold(const void* samples, long long n_samples,
                       const void* offset, const void* phase,
                       const void* samperr_fb, const void* prev_angle,
                       const void* cfo, const void* shape, const void* pilot,
                       void* folded, void* phase_out, void* prev_angle_out,
                       void* keep, int n_stations, void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW ||
      (pilot != nullptr &&
       (phase_out == nullptr || prev_angle_out == nullptr || keep == nullptr)))
    return (int)cudaErrorInvalidValue;
  dim3 grid(NSYM, n_stations);
  am_fold_kernel<<<grid, FFT, 0, (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, (const int*)offset,
      (const float2*)phase, (const int*)samperr_fb, (const float*)prev_angle,
      (const int*)cfo, (const float*)shape, (const float2*)pilot,
      (float2*)folded, (float2*)phase_out, (float*)prev_angle_out,
      (int*)keep);
  return (int)cudaGetLastError();
}
