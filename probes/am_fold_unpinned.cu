// K12 as it was before the AM loop's carry step moved into K13: its pass-1
// reads of offset and samperr_fb through plain loads, for
// probes/k1am_k5_variants.py.
//
// K12: the two-pass AM acquire of one L1 block per station — derotation
// ramp, 32 x 270-sample slice, shaped 14-sample cyclic-prefix fold and the
// roll into the FFT input, rounded to bfloat16 as the DFT takes it; in
// pass 2 first the pilot-phase regression.
//
// Replaces the JAX device functions
// nrsc5_tpu/pipeline/scan_chain_am_rc.py:59 _am_fold_fft_rc, :84
// _am_process_rc and :114 acquire_am_fine_rc up to each of their two DFTs,
// with the DFT's rounding of its input to bfloat16
// (nrsc5_tpu/ops/rcplx.py:119-120); the 256-point DFT itself stays a
// float32 matmul outside the kernel.  All stations of a dispatch at once;
// the window slice of scan_chain_am_rc.py:269 is folded in (each
// station's window is read straight from its buffer).
//
// samples [S, n_samples, 2] f32; per station offset, samperr_fb, cfo int32,
// prev_angle f32, phase [2] f32 ->
//   samperr = 135 + samperr_fb, angle = prev_angle - 2pi*cfo,
//   phase0  = normalize(phase * e^{i(-(135 - samperr)*angle/256)})
//   x[n]    = window[start(samperr) + n] * (p0 * e^{i (angle/256) n})
//   folded[sym, j] = bf16(y[sym, (j - 121) mod 256]), y[i] = w[i] x[i] +
//                    w[256 + i] x[256 + i] (i < 14), else x[i]
// (bf16(v): v rounded to bfloat16, to nearest, ties to even, and widened
// back to float32, as the DFT's .to(torch.bfloat16) and back rounds it).
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
// 0.00065 ms at 3.35 TB/s); at that size the launch and two dependent
// loads (the station's offset, then its samples) are most of the time.
// Design: one CTA per station and SYMS symbols, one thread per output bin;
// the roll is an index offset, not a copy.  Each thread issues its sample
// loads first (their addresses need only offset and samperr_fb).  In pass
// 1 each thread then forms phase0 itself (measured faster than warp 0
// forming it behind a barrier); in pass 2 warp 0 forms phase0 and the
// pilot fit once for the CTA (32 lanes each take one atan2, then every
// lane runs the fit's serial sums in order on values shuffled from the
// others) while the other warps' loads land, and one barrier hands them
// to the CTA.  The kernel launches with programmatic dependent launch: it
// may start while the kernel before it on the stream ends, and waits for
// it before reading anything.

#include <cuda_bf16.h>
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
constexpr int SYMS = 2;  // symbols a CTA
constexpr unsigned FULL = 0xffffffffu;

static_assert(NSYM % SYMS == 0, "whole CTAs a station");
static_assert(NSYM == 32, "the pilot fit takes a lane a symbol");

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

// cos and sin of t as cosf and sinf give them, from one sincosf
__device__ __forceinline__ float2 cis(float t) {
  float sn, cs;
  sincosf(t, &sn, &cs);
  return make_float2(cs, sn);
}

__device__ __forceinline__ float2 normalize(float2 a) {
  const float d = sqrtf(a.x * a.x + a.y * a.y + 1e-20f);
  return make_float2(a.x / d, a.y / d);
}

__device__ __forceinline__ float2 round_bf16(float2 v) {
  return make_float2(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)));
}

__global__ void __launch_bounds__(FFT) am_fold_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float2* __restrict__ phase,
    const int* __restrict__ samperr_fb, const float* __restrict__ prev_angle,
    const int* __restrict__ cfo, const float* __restrict__ shape,
    const float2* __restrict__ pilot, float2* __restrict__ folded,
    float2* __restrict__ phase_out, float* __restrict__ prev_angle_out,
    int* __restrict__ keep) {
  __shared__ float2 p0_s;  // pass 2: the fold's phase0 after the fit
  __shared__ float ang_s;  // pass 2: angle2
  const int j = threadIdx.x;  // output bin
  const int sym0 = blockIdx.x * SYMS;
  const int s = blockIdx.y;
  // programmatic dependent launch: nothing is read before the kernel
  // ahead of this one on the stream has completed
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // this bin's samples, SYMS symbols (and the cyclic prefix's partner)
  const int samperr = FFTCP / 2 + samperr_fb[s];
  const long long win = dynamic_start(offset[s], n_samples, WINDOW);
  const long long sl = dynamic_start(samperr, WINDOW, NSAMP);
  const float2* src = samples + (long long)s * n_samples + win + sl;
  const int i = (j - ROLL + FFT) % FFT;  // index before the roll
  const bool in_cp = i < CP;
  float2 a[SYMS], b[SYMS];
  float wa = 0.0f, wb = 0.0f;
#pragma unroll
  for (int q = 0; q < SYMS; ++q) {
    const int n = (sym0 + q) * FFTCP + i;
    a[q] = src[n];
    b[q] = in_cp ? src[n + FFT] : make_float2(0.0f, 0.0f);
  }
  if (in_cp) {
    wa = shape[i];
    wb = shape[FFT + i];
  }

  const float cf = (float)cfo[s];
  const float angle = prev_angle[s] - TWO_PI * cf;
  float2 p0;
  float ang;
  if (pilot == nullptr) {
    // pass 1: each thread forms phase0 itself, so no barrier is needed
    const float adj = (float)(FFTCP / 2 - samperr);
    p0 = normalize(cmul(phase[s], cis((-adj * angle) / 256.0f)));
    ang = angle;
  } else {
    // pass 2: warp 0 forms phase0 and the pilot fit once for the CTA
    if (j < 32) {
      const float2 pv = pilot[((long long)s * NSYM + j) * FFT + CENTER];
      const float adj = (float)(FFTCP / 2 - samperr);
      const float2 phase0 =
          normalize(cmul(phase[s], cis((-adj * angle) / 256.0f)));
      // lane l < 31: dphi_l = arg(P_{l+1} conj P_l); lane 31: arg P_0
      const float2 nx = make_float2(__shfl_down_sync(FULL, pv.x, 1),
                                    __shfl_down_sync(FULL, pv.y, 1));
      const float2 first = make_float2(__shfl_sync(FULL, pv.x, 0),
                                       __shfl_sync(FULL, pv.y, 0));
      float v;
      if (j < NSYM - 1) {
        const float2 d = cmul_conj(nx, pv);
        v = atan2f(d.y, d.x);
      } else {
        v = atan2f(first.y, first.x);
      }
      const float a0 = __shfl_sync(FULL, v, NSYM - 1);
      float cs = 0.0f, sxy = 0.0f, sxx = 0.0f, sy = 0.0f;
#pragma unroll
      for (int k = 0; k < NSYM; ++k) {
        const float dphi = __shfl_sync(FULL, v, (k + NSYM - 1) % NSYM);
        if (k > 0) cs = cs + dphi;
        const float y = a0 + cs;
        const float x = (float)FFTCP * ((float)k - 15.5f);
        sxy = k ? sxy + x * y : x * y;
        sxx = k ? sxx + x * x : x * x;
        sy = k ? sy + y : y;
      }
      const float slope = sxy / sxx;
      const float ang2 = angle - slope * (float)FFT;
      const float mean = sy / (float)NSYM;
      const float t =
          (-mean + ((slope * (float)NSYM) * (float)FFTCP) / 2.0f) - 0.06f;
      const float2 p0b = cmul(phase0, cis(t));
      if (j == 0) {
        p0_s = p0b;
        ang_s = ang2;
        if (blockIdx.x == 0) {
          phase_out[s] =
              normalize(cmul(p0b, cis((ang2 / (float)FFT) * (float)NSAMP)));
          prev_angle_out[s] = ang2 + TWO_PI * cf;
          keep[s] = FFTCP + (FFTCP / 2 - samperr);
        }
      }
    }
    __syncthreads();
    p0 = p0_s;
    ang = ang_s;
  }

  const float step = ang / (float)FFT;
#pragma unroll
  for (int q = 0; q < SYMS; ++q) {
    const int n = (sym0 + q) * FFTCP + i;
    float2 y = cmul(a[q], cmul(p0, cis(step * (float)n)));
    if (in_cp) {
      const float2 t = cmul(b[q], cmul(p0, cis(step * (float)(n + FFT))));
      y = make_float2(wa * y.x + wb * t.x, wa * y.y + wb * t.y);
    }
    folded[((long long)s * NSYM + sym0 + q) * FFT + j] = round_bf16(y);
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
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NSYM / SYMS, n_stations);
  cfg.blockDim = dim3(FFT);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, am_fold_kernel, (const float2*)samples, n_samples,
      (const int*)offset, (const float2*)phase, (const int*)samperr_fb,
      (const float*)prev_angle, (const int*)cfo, (const float*)shape,
      (const float2*)pilot, (float2*)folded, (float2*)phase_out,
      (float*)prev_angle_out, (int*)keep);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
