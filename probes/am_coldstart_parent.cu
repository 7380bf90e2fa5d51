// K14's am_coarse and am_cfo_step as they were before their redesign, for
// probes/k14_coarse_cfo_variants.py: am_coarse one CTA of 512 threads a
// station, the tone-subtracted window in 71 KB of shared memory, each
// sample a load, a cosf and a sinf in turn; am_cfo_step one CTA a station,
// a thread a bin summing its 32 strided loads one after another.  The
// arithmetic is the port's, so both are exact against the plain versions.
//
// Phase cuts and a clock, for timing the parent's parts:
//   -DCOARSE_STOP=1  return after the tone-subtract loop (x in shared memory)
//   -DCOARSE_STOP=2  ... after the 270 lane sums
//   -DCOARSE_STOP=3  ... after the 14-tap window and the block argmax
//                    (a cut kernel writes one value of its last phase into
//                    v_max, so its outputs are not the function's)
//   -DCOARSE_CLOCK   thread 0 of each CTA writes the global timer (ns) at
//                    its entry and after each of the four phases into
//                    clock[8 s ...] (int64, 8 a station)
//   -DCFO_UNROLL     am_cfo_step's loop fully unrolled
//
// Entry points: am_coarse_parent (am_coarse's arguments, then clock, which
// may be null) and am_cfo_step_parent (am_cfo_step's).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef COARSE_STOP
#define COARSE_STOP 4
#endif

namespace {

constexpr int FFT = 256;
constexpr int CP = 14;
constexpr int FFTCP = FFT + CP;
constexpr int NSYM = 32;
constexpr int WINDOW = FFTCP * (NSYM + 1);
constexpr int COARSE_THREADS = 512;
constexpr int CFO_LO = FFT / 2 - 53;
constexpr int CFO_BINS = 2 * 53 + 1;
constexpr float NEG_TWO_PI = -6.283185307179586f;
constexpr float HALF_SPAN = 4454.5f;

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

__device__ __forceinline__ void tick(long long* clock, int s, int k) {
#ifdef COARSE_CLOCK
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    clock[8 * s + k] = (long long)t;
  }
#endif
}

__device__ int block_argmax(float best, int at, float* bp, int* bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, at, o);
    if (ob > best || (ob == best && oi < at)) {
      best = ob;
      at = oi;
    }
  }
  const int warps = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0) {
    bp[threadIdx.x >> 5] = best;
    bi[threadIdx.x >> 5] = at;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < warps; ++w) {
      if (bp[w] > best || (bp[w] == best && bi[w] < at)) {
        best = bp[w];
        at = bi[w];
      }
    }
    bi[0] = at;
  }
  __syncthreads();
  const int r = bi[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(COARSE_THREADS) am_coarse_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float* __restrict__ f_in,
    const float2* __restrict__ amp_in, const float* __restrict__ prev_angle,
    const int* __restrict__ coarse_override,
    const float* __restrict__ shape_kernel, int* __restrict__ measured,
    int* __restrict__ samperr, float* __restrict__ prev_angle_out,
    float2* __restrict__ v_max, long long* __restrict__ clock) {
  extern __shared__ float2 x[];  // the tone-subtracted window [WINDOW]
  __shared__ float2 sums[FFTCP];
  __shared__ float2 v_s[FFTCP];
  __shared__ float kern[CP];
  __shared__ float bp[COARSE_THREADS / 32];
  __shared__ int bi[COARSE_THREADS / 32];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  tick(clock, s, 0);
  if (tid < CP) kern[tid] = shape_kernel[tid];
  const float2* w =
      samples + (long long)s * n_samples + dynamic_start(offset[s], n_samples, WINDOW);
  const float c = NEG_TWO_PI * f_in[s];
  const float2 amp = amp_in[s];
  for (int n = tid; n < WINDOW; n += COARSE_THREADS) {
    const float2 e = cexp(c * ((float)n - HALF_SPAN));
    const float2 tone = cmul(amp, make_float2(e.x, -e.y));
    const float2 a = w[n];
    x[n] = make_float2(a.x - tone.x, a.y - tone.y);
  }
  __syncthreads();
  tick(clock, s, 1);
#if COARSE_STOP == 1
  if (tid == 0) v_max[s] = x[s % WINDOW];
  return;
#endif

  if (tid < FFTCP) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int k = 0; k < NSYM; ++k) {
      const float2 p = cmul_conj(x[k * FFTCP + tid], x[FFT + k * FFTCP + tid]);
      acc = k ? make_float2(acc.x + p.x, acc.y + p.y) : p;
    }
    sums[tid] = acc;
  }
  __syncthreads();
  tick(clock, s, 2);
#if COARSE_STOP == 2
  if (tid == 0) v_max[s] = sums[s % FFTCP];
  return;
#endif

  float best = -1.0f;
  int at = 0x7fffffff;
  if (tid < FFTCP) {
    float2 v = make_float2(0.0f, 0.0f);
    for (int j = 0; j < CP; ++j) {
      int m = tid + j;
      if (m >= FFTCP) m -= FFTCP;
      const float2 t = make_float2(sums[m].x * kern[j], sums[m].y * kern[j]);
      v = j ? make_float2(v.x + t.x, v.y + t.y) : t;
    }
    v_s[tid] = v;
    best = v.x * v.x + v.y * v.y;
    at = tid;
  }
  const int i_max = block_argmax(best, at, bp, bi);
  tick(clock, s, 3);
#if COARSE_STOP == 3
  if (tid == 0) v_max[s] = v_s[i_max];
  return;
#endif

  if (tid == 0) {
    const float2 v = v_s[i_max];
    const int ov = coarse_override[s];
    const float pa = prev_angle[s];
    const float2 r = cmul(v, cexp(-pa));
    const float diff = atan2f(r.y, r.x);
    measured[s] = i_max;
    samperr[s] = ov >= 0 ? ov % FFTCP : i_max;
    prev_angle_out[s] = pa + diff * (pa != 0.0f ? 0.25f : 1.0f);
    v_max[s] = v;
  }
  tick(clock, s, 4);
}

__global__ void __launch_bounds__(128) am_cfo_step_kernel(
    const float2* __restrict__ spectra, float* __restrict__ mags,
    int* __restrict__ step) {
  __shared__ float bp[4];
  __shared__ int bi[4];
  const int s = blockIdx.x;
  const int b = threadIdx.x;
  float best = -1.0f;
  int at = 0x7fffffff;
  if (b < CFO_BINS) {
    const float2* sp = spectra + (long long)s * NSYM * FFT + CFO_LO + b;
    float acc = 0.0f;
#ifdef CFO_UNROLL
#pragma unroll
#endif
    for (int sym = 0; sym < NSYM; ++sym) {
      const float2 v = sp[sym * FFT];
      const float a = sqrtf(v.x * v.x + v.y * v.y);
      acc = sym ? acc + a : a;
    }
    mags[s * CFO_BINS + b] = acc;
    best = acc;
    at = b;
  }
  const int arg = block_argmax(best, at, bp, bi);
  if (b == 0) step[s] = arg + CFO_LO - FFT / 2;
}

}  // namespace

extern "C" int am_coarse_parent(const void* samples, long long n_samples,
                                const void* offset, const void* f,
                                const void* amp, const void* prev_angle,
                                const void* coarse_override,
                                const void* shape_kernel, void* measured,
                                void* samperr, void* prev_angle_out,
                                void* v_max, void* clock, int n_stations,
                                void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  const int smem = WINDOW * (int)sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      am_coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  am_coarse_kernel<<<n_stations, COARSE_THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, (const int*)offset, (const float*)f,
      (const float2*)amp, (const float*)prev_angle,
      (const int*)coarse_override, (const float*)shape_kernel, (int*)measured,
      (int*)samperr, (float*)prev_angle_out, (float2*)v_max,
      (long long*)clock);
  return (int)cudaGetLastError();
}

extern "C" int am_cfo_step_parent(const void* spectra, void* mags, void* step,
                                  int n_stations, void* stream) {
  if (n_stations <= 0) return (int)cudaErrorInvalidValue;
  am_cfo_step_kernel<<<n_stations, 128, 0, (cudaStream_t)stream>>>(
      (const float2*)spectra, (float*)mags, (int*)step);
  return (int)cudaGetLastError();
}
