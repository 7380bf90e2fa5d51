// K9: coarse symbol timing by cyclic-prefix correlation, one CTA per
// station.
//
// Replaces the JAX device function
// nrsc5_tpu/ops/acquire_rc.py:coarse_timing_rc (lines 43-70), for all
// stations of a cold start in one launch.  Per station, on the first
// 71280 samples x of its conjugated rc buffer:
//   f[0] = 0,  f[n] = sum_o taps[o] * x[n-1-o]      (32-tap band filter)
//   sums[t] = sum_k f[k*2160 + t] * conj(f[2048 + k*2160 + t])
//                                   (t < 2160, k < 32: the CP product)
//   v[i] = sum_j w[j] * sums[(i + j) mod 2160]     (j < 112, circular)
//   i_max = first argmax |v[i]|^2,  samperr = (i_max + 2160 - delay) % 2160
//   max_v = v[i_max]
//
// Bound on the H100: about 10 Mflop and 570 KB of samples a station, so
// neither bound reaches 3 us for 16 stations.  A simple design, kept right
// first: one CTA per station, threads over the 2160 timings; each thread
// filters the two samples of each CP pair on the fly from the 32 taps (in
// shared memory) and reads the samples through L1, so each sample is
// filtered about twice.  sums and v live in shared memory (17 KB each).
// Every sum runs in index order from 0, as the plain version's loops do,
// so with -fmad=false the kernel and its plain version agree bit for bit;
// the block argmax lets the lower index win ties, as jnp.argmax does.

#include <cuda_runtime.h>

namespace {

constexpr int FFT = 2048;
constexpr int CP = 112;
constexpr int FFTCP = FFT + CP;
constexpr int NSYM = 32;
constexpr int NTAPS = 32;
constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS) coarse_timing_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const float* __restrict__ taps, const float* __restrict__ shape_kernel,
    int filter_delay, int* __restrict__ samperr, float2* __restrict__ max_v) {
  __shared__ float tap_s[NTAPS], w_s[CP];
  __shared__ float2 sums[FFTCP], v_s[FFTCP];
  __shared__ float best_p[THREADS / 32];
  __shared__ int best_i[THREADS / 32];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const float2* x = samples + (long long)s * n_samples;
  if (tid < NTAPS) tap_s[tid] = taps[tid];
  if (tid < CP) w_s[tid] = shape_kernel[tid];
  __syncthreads();

  auto filt = [&](int n) {
    float2 f = make_float2(0.0f, 0.0f);
    for (int o = 0; o < NTAPS && o <= n - 1; ++o) {
      const float2 a = x[n - 1 - o];
      f.x = f.x + tap_s[o] * a.x;
      f.y = f.y + tap_s[o] * a.y;
    }
    return f;
  };

  for (int t = tid; t < FFTCP; t += THREADS) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int k = 0; k < NSYM; ++k) {
      const float2 a = filt(k * FFTCP + t);
      const float2 b = filt(FFT + k * FFTCP + t);
      acc.x = acc.x + (a.x * b.x + a.y * b.y);
      acc.y = acc.y + (a.y * b.x - a.x * b.y);
    }
    sums[t] = acc;
  }
  __syncthreads();

  float best = -1.0f;
  int at = 0x7fffffff;
  for (int i = tid; i < FFTCP; i += THREADS) {
    float2 v = make_float2(0.0f, 0.0f);
    for (int j = 0; j < CP; ++j) {
      int m = i + j;
      if (m >= FFTCP) m -= FFTCP;
      v.x = v.x + w_s[j] * sums[m].x;
      v.y = v.y + w_s[j] * sums[m].y;
    }
    v_s[i] = v;
    const float p = v.x * v.x + v.y * v.y;
    if (p > best) {  // i rises within a thread: the first index wins ties
      best = p;
      at = i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, at, o);
    if (ob > best || (ob == best && oi < at)) {
      best = ob;
      at = oi;
    }
  }
  if ((tid & 31) == 0) {
    best_p[tid >> 5] = best;
    best_i[tid >> 5] = at;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      if (best_p[w] > best || (best_p[w] == best && best_i[w] < at)) {
        best = best_p[w];
        at = best_i[w];
      }
    }
    samperr[s] = (at + FFTCP - filter_delay) % FFTCP;
    max_v[s] = v_s[at];
  }
}

}  // namespace

extern "C" int coarse_timing(const void* samples, long long n_samples,
                             const void* taps, const void* shape_kernel,
                             int filter_delay, void* samperr, void* max_v,
                             int n_stations, void* stream) {
  coarse_timing_kernel<<<n_stations, THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, (const float*)taps,
      (const float*)shape_kernel, filter_delay, (int*)samperr,
      (float2*)max_v);
  return (int)cudaGetLastError();
}
