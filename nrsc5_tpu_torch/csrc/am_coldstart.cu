// K14: the AM cold start's probe block — the carrier-tone estimate, the
// tone-subtracted coarse timing with the latch override and the
// prev_angle smoothing, and the integer-CFO step from pass 1's spectra.
//
// Replaces the JAX device functions of
// nrsc5_tpu/pipeline/scan_chain_am_rc.py: :350 _am_tone_subtract_rc (am_tone
// estimates the tone, am_coarse subtracts it as it reads the window), :404
// _am_coarse_timing_rc and :439-445 of am_coldstart_block_rc (am_coarse),
// and the magnitude sums of :106 with the host's argmax of :503-506
// (am_cfo_step), for all stations of a cold start at once.  Per station,
// on the window w[n] = samples[offset + n], n < 8910 (offset placed as
// lax.dynamic_slice places it):
//
// am_tone (from the power DFT's spectra P [32, 256] of the window's first
//   256 samples of each symbol):
//   k0 = first argmax_k sum_sym |P[sym, k]|^2, folded to [-128, 128)
//   z[n] = w[n] e^{i ((k0 n) mod 256) (-2pi/256)}
//   S_g = sum_n z[n] e^{i (-2pi/256) (u_g n)}  for the 85 grid points u_g
//   i = clip(first argmax |S_g|^2, 1, 83), parabolic refine -> u*,
//   f = (k0 + u*) / 256; two Newton steps on |S(f)|^2 with m = n - 4454.5,
//   taken only where the curvature h < 0; amp = sum_n w[n] e(n) / 8910,
//   e(n) = e^{i ((-2pi) f) m}.
// am_coarse: x[n] = w[n] - amp conj(e(n)) in shared memory (71 KB);
//   sums[t] = sum_k x[270k + t] conj(x[256 + 270k + t]) (t < 270, k < 32);
//   v[i] = sum_j sums[(i + j) mod 270] kern[j] (j < 14); measured = first
//   argmax |v|^2; samperr = override % 270 where override >= 0, else
//   measured; prev_angle += arg(v e^{-i prev_angle}) * (prev_angle != 0 ?
//   0.25 : 1).
// am_cfo_step (from pass 1's spectra [32, 256], bins 75..181):
//   mags[b] = sum_sym |P[sym, 75 + b]|; step = first argmax - 53.
//
// Every sum runs in an order the plain PyTorch versions reproduce: over
// the 32 symbols and the 14 window taps from the first term to the last;
// over the 8910 samples, thread t of 256 sums samples t, t + 256, ... in
// turn (zeros past the end), then a fixed pairwise tree halves the 256
// partial sums.  Phases are float32 product chains in the reference's
// order, and the trigonometric functions are cosf/sinf with full range
// reduction (Newton's arguments reach ~14000 rad, where __sinf/__cosf are
// wrong by about a radian).  With -fmad=false the kernels then agree with
// their plain versions bit for bit on the card.
//
// Bound on the H100: operations.  The grid projection is 85 x 8910 complex
// products with a sincos each, ~0.12 Gop for 16 stations; the window reads
// are 1.1 MB a kernel.  Design: am_tone runs one CTA per (station, 5 grid
// points), each deriving z[n] itself; the CTA that finishes its station
// last (a counter per station, after a memory fence) does the parabola,
// Newton and amp.  am_coarse runs one CTA per station, am_cfo_step one per
// station with a thread per bin.  Tables come in as device pointers and
// are read into shared memory; no thread keeps a local array.

#include <cuda_runtime.h>

namespace {

constexpr int FFT = 256;
constexpr int CP = 14;
constexpr int FFTCP = FFT + CP;            // 270
constexpr int NSYM = 32;
constexpr int WINDOW = FFTCP * (NSYM + 1);  // 8910
constexpr int NGRID = 85;
constexpr int T = 256;                      // width of the ordered sums
constexpr int ROWS = (WINDOW + T - 1) / T;  // 35
constexpr int GP = 5;                       // grid points per CTA
constexpr int GRID_CTAS = NGRID / GP;       // 17
constexpr int COARSE_THREADS = 512;
constexpr int CFO_LO = FFT / 2 - 53;        // CENTER_AM - PIDS_OUTER_INDEX_AM
constexpr int CFO_BINS = 2 * 53 + 1;        // 107
constexpr float NEG_TWO_PI_OVER_FFT = -0.02454369260617026f;
constexpr float NEG_TWO_PI = -6.283185307179586f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr float HALF_SPAN = 4454.5f;        // (WINDOW - 1) / 2

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

// Block argmax over one value a thread (index ``at``, or a value of -1
// where a thread holds none): the first index wins ties.  Returns the
// index to every thread.
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

__global__ void __launch_bounds__(T) am_tone_kernel(
    const float2* __restrict__ spectra, const float2* __restrict__ samples,
    long long n_samples, const int* __restrict__ offset,
    const float* __restrict__ grid_u, float2* proj, unsigned int* done,
    float* __restrict__ f_out, float2* __restrict__ amp_out) {
  __shared__ float red[2 * GP][T];
  __shared__ float u_s[NGRID];
  __shared__ float bp[T / 32];
  __shared__ int bi[T / 32];
  __shared__ float f_s;
  __shared__ int last_s;

  const int s = blockIdx.y;
  const int g0 = blockIdx.x * GP;
  const int tid = threadIdx.x;
  if (tid < NGRID) u_s[tid] = grid_u[tid];

  // k0: the power summed over the 32 symbols, bin by bin
  const float2* sp = spectra + (long long)s * NSYM * FFT;
  float p = 0.0f;
  for (int sym = 0; sym < NSYM; ++sym) {
    const float2 v = sp[sym * FFT + tid];
    const float a2 = v.x * v.x + v.y * v.y;
    p = sym ? p + a2 : a2;
  }
  int k0 = block_argmax(p, tid, bp, bi);
  if (k0 >= FFT / 2) k0 -= FFT;

  const float2* w =
      samples + (long long)s * n_samples + dynamic_start(offset[s], n_samples, WINDOW);

  // this CTA's GP grid projections, each in the fixed order
  float2 acc[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) acc[g] = make_float2(0.0f, 0.0f);
  for (int r = 0; r < ROWS; ++r) {
    const int n = r * T + tid;
    float2 z = make_float2(0.0f, 0.0f);
    if (n < WINDOW) {
      int k = (k0 * n) % FFT;
      if (k < 0) k += FFT;
      z = cmul(w[n], cexp((float)k * NEG_TWO_PI_OVER_FFT));
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float2 t = make_float2(0.0f, 0.0f);
      if (n < WINDOW)
        t = cmul(z, cexp(NEG_TWO_PI_OVER_FFT * (u_s[g0 + g] * (float)n)));
      acc[g] = r ? make_float2(acc[g].x + t.x, acc[g].y + t.y) : t;
    }
  }
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    red[2 * g][tid] = acc[g].x;
    red[2 * g + 1][tid] = acc[g].y;
  }
  __syncthreads();
  for (int h = T / 2; h > 0; h >>= 1) {
    if (tid < h) {
#pragma unroll
      for (int q = 0; q < 2 * GP; ++q) red[q][tid] = red[q][tid] + red[q][tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    for (int g = 0; g < GP; ++g)
      proj[(long long)s * NGRID + g0 + g] = make_float2(red[2 * g][0], red[2 * g + 1][0]);
    __threadfence();
    last_s = atomicAdd(done + s, 1u) == GRID_CTAS - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the last CTA of the station: parabola, Newton, amplitude
  if (tid == 0) {
    const volatile float2* pr = proj + (long long)s * NGRID;
    auto power = [&](int g) {
      const float x = pr[g].x, y = pr[g].y;
      return x * x + y * y;
    };
    float best = -1.0f;
    int at = 0;
    for (int g = 0; g < NGRID; ++g) {
      const float q = power(g);
      if (q > best) {
        best = q;
        at = g;
      }
    }
    const int i = at < 1 ? 1 : (at > NGRID - 2 ? NGRID - 2 : at);
    const float pm = power(i - 1), p0 = power(i), pp = power(i + 1);
    const float den = (pm - 2.0f * p0) + pp;
    const float d = den != 0.0f ? (0.5f * (pm - pp)) / den : 0.0f;
    const float dc = fminf(fmaxf(d, -1.0f), 1.0f);
    const float ustar = u_s[i] + dc * (u_s[1] - u_s[0]);
    f_s = ((float)k0 + ustar) / 256.0f;
  }
  __syncthreads();

  for (int step = 0; step < 2; ++step) {
    const float f = f_s;
    const float c = NEG_TWO_PI * f;
    float sr = 0.0f, si = 0.0f, tr = 0.0f, ti = 0.0f, dr = 0.0f, di = 0.0f;
    for (int r = 0; r < ROWS; ++r) {
      const int n = r * T + tid;
      float2 xe = make_float2(0.0f, 0.0f), wx = xe, w2x = xe;
      if (n < WINDOW) {
        const float m = (float)n - HALF_SPAN;
        xe = cmul(w[n], cexp(c * m));
        const float wm = TWO_PI * m;
        wx = make_float2(wm * xe.x, wm * xe.y);
        const float wm2 = wm * wm;
        w2x = make_float2(wm2 * xe.x, wm2 * xe.y);
      }
      sr = r ? sr + xe.x : xe.x;
      si = r ? si + xe.y : xe.y;
      tr = r ? tr + wx.x : wx.x;
      ti = r ? ti + wx.y : wx.y;
      dr = r ? dr + w2x.x : w2x.x;
      di = r ? di + w2x.y : w2x.y;
    }
    red[0][tid] = sr;
    red[1][tid] = si;
    red[2][tid] = tr;
    red[3][tid] = ti;
    red[4][tid] = dr;
    red[5][tid] = di;
    __syncthreads();
    for (int h = T / 2; h > 0; h >>= 1) {
      if (tid < h) {
#pragma unroll
        for (int q = 0; q < 6; ++q) red[q][tid] = red[q][tid] + red[q][tid + h];
      }
      __syncthreads();
    }
    if (tid == 0) {
      const float S0 = red[0][0], S1 = red[1][0];
      const float dS0 = red[3][0], dS1 = -red[2][0];  // -i t
      const float d2S0 = -red[4][0], d2S1 = -red[5][0];
      const float g = 2.0f * (S0 * dS0 + S1 * dS1);
      const float h = 2.0f * (dS0 * dS0 + dS1 * dS1) + 2.0f * (S0 * d2S0 + S1 * d2S1);
      f_s = h < 0.0f ? f - g / h : f;
    }
    __syncthreads();
  }

  const float f = f_s;
  const float c = NEG_TWO_PI * f;
  float ar = 0.0f, ai = 0.0f;
  for (int r = 0; r < ROWS; ++r) {
    const int n = r * T + tid;
    float2 xe = make_float2(0.0f, 0.0f);
    if (n < WINDOW) xe = cmul(w[n], cexp(c * ((float)n - HALF_SPAN)));
    ar = r ? ar + xe.x : xe.x;
    ai = r ? ai + xe.y : xe.y;
  }
  red[0][tid] = ar;
  red[1][tid] = ai;
  __syncthreads();
  for (int h = T / 2; h > 0; h >>= 1) {
    if (tid < h) {
      red[0][tid] = red[0][tid] + red[0][tid + h];
      red[1][tid] = red[1][tid] + red[1][tid + h];
    }
    __syncthreads();
  }
  if (tid == 0) {
    f_out[s] = f;
    amp_out[s] = make_float2(red[0][0] / (float)WINDOW, red[1][0] / (float)WINDOW);
  }
}

__global__ void __launch_bounds__(COARSE_THREADS) am_coarse_kernel(
    const float2* __restrict__ samples, long long n_samples,
    const int* __restrict__ offset, const float* __restrict__ f_in,
    const float2* __restrict__ amp_in, const float* __restrict__ prev_angle,
    const int* __restrict__ coarse_override,
    const float* __restrict__ shape_kernel, int* __restrict__ measured,
    int* __restrict__ samperr, float* __restrict__ prev_angle_out,
    float2* __restrict__ v_max) {
  extern __shared__ float2 x[];  // the tone-subtracted window [WINDOW]
  __shared__ float2 sums[FFTCP];
  __shared__ float2 v_s[FFTCP];
  __shared__ float kern[CP];
  __shared__ float bp[COARSE_THREADS / 32];
  __shared__ int bi[COARSE_THREADS / 32];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
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

  if (tid < FFTCP) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int k = 0; k < NSYM; ++k) {
      const float2 p = cmul_conj(x[k * FFTCP + tid], x[FFT + k * FFTCP + tid]);
      acc = k ? make_float2(acc.x + p.x, acc.y + p.y) : p;
    }
    sums[tid] = acc;
  }
  __syncthreads();

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

// done: n_stations zeroed uint32 counters; proj: [n_stations, 85] float2
// scratch.
extern "C" int am_tone(const void* spectra, const void* samples,
                       long long n_samples, const void* offset,
                       const void* grid_u, void* proj, void* done, void* f,
                       void* amp, int n_stations, void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  dim3 grid(GRID_CTAS, n_stations);
  am_tone_kernel<<<grid, T, 0, (cudaStream_t)stream>>>(
      (const float2*)spectra, (const float2*)samples, n_samples,
      (const int*)offset, (const float*)grid_u, (float2*)proj,
      (unsigned int*)done, (float*)f, (float2*)amp);
  return (int)cudaGetLastError();
}

extern "C" int am_coarse(const void* samples, long long n_samples,
                         const void* offset, const void* f, const void* amp,
                         const void* prev_angle, const void* coarse_override,
                         const void* shape_kernel, void* measured,
                         void* samperr, void* prev_angle_out, void* v_max,
                         int n_stations, void* stream) {
  if (n_stations <= 0 || n_samples < WINDOW) return (int)cudaErrorInvalidValue;
  const int smem = WINDOW * (int)sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      am_coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  am_coarse_kernel<<<n_stations, COARSE_THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)samples, n_samples, (const int*)offset, (const float*)f,
      (const float2*)amp, (const float*)prev_angle,
      (const int*)coarse_override, (const float*)shape_kernel, (int*)measured,
      (int*)samperr, (float*)prev_angle_out, (float2*)v_max);
  return (int)cudaGetLastError();
}

extern "C" int am_cfo_step(const void* spectra, void* mags, void* step,
                           int n_stations, void* stream) {
  if (n_stations <= 0) return (int)cudaErrorInvalidValue;
  am_cfo_step_kernel<<<n_stations, 128, 0, (cudaStream_t)stream>>>(
      (const float2*)spectra, (float*)mags, (int*)step);
  return (int)cudaGetLastError();
}
