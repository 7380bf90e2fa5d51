// K16b as it was before its redesign (nrsc5_tpu_torch/csrc/
// sbr_hf_generate.cu at the parent commit), for
// probes/k10_k16b_variants.py, with the cuts and the clock that split its
// time:
//
//   -DCUT=1  no LPC: the predictors left 0, staging and patch as the
//            parent's;
//   -DCUT=2  no patch: staging and LPC, then warp 0 writes its band's
//            predictor where the patch would write;
//   -DCLOCK  the global timer at each CTA's entry, after staging, after the
//            LPC and at its exit, 4 int64 a CTA behind xh (the caller
//            leaves room for them).
//
// The SBR HF generator for every lane and packet of a batch: the
// covariance LPC per (lane, packet, QMF band) and the patch gather.
//
// Replaces stage 3 of the JAX device function
// nrsc5_tpu/audio/batch.py:164 _make_device_fn -> fn (:259-324): per band
// j < 32, the covariances p01, p02, p12 (complex), p11 and p22 over the 32
// slots of v = [2 carried or previous-packet slots | the packet's 32 slots]
// of the analysis output xl, the predictors alpha1 = (p01 p12 - p02 p11) /
// d with d = p22 p11 - |p12|^2 / 1.000001 (zero unless |d| > EPS) and
// alpha0 = -(p01 + alpha1 conj(p12)) / p11 (zero unless |p11| > EPS), both
// zeroed where either has |alpha| >= 4, and the band mask (bands 1 ..
// min(kx, 31) predict); then for each SBR bin i < m and slot t the patch
// x_high = v0[src] + b a0[src] v1[src] + b^2 a1[src] v2[src] with src =
// src_idx[i], b = bwj[i], masked by src_ok[i].
//
// Layout: xl f32 [N, 32 K, 64] (columns 0-31 real, 32-63 imaginary),
// tail_r / tail_i f32 [N, 2, 32], bwj f32 [N, K, m], src_idx int32 [m],
// src_ok f32 [m].  Out: xh f32 [N, K, 32, m, 2], the new tails (the last
// two slots of the last packet).
//
// Bound on the H100: device-memory bytes.  At N = 128, K = 8 and m = 25
// it reads the 8.4 MB of xl and writes 6.6 MB of xh (0.0045 ms at 3.35
// TB/s); the LPC is ~40 operations a (slot, band) term.  Design: one CTA
// per (lane, packet) stages v (34 x 32 complex, 8.7 KB) in shared memory;
// the first warp runs one band a thread with each covariance summed over
// the slots in slot order, as the plain version sums; then all threads
// write the patch, consecutive threads on consecutive bins.  -fmad=false
// keeps every product rounded apart from its sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int THREADS = 256;
constexpr int NSLOT = 32;
constexpr int NV = NSLOT + 2;

__global__ void __launch_bounds__(THREADS) sbr_hf_generate_kernel(
    const float* __restrict__ xl, const float* __restrict__ tail_r,
    const float* __restrict__ tail_i, const float* __restrict__ bwj,
    const int* __restrict__ src_idx, const float* __restrict__ src_ok,
    float* __restrict__ xh, float* __restrict__ new_tail_r,
    float* __restrict__ new_tail_i, int n_packets, int m, int kx, float eps,
    float lpc_div) {
  __shared__ float vr[NV][32];
  __shared__ float vi[NV][32];
  __shared__ float a0r[32], a0i[32], a1r[32], a1i[32];
  const int k = blockIdx.x % n_packets;
  const long long n = blockIdx.x / n_packets;
  const long long pk = n * n_packets + k;
#ifdef CLOCK
  long long* clk = reinterpret_cast<long long*>(
                       xh + (long long)gridDim.x * NSLOT * m * 2) +
                   4 * (long long)blockIdx.x;
  if (threadIdx.x == 0) clk[0] = gtimer();
#endif
  for (int e = threadIdx.x; e < NV * 32; e += THREADS) {
    const int t = e >> 5;
    const int j = e & 31;
    float r, im;
    if (t >= 2) {
      const float* row = xl + (pk * NSLOT + t - 2) * 64;
      r = row[j];
      im = row[32 + j];
    } else if (k == 0) {
      r = tail_r[(n * 2 + t) * 32 + j];
      im = tail_i[(n * 2 + t) * 32 + j];
    } else {
      const float* row = xl + ((pk - 1) * NSLOT + NSLOT - 2 + t) * 64;
      r = row[j];
      im = row[32 + j];
    }
    vr[t][j] = r;
    vi[t][j] = im;
  }
  __syncthreads();
#ifdef CLOCK
  if (threadIdx.x == 0) clk[1] = gtimer();
#endif
#if defined(CUT) && CUT == 1
  if (threadIdx.x < 32) {
    a0r[threadIdx.x] = a0i[threadIdx.x] = 0.0f;
    a1r[threadIdx.x] = a1i[threadIdx.x] = 0.0f;
  }
  if (false) {
#else
  if (threadIdx.x < 32) {
#endif
    const int j = threadIdx.x;
    float p01r = 0.0f, p01i = 0.0f, p11 = 0.0f, p02r = 0.0f, p02i = 0.0f;
    float p12r = 0.0f, p12i = 0.0f, p22 = 0.0f;
    for (int s = 0; s < NSLOT; ++s) {
      const float v0r = vr[s + 2][j], v0i = vi[s + 2][j];
      const float v1r = vr[s + 1][j], v1i = vi[s + 1][j];
      const float v2r = vr[s][j], v2i = vi[s][j];
      // conj(a) b: re = ar br + ai bi, im = ar bi - ai br
      p01r = p01r + (v1r * v0r + v1i * v0i);
      p01i = p01i + (v1r * v0i - v1i * v0r);
      p11 = p11 + (v1r * v1r + v1i * v1i);
      p02r = p02r + (v2r * v0r + v2i * v0i);
      p02i = p02i + (v2r * v0i - v2i * v0r);
      p12r = p12r + (v2r * v1r + v2i * v1i);
      p12i = p12i + (v2r * v1i - v2i * v1r);
      p22 = p22 + (v2r * v2r + v2i * v2i);
    }
    const float d = p22 * p11 - (p12r * p12r + p12i * p12i) / lpc_div;
    const bool d_ok = fabsf(d) > eps;
    const float dd = d_ok ? d : 1.0f;
    float b1r = d_ok ? (p01r * p12r - p01i * p12i - p02r * p11) / dd : 0.0f;
    float b1i = d_ok ? (p01r * p12i + p01i * p12r - p02i * p11) / dd : 0.0f;
    const bool p_ok = fabsf(p11) > eps;
    const float pp = p_ok ? p11 : 1.0f;
    // alpha0 = -(p01 + alpha1 conj(p12)) / p11
    const float t0r = b1r * p12r - b1i * -p12i;
    const float t0i = b1r * -p12i + b1i * p12r;
    float b0r = p_ok ? -(p01r + t0r) / pp : 0.0f;
    float b0i = p_ok ? -(p01i + t0i) / pp : 0.0f;
    const bool big =
        (b0r * b0r + b0i * b0i >= 16.0f) || (b1r * b1r + b1i * b1i >= 16.0f);
    const int lim = kx + 1 < 32 ? kx + 1 : 32;
    const float mask = (!big && j >= 1 && j < lim) ? 1.0f : 0.0f;
    if (big) b0r = b0i = b1r = b1i = 0.0f;
    a0r[j] = b0r * mask;
    a0i[j] = b0i * mask;
    a1r[j] = b1r * mask;
    a1i[j] = b1i * mask;
  }
  __syncthreads();
#ifdef CLOCK
  if (threadIdx.x == 0) clk[2] = gtimer();
#endif
#if defined(CUT) && CUT == 2
  if (threadIdx.x < 32)
    xh[(pk * NSLOT * m + threadIdx.x % m) * 2] =
        a0r[threadIdx.x] + a1i[threadIdx.x];
#else
  const float* bw = bwj + pk * m;
  for (int e = threadIdx.x; e < NSLOT * m; e += THREADS) {
    const int t = e / m;
    const int i = e - t * m;
    const int src = src_idx[i];
    const float b = bw[i];
    const float c1r = b * a0r[src], c1i = b * a0i[src];
    const float b2 = b * b;
    const float c2r = b2 * a1r[src], c2i = b2 * a1i[src];
    const float s0r = vr[t + 2][src], s0i = vi[t + 2][src];
    const float s1r = vr[t + 1][src], s1i = vi[t + 1][src];
    const float s2r = vr[t][src], s2i = vi[t][src];
    const float hr =
        s0r + (c1r * s1r - c1i * s1i) + (c2r * s2r - c2i * s2i);
    const float hi =
        s0i + (c1r * s1i + c1i * s1r) + (c2r * s2i + c2i * s2r);
    const float ok = src_ok[i];
    float* out = xh + ((pk * NSLOT + t) * m + i) * 2;
    out[0] = hr * ok;
    out[1] = hi * ok;
  }
#endif
  if (k == n_packets - 1 && threadIdx.x < 64) {
    const int t = threadIdx.x >> 5;
    const int j = threadIdx.x & 31;
    new_tail_r[(n * 2 + t) * 32 + j] = vr[NSLOT + t][j];
    new_tail_i[(n * 2 + t) * 32 + j] = vi[NSLOT + t][j];
  }
#ifdef CLOCK
  __syncthreads();
  if (threadIdx.x == 0) clk[3] = gtimer();
#endif
}

}  // namespace

extern "C" int sbr_hf_generate_parent(const void* xl, const void* tail_r,
                               const void* tail_i, const void* bwj,
                               const void* src_idx, const void* src_ok,
                               void* xh, void* new_tail_r, void* new_tail_i,
                               int n_lanes, int n_packets, int m, int kx,
                               float eps, float lpc_div, void* stream) {
  if (n_lanes <= 0 || n_packets <= 0 || m <= 0 || m > 64)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n_lanes * n_packets;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sbr_hf_generate_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)xl, (const float*)tail_r, (const float*)tail_i,
      (const float*)bwj, (const int*)src_idx, (const float*)src_ok,
      (float*)xh, (float*)new_tail_r, (float*)new_tail_i, n_packets, m, kx,
      eps, lpc_div);
  return (int)cudaGetLastError();
}
