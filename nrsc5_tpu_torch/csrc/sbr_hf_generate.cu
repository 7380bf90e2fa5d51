// K16b: the SBR HF generator for every lane and packet of a batch: the
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
// two slots of the last packet).  xl and the tails 16-byte aligned.
//
// Bound on the H100: device-memory bytes.  At N = 128, K = 8 and m = 25
// it reads the 8.4 MB of xl and writes 6.6 MB of xh (0.0045 ms at 3.35
// TB/s); the LPC is ~40 operations a (slot, band) term.  What sets the
// time is a CTA's chain of short phases, so the design keeps a CTA small
// enough that all of a batch's CTAs are resident at once (128 threads, 9
// KB of shared memory, 46 registers: 8 a SM at the fleet's 1024) and
// every phase's shared-memory traffic low: one CTA per (lane, packet)
// stages its window of v, one contiguous run of xl (the packet's 32 rows
// and the 2 before them, 8.7 KB; packet 0 takes those 2 from the tails),
// by bulk copies, while each lane loads its bins' tables; warp 0 runs the
// LPC a lane a band, each covariance summed over the slots in slot order
// as the plain version sums, its slots' values rolled through registers
// (two shared-memory loads a slot), then the band's predictors, while the
// last two warps write the new tails; then warp w patches slots [8 w, 8 w
// + 8) a lane a bin, the bin's coefficients in registers and its source
// band's values rolled through registers, storing x_high straight to
// device memory (8 bytes a lane, consecutive bins on consecutive lanes).
// -fmad=false keeps every product rounded apart from its sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NSLOT = 32;
constexpr int SLOTS = NSLOT / WARPS;  // a warp's slots in the patch
constexpr int ROW = 64;  // floats a slot row: 32 re, then 32 im
constexpr int ROW_BYTES = ROW * 4;
constexpr int MAXM = 64;

__global__ void __launch_bounds__(THREADS) sbr_hf_generate_kernel(
    const float* __restrict__ xl, const float* __restrict__ tail_r,
    const float* __restrict__ tail_i, const float* __restrict__ bwj,
    const int* __restrict__ src_idx, const float* __restrict__ src_ok,
    float* __restrict__ xh, float* __restrict__ new_tail_r,
    float* __restrict__ new_tail_i, int n_packets, int m, int kx, float eps,
    float lpc_div) {
  __shared__ __align__(128) float v[(NSLOT + 2) * ROW];  // the window
  __shared__ float a[4][32];  // each band's a0r, a0i, a1r, a1i
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int k = blockIdx.x % n_packets;
  const long long n = blockIdx.x / n_packets;
  const long long pk = n * n_packets + k;

  // the window: rows 32k - 2 .. 32k + 31 of the lane, one run of xl (for
  // packet 0, rows 0-1 from the tails' real and imaginary halves)
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    const float* rows = xl + pk * NSLOT * ROW;
    if (k == 0) {
      bulk::expect(&bar, NSLOT * ROW_BYTES + 4 * 128);
      for (int t = 0; t < 2; ++t) {
        bulk::copy(v + t * ROW, tail_r + (n * 2 + t) * 32, 128, &bar);
        bulk::copy(v + t * ROW + 32, tail_i + (n * 2 + t) * 32, 128, &bar);
      }
      bulk::copy(v + 2 * ROW, rows, NSLOT * ROW_BYTES, &bar);
    } else {
      bulk::expect(&bar, (NSLOT + 2) * ROW_BYTES);
      bulk::copy(v, rows - 2 * ROW, (NSLOT + 2) * ROW_BYTES, &bar);
    }
  }
  // each lane's bins (lane, lane + 32): source band, mask and chirp
  int src[2];
  float ok[2], bw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    src[h] = i < m ? src_idx[i] : 0;
    ok[h] = i < m ? src_ok[i] : 0.0f;
    bw[h] = i < m ? bwj[pk * m + i] : 0.0f;
  }
  bulk::wait(&bar);

  if (w == 0) {
    // band j's covariances, v0 = row s + 2, v1 = row s + 1, v2 = row s;
    // conj(a) b: re = ar br + ai bi, im = ar bi - ai br
    const int j = lane;
    float p01r = 0.0f, p01i = 0.0f, p11 = 0.0f, p02r = 0.0f, p02i = 0.0f;
    float p12r = 0.0f, p12i = 0.0f, p22 = 0.0f;
    float v2r = v[j], v2i = v[32 + j];
    float v1r = v[ROW + j], v1i = v[ROW + 32 + j];
#pragma unroll 8
    for (int s = 0; s < NSLOT; ++s) {
      const float v0r = v[(s + 2) * ROW + j];
      const float v0i = v[(s + 2) * ROW + 32 + j];
      p01r = p01r + (v1r * v0r + v1i * v0i);
      p01i = p01i + (v1r * v0i - v1i * v0r);
      p11 = p11 + (v1r * v1r + v1i * v1i);
      p02r = p02r + (v2r * v0r + v2i * v0i);
      p02i = p02i + (v2r * v0i - v2i * v0r);
      p12r = p12r + (v2r * v1r + v2i * v1i);
      p12i = p12i + (v2r * v1i - v2i * v1r);
      p22 = p22 + (v2r * v2r + v2i * v2i);
      v2r = v1r;
      v2i = v1i;
      v1r = v0r;
      v1i = v0i;
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
    a[0][j] = b0r * mask;
    a[1][j] = b0i * mask;
    a[2][j] = b1r * mask;
    a[3][j] = b1i * mask;
  } else if (k == n_packets - 1 && tid >= THREADS - 64) {
    const int t = (tid - (THREADS - 64)) >> 5;
    new_tail_r[(n * 2 + t) * 32 + lane] = v[(NSLOT + t) * ROW + lane];
    new_tail_i[(n * 2 + t) * 32 + lane] = v[(NSLOT + t) * ROW + 32 + lane];
  }
  __syncthreads();

  // the patch: warp w the slots [SLOTS w, SLOTS (w + 1)), a lane a bin
  float2* out = reinterpret_cast<float2*>(xh) + pk * NSLOT * m;
  const int t0 = SLOTS * w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    if (i < m) {
      const int b = src[h];
      const float bw2 = bw[h] * bw[h];
      const float c1r = bw[h] * a[0][b], c1i = bw[h] * a[1][b];
      const float c2r = bw2 * a[2][b], c2i = bw2 * a[3][b];
      float s2r = v[t0 * ROW + b], s2i = v[t0 * ROW + 32 + b];
      float s1r = v[(t0 + 1) * ROW + b], s1i = v[(t0 + 1) * ROW + 32 + b];
#pragma unroll
      for (int q = 0; q < SLOTS; ++q) {
        const float s0r = v[(t0 + q + 2) * ROW + b];
        const float s0i = v[(t0 + q + 2) * ROW + 32 + b];
        const float hr =
            s0r + (c1r * s1r - c1i * s1i) + (c2r * s2r - c2i * s2i);
        const float hi =
            s0i + (c1r * s1i + c1i * s1r) + (c2r * s2i + c2i * s2r);
        out[(t0 + q) * m + i] = make_float2(hr * ok[h], hi * ok[h]);
        s2r = s1r;
        s2i = s1i;
        s1r = s0r;
        s1i = s0i;
      }
    }
  }
}

}  // namespace

extern "C" int sbr_hf_generate(const void* xl, const void* tail_r,
                               const void* tail_i, const void* bwj,
                               const void* src_idx, const void* src_ok,
                               void* xh, void* new_tail_r, void* new_tail_i,
                               int n_lanes, int n_packets, int m, int kx,
                               float eps, float lpc_div, void* stream) {
  if (n_lanes <= 0 || n_packets <= 0 || m <= 0 || m > MAXM)
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
