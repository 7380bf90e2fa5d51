// K4: the FM sync block of one L1 block, fused, one CTA per station.
//
// Replaces the JAX device function
// nrsc5_tpu/pipeline/scan_chain_rc.py:sync_block_rc (lines 128-267) for
// every FM service mode (ppb = 10, 11, 12 or 14 partitions per band,
// 2R = 2*(ppb+1) reference subcarriers), for all stations of a dispatch in
// one launch.  Per station, on spectra [32, 2048, 2]:
//   1. the Costas PLL (costas.cuh, shared with K3) on the 2R reference
//      bins from costas_phase[bin] - timing_adj*k_rel*2pi/2048 and
//      costas_freq[bin], one thread per track;
//   2. the pi-ambiguity flip from the sync-sign score, the DBPSK needles
//      (ref_ok), the block count and service mode words (ref_bc,
//      ref_psmi), and smag = mean |Re derot|;
//   3. samperr from symbol 0's phase steps and the frequency regression,
//      angle = mean fr;
//   4. the linear-interpolated equalizer of every data bin, the MER error
//      sums of each sideband, and the MMSE weights' per-symbol means;
//   5. the int8 soft demap of the 2x10 PM partitions (upper ones in
//      reversed partition order) with mult = clip(sig/err*10, 1, 127),
//      then of the PX1/PX2 columns the host lists (lines 240-263: a
//      partition, its side, and which sideband's mult it takes — MP11's
//      px2 takes the lower one's on both sides, as the reference does);
//   6. whole new Costas rows: the old row, with wrap_pi(ph) and fr - angle
//      at the reference bins.
//
// Bound on the H100: device-memory bytes (382 of 2048 bins of the spectra,
// the two Costas rows in and out, 23 KB of pm), about 154 KB a station
// and 2.46 MB for 16; the work is a few hundred flops a data bin.  A
// simple design, kept right first: the 32-step Costas chain runs on one
// warp while the rest of the CTA copies the Costas rows; the equalized
// data and its MMSE weights of the PM partitions stay in shared memory (data_eq [32, 20, 18] float2 =
// 92 KB and h2 [32, 20, 18] f32 = 46 KB, dynamic, past the 48 KB default
// by the opt-in) between the sums and the demap.  The PX partitions (up
// to 8 more, 69 KB) are not kept: the demap equalizes them again from the
// spectra with the same arithmetic (the same device function), so they
// round as if stored, and the shared memory stays at 138 KB for every
// mode.  The short sums (22
// tracks, 20 phase steps, 32 symbols) run in one thread in index order;
// the 180-term sums run over a warp in a butterfly, so they round in
// another order than PyTorch's reductions: pm may move by one where a
// product sits on a .5 rounding edge.  f32 in the reference's operation
// order (-fmad=false, constants as float arguments).

#include <cuda_runtime.h>
#include <stdint.h>

#include "costas.cuh"

namespace {

constexpr int FFT = 2048;
constexpr int NSYM = 32;
constexpr int W = 19;    // partition width in bins
constexpr int NDC = 18;  // data carriers of a partition
constexpr int PMP = 10;  // PM partitions per sideband
constexpr int LB_START = FFT / 2 - 546;
constexpr int UB_END = FFT / 2 + 546;
constexpr int MAX_R2 = 32;  // 2R <= 30
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int PM_OUT = NSYM * 2 * PMP * NDC * 2;  // 23040 soft bits
constexpr size_t EQ_SMEM =
    (size_t)NSYM * 2 * PMP * NDC * (sizeof(float2) + sizeof(float));

__device__ __forceinline__ float sign(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void __launch_bounds__(THREADS) sync_block_kernel(
    const float2* __restrict__ spectra, const float* __restrict__ cph_in,
    const float* __restrict__ cfr_in, const int* __restrict__ timing_adj,
    const float* __restrict__ sync_signs,
    const unsigned* __restrict__ needle_vals,
    const unsigned* __restrict__ needle_known, int8_t* __restrict__ pm,
    uint8_t* __restrict__ ref_ok, int* __restrict__ ref_bc,
    int* __restrict__ ref_psmi, int* __restrict__ samperr_out,
    float* __restrict__ angle_out, float* __restrict__ error_lb,
    float* __restrict__ error_ub, float* __restrict__ cph_out,
    float* __restrict__ cfr_out, int8_t* __restrict__ px1,
    int8_t* __restrict__ px2, const int* __restrict__ px_cols, int n_px1,
    int n_px2, int ppb, float alpha, float beta, float two_pi, float pi,
    float two_pi_over_fft) {
  extern __shared__ float4 smem_raw[];
  float2* data_eq = reinterpret_cast<float2*>(smem_raw);  // [32][20][18]
  float* h2s = reinterpret_cast<float*>(data_eq + NSYM * 2 * PMP * NDC);

  __shared__ float dx[NSYM][MAX_R2];      // Re derot, flipped
  __shared__ float phs[NSYM][MAX_R2];     // phases, flipped
  __shared__ float2 amp[NSYM][MAX_R2];    // smag * e^{i phase}
  __shared__ float smag[MAX_R2], ph_end[MAX_R2], fr_end[MAX_R2];
  __shared__ float err_g[NSYM][2], h_mean[NSYM][2];
  __shared__ float mult[2], angle_s;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int R = ppb + 1, r2 = 2 * R;
  const float2* spec = spectra + (size_t)s * NSYM * FFT;
  const float* cph = cph_in + (size_t)s * FFT;
  const float* cfr = cfr_in + (size_t)s * FFT;

  auto ref_bin = [&](int r) {
    return r < R ? LB_START + r * W : UB_END - (r - R) * W;
  };
  // the reference bins bounding partition p (lower p < ppb, upper after)
  auto lo_idx = [&](int p) { return p < ppb ? p : R + (p - ppb) + 1; };
  auto hi_idx = [&](int p) { return p < ppb ? p + 1 : R + (p - ppb); };

  // 0. the old Costas rows; the reference bins are overwritten in step 6
  for (int j = tid; j < FFT; j += THREADS) {
    cph_out[(size_t)s * FFT + j] = cph[j];
    cfr_out[(size_t)s * FFT + j] = cfr[j];
  }

  // 1-2. one thread per reference track
  if (tid < r2) {
    const int r = tid;
    const int bin = ref_bin(r);
    const float k_rel = (float)(bin - FFT / 2);
    float ph = cph[bin] - ((float)timing_adj[s] * k_rel) * two_pi_over_fft;
    float fr = cfr[bin];
    for (int k = 0; k < NSYM; ++k) {
      phs[k][r] = ph;
      dx[k][r] = nrsc5::costas_step(spec[k * FFT + bin], ph, fr, 0.0f,
                                    alpha, beta, two_pi)
                     .x;
    }
    float score = 0.0f;
    for (int k = 0; k < NSYM; ++k) score = score + dx[k][r] * sync_signs[k];
    const bool flip = score < 0.0f;
    if (flip) ph = ph + pi;
    const unsigned vals = needle_vals[r], known = needle_known[r];
    bool ok = true;
    int prev = 0, bc = 0, ps = 0;
    float mag = 0.0f;
    for (int k = 0; k < NSYM; ++k) {
      const float d = flip ? -dx[k][r] : dx[k][r];
      if (flip) {
        dx[k][r] = d;
        phs[k][r] = phs[k][r] + pi;
      }
      const int sg = d > 0.0f;
      if (((known >> k) & 1u) && (unsigned)sg != ((vals >> k) & 1u)) ok = false;
      const int bit = sg ^ prev;
      prev = sg;
      if (k >= 16 && k < 20) bc = bc * 2 + bit;
      if (k >= 25 && k < 31) ps = ps * 2 + bit;
      mag = mag + fabsf(d);
    }
    ref_ok[s * r2 + r] = ok;
    ref_bc[s * r2 + r] = bc;
    ref_psmi[s * r2 + r] = ps;
    smag[r] = mag / (float)NSYM;
    ph_end[r] = ph;
    fr_end[r] = fr;
  }
  __syncthreads();

  // 3. timing and angle, in index order
  if (tid == 0) {
    float acc = 0.0f;
    for (int p = 0; p < 2 * ppb; ++p) {
      const float d = phs[0][lo_idx(p)] - phs[0][hi_idx(p)];
      acc = acc + (d - pi * rintf(d / pi));
    }
    acc = acc / (float)(2 * ppb) * (float)FFT / (float)W / two_pi;
    float sxy = 0.0f, sxx = 0.0f, sf = 0.0f;
    for (int r = 0; r < r2; ++r) {
      const float x = (float)(ref_bin(r) - FFT / 2);
      sxy = sxy + x * fr_end[r];
      sxx = sxx + x * x;
      sf = sf + fr_end[r];
    }
    const float slope = sxy / sxx;
    acc = acc - slope * (float)FFT / two_pi * (float)NSYM;
    samperr_out[s] = (int)rintf(acc);
    angle_s = sf / (float)r2;
    angle_out[s] = angle_s;
  }
  for (int i = tid; i < NSYM * r2; i += THREADS) {
    const int k = i / r2, r = i % r2;
    const float phi = phs[k][r];
    amp[k][r] = make_float2(cosf(phi) * smag[r], sinf(phi) * smag[r]);
  }
  __syncthreads();

  // the equalized data bin kk of partition pp of a sideband at symbol k,
  // and its MMSE weight numerator h = 1 / |eq|^2
  auto equalize = [&](int k, int side, int pp, int kk, float2& z, float& h) {
    const int p = side * ppb + pp;
    const float2 ah = amp[k][hi_idx(p)], al = amp[k][lo_idx(p)];
    const float kf = (float)(kk + 1), wk = (float)(W - (kk + 1));
    const float dr = kf * ah.x + wk * al.x;
    const float di = kf * ah.y + wk * al.y;
    const float a2 = dr * dr + di * di;
    const float er = ((float)W * dr + (float)W * di) / a2;
    const float ei = ((float)W * dr - (float)W * di) / a2;
    const int bin = side == 0 ? LB_START + pp * W + kk + 1
                              : UB_END - (pp + 1) * W + kk + 1;
    const float2 x = spec[k * FFT + bin];
    z = make_float2(x.x * er - x.y * ei, x.x * ei + x.y * er);
    h = 1.0f / fmaxf(er * er + ei * ei, 1e-12f);
  };

  // 4. equalize; MER and MMSE sums, one warp per (symbol, sideband)
  const int per_side = ppb * NDC;
  for (int g = warp; g < NSYM * 2; g += WARPS) {
    const int k = g >> 1, side = g & 1;
    float e_acc = 0.0f, h_acc = 0.0f;
    for (int i = lane; i < per_side; i += 32) {
      const int pp = i / NDC, kk = i % NDC;
      float2 z;
      float h;
      equalize(k, side, pp, kk, z, h);
      const float tr = sign(z.x) - z.x, ti = sign(z.y) - z.y;
      e_acc = e_acc + (tr * tr + ti * ti);
      h_acc = h_acc + h;
      if (pp < PMP) {
        const int at = (k * 2 * PMP + side * PMP + pp) * NDC + kk;
        data_eq[at] = z;
        h2s[at] = h;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      e_acc = e_acc + __shfl_xor_sync(0xffffffffu, e_acc, o);
      h_acc = h_acc + __shfl_xor_sync(0xffffffffu, h_acc, o);
    }
    if (lane == 0) {
      err_g[k][side] = e_acc;
      h_mean[k][side] = h_acc / (float)per_side;
    }
  }
  __syncthreads();

  // 5a. the MER multipliers
  if (tid == 0) {
    float elb = 0.0f, eub = 0.0f;
    for (int k = 0; k < NSYM; ++k) {
      elb = elb + err_g[k][0];
      eub = eub + err_g[k][1];
    }
    error_lb[s] = elb;
    error_ub[s] = eub;
    const float sig = (float)(2 * NSYM * per_side);
    mult[0] = clip(sig / elb * 10.0f, 1.0f, 127.0f);
    mult[1] = clip(sig / eub * 10.0f, 1.0f, 127.0f);
  }
  __syncthreads();

  // 5b. int8 demap: [32][20 partitions][18][2], upper partitions reversed
  for (int o = tid; o < PM_OUT; o += THREADS) {
    const int c = o & 1;
    int t = o >> 1;
    const int kk = t % NDC;
    t /= NDC;
    const int q = t % (2 * PMP), k = t / (2 * PMP);
    const int side = q >= PMP;
    const int slot = side ? 3 * PMP - 1 - q : q;
    const int at = (k * 2 * PMP + slot) * NDC + kk;
    const float z = c ? data_eq[at].y : data_eq[at].x;
    const float w = clip(h2s[at] / h_mean[k][side], 0.0f, 1.0f);
    pm[(size_t)s * PM_OUT + o] =
        (int8_t)rintf(clip(z, -1.0f, 1.0f) * (mult[side] * w));
  }

  // 5c. the PX demaps: [32][columns][18][2]; column code = side
  // + 2 * mult_side + 4 * partition, px1's columns then px2's
  for (int ch = 0; ch < 2; ++ch) {
    const int ncols = ch ? n_px2 : n_px1;
    int8_t* dst = ch ? px2 : px1;
    const int* cols = px_cols + (ch ? n_px1 : 0);
    const int per = NSYM * ncols * NDC * 2;
    for (int o = tid; o < per; o += THREADS) {
      const int c = o & 1;
      int t = o >> 1;
      const int kk = t % NDC;
      t /= NDC;
      const int col = t % ncols, k = t / ncols;
      const int code = cols[col];
      const int side = code & 1, ms = (code >> 1) & 1, pp = code >> 2;
      float2 z;
      float h;
      equalize(k, side, pp, kk, z, h);
      const float w = clip(h / h_mean[k][side], 0.0f, 1.0f);
      dst[(size_t)s * per + o] = (int8_t)rintf(
          clip(c ? z.y : z.x, -1.0f, 1.0f) * (mult[ms] * w));
    }
  }

  // 6. the new Costas state at the reference bins
  if (tid < r2) {
    const int bin = ref_bin(tid);
    cph_out[(size_t)s * FFT + bin] = nrsc5::wrap_pi(ph_end[tid], two_pi);
    cfr_out[(size_t)s * FFT + bin] = fr_end[tid] - angle_s;
  }
}

}  // namespace

extern "C" int sync_block(const void* spectra, const void* costas_phase,
                          const void* costas_freq, const void* timing_adj,
                          const void* sync_signs, const void* needle_vals,
                          const void* needle_known, void* pm, void* ref_ok,
                          void* ref_bc, void* ref_psmi, void* samperr,
                          void* angle, void* error_lb, void* error_ub,
                          void* new_phase, void* new_freq, void* px1,
                          void* px2, const void* px_cols, int n_px1,
                          int n_px2, int n_stations, int ppb, float alpha,
                          float beta, float two_pi, float pi,
                          float two_pi_over_fft, void* stream) {
  if (ppb < PMP || 2 * (ppb + 1) > MAX_R2 || (n_px1 > 0) != (px1 != nullptr)
      || (n_px2 > 0) != (px2 != nullptr))
    return (int)cudaErrorInvalidValue;
  // the opt-in is a host-side call, made on every launch for the current
  // device rather than remembered once per process
  cudaError_t err = cudaFuncSetAttribute(
      sync_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)EQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  sync_block_kernel<<<n_stations, THREADS, EQ_SMEM, (cudaStream_t)stream>>>(
      (const float2*)spectra, (const float*)costas_phase,
      (const float*)costas_freq, (const int*)timing_adj,
      (const float*)sync_signs, (const unsigned*)needle_vals,
      (const unsigned*)needle_known, (int8_t*)pm, (uint8_t*)ref_ok,
      (int*)ref_bc, (int*)ref_psmi, (int*)samperr, (float*)angle,
      (float*)error_lb, (float*)error_ub, (float*)new_phase,
      (float*)new_freq, (int8_t*)px1, (int8_t*)px2, (const int*)px_cols,
      n_px1, n_px2, ppb, alpha, beta, two_pi, pi, two_pi_over_fft);
  return (int)cudaGetLastError();
}
