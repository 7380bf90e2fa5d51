// The FM sync block's kernel body, shared by K4 (sync_block.cu, the
// real-pair chain, kernel sync_block_kernel) and K18 (sync_fm_c.cu, the
// complex chain, kernel sync_fm_c_kernel): one thread-block cluster of 8
// CTAs per station.  sync_block.cu describes the design; the two kernels
// differ only in the Costas phase detector (costas.cuh: K4 wraps
// angle(v^2) - 2 ph, K18 takes the angle of v^2 e^{-2i ph}, as the complex
// chain's sync_fm_block does), and each has a name of its own, so that a
// trace tells them apart.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "costas.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FFT = 2048;
constexpr int NSYM = 32;
constexpr int W = 19;    // partition width in bins
constexpr int NDC = 18;  // data carriers of a partition
constexpr int PMP = 10;  // PM partitions per sideband
constexpr int LB_START = FFT / 2 - 546;
constexpr int UB_END = FFT / 2 + 546;
constexpr int MAX_R2 = 32;         // 2R <= 30
constexpr int MAX_P = MAX_R2 - 2;  // 2 ppb <= 30 partitions
constexpr int CLUSTER = 8;         // CTAs a station
constexpr int SPC = NSYM / CLUSTER;  // symbols a CTA: 4
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // one per (symbol, sideband) of a CTA
constexpr int PM_SYM = 2 * PMP * NDC * 2;  // soft bits a symbol: 720
constexpr int PM_OUT = NSYM * PM_SYM;      // 23040
// the most loads a thread starts at once: the reference values, the data
// bins (all but warp 0), and the items a lane equalizes
constexpr int REF_LOADS = NSYM * MAX_R2 / THREADS;
constexpr int DAT_LOADS = (SPC * MAX_P * NDC + THREADS - 33) / (THREADS - 32);
static_assert(REF_LOADS * THREADS == NSYM * MAX_R2 && SPC * MAX_R2 <= THREADS,
              "whole passes over the reference values and anchors");
constexpr int EQ_ITEMS = (MAX_P / 2 * NDC + 31) / 32;

// The block loop's carry (K5's FM step), all int32/float32 [S]; offset
// null: no step.
struct Carry {
  const int* keep;
  int* offset;
  float* prev_angle;
  int* samperr_fb;
  float* angle_fb;
  int* samperr;
  float* angle;
  int* timing_adj;  // the next block's (ping-pong)
  int window;
  int half_fftcp;
};

static_assert(WARPS == 2 * SPC, "one warp per (symbol, sideband)");

__device__ __forceinline__ float sign(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The kernel's parameters, and their names to pass on: each of K4 and K18
// is a __global__ of its own name (SYNC_BLOCK_KERNEL) around the body
#define SYNC_BLOCK_PARAMS                                                    \
  const float2 *__restrict__ spectra, const float *__restrict__ cph_in,      \
      const float *__restrict__ cfr_in, const int *__restrict__ timing_adj,  \
      const float *__restrict__ sync_signs,                                  \
      const unsigned *__restrict__ needle_vals,                              \
      const unsigned *__restrict__ needle_known, int8_t *__restrict__ pm,    \
      uint8_t *__restrict__ ref_ok, int *__restrict__ ref_bc,                \
      int *__restrict__ ref_psmi, int *__restrict__ samperr_out,             \
      float *__restrict__ angle_out, float *__restrict__ error_lb,           \
      float *__restrict__ error_ub, float *__restrict__ cph_out,             \
      float *__restrict__ cfr_out, int8_t *__restrict__ px1,                 \
      int8_t *__restrict__ px2, const int *__restrict__ px_cols, int n_px1,  \
      int n_px2, int ppb, float alpha, float beta, float two_pi, float pi,   \
      float two_pi_over_fft, const Carry carry
#define SYNC_BLOCK_ARGS                                                      \
  spectra, cph_in, cfr_in, timing_adj, sync_signs, needle_vals,              \
      needle_known, pm, ref_ok, ref_bc, ref_psmi, samperr_out, angle_out,    \
      error_lb, error_ub, cph_out, cfr_out, px1, px2, px_cols, n_px1, n_px2, \
      ppb, alpha, beta, two_pi, pi, two_pi_over_fft, carry
// the __global__ ``name``: the body with the phase detector kComplexPll
#define SYNC_BLOCK_KERNEL(name, kComplexPll)                                 \
  __global__ void __cluster_dims__(CLUSTER, 1, 1)                            \
      __launch_bounds__(THREADS, 1) name(SYNC_BLOCK_PARAMS) {                \
    sync_block_body<kComplexPll>(SYNC_BLOCK_ARGS);                           \
  }

// kComplexPll: the phase detector in the complex chain's form (K18), else
// in the real-pair chain's (K4); see costas.cuh
template <bool kComplexPll>
__device__ __forceinline__ void sync_block_body(SYNC_BLOCK_PARAMS) {
  __shared__ float2 refv[NSYM][MAX_R2];  // the reference bins' values
  __shared__ float work[NSYM][MAX_R2];   // atan2 of v^2, then Re derot
  __shared__ float phs[NSYM][MAX_R2];    // phases, flipped
  __shared__ float smag[MAX_R2], ph_end[MAX_R2], fr_end[MAX_R2];
  __shared__ float ph0[MAX_R2], fr0[MAX_R2], signs_k[NSYM];
  __shared__ unsigned vals_r[MAX_R2], known_r[MAX_R2];
  __shared__ float t_step[MAX_R2], t_xy[MAX_R2], t_xx[MAX_R2];
  __shared__ float2 amp[SPC][MAX_R2];    // smag * e^{i phase}
  __shared__ float2 dat[SPC][MAX_P][NDC];  // data bins, then equalized
  __shared__ float h2[SPC][MAX_P][NDC];    // MMSE weight numerators
  __shared__ float err_g[SPC][2], h_mean[SPC][2], err_all[NSYM][2];
  __shared__ float mult[2], angle_s;
  // thread 0 of CTA 0: this block's samperr, and the carry step's inputs,
  // loaded first so that the step at the end only stores
  int samperr_k4 = 0, keep_c = 0, offset_c = 0;
  float angle_c = 0.0f;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / CLUSTER;
  const int k0 = rank * SPC;  // this CTA's first symbol
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int R = ppb + 1, r2 = 2 * R, np = 2 * ppb;
  const float2* spec = spectra + (size_t)s * NSYM * FFT;
  const float* cph = cph_in + (size_t)s * FFT;
  const float* cfr = cfr_in + (size_t)s * FFT;

  auto ref_bin = [&](int r) {
    return r < R ? LB_START + r * W : UB_END - (r - R) * W;
  };
  // the reference bins bounding partition p (lower p < ppb, upper after)
  auto lo_idx = [&](int p) { return p < ppb ? p : R + (p - ppb) + 1; };
  auto hi_idx = [&](int p) { return p < ppb ? p + 1 : R + (p - ppb); };
  // data bin kk of partition p (side 0 lower, 1 upper)
  auto data_bin = [&](int p, int kk) {
    return p < ppb ? LB_START + p * W + kk + 1
                   : UB_END - (p - ppb + 1) * W + kk + 1;
  };

  // 0. every reference value of the block and the angle of its square,
  // all loads of a thread started before their first use
  {
    float2 v[REF_LOADS];
#pragma unroll
    for (int j = 0; j < REF_LOADS; ++j) {
      const int i = tid + j * THREADS;  // (k, r) = (i / 32, i % 32)
      if (i % MAX_R2 < r2)
        v[j] = spec[(i / MAX_R2) * FFT + ref_bin(i % MAX_R2)];
    }
    // each track's starting phase and frequency, the sync signs and the
    // needles, beside them
    if (carry.offset != nullptr && rank == 0 && tid == 0) {
      keep_c = carry.keep[s];
      offset_c = carry.offset[s];
      angle_c = carry.angle[s];
    }
    if (tid < r2) {
      const int bin = ref_bin(tid);
      const float k_rel = (float)(bin - FFT / 2);
      ph0[tid] = cph[bin] - ((float)timing_adj[s] * k_rel) * two_pi_over_fft;
      fr0[tid] = cfr[bin];
    } else if (tid >= 32 && tid < 32 + NSYM) {
      signs_k[tid - 32] = sync_signs[tid - 32];
    } else if (tid >= 64 && tid < 64 + r2) {
      vals_r[tid - 64] = needle_vals[tid - 64];
      known_r[tid - 64] = needle_known[tid - 64];
    }
#pragma unroll
    for (int j = 0; j < REF_LOADS; ++j) {
      const int i = tid + j * THREADS;
      if (i % MAX_R2 < r2) {
        refv[i / MAX_R2][i % MAX_R2] = v[j];
        if (!kComplexPll)
          work[i / MAX_R2][i % MAX_R2] = nrsc5::costas_angle(v[j]);
      }
    }
  }
  __syncthreads();

  // 1. warp 0: the phase and frequency recursion, one lane a track; the
  // other warps meanwhile load this CTA's data bins, and in CTA 0 copy the
  // old Costas rows (the reference bins are overwritten in step 6)
  if (warp == 0) {
    if (lane < r2) {
      const int r = lane;
      float ph = ph0[r], fr = fr0[r];
      for (int k = 0; k < NSYM; ++k) {
        phs[k][r] = ph;
        if (kComplexPll)
          nrsc5::costas_advance_c(refv[k][r], ph, fr, alpha, beta, two_pi);
        else
          nrsc5::costas_advance(work[k][r], ph, fr, 0.0f, alpha, beta,
                                two_pi);
      }
      ph_end[r] = ph;
      fr_end[r] = fr;
    }
  } else {
    // (kl, p, kk) = (i / (30 * 18), (i / 18) % 30, i % 18): constant
    // divisors; the partitions past 2 ppb are skipped
    const int t = tid - 32;
    float2 v[DAT_LOADS];
#pragma unroll
    for (int j = 0; j < DAT_LOADS; ++j) {
      const int i = t + j * (THREADS - 32);
      const int kk = i % NDC, p = (i / NDC) % MAX_P, kl = i / (NDC * MAX_P);
      if (kl < SPC && p < np) v[j] = spec[(k0 + kl) * FFT + data_bin(p, kk)];
    }
#pragma unroll
    for (int j = 0; j < DAT_LOADS; ++j) {
      const int i = t + j * (THREADS - 32);
      const int kk = i % NDC, p = (i / NDC) % MAX_P, kl = i / (NDC * MAX_P);
      if (kl < SPC && p < np) dat[kl][p][kk] = v[j];
    }
    if (rank == 0) {
#pragma unroll 4
      for (int j = t; j < FFT; j += THREADS - 32) {
        cph_out[(size_t)s * FFT + j] = cph[j];
        cfr_out[(size_t)s * FFT + j] = cfr[j];
      }
    }
  }
  __syncthreads();
  // the derotated reference values, all steps at once
  for (int i = tid; i < NSYM * MAX_R2; i += THREADS) {
    const int k = i / MAX_R2, r = i % MAX_R2;
    if (r < r2) work[k][r] = nrsc5::costas_derot(refv[k][r], phs[k][r]).x;
  }
  __syncthreads();

  // 2. flip, needles, words and smag, one thread a track, its 32 values in
  // registers
  if (tid < r2) {
    const int r = tid;
    float dx[NSYM];
#pragma unroll
    for (int k = 0; k < NSYM; ++k) dx[k] = work[k][r];
    float score = 0.0f;
#pragma unroll
    for (int k = 0; k < NSYM; ++k) score = score + dx[k] * signs_k[k];
    const bool flip = score < 0.0f;
    const unsigned vals = vals_r[r], known = known_r[r];
    bool ok = true;
    int prev = 0, bc = 0, ps = 0;
    float mag = 0.0f;
#pragma unroll
    for (int k = 0; k < NSYM; ++k) {
      const float d = flip ? -dx[k] : dx[k];
      if (flip) phs[k][r] = phs[k][r] + pi;
      const int sg = d > 0.0f;
      if (((known >> k) & 1u) && (unsigned)sg != ((vals >> k) & 1u)) ok = false;
      const int bit = sg ^ prev;
      prev = sg;
      if (k >= 16 && k < 20) bc = bc * 2 + bit;
      if (k >= 25 && k < 31) ps = ps * 2 + bit;
      mag = mag + fabsf(d);
    }
    if (rank == 0) {
      ref_ok[s * r2 + r] = ok;
      ref_bc[s * r2 + r] = bc;
      ref_psmi[s * r2 + r] = ps;
    }
    smag[r] = mag / (float)NSYM;
    if (flip) ph_end[r] = ph_end[r] + pi;
  }
  __syncthreads();

  // the interpolation anchors of this CTA's symbols: smag * e^{i phase}
  if (tid < SPC * MAX_R2) {
    const int kl = tid / MAX_R2, r = tid % MAX_R2;
    if (r < r2) {
      const float phi = phs[k0 + kl][r];
      amp[kl][r] = make_float2(cosf(phi) * smag[r], sinf(phi) * smag[r]);
    }
  }
  __syncthreads();

  // 4. equalize this CTA's symbols in place; MER and MMSE sums, one warp
  // per (symbol, sideband), lane l adding items l, l + 32, ... in turn
  // (their terms taken first, all at once), then a butterfly
  const int per_side = ppb * NDC;
  {
    const int kl = warp >> 1, side = warp & 1;
    float e_t[EQ_ITEMS], h_t[EQ_ITEMS];
#pragma unroll
    for (int j = 0; j < EQ_ITEMS; ++j) {
      const int i = lane + 32 * j;
      if (i < per_side) {
        const int p = side * ppb + i / NDC, kk = i % NDC;
        const float2 ah = amp[kl][hi_idx(p)], al = amp[kl][lo_idx(p)];
        const float kf = (float)(kk + 1), wk = (float)(W - (kk + 1));
        const float dr = kf * ah.x + wk * al.x;
        const float di = kf * ah.y + wk * al.y;
        const float a2 = dr * dr + di * di;
        const float er = ((float)W * dr + (float)W * di) / a2;
        const float ei = ((float)W * dr - (float)W * di) / a2;
        const float2 x = dat[kl][p][kk];
        const float2 z =
            make_float2(x.x * er - x.y * ei, x.x * ei + x.y * er);
        const float h = 1.0f / fmaxf(er * er + ei * ei, 1e-12f);
        const float tr = sign(z.x) - z.x, ti = sign(z.y) - z.y;
        e_t[j] = tr * tr + ti * ti;
        h_t[j] = h;
        dat[kl][p][kk] = z;
        h2[kl][p][kk] = h;
      }
    }
    float e_acc = 0.0f, h_acc = 0.0f;
#pragma unroll
    for (int j = 0; j < EQ_ITEMS; ++j)
      if (lane + 32 * j < per_side) {
        e_acc = e_acc + e_t[j];
        h_acc = h_acc + h_t[j];
      }
    for (int o = 16; o > 0; o >>= 1) {
      e_acc = e_acc + __shfl_xor_sync(0xffffffffu, e_acc, o);
      h_acc = h_acc + __shfl_xor_sync(0xffffffffu, h_acc, o);
    }
    if (lane == 0) {
      err_g[kl][side] = e_acc;
      h_mean[kl][side] = h_acc / (float)per_side;
    }
  }

  // 5a. the MER sums of all 32 symbols, from the cluster's CTAs, added in
  // symbol order by every CTA
  cluster.sync();
  if (tid < 2 * NSYM) {
    const int k = tid >> 1, side = tid & 1;
    const float* remote = cluster.map_shared_rank(&err_g[0][0], k / SPC);
    err_all[k][side] = remote[(k % SPC) * 2 + side];
  }
  __syncthreads();
  if (tid == 0) {
    float elb = 0.0f, eub = 0.0f;
#pragma unroll
    for (int k = 0; k < NSYM; ++k) {
      elb = elb + err_all[k][0];
      eub = eub + err_all[k][1];
    }
    if (rank == 0) {
      error_lb[s] = elb;
      error_ub[s] = eub;
    }
    const float sig = (float)(2 * NSYM * per_side);
    mult[0] = clip(sig / elb * 10.0f, 1.0f, 127.0f);
    mult[1] = clip(sig / eub * 10.0f, 1.0f, 127.0f);
  }
  __syncthreads();

  if (warp == 0) {
    // 3. timing and angle (CTA 0), beside the demaps: the terms in
    // parallel, then their four sums in index order on one lane
    if (rank == 0) {
      if (lane < np) {
        const float d = phs[0][lo_idx(lane)] - phs[0][hi_idx(lane)];
        t_step[lane] = d - pi * rintf(d / pi);
      }
      if (lane < r2) {
        const float x = (float)(ref_bin(lane) - FFT / 2);
        t_xy[lane] = x * fr_end[lane];
        t_xx[lane] = x * x;
      }
      __syncwarp();
      if (lane == 0) {
        float acc = 0.0f, sxy = 0.0f, sxx = 0.0f, sf = 0.0f;
#pragma unroll
        for (int i = 0; i < MAX_R2; ++i) {
          if (i < np) acc = acc + t_step[i];
          if (i < r2) {
            sxy = sxy + t_xy[i];
            sxx = sxx + t_xx[i];
            sf = sf + fr_end[i];
          }
        }
        acc = acc / (float)np * (float)FFT / (float)W / two_pi;
        const float slope = sxy / sxx;
        acc = acc - slope * (float)FFT / two_pi * (float)NSYM;
        samperr_k4 = (int)rintf(acc);
        samperr_out[s] = samperr_k4;
        angle_s = sf / (float)r2;
        angle_out[s] = angle_s;
      }
      __syncwarp();
      // 6. the new Costas state at the reference bins
      if (lane < r2) {
        const int bin = ref_bin(lane);
        cph_out[(size_t)s * FFT + bin] =
            nrsc5::wrap_pi(ph_end[lane], two_pi);
        cfr_out[(size_t)s * FFT + bin] = fr_end[lane] - angle_s;
      }
    }
  } else {
    const int u = tid - 32;  // the demaps' thread index
    // 5b. int8 demap of this CTA's symbols: [32][20 partitions][18][2],
    // upper partitions reversed; a data bin's weight once for its re and im
    for (int e = u; e < SPC * 2 * PMP * NDC; e += THREADS - 32) {
      const int kk = e % NDC, t = e / NDC;
      const int q = t % (2 * PMP), kl = t / (2 * PMP);
      const int side = q >= PMP;
      const int p = side ? ppb + (2 * PMP - 1 - q) : q;
      const float2 z = dat[kl][p][kk];
      const float m = mult[side] * clip(h2[kl][p][kk] / h_mean[kl][side],
                                        0.0f, 1.0f);
      *reinterpret_cast<char2*>(pm + (size_t)s * PM_OUT + k0 * PM_SYM
                                + 2 * e) =
          make_char2((signed char)rintf(clip(z.x, -1.0f, 1.0f) * m),
                     (signed char)rintf(clip(z.y, -1.0f, 1.0f) * m));
    }

    // 5c. the PX demaps: [32][columns][18][2]; column code = side
    // + 2 * mult_side + 4 * partition, px1's columns then px2's
    for (int ch = 0; ch < 2; ++ch) {
      const int ncols = ch ? n_px2 : n_px1;
      int8_t* dst = ch ? px2 : px1;
      const int* cols = px_cols + (ch ? n_px1 : 0);
      const int per_sym = ncols * NDC * 2;
      for (int e = u; e < SPC * ncols * NDC; e += THREADS - 32) {
        const int kk = e % NDC, t = e / NDC;
        const int col = t % ncols, kl = t / ncols;
        const int code = cols[col];
        const int side = code & 1, ms = (code >> 1) & 1, pp = code >> 2;
        const int p = side * ppb + pp;
        const float2 z = dat[kl][p][kk];
        const float m = mult[ms] * clip(h2[kl][p][kk] / h_mean[kl][side],
                                        0.0f, 1.0f);
        *reinterpret_cast<char2*>(dst + (size_t)s * NSYM * per_sym
                                  + k0 * per_sym + 2 * e) =
            make_char2((signed char)rintf(clip(z.x, -1.0f, 1.0f) * m),
                       (signed char)rintf(clip(z.y, -1.0f, 1.0f) * m));
      }
    }
  }
  // no CTA leaves while another may still read its err_g
  cluster.sync();

  // the loop's carry step for the next block
  if (carry.offset != nullptr && rank == 0 && tid == 0) {
    carry.offset[s] = offset_c + (carry.window - keep_c);
    carry.prev_angle[s] = angle_c;
    carry.samperr_fb[s] = samperr_k4;
    carry.angle_fb[s] = angle_s;
    const int se = carry.half_fftcp + samperr_k4;
    carry.samperr[s] = se;
    carry.angle[s] = angle_c - angle_s;
    carry.timing_adj[s] = carry.half_fftcp - se;
  }
}

}  // namespace
