// K16c as it was before its redesign (nrsc5_tpu_torch/csrc/sbr_hf_adjust.cu
// at the parent commit), for probes/k16cd_variants.py, with knobs:
// -DMAXM=n sizes its static shared memory to n bins (64: as it was);
// -DCUT=1 stops before the X pass (the envelope phases, limiter and slot
// expansion alone), -DCUT=2 skips the envelope, limiter and slot phases
// (the packet's loads and the X pass on whatever shared memory holds);
// -DCLOCK makes thread 0 of each CTA read the global timer at entry, after
// the packet's inputs, after e_curr (and the interpol_freq = 0 means),
// after the limiter and boost, after the slot expansion, after the X pass
// and after the history shift of a smoothing walk, summed over a lane's
// packets when it walks them, and write the 8 int64 behind X (entry, the
// six phase lengths, exit).
//
// The parent's own notes:
//
// K16c: the SBR HF adjuster and the assembly of the 64-band synthesis
// input X, for every lane and packet of a batch.
//
// Replaces stage 4 and the assembly of stage 5 of the JAX device function
// nrsc5_tpu/audio/batch.py:164 _make_device_fn -> fn (:326-478): per
// envelope e and SBR bin i, the band -> bin expansions of the envelope,
// noise and sinusoid data (gathers through the bin's band: each bin lies
// in at most one band, so the reference's 0/1 indicator products add
// exact zeros); e_curr, the mean of |x_high|^2 over the envelope's slots
// (with interpol_freq = 0 its per-band mean over the bins); the gain, noise
// and sinusoid levels; the limiter over the limiter bands and the boost;
// the expansion to slots (sums over the five envelopes), the 5-tap h_smooth
// filter with its transient bypass and its 4-slot history when the header
// smooths; the noise phasors from noise_start and the sinusoid phases
// i^((slot + bin) & 3); then X = the low band xl masked by nlow, plus the
// adjusted high band at bins kx .. kx + m - 1.
//
// Layout: xh f32 [N, K, 32, m, 2], xl f32 [N, 32 K, 64]; env_seg uint8 [N,
// K, 32, 5], freq_res and delta_e uint8 [N, K, 5], e_bands f32 [N, K, 5,
// n_high], q_bands f32 [N, K, 5, n_q], harm_act uint8 [N, K, 5, n_high],
// noise_start int32 [N, K, 32], nlow f32 [N, K, 32]; the bin maps int32
// [m] (band_hi, band_lo, band_noise, sin_band, lim_band; -1 for none), the
// band widths w_hi [n_high], w_lo [n_low], noise_tab f32 [512, 2] (4 KB,
// read through the read-only cache, as every table here: none is a local
// array); g_hist / q_hist f32 [N, 4, 64] when smoothing.  Out: X f32 [2,
// N, K, 32, 64] (real and imaginary planes, the layout of the synthesis
// matmul), new g_hist / q_hist.
//
// Bound on the H100: device-memory bytes.  At N = 128, K = 8, m = 25 it
// reads 6.6 MB of xh and 8.4 MB of xl and writes 16.8 MB of X (0.0095 ms
// at 3.35 TB/s).  Design: one CTA per (lane, packet), or, when the header
// smooths, one CTA per lane that walks its packets in order (the filter
// reaches 4 slots back into the previous packet, so the raw slot
// trajectories of the last 4 slots stay in shared memory from one packet
// to the next).  Per packet: a pass over the 5 x m (envelope, bin) values,
// the limiter sums per (envelope, limiter band) in bin order, a pass per
// (slot, bin) for the raw slot values, then one per (slot, band) that
// writes X.  Every sum runs in the plain version's order; -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NSLOT = 32;
constexpr int MAXENV = 5;
#ifndef MAXM
#define MAXM 64
#endif
#ifndef CUT
#define CUT 0
#endif

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
constexpr int HIST = 4;

struct Params {
  const float* xh;
  const float* xl;
  const uint8_t* env_seg;
  const uint8_t* freq_res;
  const float* e_bands;
  const float* q_bands;
  const uint8_t* harm_act;
  const uint8_t* delta_e;
  const int* noise_start;
  const float* nlow;
  const int* band_hi;
  const int* band_lo;
  const int* band_noise;
  const int* sin_band;
  const int* lim_band;
  const float* w_hi;
  const float* w_lo;
  const float* noise_tab;
  const float* g_hist;
  const float* q_hist;
  float* new_g_hist;
  float* new_q_hist;
  float* x;
  int n_lanes, n_packets, m, kx, n_high, n_low, n_q, n_lim;
  int interpol, smooth;
  float lim_gain, eps, g_max_cap, max_boost;
  float h0, h1, h2, h3, h4;
};

__device__ __forceinline__ float bin_of(const float* row, int b) {
  return b >= 0 ? row[b] : 0.0f;
}

__global__ void __launch_bounds__(THREADS) sbr_hf_adjust_kernel(Params p) {
  // per (envelope, bin)
  __shared__ float s_eorig[MAXENV][MAXM];
  __shared__ float s_ecurr[MAXENV][MAXM];
  __shared__ float s_gain[MAXENV][MAXM];
  __shared__ float s_qm[MAXENV][MAXM];
  __shared__ float s_sm[MAXENV][MAXM];
  __shared__ float s_smap[MAXENV][MAXM];
  // per (envelope, band): the band means of interpol_freq = 0, then the
  // limiter sums and levels (the same storage, used one after the other)
  __shared__ float s_eo_sum[MAXENV][MAXM];
  __shared__ float s_lim[MAXENV][MAXM];
  float (*s_band_hi)[MAXM] = s_eo_sum;
  float (*s_band_lo)[MAXM] = s_lim;
  // per slot of the packet, after HIST slots of history: raw gain and
  // noise trajectories
  __shared__ float s_gs[HIST + NSLOT][MAXM];
  __shared__ float s_qs[HIST + NSLOT][MAXM];
  __shared__ float s_sms[NSLOT][MAXM];
  __shared__ float s_gate[NSLOT][MAXM];
  __shared__ float s_seg[NSLOT][MAXENV];
  __shared__ float s_cover[NSLOT], s_ok[NSLOT];
  __shared__ float s_res[MAXENV], s_delta[MAXENV];

  const int m = p.m;
  const int kc = p.smooth ? p.n_packets : 1;
  const long long n = blockIdx.x / (p.n_packets / kc);
  const int k0 = (int)(blockIdx.x % (p.n_packets / kc)) * kc;
  const int tid = threadIdx.x;
#ifdef CLOCK
  unsigned long long clk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  unsigned long long t_last = gtime();
  clk[0] = t_last;
#define TICK(i)                                \
  if (tid == 0) {                              \
    const unsigned long long t_now = gtime();  \
    clk[i] += t_now - t_last;                  \
    t_last = t_now;                            \
  }
#else
#define TICK(i)
#endif

  if (p.smooth) {
    for (int e = tid; e < HIST * m; e += THREADS) {
      const int j = e / m, i = e - j * m;
      s_gs[j][i] = p.g_hist[(n * HIST + j) * 64 + i];
      s_qs[j][i] = p.q_hist[(n * HIST + j) * 64 + i];
    }
  }

  for (int k = k0; k < k0 + kc; ++k) {
    const long long pk = n * p.n_packets + k;
    for (int e = tid; e < NSLOT * MAXENV; e += THREADS) {
      s_seg[e / MAXENV][e % MAXENV] =
          (float)p.env_seg[pk * NSLOT * MAXENV + e];
    }
    if (tid < MAXENV) {
      s_res[tid] = (float)p.freq_res[pk * MAXENV + tid];
      s_delta[tid] = (float)p.delta_e[pk * MAXENV + tid];
    }
    __syncthreads();
    TICK(1)
    const float* xh = p.xh + pk * NSLOT * m * 2;
#if CUT != 2

    // ---- per (envelope, bin): e_orig, e_curr ------------------------
    for (int e = tid; e < MAXENV * m; e += THREADS) {
      const int v = e / m, i = e - v * m;
      const float* eb = p.e_bands + (pk * MAXENV + v) * p.n_high;
      const float res = s_res[v];
      s_eorig[v][i] = res * bin_of(eb, p.band_hi[i]) +
                      (1.0f - res) * bin_of(eb, p.band_lo[i]);
      float cnt = 0.0f, acc = 0.0f;
      for (int t = 0; t < NSLOT; ++t) {
        const float hr = xh[(t * m + i) * 2], hi = xh[(t * m + i) * 2 + 1];
        const float seg = s_seg[t][v];
        cnt = cnt + seg;
        acc = acc + seg * (hr * hr + hi * hi);
      }
      s_ecurr[v][i] = acc / fmaxf(cnt, 1.0f);
    }
    __syncthreads();
    if (!p.interpol) {
      // per-band means of e_curr over the band's bins, in bin order
      for (int e = tid; e < MAXENV * (p.n_high + p.n_low); e += THREADS) {
        const int v = e / (p.n_high + p.n_low);
        const int b = e - v * (p.n_high + p.n_low);
        const bool hi_band = b < p.n_high;
        const int bb = hi_band ? b : b - p.n_high;
        const int* map = hi_band ? p.band_hi : p.band_lo;
        float acc = 0.0f;
        for (int i = 0; i < m; ++i) {
          if (map[i] == bb) acc = acc + s_ecurr[v][i];
        }
        if (hi_band) {
          s_band_hi[v][bb] = acc / p.w_hi[bb];
        } else {
          s_band_lo[v][bb] = acc / p.w_lo[bb];
        }
      }
      __syncthreads();
      for (int e = tid; e < MAXENV * m; e += THREADS) {
        const int v = e / m, i = e - v * m;
        const float res = s_res[v];
        s_ecurr[v][i] = res * bin_of(s_band_hi[v], p.band_hi[i]) +
                        (1.0f - res) * bin_of(s_band_lo[v], p.band_lo[i]);
      }
      __syncthreads();
    }
    TICK(2)

    // ---- gain, noise and sinusoid levels ---------------------------
    for (int e = tid; e < MAXENV * m; e += THREADS) {
      const int v = e / m, i = e - v * m;
      const float eo = s_eorig[v][i], ec = s_ecurr[v][i];
      const float qo = bin_of(p.q_bands + (pk * MAXENV + v) * p.n_q,
                              p.band_noise[i]);
      const uint8_t* act = p.harm_act + (pk * MAXENV + v) * p.n_high;
      const int bh = p.band_hi[i], bs = p.sin_band[i];
      const float smap = bh >= 0 ? (float)act[bh] : 0.0f;
      const float sbin = bs >= 0 ? (float)act[bs] : 0.0f;
      const float q_frac = qo / (1.0f + qo);
      const float gain =
          smap > 0.0f ? sqrtf(eo * q_frac / (1.0f + ec))
                      : sqrtf(eo / ((1.0f + ec) * (1.0f + s_delta[v] * qo)));
      s_gain[v][i] = gain;
      s_qm[v][i] = sqrtf(eo * q_frac);
      s_sm[v][i] = sbin > 0.0f ? sqrtf(eo / (1.0f + qo)) : 0.0f;
      s_smap[v][i] = smap;
    }
    __syncthreads();

    // ---- limiter: per (envelope, limiter band), sums in bin order ---
    for (int e = tid; e < MAXENV * p.n_lim; e += THREADS) {
      const int v = e / p.n_lim, l = e - v * p.n_lim;
      float eo = 0.0f, ec = 0.0f;
      for (int i = 0; i < m; ++i) {
        if (p.lim_band[i] == l) {
          eo = eo + s_eorig[v][i];
          ec = ec + s_ecurr[v][i];
        }
      }
      s_eo_sum[v][l] = eo;
      s_lim[v][l] = fminf(p.lim_gain * sqrtf((p.eps + eo) / (p.eps + ec)),
                          p.g_max_cap);
    }
    __syncthreads();
    for (int e = tid; e < MAXENV * m; e += THREADS) {
      const int v = e / m, i = e - v * m;
      const float g_max = bin_of(s_lim[v], p.lim_band[i]);
      float gain = s_gain[v][i], qm = s_qm[v][i];
      if (gain > g_max) qm = qm * g_max / fmaxf(gain, p.eps);
      gain = fminf(gain, g_max);
      const float sm = s_sm[v][i];
      s_gain[v][i] = gain;
      s_qm[v][i] = qm;
      // the level the adjusted band carries, for the boost
      s_ecurr[v][i] = gain * gain * s_ecurr[v][i] +
                      s_delta[v] * (qm * qm * (1.0f - s_smap[v][i])) +
                      sm * sm;
    }
    __syncthreads();
    for (int e = tid; e < MAXENV * p.n_lim; e += THREADS) {
      const int v = e / p.n_lim, l = e - v * p.n_lim;
      float got = 0.0f;
      for (int i = 0; i < m; ++i) {
        if (p.lim_band[i] == l) got = got + s_ecurr[v][i];
      }
      s_lim[v][l] = fminf(sqrtf((p.eps + s_eo_sum[v][l]) / (p.eps + got)),
                          p.max_boost);
    }
    __syncthreads();
    for (int e = tid; e < MAXENV * m; e += THREADS) {
      const int v = e / m, i = e - v * m;
      const float boost = bin_of(s_lim[v], p.lim_band[i]);
      s_gain[v][i] = s_gain[v][i] * boost;
      s_qm[v][i] = s_qm[v][i] * boost;
      s_sm[v][i] = s_sm[v][i] * boost;
    }
    if (tid < NSLOT) {
      float cover = 0.0f, ok = 0.0f;
      for (int v = 0; v < MAXENV; ++v) {
        cover = cover + s_seg[tid][v];
        ok = ok + s_seg[tid][v] * s_delta[v];
      }
      s_cover[tid] = cover;
      s_ok[tid] = ok;
    }
    __syncthreads();
    TICK(3)

    // ---- per (slot, bin): the envelope values expanded to slots -----
    for (int e = tid; e < NSLOT * m; e += THREADS) {
      const int t = e / m, i = e - t * m;
      float gs = 0.0f, sms = 0.0f, qs = 0.0f, gate = 0.0f;
      for (int v = 0; v < MAXENV; ++v) {
        const float seg = s_seg[t][v];
        gs = gs + seg * s_gain[v][i];
        sms = sms + seg * s_sm[v][i];
        if (p.smooth) {
          qs = qs + seg * s_qm[v][i];
          gate = gate + seg * (s_delta[v] * (1.0f - s_smap[v][i]));
        } else {
          gate = gate + seg * (s_delta[v] * s_qm[v][i] *
                               (1.0f - s_smap[v][i]));
        }
      }
      s_gs[HIST + t][i] = gs;
      s_qs[HIST + t][i] = qs;
      s_sms[t][i] = sms;
      s_gate[t][i] = gate;  // smoothing: the gate; else the noise level
    }
    __syncthreads();
    TICK(4)
#endif
#if CUT != 1

    // ---- per (slot, band): X ----------------------------------------
    const float* xl = p.xl + pk * NSLOT * 64;
    const long long plane = (long long)p.n_lanes * p.n_packets * NSLOT * 64;
    for (int e = tid; e < NSLOT * 64; e += THREADS) {
      const int t = e >> 6, b = e & 63;
      float xr = 0.0f, xi = 0.0f;
      if (b < 32) {
        const float lo = p.nlow[pk * 32 + b];
        xr = xl[t * 64 + b] * lo;
        xi = xl[t * 64 + 32 + b] * lo;
      }
      const int i = b - p.kx;
      if (i >= 0 && i < m) {
        float gain_s, qm_s;
        if (p.smooth) {
          const int c = HIST + t;
          float gf = 0.0f, qf = 0.0f;
          gf = gf + p.h0 * s_gs[c][i];
          qf = qf + p.h0 * s_qs[c][i];
          gf = gf + p.h1 * s_gs[c - 1][i];
          qf = qf + p.h1 * s_qs[c - 1][i];
          gf = gf + p.h2 * s_gs[c - 2][i];
          qf = qf + p.h2 * s_qs[c - 2][i];
          gf = gf + p.h3 * s_gs[c - 3][i];
          qf = qf + p.h3 * s_qs[c - 3][i];
          gf = gf + p.h4 * s_gs[c - 4][i];
          qf = qf + p.h4 * s_qs[c - 4][i];
          const float ok = s_ok[t];
          gain_s = ok * gf + (1.0f - ok) * s_gs[HIST + t][i];
          qm_s = s_gate[t][i] * (ok * qf + (1.0f - ok) * s_qs[HIST + t][i]);
        } else {
          gain_s = s_gs[HIST + t][i];
          qm_s = s_gate[t][i];
        }
        const int nidx =
            (int)(((unsigned)p.noise_start[pk * NSLOT + t] + 1u + i) & 511u);
        const float nzr = __ldg(p.noise_tab + 2 * nidx);
        const float nzi = __ldg(p.noise_tab + 2 * nidx + 1);
        const int ph = (t + i) & 3;
        const float phr = ph == 0 ? 1.0f : (ph == 2 ? -1.0f : 0.0f);
        const float phi = ph == 1 ? 1.0f : (ph == 3 ? -1.0f : 0.0f);
        const float sms = s_sms[t][i];
        const float* h = xh + (t * m + i) * 2;
        const float cov = s_cover[t];
        const float yr = (h[0] * gain_s + qm_s * nzr + sms * phr) * cov;
        const float yi = (h[1] * gain_s + qm_s * nzi + sms * phi) * cov;
        xr = xr + yr;
        xi = xi + yi;
      }
      const long long o = (pk * NSLOT + t) * 64 + b;
      p.x[o] = xr;
      p.x[plane + o] = xi;
    }
#endif
    __syncthreads();
    TICK(5)
    if (p.smooth) {
      // the last HIST raw slots become the next packet's history
      for (int e = tid; e < HIST * m; e += THREADS) {
        const int j = e / m, i = e - j * m;
        s_gs[j][i] = s_gs[NSLOT + j][i];
        s_qs[j][i] = s_qs[NSLOT + j][i];
      }
      __syncthreads();
    }
    TICK(6)
  }
  if (p.smooth) {
    for (int e = tid; e < HIST * 64; e += THREADS) {
      const int j = e >> 6, i = e & 63;
      p.new_g_hist[(n * HIST + j) * 64 + i] = i < m ? s_gs[j][i] : 0.0f;
      p.new_q_hist[(n * HIST + j) * 64 + i] = i < m ? s_qs[j][i] : 0.0f;
    }
  }
#ifdef CLOCK
  if (tid == 0) {
    clk[7] = gtime();
    long long* out = reinterpret_cast<long long*>(
        p.x + 2LL * p.n_lanes * p.n_packets * NSLOT * 64) + 8LL * blockIdx.x;
    for (int q = 0; q < 8; ++q) out[q] = (long long)clk[q];
  }
#endif
}

}  // namespace

extern "C" int sbr_hf_adjust_parent(
    const void* xh, const void* xl, const void* env_seg, const void* freq_res,
    const void* e_bands, const void* q_bands, const void* harm_act,
    const void* delta_e, const void* noise_start, const void* nlow,
    const void* band_hi, const void* band_lo, const void* band_noise,
    const void* sin_band, const void* lim_band, const void* w_hi,
    const void* w_lo, const void* noise_tab, const void* g_hist,
    const void* q_hist, void* new_g_hist, void* new_q_hist, void* x,
    int n_lanes, int n_packets, int m, int kx, int n_high, int n_low,
    int n_q, int n_lim, int interpol, int smooth, float lim_gain, float eps,
    float g_max_cap, float max_boost, float h0, float h1, float h2, float h3,
    float h4, void* stream) {
  if (n_lanes <= 0 || n_packets <= 0 || m <= 0 || m > MAXM || kx < 0 ||
      kx + m > 64 || n_high <= 0 || n_high > MAXM || n_low <= 0 ||
      n_low > MAXM || n_q <= 0 || n_lim < 0 || n_lim > MAXM)
    return (int)cudaErrorInvalidValue;
  if (smooth && (!g_hist || !q_hist || !new_g_hist || !new_q_hist))
    return (int)cudaErrorInvalidValue;
  Params p{(const float*)xh, (const float*)xl, (const uint8_t*)env_seg,
           (const uint8_t*)freq_res, (const float*)e_bands,
           (const float*)q_bands, (const uint8_t*)harm_act,
           (const uint8_t*)delta_e, (const int*)noise_start,
           (const float*)nlow, (const int*)band_hi, (const int*)band_lo,
           (const int*)band_noise, (const int*)sin_band,
           (const int*)lim_band, (const float*)w_hi, (const float*)w_lo,
           (const float*)noise_tab, (const float*)g_hist,
           (const float*)q_hist, (float*)new_g_hist, (float*)new_q_hist,
           (float*)x, n_lanes, n_packets, m, kx, n_high, n_low, n_q, n_lim,
           interpol, smooth, lim_gain, eps, g_max_cap, max_boost,
           h0, h1, h2, h3, h4};
  const long long blocks =
      smooth ? (long long)n_lanes : (long long)n_lanes * n_packets;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sbr_hf_adjust_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
