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
// [m] (band_hi, band_lo, band_noise, sin_band, lim_band; -1 for none) and
// the spans int32 [m, 2] of each bin's high, low and limiter band (its
// first bin and one past its last: every band is a run of bins), the band
// widths w_hi [n_high], w_lo [n_low], noise_tab f32 [512, 2] (4 KB, read
// through the read-only cache: no table is a local array); g_hist / q_hist
// f32 [N, 4, 64] when smoothing.  Out: X f32 [2, N, K, 32, 64] (real and
// imaginary planes, the layout of the synthesis matmul), new g_hist /
// q_hist.  xh, xl, env_seg, noise_start and nlow are staged by bulk
// copies, so they must be 16-byte aligned.
//
// Bound on the H100: device-memory bytes.  At N = 128, K = 8, m = 25 it
// reads 6.6 MB of xh and 8.4 MB of xl and writes 16.8 MB of X (0.0097 ms
// at 3.35 TB/s).  Design: one CTA a lane's two packets (a packet's work is
// a chain of short phases, and two side by side fill the CTA's 256 threads
// and put the whole batch in one wave at four CTAs an SM), whatever the
// header.  At entry one thread brings the packets' x_high and envelope
// maps, xl rows, noise starts and nlow into shared memory by bulk copies
// (two barriers: the low band's inputs, then x_high's), while every thread
// loads the maps, spans, band widths and the packets' band rows into
// shared memory, no load waiting on another.  The groups of 4 bins of X
// that no gain reaches (xl x nlow below kx, zeros from kx + m) are written
// by 16-byte stores as soon as xl lands, under x_high's copy.  Then each
// (envelope, bin) pair sums its e_curr over the 32 staged slots and takes
// its band data from the tables, and each band or limiter sum a bin needs
// is summed by that bin's own thread over its band's span, in bin order:
// the limiter takes two phases (levels and the clip, then the boost), and
// no phase runs on a handful of threads.  Last, a thread per (slot, 4
// bins) expands the envelope values to its slot and writes its bins of X
// by 16-byte stores.  Shared memory is sized to m (about 36 KB at m = 25).
// When the header smooths, the 5-tap filter reaches 4 slots back into the
// previous packet, whose raw slot trajectories depend only on that packet:
// each CTA also stages the packet before its first and runs its envelope
// phases beside its own, on 512 threads, and takes its last 4 raw rows;
// packet 0 takes the carried history, and the lane's last packet writes
// the new one.  Every
// sum runs in the plain version's order; -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

// threads a CTA: 512 when the header smooths (its CTAs also run the
// envelope phases of the packet before their first: 3 packets' pairs)
constexpr int THREADS = 256;
constexpr int THREADS_SMOOTH = 512;
constexpr int OWN = 2;  // packets a CTA
constexpr int NSLOT = 32;
constexpr int MAXENV = 5;
constexpr int MAXM = 64;
constexpr int HIST = 4;
constexpr int NCOL = 64;
constexpr int SEG_BYTES = NSLOT * MAXENV;  // 160

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
  const int* hi_span;
  const int* lo_span;
  const int* lim_span;
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

__host__ __device__ constexpr int up4(int w) { return (w + 3) & ~3; }

// The dynamic shared memory of a CTA, in 4-byte words (every part 16-byte
// aligned): two mbarriers; the staged packets' x_high and envelope maps
// (the packet before the CTA's first too, when smoothing); the own
// packets' xl rows, nlow and noise starts; the resolution and delta flags;
// the maps, spans and band widths, and the staged packets' band rows; 11
// arrays of an (envelope, bin) pair; and with smoothing the raw gain and
// noise rows of the own packets' slots behind HIST rows of history.
struct Layout {
  int staged, pairs, xh, seg, xl, nlow, nstart, res, delta, map, span, w,
      eb, qb, act, pair0, gs, qs, words;
  __host__ __device__ Layout(int m, bool smooth, int n_high, int n_low,
                             int n_q) {
    staged = smooth ? OWN + 1 : OWN;
    pairs = staged * MAXENV * m;
    xh = 4;
    seg = xh + staged * 2 * NSLOT * m;
    xl = seg + up4(staged * SEG_BYTES / 4);
    nlow = xl + OWN * NSLOT * NCOL;
    nstart = nlow + OWN * NSLOT;
    res = nstart + OWN * NSLOT;
    delta = res + up4(staged * MAXENV);
    map = delta + up4(staged * MAXENV);
    span = map + up4(5 * m);
    w = span + up4(6 * m);
    eb = w + up4(n_high + n_low);
    qb = eb + up4(staged * MAXENV * n_high);
    act = qb + up4(staged * MAXENV * n_q);
    pair0 = act + up4(staged * MAXENV * n_high);
    gs = pair0 + 11 * up4(pairs);
    const int rows = smooth ? (HIST + OWN * NSLOT) * m : 0;
    qs = gs + up4(rows);
    words = qs + up4(rows);
  }
  __device__ float* pair(float* s, int which) const {
    return s + pair0 + which * up4(pairs);
  }
};

enum { P_EO, P_QO, P_SMAP, P_SBIN, P_EC, P_ECF, P_GAIN, P_QM, P_SM, P_GOT,
       P_EOL };

__device__ __forceinline__ float bin_of(const float* row, int b) {
  return b >= 0 ? row[b] : 0.0f;
}

__device__ __forceinline__ void st4(float* dst, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

template <int NT>
__global__ void __launch_bounds__(NT) sbr_hf_adjust_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int m = p.m, tid = threadIdx.x;
  const Layout L(m, p.smooth != 0, p.n_high, p.n_low, p.n_q);
  const int ctas_a_lane = (p.n_packets + OWN - 1) / OWN;
  const int n = blockIdx.x / ctas_a_lane;
  const int k0 = (blockIdx.x - n * ctas_a_lane) * OWN;  // first own packet
  const int nown = min(OWN, p.n_packets - k0);
  // staged packets k0 - prior .. k0 + nown - 1; the own ones last
  const int prior = (p.smooth && k0 > 0) ? 1 : 0;
  const int ns = prior + nown;
  const long long pk0 = (long long)n * p.n_packets + k0 - prior;
  const long long own0 = pk0 + prior;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_xh = smem + L.xh;
  uint8_t* s_seg = reinterpret_cast<uint8_t*>(smem + L.seg);
  float* s_xl = smem + L.xl;
  float* s_nlow = smem + L.nlow;
  int* s_nstart = reinterpret_cast<int*>(smem + L.nstart);
  float* s_res = smem + L.res;
  float* s_delta = smem + L.delta;
  float* s_eo = L.pair(smem, P_EO);
  float* s_qo = L.pair(smem, P_QO);
  float* s_smap = L.pair(smem, P_SMAP);
  float* s_sbin = L.pair(smem, P_SBIN);
  float* s_ec = L.pair(smem, P_EC);
  float* s_ecf = L.pair(smem, P_ECF);
  float* s_gain = L.pair(smem, P_GAIN);
  float* s_qm = L.pair(smem, P_QM);
  float* s_sm = L.pair(smem, P_SM);
  float* s_got = L.pair(smem, P_GOT);
  float* s_eol = L.pair(smem, P_EOL);
  float* s_gs = smem + L.gs;
  float* s_qs = smem + L.qs;
  int* s_map = reinterpret_cast<int*>(smem + L.map);  // hi lo noise sin lim
  int* s_span = reinterpret_cast<int*>(smem + L.span);  // hi lo lim
  float* s_w = smem + L.w;                               // w_hi | w_lo
  float* s_eb = smem + L.eb;
  float* s_qb = smem + L.qb;
  float* s_act = smem + L.act;

  // ---- stage: the packets' bytes by bulk copies, two barriers ---------
  if (tid == 0) {
    bulk::init(&bar[0]);
    bulk::init(&bar[1]);
    bulk::expect(&bar[0], nown * (NSLOT * NCOL * 4 + 2 * NSLOT * 4));
    bulk::copy(s_xl, p.xl + own0 * NSLOT * NCOL, nown * NSLOT * NCOL * 4,
               &bar[0]);
    bulk::copy(s_nlow, p.nlow + own0 * NSLOT, nown * NSLOT * 4, &bar[0]);
    bulk::copy(s_nstart, p.noise_start + own0 * NSLOT, nown * NSLOT * 4,
               &bar[0]);
    bulk::expect(&bar[1], ns * (2 * NSLOT * m * 4 + SEG_BYTES));
    bulk::copy(s_xh, p.xh + pk0 * 2 * NSLOT * m, ns * 2 * NSLOT * m * 4,
               &bar[1]);
    bulk::copy(s_seg, p.env_seg + pk0 * SEG_BYTES, ns * SEG_BYTES, &bar[1]);
  }
  // meanwhile every thread loads the maps, spans, band widths and the
  // staged packets' band rows, none of these loads waiting on another
  const int npairs = ns * MAXENV * m;
  for (int e = tid; e < 5 * m; e += NT) {
    const int q = e / m, i = e - q * m;
    const int* src = q == 0 ? p.band_hi : q == 1 ? p.band_lo
                   : q == 2 ? p.band_noise : q == 3 ? p.sin_band
                   : p.lim_band;
    s_map[e] = __ldg(src + i);
  }
  for (int e = tid; e < 6 * m; e += NT) {
    const int q = e / (2 * m), r = e - q * 2 * m;
    const int* src = q == 0 ? p.hi_span : q == 1 ? p.lo_span : p.lim_span;
    s_span[e] = __ldg(src + r);
  }
  for (int e = tid; e < p.n_high + p.n_low; e += NT)
    s_w[e] = e < p.n_high ? __ldg(p.w_hi + e) : __ldg(p.w_lo + e - p.n_high);
  for (int e = tid; e < ns * MAXENV * p.n_high; e += NT) {
    s_eb[e] = p.e_bands[pk0 * MAXENV * p.n_high + e];
    s_act[e] = (float)p.harm_act[pk0 * MAXENV * p.n_high + e];
  }
  for (int e = tid; e < ns * MAXENV * p.n_q; e += NT)
    s_qb[e] = p.q_bands[pk0 * MAXENV * p.n_q + e];
  const int* m_hi = s_map;
  const int* m_lo = s_map + m;
  const int* m_noise = s_map + 2 * m;
  const int* m_sin = s_map + 3 * m;
  const int* m_lim = s_map + 4 * m;
  const int* sp_hi = s_span;
  const int* sp_lo = s_span + 2 * m;
  const int* sp_lim = s_span + 4 * m;
  if (tid < ns * MAXENV) {
    s_res[tid] = (float)p.freq_res[pk0 * MAXENV + tid];
    s_delta[tid] = (float)p.delta_e[pk0 * MAXENV + tid];
  }
  if (p.smooth && k0 == 0) {
    for (int e = tid; e < HIST * m; e += NT) {
      const int j = e / m, i = e - j * m;
      s_gs[e] = p.g_hist[((long long)n * HIST + j) * 64 + i];
      s_qs[e] = p.q_hist[((long long)n * HIST + j) * 64 + i];
    }
  }
  __syncthreads();

  // ---- the gain-free groups of X as soon as xl lands ------------------
  const long long plane = (long long)p.n_lanes * p.n_packets * NSLOT * NCOL;
  const int g_lo = p.kx >> 2, g_hi = (p.kx + m - 1) >> 2;
  const int n_free = 16 - (g_hi - g_lo + 1);
  bulk::wait(&bar[0]);
  for (int e = tid; e < nown * NSLOT * n_free; e += NT) {
    const int ot = e / n_free, gf = e - ot * n_free;  // own slot, group
    const int g = gf < g_lo ? gf : gf + (g_hi - g_lo + 1);
    float* xo = p.x + (own0 * NSLOT + ot) * NCOL + 4 * g;
    if (g < 8) {
      const float4 lo = *reinterpret_cast<const float4*>(
          s_nlow + (ot / NSLOT) * NSLOT + 4 * g);
      const float4 re =
          *reinterpret_cast<const float4*>(s_xl + ot * NCOL + 4 * g);
      const float4 im =
          *reinterpret_cast<const float4*>(s_xl + ot * NCOL + 32 + 4 * g);
      st4(xo, re.x * lo.x, re.y * lo.y, re.z * lo.z, re.w * lo.w);
      st4(xo + plane, im.x * lo.x, im.y * lo.y, im.z * lo.z, im.w * lo.w);
    } else {
      st4(xo, 0.0f, 0.0f, 0.0f, 0.0f);
      st4(xo + plane, 0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // ---- e_curr: the envelope's mean |x_high|^2, summed over slots ------
  bulk::wait(&bar[1]);
  for (int e = tid; e < npairs; e += NT) {
    const int jv = e / m, i = e - jv * m;
    const int j = jv / MAXENV, v = jv - j * MAXENV;
    const float2* xh =
        reinterpret_cast<const float2*>(s_xh + j * 2 * NSLOT * m) + i;
    const uint8_t* seg = s_seg + j * SEG_BYTES + v;
    float cnt = 0.0f, acc = 0.0f;
#pragma unroll 8
    for (int t = 0; t < NSLOT; ++t) {
      const float2 h = xh[t * m];
      const float sg = (float)seg[t * MAXENV];
      cnt = cnt + sg;
      acc = acc + sg * (h.x * h.x + h.y * h.y);
    }
    s_ec[e] = acc / fmaxf(cnt, 1.0f);
    // the pair's band data through the maps
    const float res = s_res[jv];
    const float* eb = s_eb + jv * p.n_high;
    const int bh = m_hi[i], bl = m_lo[i], bs = m_sin[i];
    s_eo[e] = res * bin_of(eb, bh) + (1.0f - res) * bin_of(eb, bl);
    s_qo[e] = bin_of(s_qb + jv * p.n_q, m_noise[i]);
    const float* act = s_act + jv * p.n_high;
    s_smap[e] = bh >= 0 ? act[bh] : 0.0f;
    s_sbin[e] = bs >= 0 ? act[bs] : 0.0f;
  }
  __syncthreads();
  const float* ec = s_ec;
  if (!p.interpol) {
    // the band means over each bin's own band, in bin order
    for (int e = tid; e < npairs; e += NT) {
      const int jv = e / m, i = e - jv * m;
      const float* row = s_ec + jv * m;
      const float res = s_res[jv];
      const int bh = m_hi[i], bl = m_lo[i];
      float hb = 0.0f, lb = 0.0f;
      if (bh >= 0) {
        float acc = 0.0f;
        for (int r = sp_hi[2 * i]; r < sp_hi[2 * i + 1]; ++r)
          acc = acc + row[r];
        hb = acc / s_w[bh];
      }
      if (bl >= 0) {
        float acc = 0.0f;
        for (int r = sp_lo[2 * i]; r < sp_lo[2 * i + 1]; ++r)
          acc = acc + row[r];
        lb = acc / s_w[p.n_high + bl];
      }
      s_ecf[e] = res * hb + (1.0f - res) * lb;
    }
    __syncthreads();
    ec = s_ecf;
  }

  // ---- levels, and the limiter over each bin's limiter band -----------
  for (int e = tid; e < npairs; e += NT) {
    const int jv = e / m, i = e - jv * m;
    const float eo = s_eo[e], ecv = ec[e], qo = s_qo[e], smap = s_smap[e];
    const float de = s_delta[jv];
    const float q_frac = qo / (1.0f + qo);
    float gain = smap > 0.0f
                     ? sqrtf(eo * q_frac / (1.0f + ecv))
                     : sqrtf(eo / ((1.0f + ecv) * (1.0f + de * qo)));
    float qm = sqrtf(eo * q_frac);
    const float sm = s_sbin[e] > 0.0f ? sqrtf(eo / (1.0f + qo)) : 0.0f;
    float g_max = 0.0f, eol = 0.0f;
    if (m_lim[i] >= 0) {
      const float* eo_row = s_eo + jv * m;
      const float* ec_row = ec + jv * m;
      float a = 0.0f, b = 0.0f;
      for (int r = sp_lim[2 * i]; r < sp_lim[2 * i + 1]; ++r) {
        a = a + eo_row[r];
        b = b + ec_row[r];
      }
      eol = a;
      g_max = fminf(p.lim_gain * sqrtf((p.eps + a) / (p.eps + b)),
                    p.g_max_cap);
    }
    if (gain > g_max) qm = qm * g_max / fmaxf(gain, p.eps);
    gain = fminf(gain, g_max);
    s_gain[e] = gain;
    s_qm[e] = qm;
    s_sm[e] = sm;
    s_eol[e] = eol;
    // the level the adjusted band carries, for the boost
    s_got[e] = gain * gain * ecv + de * (qm * qm * (1.0f - smap)) + sm * sm;
  }
  __syncthreads();
  for (int e = tid; e < npairs; e += NT) {
    const int jv = e / m, i = e - jv * m;
    float boost = 0.0f;
    if (m_lim[i] >= 0) {
      const float* row = s_got + jv * m;
      float got = 0.0f;
      for (int r = sp_lim[2 * i]; r < sp_lim[2 * i + 1]; ++r)
        got = got + row[r];
      boost = fminf(sqrtf((p.eps + s_eol[e]) / (p.eps + got)), p.max_boost);
    }
    const float gain = s_gain[e] * boost, qm = s_qm[e] * boost,
                sm = s_sm[e] * boost;
    s_gain[e] = gain;
    s_qm[e] = qm;
    s_sm[e] = sm;
  }
  __syncthreads();

  // ---- smoothing: the raw gain and noise rows of every slot -----------
  if (p.smooth) {
    // rows 0 .. HIST-1: the previous packet's last slots (staged packet 0
    // when it was staged); then the own packet's slots
    const int rows = nown * NSLOT + (prior ? HIST : 0);
    for (int e = tid; e < rows * m; e += NT) {
      const int rr = e / m, i = e - rr * m;
      int j, t, row;
      if (rr < HIST && prior) {
        j = 0;
        t = NSLOT - HIST + rr;
        row = rr;
      } else {
        const int u = rr - (prior ? HIST : 0), o = u / NSLOT;
        j = prior + o;
        t = u - o * NSLOT;
        row = HIST + u;
      }
      const uint8_t* seg = s_seg + j * SEG_BYTES + t * MAXENV;
      float gs = 0.0f, qs = 0.0f;
#pragma unroll
      for (int v = 0; v < MAXENV; ++v) {
        const float sg = (float)seg[v];
        const int pe = (j * MAXENV + v) * m + i;
        gs = gs + sg * s_gain[pe];
        qs = qs + sg * s_qm[pe];
      }
      s_gs[row * m + i] = gs;
      s_qs[row * m + i] = qs;
    }
    __syncthreads();
  }
  // ---- X: the slot expansion and the adjusted band, 4 bins a thread ---
  const int n_gain = g_hi - g_lo + 1;
  for (int e = tid; e < nown * NSLOT * n_gain; e += NT) {
    const int ot = e / n_gain, g = g_lo + (e - ot * n_gain);
    const int o = ot / NSLOT, t = ot - o * NSLOT;
    const int j = prior + o;
    const uint8_t* seg = s_seg + j * SEG_BYTES + t * MAXENV;
    const float* dl = s_delta + j * MAXENV;
    float sgv[MAXENV];
    float cov = 0.0f, ok = 0.0f;
#pragma unroll
    for (int v = 0; v < MAXENV; ++v) {
      sgv[v] = (float)seg[v];
      cov = cov + sgv[v];
      ok = ok + sgv[v] * dl[v];
    }
    const int nstart = s_nstart[ot];
    const float2* xh2 =
        reinterpret_cast<const float2*>(s_xh + j * 2 * NSLOT * m) + t * m;
    float xr[4], xi[4];
    // the group's low band by three 16-byte loads
    float4 lo4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), re4 = lo4, im4 = lo4;
    if (g < 8) {
      lo4 = *reinterpret_cast<const float4*>(s_nlow + o * NSLOT + 4 * g);
      re4 = *reinterpret_cast<const float4*>(s_xl + ot * NCOL + 4 * g);
      im4 = *reinterpret_cast<const float4*>(s_xl + ot * NCOL + 32 + 4 * g);
    }
    const float lo_c[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
    const float re_c[4] = {re4.x, re4.y, re4.z, re4.w};
    const float im_c[4] = {im4.x, im4.y, im4.z, im4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = 4 * g + c;
      xr[c] = 0.0f;
      xi[c] = 0.0f;
      if (g < 8) {
        xr[c] = re_c[c] * lo_c[c];
        xi[c] = im_c[c] * lo_c[c];
      }
      const int i = b - p.kx;
      if (i < 0 || i >= m) continue;
      float gs = 0.0f, sms = 0.0f, gate = 0.0f;
#pragma unroll
      for (int v = 0; v < MAXENV; ++v) {
        const int pe = (j * MAXENV + v) * m + i;
        gs = gs + sgv[v] * s_gain[pe];
        sms = sms + sgv[v] * s_sm[pe];
        if (p.smooth) {
          gate = gate + sgv[v] * (dl[v] * (1.0f - s_smap[pe]));
        } else {
          gate = gate + sgv[v] * (dl[v] * s_qm[pe] * (1.0f - s_smap[pe]));
        }
      }
      float gain_s, qm_s;
      if (p.smooth) {
        const int r = (HIST + o * NSLOT + t) * m + i;
        float gf = 0.0f, qf = 0.0f;
        gf = gf + p.h0 * s_gs[r];
        qf = qf + p.h0 * s_qs[r];
        gf = gf + p.h1 * s_gs[r - m];
        qf = qf + p.h1 * s_qs[r - m];
        gf = gf + p.h2 * s_gs[r - 2 * m];
        qf = qf + p.h2 * s_qs[r - 2 * m];
        gf = gf + p.h3 * s_gs[r - 3 * m];
        qf = qf + p.h3 * s_qs[r - 3 * m];
        gf = gf + p.h4 * s_gs[r - 4 * m];
        qf = qf + p.h4 * s_qs[r - 4 * m];
        gain_s = ok * gf + (1.0f - ok) * s_gs[r];
        qm_s = gate * (ok * qf + (1.0f - ok) * s_qs[r]);
      } else {
        gain_s = gs;
        qm_s = gate;
      }
      const int nidx = (int)(((unsigned)nstart + 1u + i) & 511u);
      const float2 nz = __ldg(reinterpret_cast<const float2*>(p.noise_tab) +
                              nidx);
      const int ph = (t + i) & 3;
      const float phr = ph == 0 ? 1.0f : (ph == 2 ? -1.0f : 0.0f);
      const float phi = ph == 1 ? 1.0f : (ph == 3 ? -1.0f : 0.0f);
      const float2 h = xh2[i];
      xr[c] = xr[c] + (h.x * gain_s + qm_s * nz.x + sms * phr) * cov;
      xi[c] = xi[c] + (h.y * gain_s + qm_s * nz.y + sms * phi) * cov;
    }
    float* xo = p.x + (own0 * NSLOT + ot) * NCOL + 4 * g;
    st4(xo, xr[0], xr[1], xr[2], xr[3]);
    st4(xo + plane, xi[0], xi[1], xi[2], xi[3]);
  }
  if (p.smooth && k0 + nown == p.n_packets) {
    // the last HIST raw slots become the lane's new history
    const int base = (HIST + nown * NSLOT - HIST) * m;
    for (int e = tid; e < HIST * 64; e += NT) {
      const int j = e >> 6, i = e & 63;
      const long long o = ((long long)n * HIST + j) * 64 + i;
      p.new_g_hist[o] = i < m ? s_gs[base + j * m + i] : 0.0f;
      p.new_q_hist[o] = i < m ? s_qs[base + j * m + i] : 0.0f;
    }
  }
}

}  // namespace

extern "C" int sbr_hf_adjust(
    const void* xh, const void* xl, const void* env_seg, const void* freq_res,
    const void* e_bands, const void* q_bands, const void* harm_act,
    const void* delta_e, const void* noise_start, const void* nlow,
    const void* band_hi, const void* band_lo, const void* band_noise,
    const void* sin_band, const void* lim_band, const void* hi_span,
    const void* lo_span, const void* lim_span, const void* w_hi,
    const void* w_lo, const void* noise_tab, const void* g_hist,
    const void* q_hist, void* new_g_hist, void* new_q_hist, void* x,
    int n_lanes, int n_packets, int m, int kx, int n_high, int n_low,
    int n_q, int n_lim, int interpol, int smooth, float lim_gain, float eps,
    float g_max_cap, float max_boost, float h0, float h1, float h2, float h3,
    float h4, void* stream) {
  if (n_lanes <= 0 || n_packets <= 0 || m <= 0 || m > MAXM || kx < 0 ||
      kx + m > 64 || n_high <= 0 || n_high > MAXM || n_low <= 0 ||
      n_low > MAXM || n_q <= 0 || n_q > MAXM || n_lim < 0 || n_lim > MAXM)
    return (int)cudaErrorInvalidValue;
  if (smooth && (!g_hist || !q_hist || !new_g_hist || !new_q_hist))
    return (int)cudaErrorInvalidValue;
  Params p{(const float*)xh, (const float*)xl, (const uint8_t*)env_seg,
           (const uint8_t*)freq_res, (const float*)e_bands,
           (const float*)q_bands, (const uint8_t*)harm_act,
           (const uint8_t*)delta_e, (const int*)noise_start,
           (const float*)nlow, (const int*)band_hi, (const int*)band_lo,
           (const int*)band_noise, (const int*)sin_band,
           (const int*)lim_band, (const int*)hi_span, (const int*)lo_span,
           (const int*)lim_span, (const float*)w_hi, (const float*)w_lo,
           (const float*)noise_tab, (const float*)g_hist,
           (const float*)q_hist, (float*)new_g_hist, (float*)new_q_hist,
           (float*)x, n_lanes, n_packets, m, kx, n_high, n_low, n_q, n_lim,
           interpol, smooth, lim_gain, eps, g_max_cap, max_boost,
           h0, h1, h2, h3, h4};
  const long long blocks =
      (long long)n_lanes * ((n_packets + OWN - 1) / OWN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // <= 146 KB at m = n_high = n_q = 64 with smoothing; 36 KB at m = 25
  const int smem = Layout(m, smooth != 0, n_high, n_low, n_q).words * 4;
  const auto kernel = smooth ? sbr_hf_adjust_kernel<THREADS_SMOOTH>
                             : sbr_hf_adjust_kernel<THREADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(int)blocks, smooth ? THREADS_SMOOTH : THREADS, smem,
           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
