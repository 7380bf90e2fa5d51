// The designs tried for K16c (the SBR HF adjuster and the assembly of X)
// and K16d (the QMF synthesis fold and the int16 clip), with their choices
// as compile-time knobs.  Built and timed by probes/k16cd_variants.py.
// Every entry point takes the port's arguments, so that the probe calls
// each the same way.  The port's kernels (nrsc5_tpu_torch/csrc/
// sbr_hf_adjust.cu and qmf_synthesis.cu) are: K16c the first design with
// -DC_OWN=2 -DC_XL4=1 (and 512 threads under the smoothing header); K16d
// -DD_SLIDE=1 -DD_R=8 -DD_T=64.
//
// K16c, first design, one CTA a (lane, C_OWN packets): the packets'
// x_high, xl rows, envelope maps, noise starts and nlow by bulk copies at
// entry, the maps, spans, band widths and band rows by plain loads into
// shared memory; the gain-free bins of X (xl x nlow below kx, zeros from
// kx + m) written by 16-byte stores as soon as xl lands; e_curr for every
// (envelope, bin) pair from the staged x_high; every band and limiter sum
// over its own bin's span, summed by that bin's thread, so the limiter
// takes two phases and no per-band phase; the slot expansion fused into
// the X pass (bins in groups of 4, 16-byte stores).  Under the smoothing
// header each CTA also needs the previous packet's last 4 raw slot rows:
// C_CLUSTER=0 stages that packet too and runs its envelope phases beside
// its own (one grid for any K); C_CLUSTER=1 runs a lane's K <= 8 packets
// as one cluster and reads them from the predecessor's shared memory.
// Knobs: C_THREADS (threads a CTA), C_OWN (packets a CTA), C_CLUSTER,
// C_PACK (the X pass's operands of a pair in one 16-byte word), C_CARVE
// (the largest shared-memory carve-out), C_EARLY (the tables through
// registers, stored after the low band), C_CONV (map bytes to floats on
// the float pipe), C_TMAJ (a warp one group of bins over 32 slots in the
// X pass), C_XL4 (the X pass's low band by 16-byte loads), C_MINB
// (minimum CTAs an SM in the launch bounds).  C_V2=1 selects a second
// design (the slot expansions once a distinct row of the envelope map),
// C_V3=1 a third (a persistent grid with two staging buffers).
//
// K16d, one CTA a (lane, tile of D_T slots): rows [s0 - 9, s0 + D_T) of
// Vx = [syn_hist | V] staged in shared memory (D_BULK=1 by bulk copies,
// 0 by 16-byte loads of all threads; D_SPLIT=1 two barriers, a half tile
// each; D_CARVE=1 the largest carve-out); a thread D_COLS adjacent
// columns of D_R consecutive slots, its 10 taps' weights and columns in
// registers; the 10 values of a tap by one D_COLS-wide load where its
// columns are adjacent, else one by one; with D_SLIDE=1 and the taps of
// _synthesis_taps, each of the thread's rows read once for every slot
// that reads it; the int16 outputs packed into one store; the last tile
// writes the new history from its staged rows by a bulk store.
//
// -DCLOCK: thread 0 of each CTA stamps the global timer at the phase
// boundaries.  Every sum runs in the plain version's order; built with
// -fmad=false.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../nrsc5_tpu_torch/csrc/bulk_copy.cuh"

#ifndef C_THREADS
#define C_THREADS 256
#endif
#ifndef C_OWN
#define C_OWN 1
#endif
#ifndef C_CLUSTER
#define C_CLUSTER 0
#endif
#ifndef C_PACK
#define C_PACK 0
#endif
#ifndef C_CARVE
#define C_CARVE 0
#endif
#ifndef C_V2
#define C_V2 0
#endif
#ifndef C_V3
#define C_V3 0
#endif
#ifndef D_T
#define D_T 32
#endif
#ifndef D_COLS
#define D_COLS 4
#endif
#ifndef D_R
#define D_R 4
#endif
#ifndef D_BULK
#define D_BULK 1
#endif
#ifndef D_SPLIT
#define D_SPLIT 0
#endif
#ifndef D_SLIDE
#define D_SLIDE 0
#endif
#ifndef D_CARVE
#define D_CARVE 0
#endif

namespace cg = cooperative_groups;

namespace {

// -DCLOCK: thread 0 of each CTA stamps the global timer at its phase
// boundaries and writes the stamps behind the kernel's last output (16
// int64 a CTA behind X for K16c, 4 behind the new history for K16d)
#ifdef CLOCK
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) \
  if (threadIdx.x == 0) s_clk[i] = gtime();
#else
#define STAMP(i)
#endif

// ---------------------------------------------------------------------
// K16c
// ---------------------------------------------------------------------
constexpr int THREADS = C_THREADS;
constexpr int OWN = C_OWN;
constexpr bool CLUSTER = C_CLUSTER != 0;
constexpr int NSLOT = 32;
constexpr int MAXENV = 5;
constexpr int MAXM = 64;
constexpr int HIST = 4;
constexpr int NCOL = 64;
constexpr int SEG_BYTES = NSLOT * MAXENV;  // 160

static_assert(OWN == 1 || !CLUSTER, "one packet a CTA in the cluster");
#ifndef C_EARLY
#define C_EARLY 0
#endif
#ifndef C_CONV
#define C_CONV 0
#endif
#ifndef C_MINB
#define C_MINB 1
#endif
#ifndef C_XL4
#define C_XL4 0
#endif
#ifndef C_TMAJ
#define C_TMAJ 0
#endif
// a map byte as a float: by the conversion unit, or (C_CONV) as the low
// mantissa bits of 2^23 less 2^23 on the float pipe (exact for 0-255)
__device__ __forceinline__ float b2f(uint8_t b) {
#if C_CONV
  return __int_as_float(0x4B000000 | (int)b) - 8388608.0f;
#else
  return (float)b;
#endif
}

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
// aligned): two mbarriers, the staged packets' x_high and envelope maps,
// the own packets' xl, nlow and noise start, 11 arrays of an (envelope,
// bin) pair, and with smoothing the raw gain and noise rows of the own
// packets' slots behind HIST rows of history.
struct Layout {
  int staged, pairs, xh, seg, xl, nlow, nstart, res, delta, map, span, w,
      eb, qb, act, pair0, pack, gs, qs, words;
  __host__ __device__ Layout(int m, bool smooth, int n_high, int n_low,
                             int n_q) {
    staged = smooth && !CLUSTER ? OWN + 1 : OWN;
    pairs = staged * MAXENV * m;
    xh = 4;
    seg = xh + staged * 2 * NSLOT * m;
    xl = seg + up4(staged * SEG_BYTES / 4);
    nlow = xl + OWN * NSLOT * NCOL;
    nstart = nlow + OWN * NSLOT;
    res = nstart + OWN * NSLOT;
    delta = res + up4(staged * MAXENV);
    // the maps, spans and band widths, and the staged packets' band rows
    map = delta + up4(staged * MAXENV);
    span = map + up4(5 * m);
    w = span + up4(6 * m);
    eb = w + up4(n_high + n_low);
    qb = eb + up4(staged * MAXENV * n_high);
    act = qb + up4(staged * MAXENV * n_q);
    pair0 = act + up4(staged * MAXENV * n_high);
    pack = pair0 + 11 * up4(pairs);
    gs = pack + (C_PACK ? 4 * pairs : 0);
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

__global__ void __launch_bounds__(THREADS, C_MINB)
    sbr_hf_adjust_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
#ifdef CLOCK
  __shared__ unsigned long long s_clk[16];
#endif
  STAMP(0)
  const int m = p.m, tid = threadIdx.x;
  const Layout L(m, p.smooth != 0, p.n_high, p.n_low, p.n_q);
  const int ctas_a_lane = (p.n_packets + OWN - 1) / OWN;
  const int n = blockIdx.x / ctas_a_lane;
  const int k0 = (blockIdx.x - n * ctas_a_lane) * OWN;  // first own packet
  const int nown = min(OWN, p.n_packets - k0);
  // staged packets k0 - prior .. k0 + nown - 1; the own ones last
  const int prior = (!CLUSTER && p.smooth && k0 > 0) ? 1 : 0;
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
  float4* s_pack = reinterpret_cast<float4*>(smem + L.pack);
  (void)s_pack;

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
#if C_EARLY
  // into registers here, into shared memory after the low band, so that
  // their latency runs under xl's copy
  constexpr int Q_MAP = (5 * MAXM + THREADS - 1) / THREADS;
  constexpr int Q_SPAN = (6 * MAXM + THREADS - 1) / THREADS;
  constexpr int Q_W = (2 * MAXM + THREADS - 1) / THREADS;
  constexpr int Q_ROW = ((OWN + 1) * MAXENV * MAXM + THREADS - 1) / THREADS;
  int r_map[Q_MAP], r_span[Q_SPAN];
  float r_w[Q_W], r_eb[Q_ROW], r_act[Q_ROW], r_qb[Q_ROW];
#pragma unroll
  for (int q = 0; q < Q_MAP; ++q) {
    const int e = tid + q * THREADS;
    if (e < 5 * m) {
      const int w5 = e / m, i = e - w5 * m;
      const int* src = w5 == 0 ? p.band_hi : w5 == 1 ? p.band_lo
                     : w5 == 2 ? p.band_noise : w5 == 3 ? p.sin_band
                     : p.lim_band;
      r_map[q] = __ldg(src + i);
    }
  }
#pragma unroll
  for (int q = 0; q < Q_SPAN; ++q) {
    const int e = tid + q * THREADS;
    if (e < 6 * m) {
      const int w3 = e / (2 * m), r = e - w3 * 2 * m;
      const int* src = w3 == 0 ? p.hi_span : w3 == 1 ? p.lo_span
                                           : p.lim_span;
      r_span[q] = __ldg(src + r);
    }
  }
#pragma unroll
  for (int q = 0; q < Q_W; ++q) {
    const int e = tid + q * THREADS;
    if (e < p.n_high + p.n_low)
      r_w[q] = e < p.n_high ? __ldg(p.w_hi + e)
                            : __ldg(p.w_lo + e - p.n_high);
  }
#pragma unroll
  for (int q = 0; q < Q_ROW; ++q) {
    const int e = tid + q * THREADS;
    if (e < ns * MAXENV * p.n_high) {
      r_eb[q] = p.e_bands[pk0 * MAXENV * p.n_high + e];
      r_act[q] = (float)p.harm_act[pk0 * MAXENV * p.n_high + e];
    }
    if (e < ns * MAXENV * p.n_q) r_qb[q] = p.q_bands[pk0 * MAXENV * p.n_q + e];
  }
#else
  for (int e = tid; e < 5 * m; e += THREADS) {
    const int q = e / m, i = e - q * m;
    const int* src = q == 0 ? p.band_hi : q == 1 ? p.band_lo
                   : q == 2 ? p.band_noise : q == 3 ? p.sin_band
                   : p.lim_band;
    s_map[e] = __ldg(src + i);
  }
  for (int e = tid; e < 6 * m; e += THREADS) {
    const int q = e / (2 * m), r = e - q * 2 * m;
    const int* src = q == 0 ? p.hi_span : q == 1 ? p.lo_span : p.lim_span;
    s_span[e] = __ldg(src + r);
  }
  for (int e = tid; e < p.n_high + p.n_low; e += THREADS)
    s_w[e] = e < p.n_high ? __ldg(p.w_hi + e) : __ldg(p.w_lo + e - p.n_high);
  for (int e = tid; e < ns * MAXENV * p.n_high; e += THREADS) {
    s_eb[e] = p.e_bands[pk0 * MAXENV * p.n_high + e];
    s_act[e] = (float)p.harm_act[pk0 * MAXENV * p.n_high + e];
  }
  for (int e = tid; e < ns * MAXENV * p.n_q; e += THREADS)
    s_qb[e] = p.q_bands[pk0 * MAXENV * p.n_q + e];
#endif
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
    for (int e = tid; e < HIST * m; e += THREADS) {
      const int j = e / m, i = e - j * m;
      s_gs[e] = p.g_hist[((long long)n * HIST + j) * 64 + i];
      s_qs[e] = p.q_hist[((long long)n * HIST + j) * 64 + i];
    }
  }
  __syncthreads();
  STAMP(1)

  // ---- the gain-free groups of X as soon as xl lands ------------------
  const long long plane = (long long)p.n_lanes * p.n_packets * NSLOT * NCOL;
  const int g_lo = p.kx >> 2, g_hi = (p.kx + m - 1) >> 2;
  const int n_free = 16 - (g_hi - g_lo + 1);
  bulk::wait(&bar[0]);
  STAMP(2)
  for (int e = tid; e < nown * NSLOT * n_free; e += THREADS) {
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
#if C_EARLY
#pragma unroll
  for (int q = 0; q < Q_MAP; ++q)
    if (tid + q * THREADS < 5 * m) s_map[tid + q * THREADS] = r_map[q];
#pragma unroll
  for (int q = 0; q < Q_SPAN; ++q)
    if (tid + q * THREADS < 6 * m) s_span[tid + q * THREADS] = r_span[q];
#pragma unroll
  for (int q = 0; q < Q_W; ++q)
    if (tid + q * THREADS < p.n_high + p.n_low) s_w[tid + q * THREADS] = r_w[q];
#pragma unroll
  for (int q = 0; q < Q_ROW; ++q) {
    const int e = tid + q * THREADS;
    if (e < ns * MAXENV * p.n_high) {
      s_eb[e] = r_eb[q];
      s_act[e] = r_act[q];
    }
    if (e < ns * MAXENV * p.n_q) s_qb[e] = r_qb[q];
  }
  __syncthreads();
#endif
  STAMP(3)
  bulk::wait(&bar[1]);
  STAMP(4)
  for (int e = tid; e < npairs; e += THREADS) {
    const int jv = e / m, i = e - jv * m;
    const int j = jv / MAXENV, v = jv - j * MAXENV;
    const float2* xh =
        reinterpret_cast<const float2*>(s_xh + j * 2 * NSLOT * m) + i;
    const uint8_t* seg = s_seg + j * SEG_BYTES + v;
    float cnt = 0.0f, acc = 0.0f;
#pragma unroll 8
    for (int t = 0; t < NSLOT; ++t) {
      const float2 h = xh[t * m];
      const float sg = b2f(seg[t * MAXENV]);
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
  STAMP(5)
  const float* ec = s_ec;
  if (!p.interpol) {
    // the band means over each bin's own band, in bin order
    for (int e = tid; e < npairs; e += THREADS) {
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
  STAMP(6)

  // ---- levels, and the limiter over each bin's limiter band -----------
  for (int e = tid; e < npairs; e += THREADS) {
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
  STAMP(7)
  for (int e = tid; e < npairs; e += THREADS) {
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
#if C_PACK
    // the X pass's operands of the pair in one 16-byte word: the gain, the
    // sinusoid level, the noise term (smoothing: its gate), the noise level
    const float de = s_delta[jv], smap = s_smap[e];
    s_pack[e] = make_float4(
        gain, sm, p.smooth ? de * (1.0f - smap) : de * qm * (1.0f - smap),
        qm);
#endif
  }
  __syncthreads();
  STAMP(8)

  // ---- smoothing: the raw gain and noise rows of every slot -----------
  if (p.smooth) {
    // rows 0 .. HIST-1: the previous packet's last slots (staged packet 0
    // when it was staged); then the own packet's slots
    const int rows = nown * NSLOT + (prior ? HIST : 0);
    for (int e = tid; e < rows * m; e += THREADS) {
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
        const float sg = b2f(seg[v]);
        const int pe = (j * MAXENV + v) * m + i;
        gs = gs + sg * s_gain[pe];
        qs = qs + sg * s_qm[pe];
      }
      s_gs[row * m + i] = gs;
      s_qs[row * m + i] = qs;
    }
    if constexpr (CLUSTER) {
      // the previous packet's last HIST rows from its CTA, the cluster's
      // rank before this one
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (k0 > 0) {
        const float* rg =
            cluster.map_shared_rank(s_gs, (int)cluster.block_rank() - 1);
        const float* rq =
            cluster.map_shared_rank(s_qs, (int)cluster.block_rank() - 1);
        for (int e = tid; e < HIST * m; e += THREADS) {
          s_gs[e] = rg[NSLOT * m + e];
          s_qs[e] = rq[NSLOT * m + e];
        }
      }
      cluster.sync();
    } else {
      __syncthreads();
    }
  }

  STAMP(9)
  // ---- X: the slot expansion and the adjusted band, 4 bins a thread ---
  const int n_gain = g_hi - g_lo + 1;
  for (int e = tid; e < nown * NSLOT * n_gain; e += THREADS) {
#if C_TMAJ
    // a warp takes one group of 4 bins over 32 slots
    const int og = e / NSLOT, g = g_lo + og % n_gain;
    const int ot = (og / n_gain) * NSLOT + (e - og * NSLOT);
#else
    const int ot = e / n_gain, g = g_lo + (e - ot * n_gain);
#endif
    const int o = ot / NSLOT, t = ot - o * NSLOT;
    const int j = prior + o;
    const uint8_t* seg = s_seg + j * SEG_BYTES + t * MAXENV;
    const float* dl = s_delta + j * MAXENV;
    float sgv[MAXENV];
    float cov = 0.0f, ok = 0.0f;
#pragma unroll
    for (int v = 0; v < MAXENV; ++v) {
      sgv[v] = b2f(seg[v]);
      cov = cov + sgv[v];
      ok = ok + sgv[v] * dl[v];
    }
    const int nstart = s_nstart[ot];
    const float2* xh2 =
        reinterpret_cast<const float2*>(s_xh + j * 2 * NSLOT * m) + t * m;
    float xr[4], xi[4];
#if C_XL4
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
#endif
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = 4 * g + c;
      xr[c] = 0.0f;
      xi[c] = 0.0f;
#if C_XL4
      if (g < 8) {
        xr[c] = re_c[c] * lo_c[c];
        xi[c] = im_c[c] * lo_c[c];
      }
#else
      if (b < 32) {
        const float lo = s_nlow[o * NSLOT + b];
        xr[c] = s_xl[ot * NCOL + b] * lo;
        xi[c] = s_xl[ot * NCOL + 32 + b] * lo;
      }
#endif
      const int i = b - p.kx;
      if (i < 0 || i >= m) continue;
      float gs = 0.0f, sms = 0.0f, gate = 0.0f;
#pragma unroll
      for (int v = 0; v < MAXENV; ++v) {
        const int pe = (j * MAXENV + v) * m + i;
#if C_PACK
        const float4 o = s_pack[pe];
        gs = gs + sgv[v] * o.x;
        sms = sms + sgv[v] * o.y;
        gate = gate + sgv[v] * o.z;
#else
        gs = gs + sgv[v] * s_gain[pe];
        sms = sms + sgv[v] * s_sm[pe];
        if (p.smooth) {
          gate = gate + sgv[v] * (dl[v] * (1.0f - s_smap[pe]));
        } else {
          gate = gate + sgv[v] * (dl[v] * s_qm[pe] * (1.0f - s_smap[pe]));
        }
#endif
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
  STAMP(10)
  if (p.smooth && k0 + nown == p.n_packets) {
    // the last HIST raw slots become the lane's new history
    const int base = (HIST + nown * NSLOT - HIST) * m;
    for (int e = tid; e < HIST * 64; e += THREADS) {
      const int j = e >> 6, i = e & 63;
      const long long o = ((long long)n * HIST + j) * 64 + i;
      p.new_g_hist[o] = i < m ? s_gs[base + j * m + i] : 0.0f;
      p.new_q_hist[o] = i < m ? s_qs[base + j * m + i] : 0.0f;
    }
  }
  STAMP(11)
#ifdef CLOCK
  if (tid == 0) {
    long long* out = reinterpret_cast<long long*>(
        p.x + 2LL * p.n_lanes * p.n_packets * NSLOT * NCOL) +
        16LL * blockIdx.x;
    for (int q = 0; q < 12; ++q) out[q] = (long long)s_clk[q];
  }
#endif
}

// ---------------------------------------------------------------------
// K16c, second design (-DC_V2=1): the same grid, with the work a packet
// needs cut down.  |x_high|^2 is formed once a (slot, bin) and the
// envelope map once as floats; e_curr's count once an envelope; and the
// slot expansions (gain, sinusoid level, noise term, raw noise level) are
// summed once for each distinct row of the envelope map (a packet has at
// most a handful: slots whose map rows are equal have equal sums), kept
// as one 16-byte word a (slot, bin), and read by the X pass and the
// smoothing filter through each slot's representative.
// ---------------------------------------------------------------------
struct LayoutV2 {
  int staged, pairs, xh, e2, seg, segf, xl, nlow, nstart, res, delta, cnt,
      rep, list, nlist, cov, ok, map, span, w, eb, qb, act, hist, pair0,
      expw, words;
  __host__ __device__ LayoutV2(int m, bool smooth, int n_high, int n_low,
                               int n_q) {
    staged = smooth ? 2 : OWN;
    pairs = staged * MAXENV * m;
    xh = 4;
    e2 = xh + staged * 2 * NSLOT * m;
    seg = e2 + up4(staged * NSLOT * m);
    segf = seg + up4(staged * SEG_BYTES / 4);
    xl = segf + staged * SEG_BYTES;
    nlow = xl + OWN * NSLOT * NCOL;
    nstart = nlow + OWN * NSLOT;
    res = nstart + OWN * NSLOT;
    delta = res + up4(staged * MAXENV);
    cnt = delta + up4(staged * MAXENV);
    rep = cnt + up4(staged * MAXENV);
    list = rep + staged * NSLOT;
    nlist = list + staged * NSLOT;
    cov = nlist + 4;
    ok = cov + staged * NSLOT;
    map = ok + staged * NSLOT;
    span = map + up4(5 * m);
    w = span + up4(6 * m);
    eb = w + up4(n_high + n_low);
    qb = eb + up4(staged * MAXENV * n_high);
    act = qb + up4(staged * MAXENV * n_q);
    hist = act + up4(staged * MAXENV * n_high);
    pair0 = hist + (smooth ? up4(2 * HIST * m) : 0);
    expw = pair0 + 11 * up4(pairs);
    words = expw + 4 * staged * NSLOT * m;
  }
  __device__ float* pair(float* s, int which) const {
    return s + pair0 + which * up4(pairs);
  }
};

__global__ void __launch_bounds__(THREADS) sbr_hf_adjust_v2_kernel(
    Params p) {
  extern __shared__ __align__(16) float smem[];
#ifdef CLOCK
  __shared__ unsigned long long s_clk[16];
#endif
  STAMP(0)
  const int m = p.m, tid = threadIdx.x;
  const LayoutV2 L(m, p.smooth != 0, p.n_high, p.n_low, p.n_q);
  const int ctas_a_lane = (p.n_packets + OWN - 1) / OWN;
  const int n = blockIdx.x / ctas_a_lane;
  const int k0 = (blockIdx.x - n * ctas_a_lane) * OWN;
  const int nown = min(OWN, p.n_packets - k0);
  const int prior = (p.smooth && k0 > 0) ? 1 : 0;
  const int ns = prior + nown;
  const long long pk0 = (long long)n * p.n_packets + k0 - prior;
  const long long own0 = pk0 + prior;

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_xh = smem + L.xh;
  float* s_e2 = smem + L.e2;
  uint8_t* s_seg = reinterpret_cast<uint8_t*>(smem + L.seg);
  float* s_segf = smem + L.segf;
  float* s_xl = smem + L.xl;
  float* s_nlow = smem + L.nlow;
  int* s_nstart = reinterpret_cast<int*>(smem + L.nstart);
  float* s_res = smem + L.res;
  float* s_delta = smem + L.delta;
  float* s_cnt = smem + L.cnt;
  int* s_rep = reinterpret_cast<int*>(smem + L.rep);
  int* s_list = reinterpret_cast<int*>(smem + L.list);
  int* s_nlist = reinterpret_cast<int*>(smem + L.nlist);
  float* s_cov = smem + L.cov;
  float* s_ok = smem + L.ok;
  int* s_map = reinterpret_cast<int*>(smem + L.map);
  int* s_span = reinterpret_cast<int*>(smem + L.span);
  float* s_w = smem + L.w;
  float* s_eb = smem + L.eb;
  float* s_qb = smem + L.qb;
  float* s_act = smem + L.act;
  float* s_hg = smem + L.hist;  // the carried history, rows x m
  float* s_hq = s_hg + HIST * m;
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
  float4* s_exp = reinterpret_cast<float4*>(smem + L.expw);

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
  for (int e = tid; e < 5 * m; e += THREADS) {
    const int q = e / m, i = e - q * m;
    const int* src = q == 0 ? p.band_hi : q == 1 ? p.band_lo
                   : q == 2 ? p.band_noise : q == 3 ? p.sin_band
                   : p.lim_band;
    s_map[e] = __ldg(src + i);
  }
  for (int e = tid; e < 6 * m; e += THREADS) {
    const int q = e / (2 * m), r = e - q * 2 * m;
    const int* src = q == 0 ? p.hi_span : q == 1 ? p.lo_span : p.lim_span;
    s_span[e] = __ldg(src + r);
  }
  for (int e = tid; e < p.n_high + p.n_low; e += THREADS)
    s_w[e] = e < p.n_high ? __ldg(p.w_hi + e) : __ldg(p.w_lo + e - p.n_high);
  for (int e = tid; e < ns * MAXENV * p.n_high; e += THREADS) {
    s_eb[e] = p.e_bands[pk0 * MAXENV * p.n_high + e];
    s_act[e] = (float)p.harm_act[pk0 * MAXENV * p.n_high + e];
  }
  for (int e = tid; e < ns * MAXENV * p.n_q; e += THREADS)
    s_qb[e] = p.q_bands[pk0 * MAXENV * p.n_q + e];
  if (tid < ns * MAXENV) {
    s_res[tid] = (float)p.freq_res[pk0 * MAXENV + tid];
    s_delta[tid] = (float)p.delta_e[pk0 * MAXENV + tid];
  }
  if (p.smooth && k0 == 0) {
    for (int e = tid; e < HIST * m; e += THREADS) {
      const int j = e / m, i = e - j * m;
      s_hg[e] = p.g_hist[((long long)n * HIST + j) * 64 + i];
      s_hq[e] = p.q_hist[((long long)n * HIST + j) * 64 + i];
    }
  }
  const int* m_hi = s_map;
  const int* m_lo = s_map + m;
  const int* m_noise = s_map + 2 * m;
  const int* m_sin = s_map + 3 * m;
  const int* m_lim = s_map + 4 * m;
  const int* sp_hi = s_span;
  const int* sp_lo = s_span + 2 * m;
  const int* sp_lim = s_span + 4 * m;
  __syncthreads();
  STAMP(1)

  // ---- the groups of 4 bins no gain reaches, as soon as xl lands ------
  const long long plane = (long long)p.n_lanes * p.n_packets * NSLOT * NCOL;
  const int g_lo = p.kx >> 2, g_hi = (p.kx + m - 1) >> 2;
  const int n_gain = g_hi - g_lo + 1, n_free = 16 - n_gain;
  bulk::wait(&bar[0]);
  STAMP(2)
  for (int e = tid; e < nown * NSLOT * n_free; e += THREADS) {
    const int ot = e / n_free, gf = e - ot * n_free;
    const int g = gf < g_lo ? gf : gf + n_gain;
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

  // ---- |x_high|^2 once a (slot, bin); the map as floats; each slot's
  // representative (the first slot with its map row), cover and transient
  // weight; each envelope's slot count ---------------------------------
  STAMP(3)
  bulk::wait(&bar[1]);
  STAMP(4)
  for (int e = tid; e < ns * NSLOT * m; e += THREADS) {
    const float2 h = reinterpret_cast<const float2*>(s_xh)[e];
    s_e2[e] = h.x * h.x + h.y * h.y;
  }
  for (int e = tid; e < ns * SEG_BYTES; e += THREADS)
    s_segf[e] = (float)s_seg[e];
  if (tid < 32 * ns) {
    // warp j: staged packet j's 32 slots, a lane each
    const int j = tid >> 5, t = tid & 31;
    const uint8_t* row = s_seg + j * SEG_BYTES + t * MAXENV;
    int r = t;
    for (int u = 0; u < t; ++u) {
      const uint8_t* o = s_seg + j * SEG_BYTES + u * MAXENV;
      if (o[0] == row[0] && o[1] == row[1] && o[2] == row[2] &&
          o[3] == row[3] && o[4] == row[4]) {
        r = u;
        break;
      }
    }
    s_rep[j * NSLOT + t] = r;
    const unsigned first = __ballot_sync(0xffffffffu, r == t);
    if (r == t)
      s_list[j * NSLOT + __popc(first & ((1u << t) - 1u))] = t;
    if (t == 0) s_nlist[j] = __popc(first);
    float cov = 0.0f, ok = 0.0f;
#pragma unroll
    for (int v = 0; v < MAXENV; ++v) {
      const float sg = (float)row[v];
      cov = cov + sg;
      ok = ok + sg * s_delta[j * MAXENV + v];
    }
    s_cov[j * NSLOT + t] = cov;
    s_ok[j * NSLOT + t] = ok;
  } else if (tid >= 64 && tid < 64 + ns * MAXENV) {
    const int jv = tid - 64, j = jv / MAXENV, v = jv - j * MAXENV;
    float cnt = 0.0f;
    for (int t = 0; t < NSLOT; ++t)
      cnt = cnt + (float)s_seg[j * SEG_BYTES + t * MAXENV + v];
    s_cnt[jv] = cnt;
  }
  __syncthreads();

  // ---- e_curr, and each pair's band data through the maps -------------
  const int npairs = ns * MAXENV * m;
  for (int e = tid; e < npairs; e += THREADS) {
    const int jv = e / m, i = e - jv * m;
    const int j = jv / MAXENV, v = jv - j * MAXENV;
    const float* e2 = s_e2 + j * NSLOT * m + i;
    const float* sg = s_segf + j * SEG_BYTES + v;
    float acc = 0.0f;
#pragma unroll 8
    for (int t = 0; t < NSLOT; ++t) acc = acc + sg[t * MAXENV] * e2[t * m];
    s_ec[e] = acc / fmaxf(s_cnt[jv], 1.0f);
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
  STAMP(5)
  const float* ec = s_ec;
  if (!p.interpol) {
    for (int e = tid; e < npairs; e += THREADS) {
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
  STAMP(6)

  // ---- levels, the limiter, the boost --------------------------------
  for (int e = tid; e < npairs; e += THREADS) {
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
    s_got[e] = gain * gain * ecv + de * (qm * qm * (1.0f - smap)) + sm * sm;
  }
  __syncthreads();
  STAMP(7)
  for (int e = tid; e < npairs; e += THREADS) {
    const int jv = e / m, i = e - jv * m;
    float boost = 0.0f;
    if (m_lim[i] >= 0) {
      const float* row = s_got + jv * m;
      float got = 0.0f;
      for (int r = sp_lim[2 * i]; r < sp_lim[2 * i + 1]; ++r)
        got = got + row[r];
      boost = fminf(sqrtf((p.eps + s_eol[e]) / (p.eps + got)), p.max_boost);
    }
    s_gain[e] = s_gain[e] * boost;
    s_qm[e] = s_qm[e] * boost;
    s_sm[e] = s_sm[e] * boost;
  }
  __syncthreads();
  STAMP(8)

  // ---- the slot expansions, once a distinct map row and bin -----------
  const int nd0 = s_nlist[0], nd = nd0 + (ns > 1 ? s_nlist[1] : 0);
  for (int e = tid; e < nd * m; e += THREADS) {
    const int d = e / m, i = e - d * m;
    const int j = d < nd0 ? 0 : 1;
    const int t = s_list[j * NSLOT + (d - (j ? nd0 : 0))];
    const float* sg = s_segf + j * SEG_BYTES + t * MAXENV;
    const float* dl = s_delta + j * MAXENV;
    float gs = 0.0f, sms = 0.0f, gate = 0.0f, qs = 0.0f;
#pragma unroll
    for (int v = 0; v < MAXENV; ++v) {
      const int pe = (j * MAXENV + v) * m + i;
      gs = gs + sg[v] * s_gain[pe];
      sms = sms + sg[v] * s_sm[pe];
      if (p.smooth) {
        qs = qs + sg[v] * s_qm[pe];
        gate = gate + sg[v] * (dl[v] * (1.0f - s_smap[pe]));
      } else {
        gate = gate + sg[v] * (dl[v] * s_qm[pe] * (1.0f - s_smap[pe]));
      }
    }
    s_exp[(j * NSLOT + t) * m + i] = make_float4(gs, sms, gate, qs);
  }
  __syncthreads();
  STAMP(9)

  // ---- X: the adjusted band, 4 bins a thread --------------------------
  for (int e = tid; e < nown * NSLOT * n_gain; e += THREADS) {
    const int ot = e / n_gain, g = g_lo + (e - ot * n_gain);
    const int o = ot / NSLOT, t = ot - o * NSLOT;
    const int j = prior + o;
    const float cov = s_cov[j * NSLOT + t], ok = s_ok[j * NSLOT + t];
    const int rt = s_rep[j * NSLOT + t];
    const unsigned nstart = (unsigned)s_nstart[ot];
    const float2* xh2 =
        reinterpret_cast<const float2*>(s_xh + j * 2 * NSLOT * m) + t * m;
    float xr[4], xi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = 4 * g + c;
      xr[c] = 0.0f;
      xi[c] = 0.0f;
      if (b < 32) {
        const float lo = s_nlow[o * NSLOT + b];
        xr[c] = s_xl[ot * NCOL + b] * lo;
        xi[c] = s_xl[ot * NCOL + 32 + b] * lo;
      }
      const int i = b - p.kx;
      if (i < 0 || i >= m) continue;
      const float4 x4 = s_exp[(j * NSLOT + rt) * m + i];
      float gain_s = x4.x, qm_s = x4.z;
      if (p.smooth) {
        // the raw rows of slots t - 4 .. t: this packet's, the previous
        // packet's (staged 0), or the carried history
        float rg[5], rq[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const int u = t - q;
          if (u >= 0) {
            const float4 r4 = s_exp[(j * NSLOT + s_rep[j * NSLOT + u]) * m + i];
            rg[q] = r4.x;
            rq[q] = r4.w;
          } else if (o > 0 || prior) {
            const int jj = j - 1, uu = NSLOT + u;
            const float4 r4 =
                s_exp[(jj * NSLOT + s_rep[jj * NSLOT + uu]) * m + i];
            rg[q] = r4.x;
            rq[q] = r4.w;
          } else {
            rg[q] = s_hg[(HIST + u) * m + i];
            rq[q] = s_hq[(HIST + u) * m + i];
          }
        }
        float gf = 0.0f, qf = 0.0f;
        gf = gf + p.h0 * rg[0];
        qf = qf + p.h0 * rq[0];
        gf = gf + p.h1 * rg[1];
        qf = qf + p.h1 * rq[1];
        gf = gf + p.h2 * rg[2];
        qf = qf + p.h2 * rq[2];
        gf = gf + p.h3 * rg[3];
        qf = qf + p.h3 * rq[3];
        gf = gf + p.h4 * rg[4];
        qf = qf + p.h4 * rq[4];
        gain_s = ok * gf + (1.0f - ok) * rg[0];
        qm_s = x4.z * (ok * qf + (1.0f - ok) * rq[0]);
      }
      const int nidx = (int)((nstart + 1u + (unsigned)i) & 511u);
      const float2 nz =
          __ldg(reinterpret_cast<const float2*>(p.noise_tab) + nidx);
      const int ph = (t + i) & 3;
      const float phr = ph == 0 ? 1.0f : (ph == 2 ? -1.0f : 0.0f);
      const float phi = ph == 1 ? 1.0f : (ph == 3 ? -1.0f : 0.0f);
      const float2 h = xh2[i];
      xr[c] = xr[c] + (h.x * gain_s + qm_s * nz.x + x4.y * phr) * cov;
      xi[c] = xi[c] + (h.y * gain_s + qm_s * nz.y + x4.y * phi) * cov;
    }
    float* xo = p.x + (own0 * NSLOT + ot) * NCOL + 4 * g;
    st4(xo, xr[0], xr[1], xr[2], xr[3]);
    st4(xo + plane, xi[0], xi[1], xi[2], xi[3]);
  }
  STAMP(10)
  if (p.smooth && k0 + nown == p.n_packets) {
    const int j = ns - 1;
    for (int e = tid; e < HIST * 64; e += THREADS) {
      const int r = e >> 6, i = e & 63;
      const long long o = ((long long)n * HIST + r) * 64 + i;
      float4 r4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < m)
        r4 = s_exp[(j * NSLOT + s_rep[j * NSLOT + NSLOT - HIST + r]) * m + i];
      p.new_g_hist[o] = r4.x;
      p.new_q_hist[o] = r4.w;
    }
  }
  STAMP(11)
#ifdef CLOCK
  if (tid == 0) {
    long long* out = reinterpret_cast<long long*>(
        p.x + 2LL * p.n_lanes * p.n_packets * NSLOT * NCOL) +
        16LL * blockIdx.x;
    for (int q = 0; q < 12; ++q) out[q] = (long long)s_clk[q];
  }
#endif
}

// ---------------------------------------------------------------------
// K16c, third design (-DC_V3=1): the first design's phases (one packet at
// a time, its tables in shared memory) on a persistent grid of as many
// CTAs as fit (C_MINB a multiprocessor at least), each walking the items
// (lane, packet) b, b + G, ... with two staging buffers: while it works on
// one item, the next item's bytes land in the other buffer and its small
// tables come in through registers, so that the copies of all but each
// CTA's first item run under the work of the one before.
// ---------------------------------------------------------------------
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAITP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAITP;\n"
      "}" ::"r"(bulk::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

struct LayoutV3 {
  // a staging buffer: x_high and map, xl, nlow, noise start (bulk), the
  // band rows, resolution and delta flags and carried history (loads)
  int xh, seg, xl, nlow, nstart, eb, qb, act, res, delta, hist, buf;
  int map, span, w, pair0, pairs, gs, qs, words;
  __host__ __device__ LayoutV3(int m, bool smooth, int n_high, int n_low,
                               int n_q) {
    const int staged = smooth ? 2 : 1;
    xh = 0;
    seg = xh + staged * 2 * NSLOT * m;
    xl = seg + up4(staged * SEG_BYTES / 4);
    nlow = xl + NSLOT * NCOL;
    nstart = nlow + NSLOT;
    eb = nstart + NSLOT;
    qb = eb + up4(staged * MAXENV * n_high);
    act = qb + up4(staged * MAXENV * n_q);
    res = act + up4(staged * MAXENV * n_high);
    delta = res + up4(staged * MAXENV);
    hist = delta + up4(staged * MAXENV);
    buf = hist + (smooth ? up4(2 * HIST * m) : 0);
    map = 8 + 2 * buf;  // behind four mbarriers and the two buffers
    span = map + up4(5 * m);
    w = span + up4(6 * m);
    pair0 = w + up4(n_high + n_low);
    pairs = staged * MAXENV * m;
    gs = pair0 + 11 * up4(pairs);
    const int rows = smooth ? (HIST + NSLOT) * m : 0;
    qs = gs + up4(rows);
    words = qs + up4(rows);
  }
  __device__ float* pair(float* s, int which) const {
    return s + pair0 + which * up4(pairs);
  }
};

constexpr int V3_ROW = (2 * MAXENV * MAXM + THREADS - 1) / THREADS;

// an item's small per-envelope inputs, loaded into registers
struct Small {
  float eb[V3_ROW], qb[V3_ROW], act[V3_ROW];
  float res, delta, hg, hq;
};

__device__ __forceinline__ void load_small(const Params& p, long long pk0,
                                           int ns, int n, bool hist, int m,
                                           Small& r) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < V3_ROW; ++q) {
    const int e = tid + q * THREADS;
    if (e < ns * MAXENV * p.n_high) {
      r.eb[q] = p.e_bands[pk0 * MAXENV * p.n_high + e];
      r.act[q] = (float)p.harm_act[pk0 * MAXENV * p.n_high + e];
    }
    if (e < ns * MAXENV * p.n_q) r.qb[q] = p.q_bands[pk0 * MAXENV * p.n_q + e];
  }
  if (tid < ns * MAXENV) {
    r.res = (float)p.freq_res[pk0 * MAXENV + tid];
    r.delta = (float)p.delta_e[pk0 * MAXENV + tid];
  }
  if (hist && tid < HIST * m) {
    const int j = tid / m, i = tid - j * m;
    r.hg = p.g_hist[((long long)n * HIST + j) * 64 + i];
    r.hq = p.q_hist[((long long)n * HIST + j) * 64 + i];
  }
}

__device__ __forceinline__ void store_small(const Params& p, float* buf,
                                            const LayoutV3& L, int ns,
                                            bool hist, int m,
                                            const Small& r) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < V3_ROW; ++q) {
    const int e = tid + q * THREADS;
    if (e < ns * MAXENV * p.n_high) {
      buf[L.eb + e] = r.eb[q];
      buf[L.act + e] = r.act[q];
    }
    if (e < ns * MAXENV * p.n_q) buf[L.qb + e] = r.qb[q];
  }
  if (tid < ns * MAXENV) {
    buf[L.res + tid] = r.res;
    buf[L.delta + tid] = r.delta;
  }
  if (hist && tid < HIST * m) {
    buf[L.hist + tid] = r.hg;
    buf[L.hist + HIST * m + tid] = r.hq;
  }
}

// one thread issues an item's bulk copies into a buffer, on its barriers
__device__ __forceinline__ void issue_item(const Params& p, float* buf,
                                           const LayoutV3& L, long long pk0,
                                           int ns, uint64_t* bars) {
  const int m = p.m;
  const long long pk = pk0 + ns - 1;
  bulk::expect(&bars[0], NSLOT * NCOL * 4 + 2 * NSLOT * 4);
  bulk::copy(buf + L.xl, p.xl + pk * NSLOT * NCOL, NSLOT * NCOL * 4,
             &bars[0]);
  bulk::copy(buf + L.nlow, p.nlow + pk * NSLOT, NSLOT * 4, &bars[0]);
  bulk::copy(buf + L.nstart, p.noise_start + pk * NSLOT, NSLOT * 4,
             &bars[0]);
  bulk::expect(&bars[1], ns * (2 * NSLOT * m * 4 + SEG_BYTES));
  bulk::copy(buf + L.xh, p.xh + pk0 * 2 * NSLOT * m, ns * 2 * NSLOT * m * 4,
             &bars[1]);
  bulk::copy(buf + L.seg, p.env_seg + pk0 * SEG_BYTES, ns * SEG_BYTES,
             &bars[1]);
}

__global__ void __launch_bounds__(THREADS, C_MINB)
    sbr_hf_adjust_v3_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
#ifdef CLOCK
  __shared__ unsigned long long s_clk[16];
#endif
  STAMP(0)
  const int m = p.m, tid = threadIdx.x;
  const LayoutV3 L(m, p.smooth != 0, p.n_high, p.n_low, p.n_q);
  const int items = p.n_lanes * p.n_packets;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [buffer][2]
  float* bufs = smem + 8;
  int* s_map = reinterpret_cast<int*>(smem + L.map);
  int* s_span = reinterpret_cast<int*>(smem + L.span);
  float* s_w = smem + L.w;
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
  const int* m_hi = s_map;
  const int* m_lo = s_map + m;
  const int* m_noise = s_map + 2 * m;
  const int* m_sin = s_map + 3 * m;
  const int* m_lim = s_map + 4 * m;
  const int* sp_hi = s_span;
  const int* sp_lo = s_span + 2 * m;
  const int* sp_lim = s_span + 4 * m;
  const long long plane = (long long)p.n_lanes * p.n_packets * NSLOT * NCOL;
  const int g_lo = p.kx >> 2, g_hi = (p.kx + m - 1) >> 2;
  const int n_gain = g_hi - g_lo + 1, n_free = 16 - n_gain;

  // prologue: the first item into buffer 0, the tables every item reads
  int q = blockIdx.x;
  if (q < items) {
    const int k = q % p.n_packets;
    const int prior = (p.smooth && k > 0) ? 1 : 0;
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < 4; ++b) bulk::init(&bars[b]);
      issue_item(p, bufs, L, q - prior, prior + 1, bars);
    }
    Small r;
    load_small(p, q - prior, prior + 1, q / p.n_packets,
               p.smooth && k == 0, m, r);
    store_small(p, bufs, L, prior + 1, p.smooth && k == 0, m, r);
  }
  for (int e = tid; e < 5 * m; e += THREADS) {
    const int w5 = e / m, i = e - w5 * m;
    const int* src = w5 == 0 ? p.band_hi : w5 == 1 ? p.band_lo
                   : w5 == 2 ? p.band_noise : w5 == 3 ? p.sin_band
                   : p.lim_band;
    s_map[e] = __ldg(src + i);
  }
  for (int e = tid; e < 6 * m; e += THREADS) {
    const int w3 = e / (2 * m), r = e - w3 * 2 * m;
    const int* src = w3 == 0 ? p.hi_span : w3 == 1 ? p.lo_span : p.lim_span;
    s_span[e] = __ldg(src + r);
  }
  for (int e = tid; e < p.n_high + p.n_low; e += THREADS)
    s_w[e] = e < p.n_high ? __ldg(p.w_hi + e) : __ldg(p.w_lo + e - p.n_high);
  __syncthreads();
  STAMP(1)

  for (int it = 0; q < items; q += gridDim.x, ++it) {
    const int b = it & 1;
    const uint32_t par = (it >> 1) & 1;
    float* buf = bufs + b * L.buf;
    const int n = q / p.n_packets, k = q - n * p.n_packets;
    const int prior = (p.smooth && k > 0) ? 1 : 0;
    const int ns = prior + 1;
    const long long pk = q;

    // the next item: its copies now, its small tables into registers
    const int qn = q + gridDim.x;
    const int kn = qn % p.n_packets;
    const int prior_n = (p.smooth && kn > 0) ? 1 : 0;
    float* buf_n = bufs + (b ^ 1) * L.buf;
    Small rn;
    if (qn < items) {
      if (tid == 0) {
        bulk::fence_shared();
        issue_item(p, buf_n, L, qn - prior_n, prior_n + 1, bars + 2 * (b ^ 1));
      }
      load_small(p, qn - prior_n, prior_n + 1, qn / p.n_packets,
                 p.smooth && kn == 0, m, rn);
    }

    float* s_xh = buf + L.xh;
    const uint8_t* s_seg = reinterpret_cast<const uint8_t*>(buf + L.seg);
    const float* s_xl = buf + L.xl;
    const float* s_nlow = buf + L.nlow;
    const int* s_nstart = reinterpret_cast<const int*>(buf + L.nstart);
    const float* s_eb = buf + L.eb;
    const float* s_qb = buf + L.qb;
    const float* s_act = buf + L.act;
    const float* s_res = buf + L.res;
    const float* s_delta = buf + L.delta;
    const float* s_hist = buf + L.hist;

    // ---- the groups of 4 bins no gain reaches ----------------------
    wait_parity(&bars[2 * b], par);
    STAMP(2)
    float* x_pk = p.x + pk * NSLOT * NCOL;
    for (int e = tid; e < NSLOT * n_free; e += THREADS) {
      const int t = e / n_free, gf = e - t * n_free;
      const int g = gf < g_lo ? gf : gf + n_gain;
      float* xo = x_pk + t * NCOL + 4 * g;
      if (g < 8) {
        const float4 lo = *reinterpret_cast<const float4*>(s_nlow + 4 * g);
        const float4 re =
            *reinterpret_cast<const float4*>(s_xl + t * NCOL + 4 * g);
        const float4 im =
            *reinterpret_cast<const float4*>(s_xl + t * NCOL + 32 + 4 * g);
        st4(xo, re.x * lo.x, re.y * lo.y, re.z * lo.z, re.w * lo.w);
        st4(xo + plane, im.x * lo.x, im.y * lo.y, im.z * lo.z, im.w * lo.w);
      } else {
        st4(xo, 0.0f, 0.0f, 0.0f, 0.0f);
        st4(xo + plane, 0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    if (qn < items)
      store_small(p, buf_n, L, prior_n + 1, p.smooth && kn == 0, m, rn);
    STAMP(3)

    // ---- e_curr, and each pair's band data through the maps ---------
    wait_parity(&bars[2 * b + 1], par);
    STAMP(4)
    const int npairs = ns * MAXENV * m;
    for (int e = tid; e < npairs; e += THREADS) {
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
    STAMP(5)
    const float* ec = s_ec;
    if (!p.interpol) {
      for (int e = tid; e < npairs; e += THREADS) {
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
    STAMP(6)

    // ---- levels and the limiter; the boost ----------------------------
    for (int e = tid; e < npairs; e += THREADS) {
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
        float a = 0.0f, bb = 0.0f;
        for (int r = sp_lim[2 * i]; r < sp_lim[2 * i + 1]; ++r) {
          a = a + eo_row[r];
          bb = bb + ec_row[r];
        }
        eol = a;
        g_max = fminf(p.lim_gain * sqrtf((p.eps + a) / (p.eps + bb)),
                      p.g_max_cap);
      }
      if (gain > g_max) qm = qm * g_max / fmaxf(gain, p.eps);
      gain = fminf(gain, g_max);
      s_gain[e] = gain;
      s_qm[e] = qm;
      s_sm[e] = sm;
      s_eol[e] = eol;
      s_got[e] = gain * gain * ecv + de * (qm * qm * (1.0f - smap)) + sm * sm;
    }
    __syncthreads();
    STAMP(7)
    for (int e = tid; e < npairs; e += THREADS) {
      const int jv = e / m, i = e - jv * m;
      float boost = 0.0f;
      if (m_lim[i] >= 0) {
        const float* row = s_got + jv * m;
        float got = 0.0f;
        for (int r = sp_lim[2 * i]; r < sp_lim[2 * i + 1]; ++r)
          got = got + row[r];
        boost = fminf(sqrtf((p.eps + s_eol[e]) / (p.eps + got)),
                      p.max_boost);
      }
      s_gain[e] = s_gain[e] * boost;
      s_qm[e] = s_qm[e] * boost;
      s_sm[e] = s_sm[e] * boost;
    }
    __syncthreads();
    STAMP(8)

    // ---- smoothing: the raw gain and noise rows ----------------------
    if (p.smooth) {
      for (int e = tid; e < (HIST + NSLOT) * m; e += THREADS) {
        const int rr = e / m, i = e - rr * m;
        if (rr < HIST && !prior) {
          s_gs[e] = s_hist[e];
          s_qs[e] = s_hist[HIST * m + e];
          continue;
        }
        const int j = rr < HIST ? 0 : prior;
        const int t = rr < HIST ? NSLOT - HIST + rr : rr - HIST;
        const uint8_t* seg = s_seg + j * SEG_BYTES + t * MAXENV;
        float gs = 0.0f, qs = 0.0f;
#pragma unroll
        for (int v = 0; v < MAXENV; ++v) {
          const float sg = (float)seg[v];
          const int pe = (j * MAXENV + v) * m + i;
          gs = gs + sg * s_gain[pe];
          qs = qs + sg * s_qm[pe];
        }
        s_gs[e] = gs;
        s_qs[e] = qs;
      }
      __syncthreads();
    }
    STAMP(9)

    // ---- X: the slot expansion and the adjusted band, 4 bins a thread
    const uint8_t* seg_pk = s_seg + prior * SEG_BYTES;
    const float* dl = s_delta + prior * MAXENV;
    const float2* xh_pk =
        reinterpret_cast<const float2*>(s_xh + prior * 2 * NSLOT * m);
    for (int e = tid; e < NSLOT * n_gain; e += THREADS) {
      const int t = e / n_gain, g = g_lo + (e - t * n_gain);
      const uint8_t* seg = seg_pk + t * MAXENV;
      float sgv[MAXENV];
      float cov = 0.0f, ok = 0.0f;
#pragma unroll
      for (int v = 0; v < MAXENV; ++v) {
        sgv[v] = (float)seg[v];
        cov = cov + sgv[v];
        ok = ok + sgv[v] * dl[v];
      }
      const unsigned nstart = (unsigned)s_nstart[t];
      float xr[4], xi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int bb = 4 * g + c;
        xr[c] = 0.0f;
        xi[c] = 0.0f;
        if (bb < 32) {
          const float lo = s_nlow[bb];
          xr[c] = s_xl[t * NCOL + bb] * lo;
          xi[c] = s_xl[t * NCOL + 32 + bb] * lo;
        }
        const int i = bb - p.kx;
        if (i < 0 || i >= m) continue;
        float gs = 0.0f, sms = 0.0f, gate = 0.0f;
#pragma unroll
        for (int v = 0; v < MAXENV; ++v) {
          const int pe = (prior * MAXENV + v) * m + i;
          gs = gs + sgv[v] * s_gain[pe];
          sms = sms + sgv[v] * s_sm[pe];
          gate = p.smooth
                     ? gate + sgv[v] * (dl[v] * (1.0f - s_smap[pe]))
                     : gate + sgv[v] * (dl[v] * s_qm[pe] * (1.0f - s_smap[pe]));
        }
        float gain_s = gs, qm_s = gate;
        if (p.smooth) {
          const int r = (HIST + t) * m + i;
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
        }
        const int nidx = (int)((nstart + 1u + (unsigned)i) & 511u);
        const float2 nz =
            __ldg(reinterpret_cast<const float2*>(p.noise_tab) + nidx);
        const int ph = (t + i) & 3;
        const float phr = ph == 0 ? 1.0f : (ph == 2 ? -1.0f : 0.0f);
        const float phi = ph == 1 ? 1.0f : (ph == 3 ? -1.0f : 0.0f);
        const float2 h = xh_pk[t * m + i];
        xr[c] = xr[c] + (h.x * gain_s + qm_s * nz.x + sms * phr) * cov;
        xi[c] = xi[c] + (h.y * gain_s + qm_s * nz.y + sms * phi) * cov;
      }
      float* xo = x_pk + t * NCOL + 4 * g;
      st4(xo, xr[0], xr[1], xr[2], xr[3]);
      st4(xo + plane, xi[0], xi[1], xi[2], xi[3]);
    }
    STAMP(10)
    if (p.smooth && k == p.n_packets - 1) {
      for (int e = tid; e < HIST * 64; e += THREADS) {
        const int j = e >> 6, i = e & 63;
        const long long o = ((long long)n * HIST + j) * 64 + i;
        p.new_g_hist[o] = i < m ? s_gs[(NSLOT + j) * m + i] : 0.0f;
        p.new_q_hist[o] = i < m ? s_qs[(NSLOT + j) * m + i] : 0.0f;
      }
    }
    __syncthreads();  // the item's buffer and arrays are free again
    STAMP(11)
#ifdef CLOCK
    if (tid == 0 && it == 0) {
      long long* out = reinterpret_cast<long long*>(
          p.x + 2LL * p.n_lanes * p.n_packets * NSLOT * NCOL) +
          16LL * blockIdx.x;
      for (int c = 0; c < 12; ++c) out[c] = (long long)s_clk[c];
    }
#endif
  }
}

// ---------------------------------------------------------------------
// K16d
// ---------------------------------------------------------------------
constexpr int HIST_D = 9;
constexpr int TAPS = 10;
constexpr int VROW = 128;
constexpr int T = D_T;
constexpr int COLS = D_COLS;
constexpr int R = D_R;
constexpr int D_THREADS = (64 / COLS) * (T / R);
constexpr int ROWS = T + HIST_D;

static_assert(T % R == 0 && 64 % COLS == 0, "whole tiles");
static_assert(COLS == 2 || COLS == 4, "2 or 4 columns a thread");

__device__ __forceinline__ void load_cols(const float* src, float (&x)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(src);
  x[0] = v.x;
  x[1] = v.y;
}
__device__ __forceinline__ void load_cols(const float* src, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ uint32_t pcm_bits(float acc) {
  float r = rintf(acc);
  r = fminf(fmaxf(r, -32768.0f), 32767.0f);
  return (uint32_t)(uint16_t)(int16_t)r;
}

__global__ void __launch_bounds__(D_THREADS) qmf_synthesis_kernel(
    const float* __restrict__ v, const float* __restrict__ syn_hist,
    const int* __restrict__ cidx, const float* __restrict__ w,
    int16_t* __restrict__ pcm, float* __restrict__ new_hist, int n_slots) {
  __shared__ __align__(16) float vx[ROWS * VROW];
  __shared__ uint64_t bar, bar2;
#ifdef CLOCK
  __shared__ unsigned long long s_clk[4];
#endif
  STAMP(0)
  const int n = blockIdx.x, tid = threadIdx.x;
  const int s0 = blockIdx.y * T;
  const int s_end = min(s0 + T, n_slots);
  // Vx rows [s0, s_end + 9): history rows below 9, V rows from 9
  const int h_rows = max(0, HIST_D - s0);  // history rows staged
  const int v_first = max(s0, HIST_D) - HIST_D;
  const int v_rows = s_end - v_first;
  const float* vsrc = v + ((long long)n * n_slots + v_first) * VROW;
  const float* hsrc = syn_hist + ((long long)n * HIST_D + s0) * VROW;
  if constexpr (D_BULK && D_SPLIT) {
    // two barriers: the rows of the tile's first half of slots (and the 9
    // before them), then the rest
    if (tid == 0) {
      const int total = h_rows + v_rows;
      const int cut = min(total, HIST_D + T / 2);
      bulk::init(&bar);
      bulk::init(&bar2);
      bulk::expect(&bar, cut * VROW * 4);
      bulk::expect(&bar2, (total - cut) * VROW * 4);
      for (int half = 0; half < 2; ++half) {
        const int r0 = half ? cut : 0, r1 = half ? total : cut;
        uint64_t* b = half ? &bar2 : &bar;
        const int h1 = min(r1, h_rows);
        if (h1 > r0)
          bulk::copy(vx + r0 * VROW, hsrc + r0 * VROW, (h1 - r0) * VROW * 4,
                     b);
        const int v0 = max(r0, h_rows);
        if (r1 > v0)
          bulk::copy(vx + v0 * VROW, vsrc + (v0 - h_rows) * VROW,
                     (r1 - v0) * VROW * 4, b);
      }
    }
  } else if constexpr (D_BULK) {
    if (tid == 0) {
      bulk::init(&bar);
      bulk::expect(&bar, (h_rows + v_rows) * VROW * 4);
      if (h_rows) bulk::copy(vx, hsrc, h_rows * VROW * 4, &bar);
      bulk::copy(vx + h_rows * VROW, vsrc, v_rows * VROW * 4, &bar);
    }
  } else {
    for (int e = tid; e < (h_rows + v_rows) * (VROW / 4); e += D_THREADS) {
      const int r = e / (VROW / 4), c = e - r * (VROW / 4);
      const float4* src = reinterpret_cast<const float4*>(
          r < h_rows ? hsrc + r * VROW : vsrc + (r - h_rows) * VROW);
      reinterpret_cast<float4*>(vx)[e] = src[c];
    }
  }

  // the thread's columns and slots; its taps in registers
  const int cg_ = tid % (64 / COLS), sg = tid / (64 / COLS);
  const int c0 = cg_ * COLS, sl0 = sg * R;
  float wr[TAPS][COLS];
  int cb[TAPS];
  bool adjacent = true, structured = true;
#pragma unroll
  for (int d = 0; d < TAPS; ++d) {
    cb[d] = __ldg(cidx + d * 64 + c0);
    adjacent = adjacent && (cb[d] % COLS) == 0;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      wr[d][j] = __ldg(w + d * 64 + c0 + j);
      const int c = __ldg(cidx + d * 64 + c0 + j);
      adjacent = adjacent && c == cb[d] + j;
      structured = structured && c == c0 + j + 64 * (d & 1);
    }
  }
  (void)structured;
  __syncthreads();  // the barrier's init (or the plain loads) seen by all
  if constexpr (D_BULK) bulk::wait(&bar);
  if constexpr (D_BULK && D_SPLIT) {
    if (sl0 + R > T / 2) bulk::wait(&bar2);
  }
  STAMP(1)

#if D_SLIDE
  if (structured) {
    // the taps of _synthesis_taps (column c on even taps, 64 + c on odd):
    // the thread's R slots slide over rows sl0 .. sl0 + R + 8, each row's
    // two halves loaded once and used by every slot that reads them,
    // rows from the last to the first, so each slot meets its taps in
    // the order d = 0 .. 9
    float acc[R][COLS];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[q][j] = 0.0f;
#pragma unroll
    for (int step = 0; step <= R + HIST_D - 1; ++step) {
      const int rr = R + HIST_D - 1 - step;
      const int q_lo = rr - HIST_D > 0 ? rr - HIST_D : 0;
      const int q_hi = rr < R - 1 ? rr : R - 1;
      bool ev = false, od = false;
#pragma unroll
      for (int q = q_lo; q <= q_hi; ++q) {
        if ((q + HIST_D - rr) & 1) od = true;
        else ev = true;
      }
      float lo[COLS], hi[COLS];
      const float* row = vx + (sl0 + rr) * VROW + c0;
      if (ev) load_cols(row, lo);
      if (od) load_cols(row + 64, hi);
#pragma unroll
      for (int q = q_lo; q <= q_hi; ++q) {
        const int d = q + HIST_D - rr;
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          acc[q][j] = acc[q][j] + ((d & 1) ? hi[j] : lo[j]) * wr[d][j];
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int s = s0 + sl0 + q;
      if (s >= s_end) break;
      int16_t* dst = pcm + ((long long)n * n_slots + s) * 64 + c0;
      if constexpr (COLS == 4) {
        uint2 pk;
        pk.x = pcm_bits(acc[q][0]) | (pcm_bits(acc[q][1]) << 16);
        pk.y = pcm_bits(acc[q][2]) | (pcm_bits(acc[q][3]) << 16);
        *reinterpret_cast<uint2*>(dst) = pk;
      } else {
        *reinterpret_cast<uint32_t*>(dst) =
            pcm_bits(acc[q][0]) | (pcm_bits(acc[q][1]) << 16);
      }
    }
  } else
#endif
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int s = s0 + sl0 + q;
    if (s >= s_end) break;
    float acc[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int d = 0; d < TAPS; ++d) {
      const float* row = vx + (sl0 + q + HIST_D - d) * VROW;
      float xv[COLS];
      if (adjacent) {
        load_cols(row + cb[d], xv);
      } else {
#pragma unroll
        for (int j = 0; j < COLS; ++j) xv[j] = row[__ldg(cidx + d * 64 + c0 + j)];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[j] = acc[j] + xv[j] * wr[d][j];
    }
    int16_t* dst = pcm + ((long long)n * n_slots + s) * 64 + c0;
    if constexpr (COLS == 4) {
      uint2 pk;
      pk.x = pcm_bits(acc[0]) | (pcm_bits(acc[1]) << 16);
      pk.y = pcm_bits(acc[2]) | (pcm_bits(acc[3]) << 16);
      *reinterpret_cast<uint2*>(dst) = pk;
    } else {
      *reinterpret_cast<uint32_t*>(dst) =
          pcm_bits(acc[0]) | (pcm_bits(acc[1]) << 16);
    }
  }

  STAMP(2)
  if (s_end == n_slots) {
    // the new history: Vx rows n_slots .. n_slots + 8, staged here
    const float* src = vx + (n_slots - s0) * VROW;
    float* dst = new_hist + (long long)n * HIST_D * VROW;
    if constexpr (D_BULK) {
      if (tid == 0) {
        if constexpr (D_SPLIT) bulk::wait(&bar2);
        bulk::fence_shared();
        bulk::store(dst, src, HIST_D * VROW * 4);
        bulk::commit();
        bulk::wait_read();
      }
    } else {
      for (int e = tid; e < HIST_D * VROW / 4; e += D_THREADS)
        reinterpret_cast<float4*>(dst)[e] =
            reinterpret_cast<const float4*>(src)[e];
    }
  }
  STAMP(3)
#ifdef CLOCK
  if (tid == 0) {
    long long* out = reinterpret_cast<long long*>(
        new_hist + (long long)gridDim.x * HIST_D * VROW) +
        4LL * (blockIdx.y * gridDim.x + blockIdx.x);
    for (int q = 0; q < 4; ++q) out[q] = (long long)s_clk[q];
  }
#endif
}

size_t k16c_smem_bytes(int m, int smooth, int n_high, int n_low, int n_q) {
  return (size_t)Layout(m, smooth != 0, n_high, n_low, n_q).words * 4;
}

}  // namespace

extern "C" int sbr_hf_adjust_variant(
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
      n_low > MAXM || n_q <= 0 || n_lim < 0 || n_lim > MAXM)
    return (int)cudaErrorInvalidValue;
  if (smooth && (!g_hist || !q_hist || !new_g_hist || !new_q_hist))
    return (int)cudaErrorInvalidValue;
  if (CLUSTER && smooth && n_packets > 8) return (int)cudaErrorInvalidValue;
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
  if (n_q > MAXM) return (int)cudaErrorInvalidValue;
#if C_V3
  if (OWN != 1) return (int)cudaErrorInvalidValue;
  const int smem_v3 =
      LayoutV3(m, smooth != 0, n_high, n_low, n_q).words * 4;
  cudaError_t err3 = cudaFuncSetAttribute(
      sbr_hf_adjust_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_v3);
  int dev = 0, sms = 0, per_sm = 0;
  if (err3 == cudaSuccess) err3 = cudaGetDevice(&dev);
  if (err3 == cudaSuccess)
    err3 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err3 == cudaSuccess)
    err3 = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sbr_hf_adjust_v3_kernel, THREADS, smem_v3);
  if (err3 != cudaSuccess) return (int)err3;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const int grid3 = (int)(blocks < resident ? blocks : resident);
  sbr_hf_adjust_v3_kernel<<<grid3, THREADS, smem_v3,
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
#endif
#if C_V2
  if (smooth && OWN != 1) return (int)cudaErrorInvalidValue;
  const int smem_v2 =
      LayoutV2(m, smooth != 0, n_high, n_low, n_q).words * 4;
  cudaError_t err2 = cudaFuncSetAttribute(
      sbr_hf_adjust_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_v2);
  if (err2 != cudaSuccess) return (int)err2;
  sbr_hf_adjust_v2_kernel<<<(int)blocks, THREADS, smem_v2,
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
#endif
  const size_t smem = k16c_smem_bytes(m, smooth, n_high, n_low, n_q);
  cudaError_t err = cudaFuncSetAttribute(
      sbr_hf_adjust_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (C_CARVE) {
    err = cudaFuncSetAttribute(sbr_hf_adjust_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  if (CLUSTER && smooth) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)n_packets;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, sbr_hf_adjust_kernel, p);
    if (err != cudaSuccess) return (int)err;
  } else {
    sbr_hf_adjust_kernel<<<(int)blocks, THREADS, smem,
                           (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" int qmf_synthesis_variant(const void* v, const void* syn_hist,
                                     const void* cidx, const void* w,
                                     void* pcm, void* new_hist, int n_lanes,
                                     int n_slots, void* stream) {
  if (n_lanes <= 0 || n_slots < HIST_D) return (int)cudaErrorInvalidValue;
  const long long tiles = (n_slots + T - 1) / T;
  if (tiles > 65535 || n_lanes > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (D_CARVE) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmf_synthesis_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  qmf_synthesis_kernel<<<dim3((unsigned)n_lanes, (unsigned)tiles), D_THREADS,
                         0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)syn_hist, (const int*)cidx,
      (const float*)w, (int16_t*)pcm, (float*)new_hist, n_slots);
  return (int)cudaGetLastError();
}
