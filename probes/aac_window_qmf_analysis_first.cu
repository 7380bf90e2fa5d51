// K16a as this redesign first stood (the port's kernel until its ext rows
// took 36 floats for every 32 samples, read 4 taps at a time, and its
// all-long build took 16-byte loads), kept to time it and the designs
// tried on it against the port's kernel (probes/k12_k16a_variants.py).
// Its ext rows hold 33 floats for every 32 samples, read one tap at a
// time; its all-long build goes one sample a thread at a time.  Its
// choices as compile-time knobs:
//   -DK16A_TS=n      slots a thread's tile (4; 8)
//   -DK16A_TC=n      columns a half of the tile (4; 8)
//   -DK16A_CTAS=n    CTAs an SM the launch bounds ask for (2; 1)
//   -DK16A_KA_GLOBAL read KA through the read-only cache, not shared memory
//   -DK16A_BUILD_BRANCHED  the first ext build tried: every item sample by
//                    sample, a branch a sample on its packet's window and
//                    on the carried overlap, no all-long path
//   -DK16A_BUILD_PREDICATED  the second: every load of every sample of the
//                    group's items predicated, none behind a branch
//   -DK16A_NO_BUILD  no ext build (the tap loop on whatever shared memory
//                    holds; timed, not held to the plain version)
//   -DK16A_EXT_ONLY  build ext and write one ext sample an output in place
//                    of the tap loop (timed, not held to the plain version)
// The rest is the source it came from, its entry point renamed.

// K16a: the AAC core filterbank's window and overlap-add, then the 32-band
// QMF analysis, for every lane (program x channel) and packet of a batch.
//
// Replaces stages 1 and 2 of the JAX device function
// nrsc5_tpu/audio/batch.py:164 _make_device_fn -> fn (:221-257) after its
// two IMDCT basis products, which stay matrix products (torch.matmul):
// the window LUT by index, the eight short windows placed at 448 + 128 w,
// the long/short select, the overlap-add with the carried overlap [N,
// 1024], then X[s, k] = sum_tau ext[32 s + tau] KA[tau, k] over the 320
// taps of ext = [qa_hist (288) | core (1024 K)], for the S = 32 K slots.
//
// Layout: long_raw f32 [N, K, 2048], short_raw f32 [N, K, 8, 256] (the
// IMDCT outputs), win_long_idx / win_short_idx / short uint8 [N, K],
// overlap f32 [N, 1024], qa_hist f32 [N, 288], the window LUTs f32 [13,
// 2048] and [5, 8, 256], ka f32 [320, 64] (columns 0-31 real, 32-63
// imaginary).  Out: xl f32 [N, 32 K, 64], new overlap, new qa_hist.
//
// Bound on the H100: operations.  At N = 128 lanes and K = 8 packets the
// analysis is 128 x 256 x 64 outputs of 320 multiply-adds (1.34 G
// operations, 0.020 ms at 67 TFLOP/s; -fmad=false makes each one a FMUL
// and a FADD, so the float32 pipes' issue floor is twice that); it reads
// 8.4 MB of long products, 8.4 MB of short products and writes 8.4 MB of
// xl (0.0075 ms at 3.35 TB/s).
//
// Design: a persistent grid (as many CTAs as fit, two an SM) walks over
// groups of ITEMS (lane, packet) items.  Each CTA brings KA (80 KB) into
// shared memory once, by one bulk copy, while it builds its first group's
// ext rows (the 1312 samples each item's 32 slots read: window, short
// placement and overlap-add per sample, each packet's flags and LUT rows
// read once into shared memory; where the three packets an item reads
// all have long windows, as most do, one product a sample from row
// pointers formed once, each part's loads issued together).  Then each
// thread sums a register tile of TS slots x 2 TC columns (TC real, the
// same TC imaginary) of one item: per tap it loads two float4 of KA's row
// and TS values of ext, and runs 2 TS TC products and sums, 6 loads for
// 32 multiply-adds.  The slots of a tile lie 8 apart, and ext rows are
// padded by one float every 32, so the 4 slot groups of a warp read 4
// banks.  Each output is still summed in tap order, the first product
// alone and then one rounded product and one rounded sum a tap, as the
// plain PyTorch version rounds them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../nrsc5_tpu_torch/csrc/bulk_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NSLOT = 32;
constexpr int NCOL = 64;
constexpr int TAPS = 320;
constexpr int QA_HIST = 288;               // TAPS - 32
constexpr int EXT = 32 * NSLOT + QA_HIST;  // 1312 samples an item reads
constexpr int SHORT_OFF = 448;
constexpr int SHORT_LEN = 128;
constexpr int SHORT_SPAN = SHORT_LEN * 7 + 256;  // [448, 1600)

#ifndef K16A_TS
#define K16A_TS 4
#endif
#ifndef K16A_TC
#define K16A_TC 4
#endif
#ifndef K16A_CTAS
#define K16A_CTAS 2
#endif
constexpr int TS = K16A_TS;                        // slots a thread
constexpr int TC = K16A_TC;                        // columns a half
constexpr int NC4 = TC / 4;                        // float4 a half
constexpr int SLOT_GROUPS = NSLOT / TS;            // slots that far apart
constexpr int COL_GROUPS = NCOL / 2 / TC;
constexpr int ITEM_THREADS = SLOT_GROUPS * COL_GROUPS;
constexpr int ITEMS = THREADS / ITEM_THREADS;      // items a CTA
constexpr int CTAS_PER_SM = K16A_CTAS;
#ifdef K16A_BUILD_BRANCHED
#define K16A_BRANCHED 1
#else
#define K16A_BRANCHED 0
#endif
static_assert(TC % 4 == 0, "whole float4 of KA");

// ext sample e of an item lies at e + e / 32 in its padded row
__host__ __device__ constexpr int padded(int e) { return e + (e >> 5); }
constexpr int EXT_ROW = (padded(EXT - 1) + 4) & ~3;  // 1352 floats
constexpr int KA_FLOATS = TAPS * NCOL;                // 81920 bytes
#ifdef K16A_KA_GLOBAL
constexpr int KA_SMEM = 0;  // KA stays in device memory
#else
constexpr int KA_SMEM = KA_FLOATS;
#endif

static_assert(THREADS % ITEM_THREADS == 0, "whole items a CTA");
static_assert(SLOT_GROUPS * TS == NSLOT && COL_GROUPS * TC * 2 == NCOL,
              "tiles cover an item");

// a packet's window: is_short, its long and short LUT rows; -1 for none
struct Packet {
  int is_short, wl, ws;
};

// KA, the padded ext rows, each item's packets k - 2, k - 1 and k, and
// the copy's mbarrier
constexpr int SMEM_BYTES = (KA_SMEM + ITEMS * EXT_ROW) * 4 +
                           ITEMS * 3 * (int)sizeof(Packet) + 8;
static_assert(((KA_SMEM + ITEMS * EXT_ROW) * 4 +
               ITEMS * 3 * (int)sizeof(Packet)) % 8 == 0,
              "the mbarrier is 8-byte aligned");

// sample t in [0, 2048) of packet lk's windowed IMDCT output
__device__ __forceinline__ float windowed(
    const float* __restrict__ long_raw, const float* __restrict__ short_raw,
    const float* __restrict__ lut_long, const float* __restrict__ lut_short,
    long long lk, Packet p, int t) {
  if (!p.is_short) {
    return long_raw[lk * 2048 + t] * __ldg(lut_long + p.wl * 2048 + t);
  }
  // the short windows w cover [448 + 128 w, 448 + 128 w + 256); add in
  // window order onto 0, as the reference's scatter-adds do
  const int d = t - SHORT_OFF;
  float acc = 0.0f;
  if (d >= 0 && d < SHORT_SPAN) {
    const int w_hi = min(7, d >> 7);
    const int w_lo = d >= 256 ? ((d - 256) >> 7) + 1 : 0;
    for (int w = w_lo; w <= w_hi; ++w) {
      const int u = d - SHORT_LEN * w;
      acc = acc + short_raw[(lk * 8 + w) * 256 + u] *
                      __ldg(lut_short + (p.ws * 8 + w) * 256 + u);
    }
  }
  return acc;
}

#ifdef K16A_BUILD_PREDICATED
// sample t in [0, 2048) of packet lk's windowed IMDCT output, 0 where
// `on` is false.  A long window is one product; the short windows w cover
// [448 + 128 w, 448 + 128 w + 256), at most two a sample, and add in
// window order onto 0, as the reference's scatter-adds do.  Every load is
// a lone predicated load at an address that needs no loaded value, so
// that a thread's loads for many samples issue before any is used.
__device__ __forceinline__ float windowed_predicated(
    const float* __restrict__ long_raw, const float* __restrict__ short_raw,
    const float* __restrict__ lut_long, const float* __restrict__ lut_short,
    long long lk, Packet p, int t, bool on) {
  const bool sh = p.is_short != 0;
  const int d = t - SHORT_OFF;
  const bool in = sh && d >= 0 && d < SHORT_SPAN;
  const int w_hi = min(7, d >> 7);
  const int w_lo = d >= 256 ? ((d - 256) >> 7) + 1 : 0;
  const bool two = in && w_lo < w_hi;
  const int u_lo = d - SHORT_LEN * w_lo;
  const int u_hi = d - SHORT_LEN * w_hi;
  const float* raw_a = sh ? short_raw + (lk * 8 + w_lo) * 256 + u_lo
                          : long_raw + lk * 2048 + t;
  const float* lut_a = sh ? lut_short + (p.ws * 8 + w_lo) * 256 + u_lo
                          : lut_long + p.wl * 2048 + t;
  const bool on_a = on && (!sh || in);
  const bool on_b = on && two;
  const float ra = on_a ? *raw_a : 0.0f;
  const float la = on_a ? __ldg(lut_a) : 0.0f;
  const float rb = on_b ? short_raw[(lk * 8 + w_hi) * 256 + u_hi] : 0.0f;
  const float lb = on_b ? __ldg(lut_short + (p.ws * 8 + w_hi) * 256 + u_hi)
                        : 0.0f;
  if (!sh) return ra * la;
  const float one = in ? 0.0f + ra * la : 0.0f;
  return two ? one + rb * lb : one;
}

#endif

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    window_qmf_analysis_kernel(
        const float* __restrict__ long_raw,
        const float* __restrict__ short_raw,
        const uint8_t* __restrict__ win_long_idx,
        const uint8_t* __restrict__ win_short_idx,
        const uint8_t* __restrict__ is_short,
        const float* __restrict__ overlap, const float* __restrict__ qa_hist,
        const float* __restrict__ lut_long,
        const float* __restrict__ lut_short, const float* __restrict__ ka,
        float* __restrict__ xl, float* __restrict__ new_overlap,
        float* __restrict__ new_qa, int n_packets, int n_items) {
  extern __shared__ __align__(16) float smem[];
  float* ka_s = smem;                     // [320, 64]
  float* ext_s = smem + KA_SMEM;          // [ITEMS, EXT_ROW], padded
  Packet* pk_s = reinterpret_cast<Packet*>(ext_s + ITEMS * EXT_ROW);
  uint64_t* bar = reinterpret_cast<uint64_t*>(pk_s + ITEMS * 3);
  const int tid = threadIdx.x;
  const int n_groups = (n_items + ITEMS - 1) / ITEMS;

  if (tid == 0) {
    bulk::init(bar);
  }
  __syncthreads();
#ifndef K16A_KA_GLOBAL
  if (tid == 0) {
    bulk::expect(bar, KA_FLOATS * 4);
    bulk::copy(ka_s, ka, KA_FLOATS * 4, bar);
  }
#endif

  // this thread's tile: item j of the group, slots sg + 8 i, columns
  // 4 cg + c (real) and 32 + 4 cg + c (imaginary)
  const int j = tid / ITEM_THREADS;
  const int r = tid % ITEM_THREADS;
  const int cg = r % COL_GROUPS;
  const int sg = r / COL_GROUPS;
  bool ka_ready = false;

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    // each item's packets k - 2, k - 1 and k, read once
    if (tid < ITEMS * 3) {
      const int q = grp * ITEMS + tid / 3;
      const int kk = q % n_packets - 2 + tid % 3;
      Packet p = {-1, -1, -1};
      if (q < n_items && kk >= 0) {
        const long long lk = (long long)(q / n_packets) * n_packets + kk;
        p = {(int)is_short[lk], (int)win_long_idx[lk],
             (int)win_short_idx[lk]};
      }
      pk_s[tid] = p;
    }
    __syncthreads();

#if defined(K16A_NO_BUILD)
#elif defined(K16A_BUILD_PREDICATED)
    // ext[e] of item (n, k) is sample 1024 k + e of [qa_hist | core]: for
    // e < 288 the history (k = 0) or packet k - 1's core, else packet k's
    // core (core = windowed[:1024] + the previous windowed[1024:], or the
    // carried overlap).  Unrolled over the group's items with every load
    // predicated, so that a thread's ~24 samples load together.
#pragma unroll
    for (int jj = 0; jj < ITEMS; ++jj) {
      const int q = grp * ITEMS + jj;
      const bool live = q < n_items;
      const int qc = live ? q : n_items - 1;  // a real item's addresses
      const long long n = qc / n_packets;
      const int k = qc % n_packets;
      const long long lane_pk = n * n_packets;
      const Packet* pk = pk_s + jj * 3;  // packets k - 2, k - 1, k
      float* row = ext_s + jj * EXT_ROW;
#pragma unroll
      for (int it = 0; it < (EXT + THREADS - 1) / THREADS; ++it) {
        const bool own = live && tid + it * THREADS < EXT;
        const int e = min(tid + it * THREADS, EXT - 1);
        const bool hist = k == 0 && e < QA_HIST;
        const int c = max(1024 * k + e - QA_HIST, 0);
        const int kk = c >> 10;  // k - 1 or k
        const int i = c & 1023;
        const int slot = kk - k + 2;  // 1 or 2
        const bool carried = kk == 0;  // the tail is the carried overlap
        const float h = own && hist ? qa_hist[n * QA_HIST + e] : 0.0f;
        const float o =
            own && !hist && carried ? overlap[n * 1024 + i] : 0.0f;
        const float head =
            windowed_predicated(long_raw, short_raw, lut_long, lut_short, lane_pk + kk,
                     pk[slot], i, own && !hist);
        const float tail = windowed_predicated(
            long_raw, short_raw, lut_long, lut_short,
            lane_pk + max(kk - 1, 0), pk[max(slot - 1, 0)], 1024 + i,
            own && !hist && !carried);
        if (own) row[padded(e)] = hist ? h : head + (carried ? o : tail);
      }
      // the last packet's second half is the new overlap
      const bool last = live && k == n_packets - 1;
#pragma unroll
      for (int it = 0; it < 1024 / THREADS; ++it) {
        const int i = tid + it * THREADS;
        const float v = windowed_predicated(long_raw, short_raw, lut_long, lut_short,
                                 lane_pk + k, pk[2], 1024 + i, last);
        if (last) new_overlap[n * 1024 + i] = v;
      }
    }
#else
    // ext[e] of item (n, k) is sample 1024 k + e of [qa_hist | core]: for
    // e < 288 (part A) the history (k = 0) or packet k - 1's core at 736 +
    // e, else (part B) packet k's core at e - 288 (core = windowed[:1024]
    // + the previous windowed[1024:], or the carried overlap)
#pragma unroll
    for (int jj = 0; jj < ITEMS; ++jj) {
      const int q = grp * ITEMS + jj;
      if (q >= n_items) break;
      const long long n = q / n_packets;
      const int k = q % n_packets;
      const long long lane_pk = n * n_packets;
      const Packet* pk = pk_s + jj * 3;  // packets k - 2, k - 1, k
      float* row = ext_s + jj * EXT_ROW;
      const float* ov = overlap + n * 1024;
      if (!K16A_BRANCHED && pk[0].is_short <= 0 && pk[1].is_short <= 0 &&
          pk[2].is_short <= 0) {
        // every packet read has a long window: one product a sample, the
        // rows' pointers formed once, the loads of a part issued together
        const float* raw[3];
        const float* lut[3];
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          raw[m] = long_raw + (lane_pk + max(k - 2 + m, 0)) * 2048;
          lut[m] = lut_long + max(pk[m].wl, 0) * 2048;
        }
#pragma unroll
        for (int it = 0; it < 1024 / THREADS; ++it) {
          const int i = tid + it * THREADS;
          const float head = raw[2][i] * __ldg(lut[2] + i);
          const float tail =
              k == 0 ? ov[i] : raw[1][1024 + i] * __ldg(lut[1] + 1024 + i);
          row[padded(QA_HIST + i)] = head + tail;
        }
#pragma unroll
        for (int it = 0; it < (QA_HIST + THREADS - 1) / THREADS; ++it) {
          const int e = tid + it * THREADS;
          if (e < QA_HIST) {
            const int i = 1024 - QA_HIST + e;
            float v;
            if (k == 0) {
              v = qa_hist[n * QA_HIST + e];
            } else {
              const float head = raw[1][i] * __ldg(lut[1] + i);
              const float tail = k == 1 ? ov[i]
                                        : raw[0][1024 + i] *
                                              __ldg(lut[0] + 1024 + i);
              v = head + tail;
            }
            row[padded(e)] = v;
          }
        }
        if (k == n_packets - 1) {
#pragma unroll
          for (int it = 0; it < 1024 / THREADS; ++it) {
            const int i = 1024 + tid + it * THREADS;
            new_overlap[n * 1024 + i - 1024] =
                raw[2][i] * __ldg(lut[2] + i);
          }
        }
      } else {
        // a short window among them: sample by sample
        for (int e = tid; e < EXT; e += THREADS) {
          float v;
          if (k == 0 && e < QA_HIST) {
            v = qa_hist[n * QA_HIST + e];
          } else {
            const int c = 1024 * k + e - QA_HIST;
            const int kk = c >> 10;  // k - 1 or k
            const int i = c & 1023;
            const int slot = kk - k + 2;  // 1 or 2
            const float head =
                windowed(long_raw, short_raw, lut_long, lut_short,
                         lane_pk + kk, pk[slot], i);
            const float tail =
                kk == 0 ? ov[i]
                        : windowed(long_raw, short_raw, lut_long, lut_short,
                                   lane_pk + kk - 1, pk[slot - 1], 1024 + i);
            v = head + tail;
          }
          row[padded(e)] = v;
        }
        if (k == n_packets - 1) {
          for (int i = tid; i < 1024; i += THREADS) {
            new_overlap[n * 1024 + i] =
                windowed(long_raw, short_raw, lut_long, lut_short,
                         lane_pk + k, pk[2], 1024 + i);
          }
        }
      }
    }
#endif
#ifndef K16A_KA_GLOBAL
    if (!ka_ready) {
      bulk::wait(bar);
      ka_ready = true;
    }
#endif
    __syncthreads();

    const int q = grp * ITEMS + j;
    if (q < n_items) {
      const float* x = ext_s + j * EXT_ROW;
#ifdef K16A_KA_GLOBAL
      const float* kr = ka + TC * cg;
#define KA4(p) __ldg(reinterpret_cast<const float4*>(p))
#else
      const float* kr = ka_s + TC * cg;
#define KA4(p) (*reinterpret_cast<const float4*>(p))
#endif
      float acc[TS][2 * TC];
#ifdef K16A_EXT_ONLY
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const float v = x[padded(32 * (sg + SLOT_GROUPS * i))];
#pragma unroll
        for (int c = 0; c < 2 * TC; ++c) acc[i][c] = v;
      }
#else
      // tap 0: the first product alone
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c4 = 0; c4 < NC4; ++c4) {
          const float4 a = KA4(kr + 32 * h + 4 * c4);
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            const float v = x[padded(32 * (sg + SLOT_GROUPS * i))];
            float* o = acc[i] + h * TC + 4 * c4;
            o[0] = v * a.x;
            o[1] = v * a.y;
            o[2] = v * a.z;
            o[3] = v * a.w;
          }
        }
      }
      // taps 32 t + u: slot s reads x[33 (s + t) + u] (padded)
      for (int t = 0; t < TAPS / 32; ++t) {
        const float* xt = x + 33 * (sg + t);
        const float* kt = kr + 32 * t * NCOL;
#pragma unroll 8
        for (int u = (t == 0 ? 1 : 0); u < 32; ++u) {
          float4 a[2 * NC4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c4 = 0; c4 < NC4; ++c4)
              a[h * NC4 + c4] = KA4(kt + u * NCOL + 32 * h + 4 * c4);
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            const float v = xt[33 * SLOT_GROUPS * i + u];
#pragma unroll
            for (int m = 0; m < 2 * NC4; ++m) {
              float* o = acc[i] + 4 * m;
              o[0] = o[0] + v * a[m].x;
              o[1] = o[1] + v * a[m].y;
              o[2] = o[2] + v * a[m].z;
              o[3] = o[3] + v * a[m].w;
            }
          }
        }
      }
#endif
#undef KA4
      const long long n = q / n_packets;
      const int k = q % n_packets;
      float* out = xl + ((n * n_packets + k) * NSLOT) * NCOL + TC * cg;
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        float* o = out + (sg + SLOT_GROUPS * i) * NCOL;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c4 = 0; c4 < NC4; ++c4) {
            const float* a = acc[i] + h * TC + 4 * c4;
            *reinterpret_cast<float4*>(o + 32 * h + 4 * c4) =
                make_float4(a[0], a[1], a[2], a[3]);
          }
      }
      if (k == n_packets - 1) {
        // the item's last 288 samples of ext are the new history
        for (int i = r; i < QA_HIST; i += ITEM_THREADS) {
          new_qa[n * QA_HIST + i] = x[padded(1024 + i)];
        }
      }
    }
    __syncthreads();  // the next group rewrites ext and the packets
  }
}

}  // namespace

extern "C" int aac_window_qmf_analysis_first(
    const void* long_raw, const void* short_raw, const void* win_long_idx,
    const void* win_short_idx, const void* is_short, const void* overlap,
    const void* qa_hist, const void* lut_long, const void* lut_short,
    const void* ka, void* xl, void* new_overlap, void* new_qa, int n_lanes,
    int n_packets, void* stream) {
  if (n_lanes <= 0 || n_packets <= 0) return (int)cudaErrorInvalidValue;
  const long long items = (long long)n_lanes * n_packets;
  if (items > 0x7fffffffLL - ITEMS) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)ka & 15) != 0 || ((uintptr_t)xl & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      window_qmf_analysis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_qmf_analysis_kernel, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (items + ITEMS - 1) / ITEMS;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(groups < resident ? groups : resident);
  window_qmf_analysis_kernel<<<grid, THREADS, SMEM_BYTES,
                               (cudaStream_t)stream>>>(
      (const float*)long_raw, (const float*)short_raw,
      (const uint8_t*)win_long_idx, (const uint8_t*)win_short_idx,
      (const uint8_t*)is_short, (const float*)overlap,
      (const float*)qa_hist, (const float*)lut_long,
      (const float*)lut_short, (const float*)ka, (float*)xl,
      (float*)new_overlap, (float*)new_qa, n_packets, (int)items);
  return (int)cudaGetLastError();
}
