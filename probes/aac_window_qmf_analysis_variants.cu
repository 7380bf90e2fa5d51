// The port's K16a (csrc/aac_window_qmf_analysis.cu) with the design it
// replaced and its parts, for probes/k12_k16a_variants.py, by compile-time
// knobs:
//   -DK16A_SCALAR_SHORT  an item that reads a short window built sample
//                    by sample, a branch a sample (the design before the
//                    port's, which vectorized only all-long items)
//   -DK16A_NO_BUILD  no ext build (the tap loop on whatever shared memory
//                    holds; timed, not held to the plain version)
//   -DK16A_EXT_ONLY  build ext and write one ext sample an output in place
//                    of the tap loop (timed, not held to the plain version)
//   -DK16A_CLOCK     thread 0 of each CTA writes the global timer (ns) at
//                    its entry, after the packets, after the build, after
//                    KA's wait, after the tap loop of its first group and
//                    at exit, as 8 int64 a CTA after the lanes' new_qa rows
//                    (the caller allocates them)
// Without knobs it is the port's kernel.  The rest is the port's source.

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
// ext rows: the 1312 samples each item's 32 slots read (window, short
// placement and overlap-add per sample, each packet's flags and LUT rows
// read once into shared memory), a thread 4 samples at a time by 16-byte
// loads (a short window's edges fall on multiples of 64 samples, so 4
// samples share their windows).
// Then each thread sums a register tile of TS slots x 2 TC columns (TC
// real, the same TC imaginary) of one item.  Every 4 taps it loads its TS
// slots' 4 ext values by one 16-byte load each, and per tap two float4 of
// KA's row, then runs 2 TS TC products and sums: 12 loads for 128
// multiply-adds.  The slots of a tile lie 8 apart, and ext rows hold 36
// floats for every 32 samples, so that a warp's 4 slot groups read 4
// disjoint sets of 4 banks.  Each output is still summed in tap order,
// the first product alone and then one rounded product and one rounded
// sum a tap, as the plain PyTorch version rounds them.

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

constexpr int TS = 4;                              // slots a thread
constexpr int TC = 4;                              // columns a half
constexpr int SLOT_GROUPS = NSLOT / TS;            // 8, slots 8 apart
constexpr int COL_GROUPS = NCOL / 2 / TC;          // 8
constexpr int ITEM_THREADS = SLOT_GROUPS * COL_GROUPS;  // 64
constexpr int ITEMS = THREADS / ITEM_THREADS;      // 4 items a CTA
constexpr int CTAS_PER_SM = 2;

// ext sample e of an item lies at e + 4 (e / 32) in its row: slot s at
// tap 32 t + u reads 36 (s + t) + u
__host__ __device__ constexpr int padded(int e) { return e + 4 * (e >> 5); }
constexpr int EXT_ROW = padded(EXT - 1) + 1;  // 1472 floats
constexpr int KA_FLOATS = TAPS * NCOL;         // 81920 bytes

static_assert(THREADS % ITEM_THREADS == 0, "whole items a CTA");
static_assert(SLOT_GROUPS * TS == NSLOT && COL_GROUPS * TC * 2 == NCOL,
              "tiles cover an item");
static_assert(EXT_ROW % 4 == 0, "16-byte rows");

// a packet's window: is_short, its long and short LUT rows; -1 for none
struct Packet {
  int is_short, wl, ws;
};

// KA, the ext rows, each item's packets k - 2, k - 1 and k, and the
// copy's mbarrier
constexpr int SMEM_BYTES = (KA_FLOATS + ITEMS * EXT_ROW) * 4 +
                           ITEMS * 3 * (int)sizeof(Packet) + 8;
static_assert(((KA_FLOATS + ITEMS * EXT_ROW) * 4 +
               ITEMS * 3 * (int)sizeof(Packet)) % 8 == 0,
              "the mbarrier is 8-byte aligned");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// samples t .. t + 3 (t a multiple of 4, in [0, 2048)) of packet lk's
// windowed IMDCT output.  A long window is one product a sample; the short
// windows w cover [448 + 128 w, 448 + 128 w + 256) and add in window order
// onto 0, as the reference's scatter-adds do.  Their edges fall on
// multiples of 64, so the 4 samples lie in the same windows.
__device__ __forceinline__ float4 windowed4(
    const float* __restrict__ long_raw, const float* __restrict__ short_raw,
    const float* __restrict__ lut_long, const float* __restrict__ lut_short,
    long long lk, Packet p, int t) {
  if (!p.is_short) {
    return mul4(ld4(long_raw + lk * 2048 + t),
                ldg4(lut_long + p.wl * 2048 + t));
  }
  const int d = t - SHORT_OFF;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (d >= 0 && d < SHORT_SPAN) {
    const int w_hi = min(7, d >> 7);
    const int w_lo = d >= 256 ? ((d - 256) >> 7) + 1 : 0;
    for (int w = w_lo; w <= w_hi; ++w) {
      const int u = d - SHORT_LEN * w;
      acc = add4(acc, mul4(ld4(short_raw + (lk * 8 + w) * 256 + u),
                           ldg4(lut_short + (p.ws * 8 + w) * 256 + u)));
    }
  }
  return acc;
}

#ifdef K16A_SCALAR_SHORT
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

// One item's ext row sample by sample (its packets pk: k - 2, k - 1, k),
// and, for its lane's last packet, the new overlap: the path of items
// that read a short window.
__device__ __noinline__ void build_ext_samples(
    const float* __restrict__ long_raw, const float* __restrict__ short_raw,
    const float* __restrict__ lut_long, const float* __restrict__ lut_short,
    const float* __restrict__ overlap, const float* __restrict__ qa_hist,
    float* __restrict__ new_overlap, const Packet* pk, long long n, int k,
    int n_packets, float* row, int tid) {
  const long long lane_pk = n * n_packets;
  for (int e = tid; e < EXT; e += THREADS) {
    float v;
    if (k == 0 && e < QA_HIST) {
      v = qa_hist[n * QA_HIST + e];
    } else {
      const int c = 1024 * k + e - QA_HIST;
      const int kk = c >> 10;       // k - 1 or k
      const int i = c & 1023;
      const int slot = kk - k + 2;  // 1 or 2
      const float head = windowed(long_raw, short_raw, lut_long, lut_short,
                                  lane_pk + kk, pk[slot], i);
      const float tail =
          kk == 0 ? overlap[n * 1024 + i]
                  : windowed(long_raw, short_raw, lut_long, lut_short,
                             lane_pk + kk - 1, pk[slot - 1], 1024 + i);
      v = head + tail;
    }
    row[padded(e)] = v;
  }
  if (k == n_packets - 1) {
    for (int i = tid; i < 1024; i += THREADS) {
      new_overlap[n * 1024 + i] =
          windowed(long_raw, short_raw, lut_long, lut_short, lane_pk + k,
                   pk[2], 1024 + i);
    }
  }
}

#endif

#ifdef K16A_CLOCK
__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// item (n, k)'s ext row, 4 samples a thread at a time: ext[e] is sample
// 1024 k + e of [qa_hist | core], for e < 288 (part A) the history (k = 0)
// or packet k - 1's core at 736 + e, else (part B) packet k's core at e -
// 288 (core = windowed[:1024] + the previous windowed[1024:], or the
// carried overlap); and, for the lane's last packet, the new overlap (its
// windowed[1024:]).  pk: packets k - 2, k - 1 and k.
__device__ __forceinline__ void build_ext(
    const float* __restrict__ long_raw, const float* __restrict__ short_raw,
    const float* __restrict__ lut_long, const float* __restrict__ lut_short,
    const float* __restrict__ overlap, const float* __restrict__ qa_hist,
    float* __restrict__ new_overlap, const Packet* pk, long long n, int k,
    int n_packets, float* row, int tid) {
  const long long lk = n * n_packets + k;  // packet k
  const float* ov = overlap + n * 1024;
  {  // part B: samples 4 tid .. 4 tid + 3 of packet k's core
    const int i = 4 * tid;
    const float4 head = windowed4(long_raw, short_raw, lut_long, lut_short,
                                  lk, pk[2], i);
    const float4 tail =
        k == 0 ? ld4(ov + i)
               : windowed4(long_raw, short_raw, lut_long, lut_short, lk - 1,
                           pk[1], 1024 + i);
    *reinterpret_cast<float4*>(row + padded(QA_HIST + i)) = add4(head, tail);
  }
  if (tid < QA_HIST / 4) {  // part A
    const int e = 4 * tid;
    const int i = 1024 - QA_HIST + e;
    float4 v;
    if (k == 0) {
      v = ld4(qa_hist + n * QA_HIST + e);
    } else {
      const float4 head = windowed4(long_raw, short_raw, lut_long,
                                    lut_short, lk - 1, pk[1], i);
      const float4 tail =
          k == 1 ? ld4(ov + i)
                 : windowed4(long_raw, short_raw, lut_long, lut_short,
                             lk - 2, pk[0], 1024 + i);
      v = add4(head, tail);
    }
    *reinterpret_cast<float4*>(row + padded(e)) = v;
  }
  if (k == n_packets - 1) {
    const int i = 4 * tid;
    *reinterpret_cast<float4*>(new_overlap + n * 1024 + i) = windowed4(
        long_raw, short_raw, lut_long, lut_short, lk, pk[2], 1024 + i);
  }
}

// taps 32 t + 4 u4 + uu (uu < 4) of a tile: slot s = sg + 8 i reads
// xt[288 i + 4 u4 + uu] with xt = x + 36 (sg + t), KA row 32 t + 4 u4 +
// uu from kt = KA + 32 t * 64 + 4 cg; FIRST: tap 0 assigns its products
template <bool FIRST>
__device__ __forceinline__ void taps4(float (&acc)[TS][2 * TC],
                                      const float* xt, const float* kt,
                                      int u4) {
  float4 xv[TS];
#pragma unroll
  for (int i = 0; i < TS; ++i) {
    xv[i] = ld4(xt + 36 * SLOT_GROUPS * i + 4 * u4);
  }
#pragma unroll
  for (int uu = 0; uu < 4; ++uu) {
    const float* kp = kt + (4 * u4 + uu) * NCOL;
    const float4 a = ld4(kp);
    const float4 b = ld4(kp + 32);
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      const float v = uu == 0   ? xv[i].x
                      : uu == 1 ? xv[i].y
                      : uu == 2 ? xv[i].z
                                : xv[i].w;
      float* o = acc[i];
      if (FIRST && uu == 0) {
        o[0] = v * a.x;
        o[1] = v * a.y;
        o[2] = v * a.z;
        o[3] = v * a.w;
        o[4] = v * b.x;
        o[5] = v * b.y;
        o[6] = v * b.z;
        o[7] = v * b.w;
      } else {
        o[0] = o[0] + v * a.x;
        o[1] = o[1] + v * a.y;
        o[2] = o[2] + v * a.z;
        o[3] = o[3] + v * a.w;
        o[4] = o[4] + v * b.x;
        o[5] = o[5] + v * b.y;
        o[6] = o[6] + v * b.z;
        o[7] = o[7] + v * b.w;
      }
    }
  }
}

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
  float* ka_s = smem;               // [320, 64]
  float* ext_s = smem + KA_FLOATS;  // [ITEMS, EXT_ROW]
  Packet* pk_s = reinterpret_cast<Packet*>(ext_s + ITEMS * EXT_ROW);
  uint64_t* bar = reinterpret_cast<uint64_t*>(pk_s + ITEMS * 3);
  const int tid = threadIdx.x;
  const int n_groups = (n_items + ITEMS - 1) / ITEMS;

  if (tid == 0) {
    bulk::init(bar);
  }
  __syncthreads();
  if (tid == 0) {
    bulk::expect(bar, KA_FLOATS * 4);
    bulk::copy(ka_s, ka, KA_FLOATS * 4, bar);
  }

  // this thread's tile: item j of the group, slots sg + 8 i, columns
  // 4 cg + c (real) and 32 + 4 cg + c (imaginary)
  const int j = tid / ITEM_THREADS;
  const int r = tid % ITEM_THREADS;
  const int cg = r % COL_GROUPS;
  const int sg = r / COL_GROUPS;
  bool ka_ready = false;
#ifdef K16A_CLOCK
  // the global timer (ns) at kernel entry, after the packets, after the
  // build, after KA's wait, after the tap loop (first group) and at exit
  long long tk[6] = {clk(), 0, 0, 0, 0, 0};
#endif

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
#ifdef K16A_CLOCK
    if (tid == 0 && grp == blockIdx.x) tk[1] = clk();
#endif
#ifndef K16A_NO_BUILD
#pragma unroll
    for (int jj = 0; jj < ITEMS; ++jj) {
      const int q = grp * ITEMS + jj;
      if (q >= n_items) break;
#ifdef K16A_SCALAR_SHORT
      const Packet* pk = pk_s + jj * 3;
      if (pk[0].is_short > 0 || pk[1].is_short > 0 || pk[2].is_short > 0) {
        build_ext_samples(long_raw, short_raw, lut_long, lut_short, overlap,
                          qa_hist, new_overlap, pk, q / n_packets,
                          q % n_packets, n_packets, ext_s + jj * EXT_ROW,
                          tid);
        continue;
      }
#endif
      build_ext(long_raw, short_raw, lut_long, lut_short, overlap, qa_hist,
                new_overlap, pk_s + jj * 3, q / n_packets, q % n_packets,
                n_packets, ext_s + jj * EXT_ROW, tid);
    }
#endif
#ifdef K16A_CLOCK
    if (tid == 0 && grp == blockIdx.x) tk[2] = clk();
#endif
    if (!ka_ready) {
      bulk::wait(bar);
      ka_ready = true;
    }
    __syncthreads();
#ifdef K16A_CLOCK
    if (tid == 0 && grp == blockIdx.x) tk[3] = clk();
#endif

    const int q = grp * ITEMS + j;
    if (q < n_items) {
      const float* x = ext_s + j * EXT_ROW;
      const float* kr = ka_s + TC * cg;
      float acc[TS][2 * TC];
#ifdef K16A_EXT_ONLY
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const float v = x[padded(32 * (sg + SLOT_GROUPS * i))];
#pragma unroll
        for (int c = 0; c < 2 * TC; ++c) acc[i][c] = v;
      }
#else
      taps4<true>(acc, x + 36 * sg, kr, 0);
      for (int u4 = 1; u4 < 8; ++u4) {
        taps4<false>(acc, x + 36 * sg, kr, u4);
      }
      for (int t = 1; t < TAPS / 32; ++t) {
        const float* xt = x + 36 * (sg + t);
        const float* kt = kr + 32 * t * NCOL;
#pragma unroll 2
        for (int u4 = 0; u4 < 8; ++u4) {
          taps4<false>(acc, xt, kt, u4);
        }
      }
#endif
      const long long n = q / n_packets;
      const int k = q % n_packets;
      float* out = xl + ((n * n_packets + k) * NSLOT) * NCOL + TC * cg;
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        float* o = out + (sg + SLOT_GROUPS * i) * NCOL;
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(o + 32) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
      if (k == n_packets - 1) {
        // the item's last 288 samples of ext are the new history
        for (int i = r; i < QA_HIST; i += ITEM_THREADS) {
          new_qa[n * QA_HIST + i] = x[padded(1024 + i)];
        }
      }
    }
#ifdef K16A_CLOCK
    if (tid == 0 && grp == blockIdx.x) tk[4] = clk();
#endif
    __syncthreads();  // the next group rewrites ext and the packets
  }
#ifdef K16A_CLOCK
  if (tid == 0) {
    tk[5] = clk();
    // past the lanes' new_qa rows: the caller allocates 16 floats a CTA
    long long* dbg = reinterpret_cast<long long*>(
                         new_qa + (long long)(n_items / n_packets) * QA_HIST) +
                     blockIdx.x * 8;
    for (int p = 0; p < 6; ++p) dbg[p] = tk[p];
  }
#endif
}

}  // namespace

extern "C" int aac_window_qmf_analysis_variant(
    const void* long_raw, const void* short_raw, const void* win_long_idx,
    const void* win_short_idx, const void* is_short, const void* overlap,
    const void* qa_hist, const void* lut_long, const void* lut_short,
    const void* ka, void* xl, void* new_overlap, void* new_qa, int n_lanes,
    int n_packets, void* stream) {
  if (n_lanes <= 0 || n_packets <= 0) return (int)cudaErrorInvalidValue;
  const long long items = (long long)n_lanes * n_packets;
  if (items > 0x7fffffffLL - ITEMS) return (int)cudaErrorInvalidValue;
  // 16-byte loads and stores throughout
  const void* rows[] = {long_raw, short_raw, lut_long, lut_short, overlap,
                        qa_hist,  ka,        xl,       new_overlap};
  for (const void* p : rows) {
    if (((uintptr_t)p & 15) != 0) return (int)cudaErrorMisalignedAddress;
  }
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
