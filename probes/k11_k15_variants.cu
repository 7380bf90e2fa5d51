// The designs tried for K15 (the AM channel gathers) and K11 (the PX
// interleaver-IV deinterleave), for probes/k11_k15_variants.py.  Every
// design reads the port's composed tables (ops/decode_am.py:gather_maps,
// ops/decode_fm.py:px_tables, or forms derived from them by the probe) and
// takes the arguments of the port's entry points after a design number;
// its choices are template parameters (the compile-time knobs),
// instantiated by the extern "C" entry points at the end of the file:
//
// K15 (outputs int8, or float32 where F32):
//   smem<TILES, VEC, THREADS, F32, FPC>  a grid of (TILES, S x ceil(F /
//     FPC)), each CTA staging FPC frames' bytes by bulk copies and taking
//     VEC outputs a thread step through the map, read once for its frames;
//   l2<VEC, THREADS, F32>  a thread per VEC outputs, the bits gathered from
//     L2 (the parent's shape on the composed map);
//   stationary<VEC, THREADS>  a thread holds VEC map entries and loops over
//     the S x F frames, gathering from L2;
//   mc<TILES, VEC, THREADS>  smem's design with the TILES CTAs of a frame
//     a cluster that stages the frame once, by multicast bulk copies;
//   v2..v6  the staging mode (bulk, cp.async, pieces), PRED, WORD, CUT,
//     the unpacked value table (v3), two barriers (v5), block-cyclic
//     chunks and 3-byte map entries (v6; the port's design at 4 x 1024).
// K11:
//   smem<VEC, THREADS, F32>  a CTA a (station, pair), the pair's 17 runs
//     in shared memory by bulk copies;
//   l2<VEC, THREADS, F32>  a CTA a (station, pair), each entry resolved to
//     its run and read from L2;
//   group<K, TILES, THREADS, MC>  a CTA a (station, group of K pairs,
//     tile), the group's 16 + K runs staged once for its pairs (by
//     multicast over a cluster of its TILES CTAs where MC);
//   v2..v9  staging modes and rotation, merged copies (v4), the state by
//     bulk stores and 3-byte tables (v6), clusters (v7), gathers as each
//     copy lands (v8), the copy plan without a modulo (v9: 2 pairs x 1024,
//     the port's design before its first table loads moved under the
//     staging);
//   v10<K, THREADS, SPC, CUT>  the port's design of the round before (v9
//     with its first table loads under the staging, own rows first) on a
//     table without K7's punctured inputs (the port's design at 2 pairs x
//     512, 8 steps; px_tables' form): SPC trellis steps a thread step
//     read 2 SPC entries and write 3 SPC outputs (a zero between each
//     step's two); cuts: no shared-memory loads (1), no table loads (2),
//     neither (3).
// Designs keep the port's new-line and new-state results.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../nrsc5_tpu_torch/csrc/bulk_copy.cuh"
#include "../nrsc5_tpu_torch/csrc/packed3.cuh"

namespace {

constexpr int SEG = 18000;
constexpr int LINE = 3 * SEG;
constexpr int FRAME_CODES = 25600;
constexpr int PIDS_BYTES = 512;
constexpr int LINE_BASE = FRAME_CODES + PIDS_BYTES;

struct Lines {
  const uint8_t* old[4];
  uint8_t* out[4];
};

__device__ __forceinline__ const uint8_t* old_line(const Lines& l, int d) {
  return d == 0 ? l.old[0] : d == 1 ? l.old[1] : d == 2 ? l.old[2]
                                                         : l.old[3];
}
__device__ __forceinline__ uint8_t* new_line(const Lines& l, int d) {
  return d == 0 ? l.out[0] : d == 1 ? l.out[1] : d == 2 ? l.out[2]
                                                         : l.out[3];
}

template <int VEC>
__device__ __forceinline__ void load_map(const int* __restrict__ map, int c,
                                         int (&e)[VEC]) {
  const int4* p = reinterpret_cast<const int4*>(map) + c * (VEC / 4);
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k) {
    const int4 v = __ldg(p + k);
    e[4 * k] = v.x;
    e[4 * k + 1] = v.y;
    e[4 * k + 2] = v.z;
    e[4 * k + 3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const int (&v)[VEC]) {
  uint32_t w[VEC / 4];
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k)
    w[k] = (uint32_t)(v[4 * k] & 0xff) | (uint32_t)(v[4 * k + 1] & 0xff) << 8 |
           (uint32_t)(v[4 * k + 2] & 0xff) << 16 |
           (uint32_t)(v[4 * k + 3] & 0xff) << 24;
  if constexpr (VEC == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (VEC == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(dst) = w[0];
}

template <int VEC>
__device__ __forceinline__ void store_floats(float* dst, const int (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k)
    reinterpret_cast<float4*>(dst)[k] =
        make_float4((float)v[4 * k], (float)v[4 * k + 1], (float)v[4 * k + 2],
                    (float)v[4 * k + 3]);
}

// where output m of frame sf goes: region 0-2 the K7 inputs (element
// offset into out[region]), 3 the line region (byte pointer)
struct K15Out {
  void* p1;
  void* p3;
  void* pids;
};

template <int VEC, bool F32>
__device__ __forceinline__ void k15_store(const K15Out& o, const Lines& lines,
                                          int m, int sf, int s, int f,
                                          int n_frames, int m1, int m3,
                                          int mp, const int (&bit)[VEC],
                                          const int (&e)[VEC]) {
  int v[VEC];
  if (m >= m1 + m3 + mp) {
    const int i = m - m1 - m3 - mp;
    const int d = i / SEG;
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = bit[k];
    store_bytes<VEC>(new_line(lines, d) + (size_t)s * LINE + LINE -
                         SEG * (n_frames - f) + (i - d * SEG),
                     v);
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = e[k] < 0 ? 0 : 2 * bit[k] - 1;
  void* base;
  size_t at;
  if (m < m1) {
    base = o.p1;
    at = (size_t)sf * m1 + m;
  } else if (m < m1 + m3) {
    base = o.p3;
    at = (size_t)sf * m3 + (m - m1);
  } else {
    base = o.pids;
    at = (size_t)sf * mp + (m - m1 - m3);
  }
  if constexpr (F32)
    store_floats<VEC>(static_cast<float*>(base) + at, v);
  else
    store_bytes<VEC>(static_cast<uint8_t*>(base) + at, v);
}

// the kept part of the new lines, 16 bytes a step, by `workers` threads of
// which this is `w`
__device__ __forceinline__ void k15_copy_kept(const Lines& lines, int s,
                                              int n_frames, int n_delayed,
                                              int w, int workers) {
  const int keep = LINE - SEG * n_frames;
  if (keep <= 0) return;
  const int per = keep / 16;
  for (int i = w; i < n_delayed * per; i += workers) {
    const int d = i / per, v = i - d * per;
    const size_t at = (size_t)s * LINE + 16 * v;
    *reinterpret_cast<uint4*>(new_line(lines, d) + at) =
        __ldg(reinterpret_cast<const uint4*>(old_line(lines, d) + at +
                                             SEG * n_frames));
  }
}

// the global timer (ns) into clock[3 b + i] by thread 0, if clock is set:
// i = 0 at entry, 1 when the staged bytes have landed, 2 at the end
__device__ __forceinline__ void stamp(unsigned long long* clock, int b,
                                      int i) {
  if (clock && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    clock[3 * b + i] = t;
  }
}

template <int TILES, int VEC, int THREADS, bool F32, int FPC>
__global__ void __launch_bounds__(THREADS) k15_smem(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const int* __restrict__ map, Lines lines, K15Out o, int n_frames, int m1,
    int m3, int mp, int n_delayed, unsigned long long* clock) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ uint64_t bar;
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  stamp(clock, cta, 0);
  const int tile = blockIdx.x;
  const int groups = (n_frames + FPC - 1) / FPC;
  const int s = blockIdx.y / groups, g = blockIdx.y - s * groups;
  const int tid = threadIdx.x;
  const int line_len = n_delayed * SEG;
  const int slot = LINE_BASE + line_len;
  const int f0 = g * FPC;
  const int nf = min(FPC, n_frames - f0);
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    uint32_t bytes = 0;
    for (int k = 0; k < nf; ++k)
      bytes += LINE_BASE + (f0 + k < 3 ? line_len : 0);
    bulk::expect(&bar, bytes);
    for (int k = 0; k < nf; ++k) {
      const int f = f0 + k, sf = s * n_frames + f;
      uint8_t* dst = sm + k * slot;
      bulk::copy(dst, codes + (size_t)sf * FRAME_CODES, FRAME_CODES, &bar);
      bulk::copy(dst + FRAME_CODES, pids + (size_t)sf * PIDS_BYTES,
                 PIDS_BYTES, &bar);
      if (f < 3)
        for (int d = 0; d < n_delayed; ++d)
          bulk::copy(dst + LINE_BASE + d * SEG,
                     old_line(lines, d) + (size_t)s * LINE + SEG * f, SEG,
                     &bar);
    }
  }
  const int* line_map = map + m1 + m3 + mp;
  bool built = false;
  for (int k = 0; k < nf; ++k) {
    const int f = f0 + k;
    if (f < 3) continue;
    built = true;
    const uint8_t* prev =
        codes + (size_t)(s * n_frames + f - 3) * FRAME_CODES;
    for (int i = tid; i < line_len; i += THREADS) {
      const int e = __ldg(line_map + i);
      sm[k * slot + LINE_BASE + i] = (__ldg(prev + (e >> 3)) >> (e & 7)) & 1;
    }
  }
  if (g == 0)
    k15_copy_kept(lines, s, n_frames, n_delayed, tile * THREADS + tid,
                  TILES * THREADS);
  // the line part where any of the CTA's frames keeps its bits
  const int total =
      m1 + m3 + mp + (n_frames - (f0 + nf - 1) <= 3 ? line_len : 0);
  const int chunks = total / VEC;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  bulk::wait(&bar);
  if (built) __syncthreads();
  stamp(clock, cta, 1);
  for (int c = c0 + tid; c < c1; c += THREADS) {
    int e[VEC];
    load_map<VEC>(map, c, e);
    const int m = c * VEC;
#pragma unroll
    for (int k = 0; k < FPC; ++k) {
      if (k >= nf) break;
      const int f = f0 + k;
      if (m >= m1 + m3 + mp && n_frames - f > 3) continue;
      const uint8_t* st = sm + k * slot;
      int bit[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int a = e[j] < 0 ? 0 : e[j];
        bit[j] = (st[a >> 3] >> (a & 7)) & 1;
      }
      k15_store<VEC, F32>(o, lines, m, s * n_frames + f, s, f, n_frames, m1,
                          m3, mp, bit, e);
    }
  }
  __syncthreads();
  stamp(clock, cta, 2);
}

// a cluster of TILES CTAs a frame: each CTA issues its share of the
// frame's copies to every CTA of the cluster (multicast), so that L2 reads
// the frame's bytes once; otherwise k15_smem's design at FPC = 1
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void copy_multicast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(
          bulk::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bulk::smem_addr(bar)), "h"(mask)
      : "memory");
}

template <int TILES, int VEC, int THREADS>
__global__ void __cluster_dims__(TILES, 1, 1) __launch_bounds__(THREADS)
    k15_mc(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
           const int* __restrict__ map, Lines lines, K15Out o, int n_frames,
           int m1, int m3, int mp, int n_delayed,
           unsigned long long* clock) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x, sf = blockIdx.y;
  const int cta = sf * TILES + tile;
  stamp(clock, cta, 0);
  const int s = sf / n_frames, f = sf - s * n_frames;
  const int tid = threadIdx.x;
  const int line_len = n_delayed * SEG;
  const bool staged_lines = f < 3;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  cluster_sync_all();  // every CTA's barrier set before a copy signals it
  if (tid == 0) {
    bulk::expect(&bar, LINE_BASE + (staged_lines ? line_len : 0));
    const uint16_t all = (1u << TILES) - 1u;
    // copies: the codes in 4 parts, the PIDS codes, each line slice
    const int n_copies = 5 + (staged_lines ? n_delayed : 0);
    for (int i = tile; i < n_copies; i += TILES) {
      if (i < 4)
        copy_multicast(sm + i * (FRAME_CODES / 4),
                       codes + (size_t)sf * FRAME_CODES + i * (FRAME_CODES / 4),
                       FRAME_CODES / 4, &bar, all);
      else if (i == 4)
        copy_multicast(sm + FRAME_CODES, pids + (size_t)sf * PIDS_BYTES,
                       PIDS_BYTES, &bar, all);
      else
        copy_multicast(sm + LINE_BASE + (i - 5) * SEG,
                       old_line(lines, i - 5) + (size_t)s * LINE + SEG * f,
                       SEG, &bar, all);
    }
  }
  const int* line_map = map + m1 + m3 + mp;
  if (!staged_lines) {
    const uint8_t* prev = codes + (size_t)(sf - 3) * FRAME_CODES;
    for (int i = tid; i < line_len; i += THREADS) {
      const int e = __ldg(line_map + i);
      sm[LINE_BASE + i] = (__ldg(prev + (e >> 3)) >> (e & 7)) & 1;
    }
  }
  if (f == 0)
    k15_copy_kept(lines, s, n_frames, n_delayed, tile * THREADS + tid,
                  TILES * THREADS);
  const int total = m1 + m3 + mp + (n_frames - f <= 3 ? line_len : 0);
  const int chunks = total / VEC;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  bulk::wait(&bar);
  if (!staged_lines) __syncthreads();
  stamp(clock, cta, 1);
  for (int c = c0 + tid; c < c1; c += THREADS) {
    int e[VEC], bit[VEC];
    load_map<VEC>(map, c, e);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int a = e[j] < 0 ? 0 : e[j];
      bit[j] = (sm[a >> 3] >> (a & 7)) & 1;
    }
    k15_store<VEC, false>(o, lines, c * VEC, sf, s, f, n_frames, m1, m3, mp,
                          bit, e);
  }
  __syncthreads();
  stamp(clock, cta, 2);
  cluster_sync_all();  // no CTA leaves while a copy it issued may land
}

// one bit of frame sf's bytes by its staged address, read from L2
__device__ __forceinline__ int k15_l2_bit(int a, const uint8_t* codes,
                                          const uint8_t* pids,
                                          const Lines& lines,
                                          const int* line_map, int s, int f,
                                          int sf) {
  const int byte = a >> 3, plane = a & 7;
  if (byte < FRAME_CODES)
    return (__ldg(codes + (size_t)sf * FRAME_CODES + byte) >> plane) & 1;
  if (byte < LINE_BASE)
    return (__ldg(pids + (size_t)sf * PIDS_BYTES + byte - FRAME_CODES) >>
            plane) & 1;
  const int i = byte - LINE_BASE, d = i / SEG;
  if (f < 3)
    return __ldg(old_line(lines, d) + (size_t)s * LINE + SEG * f + i -
                 d * SEG);
  const int e = __ldg(line_map + i);
  return (__ldg(codes + (size_t)(sf - 3) * FRAME_CODES + (e >> 3)) >>
          (e & 7)) & 1;
}

template <int VEC, int THREADS, bool F32>
__global__ void __launch_bounds__(THREADS) k15_l2(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const int* __restrict__ map, Lines lines, K15Out o, int n_frames, int m1,
    int m3, int mp, int n_delayed) {
  const int sf = blockIdx.y, s = sf / n_frames, f = sf - s * n_frames;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (f == 0)
    k15_copy_kept(lines, s, n_frames, n_delayed, w, gridDim.x * THREADS);
  const int total =
      m1 + m3 + mp + (n_frames - f <= 3 ? n_delayed * SEG : 0);
  const int c = w;
  if (c >= total / VEC) return;
  int e[VEC], bit[VEC];
  load_map<VEC>(map, c, e);
  const int* line_map = map + m1 + m3 + mp;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    bit[j] = e[j] < 0 ? 0
                      : k15_l2_bit(e[j], codes, pids, lines, line_map, s, f,
                                   sf);
  k15_store<VEC, F32>(o, lines, c * VEC, sf, s, f, n_frames, m1, m3, mp, bit,
                      e);
}

template <int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS) k15_stationary(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const int* __restrict__ map, Lines lines, K15Out o, int n_stations,
    int n_frames, int m1, int m3, int mp, int n_delayed) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  for (int s = 0; s < n_stations; ++s)
    k15_copy_kept(lines, s, n_frames, n_delayed, w, gridDim.x * THREADS);
  const int c = w;
  const int total = m1 + m3 + mp + n_delayed * SEG;
  if (c >= total / VEC) return;
  int e[VEC];
  load_map<VEC>(map, c, e);
  const int m = c * VEC;
  const int* line_map = map + m1 + m3 + mp;
  for (int sf = 0; sf < n_stations * n_frames; ++sf) {
    const int s = sf / n_frames, f = sf - s * n_frames;
    if (m >= m1 + m3 + mp && n_frames - f > 3) continue;
    int bit[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      bit[j] = e[j] < 0 ? 0
                        : k15_l2_bit(e[j], codes, pids, lines, line_map, s,
                                     f, sf);
    k15_store<VEC, false>(o, lines, m, sf, s, f, n_frames, m1, m3, mp, bit,
                          e);
  }
}

template <int TILES, int VEC, int THREADS, bool F32, int FPC>
int launch_k15_smem(const uint8_t* codes, const uint8_t* pids, const int* map,
                    Lines lines, K15Out o, int n_stations, int n_frames,
                    int m1, int m3, int mp, int n_delayed,
                    unsigned long long* clock, cudaStream_t st) {
  auto kern = k15_smem<TILES, VEC, THREADS, F32, FPC>;
  const int smem = FPC * (LINE_BASE + n_delayed * SEG);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (n_frames + FPC - 1) / FPC;
  kern<<<dim3(TILES, n_stations * groups), THREADS, smem, st>>>(
      codes, pids, map, lines, o, n_frames, m1, m3, mp, n_delayed, clock);
  return (int)cudaGetLastError();
}

template <int TILES, int VEC, int THREADS>
int launch_k15_mc(const uint8_t* codes, const uint8_t* pids, const int* map,
                  Lines lines, K15Out o, int n_stations, int n_frames, int m1,
                  int m3, int mp, int n_delayed, unsigned long long* clock,
                  cudaStream_t st) {
  auto kern = k15_mc<TILES, VEC, THREADS>;
  const int smem = LINE_BASE + n_delayed * SEG;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * n_frames), THREADS, smem, st>>>(
      codes, pids, map, lines, o, n_frames, m1, m3, mp, n_delayed, clock);
  return (int)cudaGetLastError();
}

template <int VEC, int THREADS, bool F32>
int launch_k15_l2(const uint8_t* codes, const uint8_t* pids, const int* map,
                  Lines lines, K15Out o, int n_stations, int n_frames, int m1,
                  int m3, int mp, int n_delayed, cudaStream_t st) {
  const int chunks = (m1 + m3 + mp + n_delayed * SEG) / VEC;
  k15_l2<VEC, THREADS, F32><<<dim3((chunks + THREADS - 1) / THREADS,
                                   n_stations * n_frames),
                              THREADS, 0, st>>>(codes, pids, map, lines, o,
                                                n_frames, m1, m3, mp,
                                                n_delayed);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

template <int THREADS>
__device__ __forceinline__ void copy16(int8_t* dst, const int8_t* src,
                                       int len) {
  for (int v = threadIdx.x; v < len / 16; v += THREADS)
    reinterpret_cast<uint4*>(dst)[v] =
        __ldg(reinterpret_cast<const uint4*>(src) + v);
}

// the pair's share of the new state and the phases, as the port's K11
template <int THREADS>
__device__ __forceinline__ void k11_state(
    const int8_t* rows, const int8_t* old, int8_t* state, int* new_phase,
    int s, int p, int ph0, int ph, int pairs, int call_len, int calls) {
  if (p + calls >= pairs)
    copy16<THREADS>(state + ph * call_len, rows + (size_t)p * call_len,
                    call_len);
  for (int q = 0; q < calls; ++q) {
    const int k = pmod(q - ph0, calls);
    if (k >= pairs && (k - pairs) % pairs == p)
      copy16<THREADS>(state + q * call_len, old + q * call_len, call_len);
  }
  if (p == 0 && threadIdx.x == 0) new_phase[s] = pmod(ph0 + pairs, calls);
}

template <int VEC, bool F32>
__device__ __forceinline__ void k11_store(void* ext, size_t at,
                                          const int (&v)[VEC]) {
  if constexpr (F32)
    store_floats<VEC>(static_cast<float*>(ext) + at, v);
  else
    store_bytes<VEC>(static_cast<uint8_t*>(ext) + at, v);
}

template <int VEC, int THREADS, bool F32>
__global__ void __launch_bounds__(THREADS) k11_smem(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ table, void* ext,
    int8_t* __restrict__ new_internal, int* __restrict__ new_phase, int pairs,
    int call_len, int calls, int map_len, unsigned long long* clock) {
  extern __shared__ __align__(16) int8_t sm11[];
  __shared__ uint64_t bar;
  const int b = blockIdx.x, s = b / pairs, p = b - s * pairs;
  stamp(clock, b, 0);
  const int tid = threadIdx.x;
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), ph = pmod(ph0 + p, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    bulk::expect(&bar, (calls + 1) * call_len);
    for (int q = 0; q < calls; ++q) {
      int d = pmod(ph - q, calls);
      if (d == 0) d = calls;
      const int pp = p - d;
      bulk::copy(sm11 + q * call_len,
                 pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len,
                 call_len, &bar);
    }
    bulk::copy(sm11 + calls * call_len, rows + (size_t)p * call_len,
               call_len, &bar);
  }
  k11_state<THREADS>(rows, old, new_internal + (size_t)s * state_len,
                     new_phase, s, p, ph0, ph, pairs, call_len, calls);
  const int* row = table + (size_t)ph * map_len;
  bulk::wait(&bar);
  stamp(clock, b, 1);
  for (int c = tid; c < map_len / VEC; c += THREADS) {
    int e[VEC], v[VEC];
    load_map<VEC>(row, c, e);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = e[j] < 0 ? 0 : sm11[e[j]];
    k11_store<VEC, F32>(ext, (size_t)b * map_len + c * VEC, v);
  }
  __syncthreads();
  stamp(clock, b, 2);
}

// a CTA a (station, group of K consecutive pairs, tile): the group's first
// pair's view of the 16 regions, then the K pairs' own soft bits, staged
// once for the group (pair p0 + k sees region ph0 + j, j < k, as pair
// p0 + j's soft bits, staged at (calls + j) L; the host's table for k
// holds that remap: gtable [K, calls, map_len]); the tiles of a group split
// its K rows of outputs, and with MC form a cluster that stages the runs
// once by multicast
template <int K, int TILES, int THREADS, bool MC>
__global__ void __launch_bounds__(THREADS) k11_group(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ gtable,
    int8_t* __restrict__ ext, int8_t* __restrict__ new_internal,
    int* __restrict__ new_phase, int pairs, int call_len, int calls,
    int map_len, unsigned long long* clock) {
  extern __shared__ __align__(16) int8_t smg[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.y / groups, grp = blockIdx.y - s * groups;
  const int cta = blockIdx.y * TILES + tile;
  stamp(clock, cta, 0);
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), phf = pmod(ph0 + p0, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if constexpr (MC) cluster_sync_all();
  if (tid == 0) {
    bulk::expect(&bar, (calls + kn) * call_len);
    for (int q = 0; q < calls + kn; ++q) {
      if (MC && q % TILES != tile) continue;
      const int8_t* src;
      if (q < calls) {
        int d = pmod(phf - q, calls);
        if (d == 0) d = calls;
        const int pp = p0 - d;
        src = pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len;
      } else {
        src = rows + (size_t)(p0 + q - calls) * call_len;
      }
      if constexpr (MC)
        copy_multicast(smg + q * call_len, src, call_len, &bar,
                       (1u << TILES) - 1u);
      else
        bulk::copy(smg + q * call_len, src, call_len, &bar);
    }
  }
  if (tile == 0) {
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k) {
      const int p = p0 + k;
      if (p + calls >= pairs)
        copy16<THREADS>(state + pmod(ph0 + p, calls) * call_len,
                        rows + (size_t)p * call_len, call_len);
    }
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);
      if (k >= pairs && (k - pairs) % groups == grp)
        copy16<THREADS>(state + q * call_len, old + q * call_len, call_len);
    }
    if (grp == 0 && tid == 0) new_phase[s] = pmod(ph0 + pairs, calls);
  }
  const int per = map_len / 16;  // chunks a pair
  const int chunks = kn * per;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  bulk::wait(&bar);
  stamp(clock, cta, 1);
  for (int c = c0 + tid; c < c1; c += THREADS) {
    const int k = c / per, cl = c - k * per;
    const int* row = gtable + ((size_t)k * calls + pmod(phf + k, calls)) *
                                  map_len;
    int e[16], v[16];
    load_map<16>(row, cl, e);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = e[j] < 0 ? 0 : smg[e[j]];
    store_bytes<16>(reinterpret_cast<uint8_t*>(ext) +
                        ((size_t)s * pairs + p0 + k) * map_len + cl * 16,
                    v);
  }
  __syncthreads();
  stamp(clock, cta, 2);
  if constexpr (MC) cluster_sync_all();
}

template <int VEC, int THREADS, bool F32>
__global__ void __launch_bounds__(THREADS) k11_l2(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ table, void* ext,
    int8_t* __restrict__ new_internal, int* __restrict__ new_phase, int pairs,
    int call_len, int calls, int map_len) {
  const int b = blockIdx.x, s = b / pairs, p = b - s * pairs;
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), ph = pmod(ph0 + p, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  k11_state<THREADS>(rows, old, new_internal + (size_t)s * state_len,
                     new_phase, s, p, ph0, ph, pairs, call_len, calls);
  const int* row = table + (size_t)ph * map_len;
  for (int c = threadIdx.x; c < map_len / VEC; c += THREADS) {
    int e[VEC], v[VEC];
    load_map<VEC>(row, c, e);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int a = e[j];
      if (a < 0) {
        v[j] = 0;
      } else if (a >= calls * call_len) {
        v[j] = __ldg(rows + (size_t)p * call_len + a - calls * call_len);
      } else {
        const int q = a / call_len;
        int d = pmod(ph - q, calls);
        if (d == 0) d = calls;
        const int pp = p - d;
        v[j] = pp >= 0 ? __ldg(rows + (size_t)pp * call_len + a - q * call_len)
                       : __ldg(old + a);
      }
    }
    k11_store<VEC, F32>(ext, (size_t)b * map_len + c * VEC, v);
  }
}

template <int VEC, int THREADS, bool F32>
int launch_k11_smem(const void* llr, const void* internal, const void* phase,
                    const void* table, void* ext, void* new_internal,
                    void* new_phase, int n_stations, int pairs, int call_len,
                    int calls, int map_len, unsigned long long* clock,
                    cudaStream_t st) {
  auto kern = k11_smem<VEC, THREADS, F32>;
  const int smem = (calls + 1) * call_len;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_stations * pairs, THREADS, smem, st>>>(
      (const int8_t*)llr, (const int8_t*)internal, (const int*)phase,
      (const int*)table, ext, (int8_t*)new_internal, (int*)new_phase, pairs,
      call_len, calls, map_len, clock);
  return (int)cudaGetLastError();
}

template <int K, int TILES, int THREADS, bool MC>
int launch_k11_group(const void* llr, const void* internal, const void* phase,
                     const void* table, void* ext, void* new_internal,
                     void* new_phase, int n_stations, int pairs, int call_len,
                     int calls, int map_len, unsigned long long* clock,
                     cudaStream_t st) {
  auto kern = k11_group<K, TILES, THREADS, MC>;
  const int smem = (calls + K) * call_len;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(TILES, n_stations * ((pairs + K - 1) / K));
  const int8_t* a = (const int8_t*)llr;
  const int8_t* b = (const int8_t*)internal;
  if constexpr (MC) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = TILES;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, a, b, (const int*)phase,
                             (const int*)table, (int8_t*)ext,
                             (int8_t*)new_internal, (int*)new_phase, pairs,
                             call_len, calls, map_len, clock);
    if (err != cudaSuccess) return (int)err;
  } else {
    kern<<<grid, THREADS, smem, st>>>(a, b, (const int*)phase,
                                      (const int*)table, (int8_t*)ext,
                                      (int8_t*)new_internal, (int*)new_phase,
                                      pairs, call_len, calls, map_len, clock);
  }
  return (int)cudaGetLastError();
}

template <int VEC, int THREADS, bool F32>
int launch_k11_l2(const void* llr, const void* internal, const void* phase,
                  const void* table, void* ext, void* new_internal,
                  void* new_phase, int n_stations, int pairs, int call_len,
                  int calls, int map_len, cudaStream_t st) {
  k11_l2<VEC, THREADS, F32><<<n_stations * pairs, THREADS, 0, st>>>(
      (const int8_t*)llr, (const int8_t*)internal, (const int*)phase,
      (const int*)table, ext, (int8_t*)new_internal, (int*)new_phase, pairs,
      call_len, calls, map_len);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// second round: the staging mode and the gather's form as knobs
//   STAGE 0  bulk copies, one a run, by thread 0 (the TMA);
//         1  cp.async of 16 bytes by every thread, then wait_all;
//         2  bulk copies in pieces of at most PIECE bytes, by warp 0's lanes
//   PRED  no shared-memory load for a punctured entry
//   WORD  the bit from a 4-byte word (e >> 5, e & 31) instead of a byte

constexpr int PIECE = 1152;

template <int STAGE, int THREADS>
struct Stager {
  uint64_t* bar;
  int n = 0;  // runs seen (for STAGE 2's round robin)
  __device__ void begin(uint32_t bytes) {
    if (STAGE != 1 && threadIdx.x == 0) bulk::expect(bar, bytes);
    if (STAGE == 2) __syncwarp();
  }
  __device__ void run(void* dst, const void* src, int bytes) {
    if constexpr (STAGE == 0) {
      if (threadIdx.x == 0) bulk::copy(dst, src, bytes, bar);
    } else if constexpr (STAGE == 1) {
      for (int i = threadIdx.x * 16; i < bytes; i += THREADS * 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         bulk::smem_addr(static_cast<char*>(dst) + i)),
                     "l"(static_cast<const char*>(src) + i)
                     : "memory");
    } else {
      const int pieces = (bytes + PIECE - 1) / PIECE;
      for (int k = 0; k < pieces; ++k, ++n)
        if (threadIdx.x < 32 && (n & 31) == (int)threadIdx.x)
          bulk::copy(static_cast<char*>(dst) + k * PIECE,
                     static_cast<const char*>(src) + k * PIECE,
                     min(PIECE, bytes - k * PIECE), bar);
    }
  }
  __device__ void wait() {
    if constexpr (STAGE == 1) {
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
    } else {
      bulk::wait(bar);
    }
  }
};

template <int TILES, int THREADS, int STAGE, bool PRED, bool WORD, int CUT>
__global__ void __launch_bounds__(THREADS) k15_v2(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const int* __restrict__ map, Lines lines, K15Out o, int n_frames, int m1,
    int m3, int mp, int n_delayed, unsigned long long* clock) {
  extern __shared__ __align__(16) uint8_t sm2[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x, sf = blockIdx.y;
  const int cta = sf * TILES + tile;
  stamp(clock, cta, 0);
  const int s = sf / n_frames, f = sf - s * n_frames;
  const int tid = threadIdx.x;
  const int line_len = n_delayed * SEG;
  const bool staged_lines = f < 3;
  if (STAGE != 1) {
    if (tid == 0) bulk::init(&bar);
    __syncthreads();
  }
  Stager<STAGE, THREADS> st{&bar};
  st.begin(LINE_BASE + (staged_lines ? line_len : 0));
  st.run(sm2, codes + (size_t)sf * FRAME_CODES, FRAME_CODES);
  st.run(sm2 + FRAME_CODES, pids + (size_t)sf * PIDS_BYTES, PIDS_BYTES);
  if (staged_lines)
    for (int d = 0; d < n_delayed; ++d)
      st.run(sm2 + LINE_BASE + d * SEG,
             old_line(lines, d) + (size_t)s * LINE + SEG * f, SEG);
  const int* line_map = map + m1 + m3 + mp;
  if (!staged_lines) {
    const uint8_t* prev = codes + (size_t)(sf - 3) * FRAME_CODES;
    for (int i = tid; i < line_len; i += THREADS) {
      const int e = __ldg(line_map + i);
      sm2[LINE_BASE + i] = (__ldg(prev + (e >> 3)) >> (e & 7)) & 1;
    }
  }
  if (f == 0)
    k15_copy_kept(lines, s, n_frames, n_delayed, tile * THREADS + tid,
                  TILES * THREADS);
  const int total = m1 + m3 + mp + (n_frames - f <= 3 ? line_len : 0);
  const int chunks = total / 16;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  st.wait();
  if (!staged_lines) __syncthreads();
  stamp(clock, cta, 1);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sm2);
  for (int c = c0 + tid; c < c1; c += THREADS) {
    int e[16], bit[16];
    if constexpr (CUT >= 2) {
      // no map load: entries spread over the staged codes
#pragma unroll
      for (int j = 0; j < 16; ++j)
        e[j] = (int)(((unsigned)(c * 16 + j) * 2654435761u) % 204800u);
    } else {
      load_map<16>(map, c, e);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int b = 0;
      if (CUT == 1 || CUT == 3) {
        b = e[j] & 1;  // no shared-memory load
      } else if (!PRED || e[j] >= 0) {
        const int a = e[j] < 0 ? 0 : e[j];
        if constexpr (WORD)
          b = (sw[a >> 5] >> (a & 31)) & 1;
        else
          b = (sm2[a >> 3] >> (a & 7)) & 1;
      }
      bit[j] = b;
    }
    k15_store<16, false>(o, lines, c * 16, sf, s, f, n_frames, m1, m3, mp,
                         bit, e);
  }
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int TILES, int THREADS, int STAGE, bool PRED, bool WORD,
          int CUT = 0>
int launch_k15_v2(const uint8_t* codes, const uint8_t* pids, const int* map,
                  Lines lines, K15Out o, int n_stations, int n_frames, int m1,
                  int m3, int mp, int n_delayed, unsigned long long* clock,
                  cudaStream_t st) {
  auto kern = k15_v2<TILES, THREADS, STAGE, PRED, WORD, CUT>;
  const int smem = LINE_BASE + n_delayed * SEG;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * n_frames), THREADS, smem, st>>>(
      codes, pids, map, lines, o, n_frames, m1, m3, mp, n_delayed, clock);
  return (int)cudaGetLastError();
}

// third round: K15 with the frame's bits unpacked in shared memory as K7
// values, so that an output is one byte load: [6 planes][25600] codes,
// [4 planes][512] PIDS codes and the delayed slices, each byte +1 or -1
// (0x01 / 0xff), and one zero byte for a punctured entry; vmap holds the
// byte addresses.  The codes and PIDS codes come in by 4-byte loads and
// go out unpacked; the line slices by bulk copies, converted in place.
constexpr int VT_PIDS = 6 * FRAME_CODES;       // 153600
constexpr int VT_LINES = VT_PIDS + 4 * PIDS_BYTES;  // 155648

__device__ __forceinline__ uint32_t pm1(uint32_t bits01) {
  return ~(bits01 * 0xfeu);  // bytes 0/1 -> 0xff / 0x01
}

template <int TILES, int THREADS>
__global__ void __launch_bounds__(THREADS) k15_v3(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const int* __restrict__ vmap, const int* __restrict__ map, Lines lines,
    K15Out o, int n_frames, int m1, int m3, int mp, int n_delayed,
    unsigned long long* clock) {
  extern __shared__ __align__(16) uint8_t sv[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x, sf = blockIdx.y;
  const int cta = sf * TILES + tile;
  stamp(clock, cta, 0);
  const int s = sf / n_frames, f = sf - s * n_frames;
  const int tid = threadIdx.x;
  const int line_len = n_delayed * SEG;
  const bool staged_lines = f < 3;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    bulk::expect(&bar, staged_lines ? line_len : 0);
    if (staged_lines)
      for (int d = 0; d < n_delayed; ++d)
        bulk::copy(sv + VT_LINES + d * SEG,
                   old_line(lines, d) + (size_t)s * LINE + SEG * f, SEG,
                   &bar);
  }
  uint32_t* sw = reinterpret_cast<uint32_t*>(sv);
  const uint32_t* cw =
      reinterpret_cast<const uint32_t*>(codes + (size_t)sf * FRAME_CODES);
  for (int i = tid; i < FRAME_CODES / 4; i += THREADS) {
    const uint32_t w = __ldg(cw + i);
#pragma unroll
    for (int p = 0; p < 6; ++p)
      sw[(p * FRAME_CODES) / 4 + i] = pm1((w >> p) & 0x01010101u);
  }
  const uint32_t* pw =
      reinterpret_cast<const uint32_t*>(pids + (size_t)sf * PIDS_BYTES);
  for (int i = tid; i < PIDS_BYTES / 4; i += THREADS) {
    const uint32_t w = __ldg(pw + i);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      sw[(VT_PIDS + p * PIDS_BYTES) / 4 + i] = pm1((w >> p) & 0x01010101u);
  }
  if (tid == 0) sv[VT_LINES + line_len] = 0;  // the punctured entries' byte
  const int* line_map = map + m1 + m3 + mp;
  if (!staged_lines) {
    const uint8_t* prev = codes + (size_t)(sf - 3) * FRAME_CODES;
    for (int i = tid; i < line_len; i += THREADS) {
      const int e = __ldg(line_map + i);
      sv[VT_LINES + i] =
          ((__ldg(prev + (e >> 3)) >> (e & 7)) & 1) ? 0x01 : 0xff;
    }
  }
  if (f == 0)
    k15_copy_kept(lines, s, n_frames, n_delayed, tile * THREADS + tid,
                  TILES * THREADS);
  bulk::wait(&bar);
  if (staged_lines)
    for (int i = tid; i < line_len / 4; i += THREADS)
      sw[VT_LINES / 4 + i] = pm1(sw[VT_LINES / 4 + i]);
  __syncthreads();
  stamp(clock, cta, 1);
  const int total = m1 + m3 + mp + (n_frames - f <= 3 ? line_len : 0);
  const int chunks = total / 16;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  for (int c = c0 + tid; c < c1; c += THREADS) {
    int e[16];
    load_map<16>(vmap, c, e);
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t a = __byte_perm(sv[e[4 * k]], sv[e[4 * k + 1]], 0x0040);
      const uint32_t b =
          __byte_perm(sv[e[4 * k + 2]], sv[e[4 * k + 3]], 0x0040);
      w[k] = __byte_perm(a, b, 0x5410);
    }
    const int m = c * 16;
    uint8_t* dst;
    if (m < m1) {
      dst = static_cast<uint8_t*>(o.p1) + (size_t)sf * m1 + m;
    } else if (m < m1 + m3) {
      dst = static_cast<uint8_t*>(o.p3) + (size_t)sf * m3 + (m - m1);
    } else if (m < m1 + m3 + mp) {
      dst = static_cast<uint8_t*>(o.pids) + (size_t)sf * mp + (m - m1 - m3);
    } else {
      const int i = m - m1 - m3 - mp, d = i / SEG;
      dst = new_line(lines, d) + (size_t)s * LINE + LINE -
            SEG * (n_frames - f) + (i - d * SEG);
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = ~(w[k] >> 1) & 0x01010101u;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int TILES, int THREADS>
int launch_k15_v3(const uint8_t* codes, const uint8_t* pids, const int* vmap,
                  const int* map, Lines lines, K15Out o, int n_stations,
                  int n_frames, int m1, int m3, int mp, int n_delayed,
                  unsigned long long* clock, cudaStream_t st) {
  auto kern = k15_v3<TILES, THREADS>;
  const int smem = VT_LINES + n_delayed * SEG + 16;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * n_frames), THREADS, smem, st>>>(
      codes, pids, vmap, map, lines, o, n_frames, m1, m3, mp, n_delayed,
      clock);
  return (int)cudaGetLastError();
}

// fifth round, K15: the frame's codes and PIDS codes on one barrier, the
// delayed-line slices on a second; the CTA's chunks block-cyclic over the
// tiles (blocks of THREADS chunks), and with TWO the chunks that read no
// delayed bit (P3 in MA1, PIDS, the lines' fresh bits) done before the
// wait for the lines
template <int TILES, int THREADS, bool TWO>
__global__ void __launch_bounds__(THREADS) k15_v5(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const int* __restrict__ map, Lines lines, K15Out o, int n_frames, int m1,
    int m3, int mp, int n_delayed, int p3_reads_lines,
    unsigned long long* clock) {
  extern __shared__ __align__(16) uint8_t s5[];
  __shared__ uint64_t bar[2];
  const int tile = blockIdx.x, sf = blockIdx.y;
  const int cta = sf * TILES + tile;
  stamp(clock, cta, 0);
  const int s = sf / n_frames, f = sf - s * n_frames;
  const int tid = threadIdx.x;
  const int line_len = n_delayed * SEG;
  const bool staged_lines = f < 3;
  if (tid == 0) {
    bulk::init(&bar[0]);
    bulk::init(&bar[1]);
  }
  __syncthreads();
  if (tid == 0) {
    bulk::expect(&bar[0], LINE_BASE);
    bulk::copy(s5, codes + (size_t)sf * FRAME_CODES, FRAME_CODES, &bar[0]);
    bulk::copy(s5 + FRAME_CODES, pids + (size_t)sf * PIDS_BYTES, PIDS_BYTES,
               &bar[0]);
    bulk::expect(&bar[1], staged_lines ? line_len : 0);
    if (staged_lines)
      for (int d = 0; d < n_delayed; ++d)
        bulk::copy(s5 + LINE_BASE + d * SEG,
                   old_line(lines, d) + (size_t)s * LINE + SEG * f, SEG,
                   &bar[1]);
  }
  const int* line_map = map + m1 + m3 + mp;
  if (!staged_lines) {
    const uint8_t* prev = codes + (size_t)(sf - 3) * FRAME_CODES;
    for (int i = tid; i < line_len; i += THREADS) {
      const int e = __ldg(line_map + i);
      s5[LINE_BASE + i] = (__ldg(prev + (e >> 3)) >> (e & 7)) & 1;
    }
  }
  if (f == 0)
    k15_copy_kept(lines, s, n_frames, n_delayed, tile * THREADS + tid,
                  TILES * THREADS);
  const int total = m1 + m3 + mp + (n_frames - f <= 3 ? line_len : 0);
  const int chunks = total / 16;
  // the chunks before `delayed_end` may read a delayed bit
  const int delayed_end = (m1 + (p3_reads_lines ? m3 : 0)) / 16;
  auto work = [&](int c) {
    int e[16], bit[16];
    load_map<16>(map, c, e);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int a = e[j] < 0 ? 0 : e[j];
      bit[j] = (s5[a >> 3] >> (a & 7)) & 1;
    }
    k15_store<16, false>(o, lines, c * 16, sf, s, f, n_frames, m1, m3, mp,
                         bit, e);
  };
  bulk::wait(&bar[0]);
  if (!staged_lines) __syncthreads();
  for (int pass = TWO ? 0 : 1; pass < 2; ++pass) {
    if (pass == 1) {
      bulk::wait(&bar[1]);
      stamp(clock, cta, 1);
    }
    for (int b = tile; b * THREADS < chunks; b += TILES) {
      const int c = b * THREADS + tid;
      if (c >= chunks) break;
      const bool delayed = c < delayed_end;
      if (!TWO || delayed == (pass == 1)) work(c);
    }
  }
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int TILES, int THREADS, bool TWO>
int launch_k15_v5(const uint8_t* codes, const uint8_t* pids, const int* map,
                  Lines lines, K15Out o, int n_stations, int n_frames, int m1,
                  int m3, int mp, int n_delayed, unsigned long long* clock,
                  cudaStream_t st) {
  auto kern = k15_v5<TILES, THREADS, TWO>;
  const int smem = LINE_BASE + n_delayed * SEG;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // MA1 delays ml, mu only, which P3 does not read
  kern<<<dim3(TILES, n_stations * n_frames), THREADS, smem, st>>>(
      codes, pids, map, lines, o, n_frames, m1, m3, mp, n_delayed,
      n_delayed > 2 ? 1 : 0, clock);
  return (int)cudaGetLastError();
}

// sixth round: 3-byte map entries (e + 1 in 24 bits, 0 where punctured;
// 16 entries in 48 bytes, three 16-byte loads), and K11's new state by
// bulk stores from the staged runs
__device__ __forceinline__ void load_map3(const uint8_t* __restrict__ map3,
                                          int c, int (&e)[16]) {
  const uint4* p = reinterpret_cast<const uint4*>(map3) + 3 * c;
  const uint4 a = __ldg(p), b = __ldg(p + 1), d = __ldg(p + 2);
  const uint32_t w[13] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                          d.x, d.y, d.z, d.w, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int byte = 3 * k, q = byte >> 2, r = byte & 3;
    const uint32_t sel = (uint32_t)r | (uint32_t)(r + 1) << 4 |
                         (uint32_t)(r + 2) << 8 | 7u << 12;
    e[k] = (int)(__byte_perm(w[q], w[q + 1], sel) & 0xffffffu) - 1;
  }
}

template <int TILES, int THREADS, bool MAP3, bool NOCOPY>
__global__ void __launch_bounds__(THREADS) k15_v6(
    const uint8_t* __restrict__ codes, const uint8_t* __restrict__ pids,
    const int* __restrict__ map, const uint8_t* __restrict__ map3,
    Lines lines, K15Out o, int n_frames, int m1, int m3, int mp,
    int n_delayed, unsigned long long* clock) {
  extern __shared__ __align__(16) uint8_t s6[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x, sf = blockIdx.y;
  const int cta = sf * TILES + tile;
  stamp(clock, cta, 0);
  const int s = sf / n_frames, f = sf - s * n_frames;
  const int tid = threadIdx.x;
  const int line_len = n_delayed * SEG;
  const bool staged_lines = f < 3;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    bulk::expect(&bar, LINE_BASE + (staged_lines ? line_len : 0));
    bulk::copy(s6, codes + (size_t)sf * FRAME_CODES, FRAME_CODES, &bar);
    bulk::copy(s6 + FRAME_CODES, pids + (size_t)sf * PIDS_BYTES, PIDS_BYTES,
               &bar);
    if (staged_lines)
      for (int d = 0; d < n_delayed; ++d)
        bulk::copy(s6 + LINE_BASE + d * SEG,
                   old_line(lines, d) + (size_t)s * LINE + SEG * f, SEG,
                   &bar);
  }
  const int* line_map = map + m1 + m3 + mp;
  if (!staged_lines) {
    const uint8_t* prev = codes + (size_t)(sf - 3) * FRAME_CODES;
    for (int i = tid; i < line_len; i += THREADS) {
      const int e = __ldg(line_map + i);
      s6[LINE_BASE + i] = (__ldg(prev + (e >> 3)) >> (e & 7)) & 1;
    }
  }
  if (f == 0 && !NOCOPY)
    k15_copy_kept(lines, s, n_frames, n_delayed, tile * THREADS + tid,
                  TILES * THREADS);
  const int total = m1 + m3 + mp + (n_frames - f <= 3 ? line_len : 0);
  const int chunks = total / 16;
  bulk::wait(&bar);
  if (!staged_lines) __syncthreads();
  stamp(clock, cta, 1);
  for (int b = tile; b * THREADS < chunks; b += TILES) {
    const int c = b * THREADS + tid;
    if (c >= chunks) break;
    int e[16], bit[16];
    if constexpr (MAP3)
      load_map3(map3, c, e);
    else
      load_map<16>(map, c, e);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int a = e[j] < 0 ? 0 : e[j];
      bit[j] = (s6[a >> 3] >> (a & 7)) & 1;
    }
    k15_store<16, false>(o, lines, c * 16, sf, s, f, n_frames, m1, m3, mp,
                         bit, e);
  }
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int TILES, int THREADS, bool MAP3, bool NOCOPY>
int launch_k15_v6(const uint8_t* codes, const uint8_t* pids, const int* map,
                  const uint8_t* map3, Lines lines, K15Out o, int n_stations,
                  int n_frames, int m1, int m3, int mp, int n_delayed,
                  unsigned long long* clock, cudaStream_t st) {
  auto kern = k15_v6<TILES, THREADS, MAP3, NOCOPY>;
  const int smem = LINE_BASE + n_delayed * SEG;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * n_frames), THREADS, smem, st>>>(
      codes, pids, map, map3, lines, o, n_frames, m1, m3, mp, n_delayed,
      clock);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(bulk::smem_addr(src)), "r"(bytes)
      : "memory");
}

// K11: v4's merged staging; the new state's regions by bulk stores from
// the staged runs (a pair's own soft bits, or the entry state's region the
// CTA staged); MAP3: the 3-byte table
template <int K, int TILES, int THREADS, bool MAP3>
__global__ void __launch_bounds__(THREADS) k11_v6(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ gtable,
    const uint8_t* __restrict__ gtable3, int8_t* __restrict__ ext,
    int8_t* __restrict__ new_internal, int* __restrict__ new_phase,
    int pairs, int call_len, int calls, int map_len,
    unsigned long long* clock) {
  extern __shared__ __align__(16) int8_t s11[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.y / groups, grp = blockIdx.y - s * groups;
  const int cta = blockIdx.y * TILES + tile;
  stamp(clock, cta, 0);
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), phf = pmod(ph0 + p0, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    bulk::expect(&bar, (calls + kn) * call_len);
    const int8_t* run = nullptr;
    int start = 0;
    for (int q = 0; q <= calls + kn; ++q) {
      const int8_t* src = nullptr;
      if (q < calls) {
        int d = pmod(phf - q, calls);
        if (d == 0) d = calls;
        const int pp = p0 - d;
        src = pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len;
      } else if (q < calls + kn) {
        src = rows + (size_t)(p0 + q - calls) * call_len;
      }
      if (run && src != run + (size_t)(q - start) * call_len) {
        bulk::copy(s11 + start * call_len, run, (q - start) * call_len, &bar);
        run = nullptr;
      }
      if (!run && src) {
        run = src;
        start = q;
      }
    }
  }
  const int per = map_len / 16;
  const int chunks = kn * per;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  bulk::wait(&bar);
  stamp(clock, cta, 1);
  if (tile == 0 && tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k) {
      const int p = p0 + k;
      if (p + calls >= pairs)
        bulk_store(state + pmod(ph0 + p, calls) * call_len,
                   s11 + (calls + k) * call_len, call_len);
    }
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);
      if (k >= pairs && (k - pairs) % groups == grp)
        bulk_store(state + q * call_len, s11 + q * call_len, call_len);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (grp == 0) new_phase[s] = pmod(ph0 + pairs, calls);
  }
  for (int c = c0 + tid; c < c1; c += THREADS) {
    const int k = c / per, cl = c - k * per;
    const size_t row = (size_t)k * calls + pmod(phf + k, calls);
    int e[16], v[16];
    if constexpr (MAP3)
      load_map3(gtable3 + row * map_len * 3, cl, e);
    else
      load_map<16>(gtable + row * map_len, cl, e);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = e[j] < 0 ? 0 : s11[e[j]];
    store_bytes<16>(reinterpret_cast<uint8_t*>(ext) +
                        ((size_t)s * pairs + p0 + k) * map_len + cl * 16,
                    v);
  }
  if (tile == 0 && tid == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int K, int TILES, int THREADS, bool MAP3>
__global__ void __launch_bounds__(THREADS) k11_v9(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ gtable,
    const uint8_t* __restrict__ gtable3, int8_t* __restrict__ ext,
    int8_t* __restrict__ new_internal, int* __restrict__ new_phase,
    int pairs, int call_len, int calls, int map_len,
    unsigned long long* clock) {
  extern __shared__ __align__(16) int8_t s11[];  // v9: cheap plan
  __shared__ uint64_t bar;
  const int tile = blockIdx.x;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.y / groups, grp = blockIdx.y - s * groups;
  const int cta = blockIdx.y * TILES + tile;
  stamp(clock, cta, 0);
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), phf = pmod(ph0 + p0, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    bulk::expect(&bar, (calls + kn) * call_len);
    // region q's source without a modulo a step: d = (phf - q) mod calls
    // (calls where 0) falls by one a region and wraps to calls at q = phf
    const int8_t* run = nullptr;
    int start = 0;
    int d = phf == 0 ? calls : phf;
    for (int q = 0; q <= calls + kn; ++q) {
      const int8_t* src = nullptr;
      if (q < calls) {
        const int pp = p0 - d;
        src = pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len;
        d = d == 1 ? calls : d - 1;
      } else if (q < calls + kn) {
        src = rows + (size_t)(p0 + q - calls) * call_len;
      }
      if (run && src != run + (size_t)(q - start) * call_len) {
        bulk::copy(s11 + start * call_len, run, (q - start) * call_len, &bar);
        run = nullptr;
      }
      if (!run && src) {
        run = src;
        start = q;
      }
    }
  }
  const int per = map_len / 16;
  const int chunks = kn * per;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  bulk::wait(&bar);
  stamp(clock, cta, 1);
  if (tile == 0 && tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k) {
      const int p = p0 + k;
      if (p + calls >= pairs)
        bulk_store(state + pmod(ph0 + p, calls) * call_len,
                   s11 + (calls + k) * call_len, call_len);
    }
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);
      if (k >= pairs && (k - pairs) % groups == grp)
        bulk_store(state + q * call_len, s11 + q * call_len, call_len);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (grp == 0) new_phase[s] = pmod(ph0 + pairs, calls);
  }
  for (int c = c0 + tid; c < c1; c += THREADS) {
    const int k = c / per, cl = c - k * per;
    const size_t row = (size_t)k * calls + pmod(phf + k, calls);
    int e[16], v[16];
    if constexpr (MAP3)
      load_map3(gtable3 + row * map_len * 3, cl, e);
    else
      load_map<16>(gtable + row * map_len, cl, e);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = e[j] < 0 ? 0 : s11[e[j]];
    store_bytes<16>(reinterpret_cast<uint8_t*>(ext) +
                        ((size_t)s * pairs + p0 + k) * map_len + cl * 16,
                    v);
  }
  if (tile == 0 && tid == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int K, int TILES, int THREADS, bool MAP3>
int launch_k11_v9(const void* llr, const void* internal, const void* phase,
                  const void* table, const void* table3, void* ext,
                  void* new_internal, void* new_phase, int n_stations,
                  int pairs, int call_len, int calls, int map_len,
                  unsigned long long* clock, cudaStream_t st) {
  auto kern = k11_v9<K, TILES, THREADS, MAP3>;
  const int smem = (calls + K) * call_len;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * ((pairs + K - 1) / K)), THREADS, smem,
         st>>>((const int8_t*)llr, (const int8_t*)internal,
               (const int*)phase, (const int*)table, (const uint8_t*)table3,
               (int8_t*)ext, (int8_t*)new_internal, (int*)new_phase, pairs,
               call_len, calls, map_len, clock);
  return (int)cudaGetLastError();
}

template <int K, int TILES, int THREADS, bool MAP3>
int launch_k11_v6(const void* llr, const void* internal, const void* phase,
                  const void* table, const void* table3, void* ext,
                  void* new_internal, void* new_phase, int n_stations,
                  int pairs, int call_len, int calls, int map_len,
                  unsigned long long* clock, cudaStream_t st) {
  auto kern = k11_v6<K, TILES, THREADS, MAP3>;
  const int smem = (calls + K) * call_len;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * ((pairs + K - 1) / K)), THREADS, smem,
         st>>>((const int8_t*)llr, (const int8_t*)internal,
               (const int*)phase, (const int*)table, (const uint8_t*)table3,
               (int8_t*)ext, (int8_t*)new_internal, (int*)new_phase, pairs,
               call_len, calls, map_len, clock);
  return (int)cudaGetLastError();
}

// seventh round, K11: v6 (3-byte table, merged copies, the state by bulk
// stores) with the TILES CTAs of a group a cluster that stages the group's
// runs once, each CTA issuing its share of the copies to all (multicast)
template <int K, int TILES, int THREADS>
__global__ void __cluster_dims__(TILES, 1, 1) __launch_bounds__(THREADS)
    k11_v7(const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
           const int* __restrict__ phase, const uint8_t* __restrict__ gtable3,
           int8_t* __restrict__ ext, int8_t* __restrict__ new_internal,
           int* __restrict__ new_phase, int pairs, int call_len, int calls,
           int map_len, unsigned long long* clock) {
  extern __shared__ __align__(16) int8_t s7[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.y / groups, grp = blockIdx.y - s * groups;
  const int cta = blockIdx.y * TILES + tile;
  stamp(clock, cta, 0);
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), phf = pmod(ph0 + p0, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  cluster_sync_all();
  if (tid == 0) {
    bulk::expect(&bar, (calls + kn) * call_len);
    const int8_t* run = nullptr;
    int start = 0, n = 0;
    for (int q = 0; q <= calls + kn; ++q) {
      const int8_t* src = nullptr;
      if (q < calls) {
        int d = pmod(phf - q, calls);
        if (d == 0) d = calls;
        const int pp = p0 - d;
        src = pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len;
      } else if (q < calls + kn) {
        src = rows + (size_t)(p0 + q - calls) * call_len;
      }
      if (run && src != run + (size_t)(q - start) * call_len) {
        // long runs in pieces of at most 4 regions, spread over the CTAs
        for (int a = start; a < q; a += 4, ++n)
          if (n % TILES == tile)
            copy_multicast(s7 + a * call_len,
                           run + (size_t)(a - start) * call_len,
                           min(4, q - a) * call_len, &bar,
                           (1u << TILES) - 1u);
        run = nullptr;
      }
      if (!run && src) {
        run = src;
        start = q;
      }
    }
  }
  const int per = map_len / 16;
  const int chunks = kn * per;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  bulk::wait(&bar);
  stamp(clock, cta, 1);
  if (tile == 0 && tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k) {
      const int p = p0 + k;
      if (p + calls >= pairs)
        bulk_store(state + pmod(ph0 + p, calls) * call_len,
                   s7 + (calls + k) * call_len, call_len);
    }
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);
      if (k >= pairs && (k - pairs) % groups == grp)
        bulk_store(state + q * call_len, s7 + q * call_len, call_len);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (grp == 0) new_phase[s] = pmod(ph0 + pairs, calls);
  }
  for (int c = c0 + tid; c < c1; c += THREADS) {
    const int k = c / per, cl = c - k * per;
    const size_t row = (size_t)k * calls + pmod(phf + k, calls);
    int e[16], v[16];
    load_map3(gtable3 + row * map_len * 3, cl, e);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = e[j] < 0 ? 0 : s7[e[j]];
    store_bytes<16>(reinterpret_cast<uint8_t*>(ext) +
                        ((size_t)s * pairs + p0 + k) * map_len + cl * 16,
                    v);
  }
  if (tile == 0 && tid == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  __syncthreads();
  stamp(clock, cta, 2);
  cluster_sync_all();
}

template <int K, int TILES, int THREADS>
int launch_k11_v7(const void* llr, const void* internal, const void* phase,
                  const void* table3, void* ext, void* new_internal,
                  void* new_phase, int n_stations, int pairs, int call_len,
                  int calls, int map_len, unsigned long long* clock,
                  cudaStream_t st) {
  auto kern = k11_v7<K, TILES, THREADS>;
  const int smem = (calls + K) * call_len;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * ((pairs + K - 1) / K)), THREADS, smem,
         st>>>((const int8_t*)llr, (const int8_t*)internal,
               (const int*)phase, (const uint8_t*)table3, (int8_t*)ext,
               (int8_t*)new_internal, (int*)new_phase, pairs, call_len,
               calls, map_len, clock);
  return (int)cudaGetLastError();
}

// eighth round, K11: the gathers overlap the staging.  Each merged copy
// has its own mbarrier; a pair's non-punctured outputs are listed by the
// staged run they read (host: sorted entries m | offset << 14, and each
// run's first entry), so that the CTA gathers the outputs of a copy's
// runs as soon as that copy lands, into a zeroed row buffer in shared
// memory that bulk stores write out at the end (with the new state)
template <int K, int THREADS>
__global__ void __launch_bounds__(THREADS) k11_v8(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const uint32_t* __restrict__ sorted,
    const int* __restrict__ starts, int n_valid,
    int8_t* __restrict__ ext, int8_t* __restrict__ new_internal,
    int* __restrict__ new_phase, int pairs, int call_len, int calls,
    int map_len, unsigned long long* clock) {
  extern __shared__ __align__(16) int8_t s8[];
  __shared__ uint64_t bars[24];
  __shared__ int cs[24], ce[24], ncopies;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.y / groups, grp = blockIdx.y - s * groups;
  const int cta = blockIdx.y;
  stamp(clock, cta, 0);
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), phf = pmod(ph0 + p0, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  const int nreg = calls + kn;
  int8_t* out = s8 + (calls + K) * call_len;  // K rows of map_len
  auto source = [&](int q) -> const int8_t* {
    if (q < calls) {
      int d = pmod(phf - q, calls);
      if (d == 0) d = calls;
      const int pp = p0 - d;
      return pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len;
    }
    return rows + (size_t)(p0 + q - calls) * call_len;
  };
  if (tid == 0) {
    int n = 0, a = 0;
    for (int q = 1; q <= nreg; ++q)
      if (q == nreg ||
          source(q) != source(a) + (size_t)(q - a) * call_len) {
        cs[n] = a;
        ce[n] = q;
        bulk::init(&bars[n]);
        ++n;
        a = q;
      }
    ncopies = n;
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < ncopies; ++i) {
      bulk::expect(&bars[i], (ce[i] - cs[i]) * call_len);
      bulk::copy(s8 + cs[i] * call_len, source(cs[i]),
                 (ce[i] - cs[i]) * call_len, &bars[i]);
    }
  for (int v = tid; v < kn * map_len / 16; v += THREADS)
    reinterpret_cast<uint4*>(out)[v] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int nstart = calls + K + 1;
  for (int i = 0; i < ncopies; ++i) {
    bulk::wait(&bars[i]);
    for (int k = 0; k < kn; ++k) {
      const size_t row = (size_t)k * calls + pmod(phf + k, calls);
      const int a = __ldg(starts + row * nstart + cs[i]);
      const int b = __ldg(starts + row * nstart + ce[i]);
      const uint32_t* list = sorted + row * n_valid;
      int8_t* o = out + k * map_len;
      for (int j = a + tid; j < b; j += THREADS) {
        const uint32_t w = __ldg(list + j);
        o[w & 16383u] = s8[w >> 14];
      }
    }
  }
  __syncthreads();
  stamp(clock, cta, 1);
  if (tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int k = 0; k < kn; ++k)
      bulk_store(ext + ((size_t)s * pairs + p0 + k) * map_len,
                 out + k * map_len, map_len);
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k) {
      const int p = p0 + k;
      if (p + calls >= pairs)
        bulk_store(state + pmod(ph0 + p, calls) * call_len,
                   s8 + (calls + k) * call_len, call_len);
    }
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);
      if (k >= pairs && (k - pairs) % groups == grp)
        bulk_store(state + q * call_len, s8 + q * call_len, call_len);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (grp == 0) new_phase[s] = pmod(ph0 + pairs, calls);
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int K, int THREADS>
int launch_k11_v8(const void* llr, const void* internal, const void* phase,
                  const void* sorted, const void* starts, int n_valid,
                  void* ext, void* new_internal, void* new_phase,
                  int n_stations, int pairs, int call_len, int calls,
                  int map_len, unsigned long long* clock, cudaStream_t st) {
  auto kern = k11_v8<K, THREADS>;
  const int smem = (calls + K) * call_len + K * map_len;
  if (calls + K > 24) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(1, n_stations * ((pairs + K - 1) / K)), THREADS, smem, st>>>(
      (const int8_t*)llr, (const int8_t*)internal, (const int*)phase,
      (const uint32_t*)sorted, (const int*)starts, n_valid, (int8_t*)ext,
      (int8_t*)new_internal, (int*)new_phase, pairs, call_len, calls,
      map_len, clock);
  return (int)cudaGetLastError();
}

// K11 over a group of K pairs (K = 1: a CTA a pair) with a staging mode
template <int K, int TILES, int THREADS, int STAGE, bool ROT = false>
__global__ void __launch_bounds__(THREADS) k11_v2(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ gtable,
    int8_t* __restrict__ ext, int8_t* __restrict__ new_internal,
    int* __restrict__ new_phase, int pairs, int call_len, int calls,
    int map_len, unsigned long long* clock) {
  extern __shared__ __align__(16) int8_t smv[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.y / groups, grp = blockIdx.y - s * groups;
  const int cta = blockIdx.y * TILES + tile;
  stamp(clock, cta, 0);
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), phf = pmod(ph0 + p0, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  if (STAGE != 1) {
    if (tid == 0) bulk::init(&bar);
    __syncthreads();
  }
  Stager<STAGE, THREADS> st{&bar};
  st.begin((calls + kn) * call_len);
  for (int qi = 0; qi < calls + kn; ++qi) {
    // ROT: each CTA starts at another run, so that the CTAs reading one
    // run at the same moment are fewer
    const int q = ROT ? (qi + cta) % (calls + kn) : qi;
    const int8_t* src;
    if (q < calls) {
      int d = pmod(phf - q, calls);
      if (d == 0) d = calls;
      const int pp = p0 - d;
      src = pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len;
    } else {
      src = rows + (size_t)(p0 + q - calls) * call_len;
    }
    st.run(smv + q * call_len, src, call_len);
  }
  if (tile == 0) {
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k) {
      const int p = p0 + k;
      if (p + calls >= pairs)
        copy16<THREADS>(state + pmod(ph0 + p, calls) * call_len,
                        rows + (size_t)p * call_len, call_len);
    }
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);
      if (k >= pairs && (k - pairs) % groups == grp)
        copy16<THREADS>(state + q * call_len, old + q * call_len, call_len);
    }
    if (grp == 0 && tid == 0) new_phase[s] = pmod(ph0 + pairs, calls);
  }
  const int per = map_len / 16;
  const int chunks = kn * per;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  st.wait();
  stamp(clock, cta, 1);
  for (int c = c0 + tid; c < c1; c += THREADS) {
    const int k = c / per, cl = c - k * per;
    const int* row = gtable + ((size_t)k * calls + pmod(phf + k, calls)) *
                                  map_len;
    int e[16], v[16];
    load_map<16>(row, cl, e);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = e[j] < 0 ? 0 : smv[e[j]];
    store_bytes<16>(reinterpret_cast<uint8_t*>(ext) +
                        ((size_t)s * pairs + p0 + k) * map_len + cl * 16,
                    v);
  }
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int K, int TILES, int THREADS, int STAGE, bool ROT = false>
int launch_k11_v2(const void* llr, const void* internal, const void* phase,
                  const void* table, void* ext, void* new_internal,
                  void* new_phase, int n_stations, int pairs, int call_len,
                  int calls, int map_len, unsigned long long* clock,
                  cudaStream_t st) {
  auto kern = k11_v2<K, TILES, THREADS, STAGE, ROT>;
  const int smem = (calls + K) * call_len;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * ((pairs + K - 1) / K)), THREADS, smem,
         st>>>((const int8_t*)llr, (const int8_t*)internal,
               (const int*)phase, (const int*)table, (int8_t*)ext,
               (int8_t*)new_internal, (int*)new_phase, pairs, call_len,
               calls, map_len, clock);
  return (int)cudaGetLastError();
}

// fourth round: the same staging in as few bulk copies as the runs allow:
// consecutive regions whose sources lie back to back in memory (the pair's
// earlier rows, ascending; the entry state's regions) go in one copy
template <int K, int TILES, int THREADS, int CUT = 0>
__global__ void __launch_bounds__(THREADS) k11_v4(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ gtable,
    int8_t* __restrict__ ext, int8_t* __restrict__ new_internal,
    int* __restrict__ new_phase, int pairs, int call_len, int calls,
    int map_len, unsigned long long* clock) {
  extern __shared__ __align__(16) int8_t sm4[];
  __shared__ uint64_t bar;
  const int tile = blockIdx.x;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.y / groups, grp = blockIdx.y - s * groups;
  const int cta = blockIdx.y * TILES + tile;
  stamp(clock, cta, 0);
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int ph0 = pmod(phase[s], calls), phf = pmod(ph0 + p0, calls);
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    bulk::expect(&bar, (calls + kn) * call_len);
    const int8_t* run = nullptr;
    int start = 0;
    for (int q = 0; q <= calls + kn; ++q) {
      const int8_t* src = nullptr;
      if (q < calls) {
        int d = pmod(phf - q, calls);
        if (d == 0) d = calls;
        const int pp = p0 - d;
        src = pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len;
      } else if (q < calls + kn) {
        src = rows + (size_t)(p0 + q - calls) * call_len;
      }
      if (run && src != run + (size_t)(q - start) * call_len) {
        bulk::copy(sm4 + start * call_len, run, (q - start) * call_len, &bar);
        run = nullptr;
      }
      if (!run && src) {
        run = src;
        start = q;
      }
    }
  }
  auto state_copies = [&]() {
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k) {
      const int p = p0 + k;
      if (p + calls >= pairs)
        copy16<THREADS>(state + pmod(ph0 + p, calls) * call_len,
                        rows + (size_t)p * call_len, call_len);
    }
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);
      if (k >= pairs && (k - pairs) % groups == grp)
        copy16<THREADS>(state + q * call_len, old + q * call_len, call_len);
    }
    if (grp == 0 && tid == 0) new_phase[s] = pmod(ph0 + pairs, calls);
  };
  if (tile == 0 && CUT == 0) state_copies();
  const int per = map_len / 16;
  const int chunks = kn * per;
  const int c0 = chunks * tile / TILES, c1 = chunks * (tile + 1) / TILES;
  bulk::wait(&bar);
  stamp(clock, cta, 1);
  for (int c = c0 + tid; c < c1; c += THREADS) {
    const int k = c / per, cl = c - k * per;
    const int* row = gtable + ((size_t)k * calls + pmod(phf + k, calls)) *
                                  map_len;
    int e[16], v[16];
    load_map<16>(row, cl, e);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = e[j] < 0 ? 0 : sm4[e[j]];
    store_bytes<16>(reinterpret_cast<uint8_t*>(ext) +
                        ((size_t)s * pairs + p0 + k) * map_len + cl * 16,
                    v);
  }
  if (tile == 0 && CUT == 2) state_copies();
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int K, int TILES, int THREADS, int CUT = 0>
int launch_k11_v4(const void* llr, const void* internal, const void* phase,
                  const void* table, void* ext, void* new_internal,
                  void* new_phase, int n_stations, int pairs, int call_len,
                  int calls, int map_len, unsigned long long* clock,
                  cudaStream_t st) {
  auto kern = k11_v4<K, TILES, THREADS, CUT>;
  const int smem = (calls + K) * call_len;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(TILES, n_stations * ((pairs + K - 1) / K)), THREADS, smem,
         st>>>((const int8_t*)llr, (const int8_t*)internal,
               (const int*)phase, (const int*)table, (int8_t*)ext,
               (int8_t*)new_internal, (int*)new_phase, pairs, call_len,
               calls, map_len, clock);
  return (int)cudaGetLastError();
}

// staging alone: each CTA copies `bytes` (from its own source block) into
// shared memory in `copies` bulk copies; clock[3 b + 0/1] entry and landed
template <int TH>
__global__ void __launch_bounds__(TH) stage_only(const uint8_t* src,
                                                  int bytes, int copies,
                                                  int blocks,
                                                  unsigned long long* clock) {
  extern __shared__ __align__(16) uint8_t sb[];
  __shared__ uint64_t bar;
  stamp(clock, blockIdx.x, 0);
  if (threadIdx.x == 0) bulk::init(&bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    bulk::expect(&bar, bytes);
    const uint8_t* from = src + (size_t)(blockIdx.x % blocks) * bytes;
    const int piece = bytes / copies;
    for (int i = 0; i < copies; ++i)
      bulk::copy(sb + i * piece, from + (size_t)i * piece, piece, &bar);
  }
  bulk::wait(&bar);
  stamp(clock, blockIdx.x, 1);
  stamp(clock, blockIdx.x, 2);
}

}  // namespace

// design: see K15_DESIGNS in probes/k11_k15_variants.py; the other
// arguments are the port's am_gather's (outputs float32 where the design
// is a float32 one)
extern "C" int k15_variant(int design, const void* codes, const void* pids,
                           const void* map, const void* ml, const void* mu,
                           const void* eml, const void* emu, void* p1_out,
                           void* p3_out, void* pids_out, void* ml_out,
                           void* mu_out, void* eml_out, void* emu_out,
                           int n_stations, int n_frames, int m1, int m3,
                           int mp, int n_delayed, void* clock, void* stream) {
  unsigned long long* ck = (unsigned long long*)clock;
  Lines lines = {{(const uint8_t*)ml, (const uint8_t*)mu,
                  (const uint8_t*)eml, (const uint8_t*)emu},
                 {(uint8_t*)ml_out, (uint8_t*)mu_out, (uint8_t*)eml_out,
                  (uint8_t*)emu_out}};
  K15Out o = {p1_out, p3_out, pids_out};
  const uint8_t* c = (const uint8_t*)codes;
  const uint8_t* p = (const uint8_t*)pids;
  const int* m = (const int*)map;
  cudaStream_t st = (cudaStream_t)stream;
#define SMEM(T, V, TH, F, FPC)                                            \
  return launch_k15_smem<T, V, TH, F, FPC>(c, p, m, lines, o, n_stations,  \
                                           n_frames, m1, m3, mp,           \
                                           n_delayed, ck, st)
#define MC(T, V, TH)                                                         \
  return launch_k15_mc<T, V, TH>(c, p, m, lines, o, n_stations, n_frames, m1, \
                                 m3, mp, n_delayed, ck, st)
#define L2(V, TH, F)                                                      \
  return launch_k15_l2<V, TH, F>(c, p, m, lines, o, n_stations, n_frames, \
                                 m1, m3, mp, n_delayed, st)
  switch (design) {
    case 0: SMEM(8, 16, 256, false, 1);
    case 1: SMEM(4, 16, 256, false, 1);
    case 2: SMEM(1, 16, 1024, false, 1);
    case 3: SMEM(8, 4, 256, false, 1);
    case 4: SMEM(8, 16, 512, false, 1);
    case 5: SMEM(16, 16, 256, false, 1);
    case 6: SMEM(8, 16, 256, true, 1);
    case 7: SMEM(8, 16, 256, false, 2);
    case 8: L2(4, 256, false);
    case 9: L2(16, 256, false);
    case 10: L2(4, 256, true);
    case 11: {
      const int chunks = (m1 + m3 + mp + n_delayed * SEG) / 4;
      k15_stationary<4, 256><<<(chunks + 255) / 256, 256, 0, st>>>(
          c, p, m, lines, o, n_stations, n_frames, m1, m3, mp, n_delayed);
      return (int)cudaGetLastError();
    }
    case 12: SMEM(4, 16, 512, false, 1);
    case 13: SMEM(4, 8, 512, false, 2);
    case 14: SMEM(8, 8, 256, false, 1);
    case 15: MC(4, 16, 512);
    case 16: MC(8, 16, 256);
    case 17: MC(4, 16, 1024);
    case 18: SMEM(4, 16, 1024, false, 1);
    case 19: MC(8, 16, 512);
    case 20: SMEM(2, 16, 1024, false, 1);
    case 21: MC(2, 16, 1024);
    case 22: MC(4, 8, 1024);
#define V2(T, TH, ST, PR, WD)                                                \
  return launch_k15_v2<T, TH, ST, PR, WD>(c, p, m, lines, o, n_stations,     \
                                          n_frames, m1, m3, mp, n_delayed,   \
                                          ck, st)
    case 23: V2(4, 512, 0, true, false);
    case 24: V2(4, 512, 1, true, false);
    case 25: V2(8, 256, 1, true, false);
    case 26: V2(4, 512, 0, true, true);
    case 27: V2(4, 1024, 1, true, false);
    case 28: V2(8, 512, 1, true, false);
    case 29: V2(4, 512, 2, true, false);
    case 30: V2(4, 512, 1, false, false);
    case 31: V2(8, 256, 1, true, true);
    case 32: V2(4, 512, 1, true, true);
#undef V2
    case 33: return launch_k15_v2<4, 512, 0, false, false, 1>(
        c, p, m, lines, o, n_stations, n_frames, m1, m3, mp, n_delayed, ck,
        st);
    case 34: return launch_k15_v2<4, 512, 0, false, false, 2>(
        c, p, m, lines, o, n_stations, n_frames, m1, m3, mp, n_delayed, ck,
        st);
    case 35: return launch_k15_v2<4, 512, 0, false, false, 3>(
        c, p, m, lines, o, n_stations, n_frames, m1, m3, mp, n_delayed, ck,
        st);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SMEM
#undef MC
#undef L2
}

extern "C" int k11_variant(int design, const void* llr, const void* internal,
                           const void* phase, const void* table, void* ext,
                           void* new_internal, void* new_phase,
                           int n_stations, int pairs, int call_len, int calls,
                           int map_len, void* clock, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* ck = (unsigned long long*)clock;
#define ARGS                                                            \
  llr, internal, phase, table, ext, new_internal, new_phase, n_stations, \
      pairs, call_len, calls, map_len
  switch (design) {
    case 0: return launch_k11_smem<16, 512, false>(ARGS, ck, st);
    case 1: return launch_k11_smem<4, 512, false>(ARGS, ck, st);
    case 2: return launch_k11_smem<16, 256, false>(ARGS, ck, st);
    case 3: return launch_k11_smem<16, 1024, false>(ARGS, ck, st);
    case 4: return launch_k11_smem<16, 512, true>(ARGS, ck, st);
    case 5: return launch_k11_l2<4, 256, false>(ARGS, st);
    case 6: return launch_k11_l2<16, 256, false>(ARGS, st);
    case 7: return launch_k11_l2<4, 256, true>(ARGS, st);
    case 8: return launch_k11_l2<4, 1024, false>(ARGS, st);
    case 9: return launch_k11_smem<8, 512, false>(ARGS, ck, st);
    // the group designs read the group table [K, calls, map_len]
    case 10: return launch_k11_group<2, 1, 512, false>(ARGS, ck, st);
    case 11: return launch_k11_group<2, 1, 1024, false>(ARGS, ck, st);
    case 12: return launch_k11_group<4, 2, 512, false>(ARGS, ck, st);
    case 13: return launch_k11_group<4, 2, 512, true>(ARGS, ck, st);
    case 14: return launch_k11_group<8, 4, 512, true>(ARGS, ck, st);
    case 15: return launch_k11_group<4, 1, 1024, false>(ARGS, ck, st);
    case 16: return launch_k11_group<8, 4, 512, false>(ARGS, ck, st);
    case 17: return launch_k11_group<2, 2, 512, true>(ARGS, ck, st);
    // second round (group table of the design's K)
    case 18: return launch_k11_v2<1, 1, 512, 1>(ARGS, ck, st);
    case 19: return launch_k11_v2<1, 1, 512, 2>(ARGS, ck, st);
    case 20: return launch_k11_v2<2, 1, 512, 1>(ARGS, ck, st);
    case 21: return launch_k11_v2<2, 1, 1024, 1>(ARGS, ck, st);
    case 22: return launch_k11_v2<4, 2, 512, 1>(ARGS, ck, st);
    case 23: return launch_k11_v2<1, 1, 256, 1>(ARGS, ck, st);
    case 24: return launch_k11_v2<2, 1, 512, 2>(ARGS, ck, st);
    case 25: return launch_k11_v2<4, 1, 1024, 1>(ARGS, ck, st);
    case 26: return launch_k11_v2<8, 4, 512, 1>(ARGS, ck, st);
    case 27: return launch_k11_v2<1, 1, 512, 0, true>(ARGS, ck, st);
    case 28: return launch_k11_v2<2, 1, 512, 0, true>(ARGS, ck, st);
    case 29: return launch_k11_v2<1, 1, 256, 0, true>(ARGS, ck, st);
    case 30: return launch_k11_v2<2, 1, 1024, 0, true>(ARGS, ck, st);
    case 31: return launch_k11_v2<4, 2, 512, 0, true>(ARGS, ck, st);
    // fourth round: merged copies
    case 32: return launch_k11_v4<1, 1, 512>(ARGS, ck, st);
    case 33: return launch_k11_v4<2, 1, 512>(ARGS, ck, st);
    case 34: return launch_k11_v4<2, 1, 1024>(ARGS, ck, st);
    case 35: return launch_k11_v4<1, 1, 256>(ARGS, ck, st);
    case 36: return launch_k11_v4<4, 2, 512>(ARGS, ck, st);
    case 37: return launch_k11_v4<1, 1, 1024>(ARGS, ck, st);
    case 38: return launch_k11_v4<2, 2, 512>(ARGS, ck, st);
    case 39: return launch_k11_v4<2, 1, 512, 1>(ARGS, ck, st);
    case 40: return launch_k11_v4<2, 1, 512, 2>(ARGS, ck, st);
    case 41: return launch_k11_v4<1, 1, 512, 1>(ARGS, ck, st);
    case 42: return launch_k11_v4<1, 1, 512, 2>(ARGS, ck, st);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// the value-table designs: vmap as decode_am's map remapped to the table
// (probes/k11_k15_variants.py:value_map), map the composed map
extern "C" int k15_v3_variant(int design, const void* codes, const void* pids,
                              const void* vmap, const void* map,
                              const void* ml, const void* mu, const void* eml,
                              const void* emu, void* p1_out, void* p3_out,
                              void* pids_out, void* ml_out, void* mu_out,
                              void* eml_out, void* emu_out, int n_stations,
                              int n_frames, int m1, int m3, int mp,
                              int n_delayed, void* clock, void* stream) {
  Lines lines = {{(const uint8_t*)ml, (const uint8_t*)mu,
                  (const uint8_t*)eml, (const uint8_t*)emu},
                 {(uint8_t*)ml_out, (uint8_t*)mu_out, (uint8_t*)eml_out,
                  (uint8_t*)emu_out}};
  K15Out o = {p1_out, p3_out, pids_out};
#define V3(T, TH)                                                            \
  return launch_k15_v3<T, TH>((const uint8_t*)codes, (const uint8_t*)pids,  \
                              (const int*)vmap, (const int*)map, lines, o,  \
                              n_stations, n_frames, m1, m3, mp, n_delayed,  \
                              (unsigned long long*)clock, (cudaStream_t)stream)
  switch (design) {
    case 36: V3(4, 512);
    case 37: V3(4, 1024);
    case 38: V3(2, 1024);
    case 39: V3(4, 768);
    case 40: V3(8, 512);
    case 41: V3(3, 1024);
#define V5(T, TH, TWO)                                                      \
  return launch_k15_v5<T, TH, TWO>((const uint8_t*)codes,                   \
                                   (const uint8_t*)pids, (const int*)map,   \
                                   lines, o, n_stations, n_frames, m1, m3,  \
                                   mp, n_delayed,                           \
                                   (unsigned long long*)clock,              \
                                   (cudaStream_t)stream)
    case 42: V5(4, 512, false);
    case 43: V5(4, 512, true);
    case 44: V5(4, 1024, true);
    case 45: V5(8, 256, true);
    case 46: V5(8, 512, true);
#undef V5
    default: return (int)cudaErrorInvalidValue;
  }
#undef V3
}

extern "C" int stage_bench(const void* src, int bytes, int copies,
                           int blocks, int ctas, void* clock, void* stream) {
  const bool big = copies < 0;  // 1024 threads
  if (big) copies = -copies;
  auto kern = big ? stage_only<1024> : stage_only<256>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<ctas, big ? 1024 : 256, bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)src, bytes, copies, blocks,
      (unsigned long long*)clock);
  return (int)cudaGetLastError();
}

// the sixth round's designs: map3 / table3 the 3-byte forms
extern "C" int k15_v6_variant(int design, const void* codes, const void* pids,
                              const void* map, const void* map3,
                              const void* ml, const void* mu, const void* eml,
                              const void* emu, void* p1_out, void* p3_out,
                              void* pids_out, void* ml_out, void* mu_out,
                              void* eml_out, void* emu_out, int n_stations,
                              int n_frames, int m1, int m3, int mp,
                              int n_delayed, void* clock, void* stream) {
  Lines lines = {{(const uint8_t*)ml, (const uint8_t*)mu,
                  (const uint8_t*)eml, (const uint8_t*)emu},
                 {(uint8_t*)ml_out, (uint8_t*)mu_out, (uint8_t*)eml_out,
                  (uint8_t*)emu_out}};
  K15Out o = {p1_out, p3_out, pids_out};
#define V6(T, TH, M3, NC)                                                   \
  return launch_k15_v6<T, TH, M3, NC>(                                      \
      (const uint8_t*)codes, (const uint8_t*)pids, (const int*)map,         \
      (const uint8_t*)map3, lines, o, n_stations, n_frames, m1, m3, mp,     \
      n_delayed, (unsigned long long*)clock, (cudaStream_t)stream)
  switch (design) {
    case 47: V6(4, 512, false, false);
    case 48: V6(4, 512, true, false);
    case 49: V6(4, 512, false, true);
    case 50: V6(4, 1024, true, false);
    case 51: V6(8, 512, true, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef V6
}

extern "C" int k11_v6_variant(int design, const void* llr,
                              const void* internal, const void* phase,
                              const void* table, const void* table3,
                              void* ext, void* new_internal, void* new_phase,
                              int n_stations, int pairs, int call_len,
                              int calls, int map_len, void* clock,
                              void* stream) {
#define V6(K, T, TH, M3)                                                     \
  return launch_k11_v6<K, T, TH, M3>(llr, internal, phase, table, table3,  \
                                     ext, new_internal, new_phase,          \
                                     n_stations, pairs, call_len, calls,    \
                                     map_len, (unsigned long long*)clock,   \
                                     (cudaStream_t)stream)
  switch (design) {
    case 43: V6(2, 1, 512, false);
    case 44: V6(2, 1, 512, true);
    case 45: V6(1, 1, 512, false);
    case 46: V6(1, 1, 512, true);
    case 47: V6(2, 1, 1024, true);
    case 48: V6(4, 2, 512, true);
    case 49: V6(2, 2, 512, true);
    case 50: V6(1, 1, 256, true);
#define V7(K, T, TH)                                                        \
  return launch_k11_v7<K, T, TH>(llr, internal, phase, table3, ext,        \
                                 new_internal, new_phase, n_stations,      \
                                 pairs, call_len, calls, map_len,          \
                                 (unsigned long long*)clock,               \
                                 (cudaStream_t)stream)
    case 51: V7(4, 2, 512);
    case 52: V7(4, 2, 1024);
    case 53: V7(8, 4, 512);
    case 54: V7(8, 4, 1024);
    case 55: V7(2, 2, 1024);
    case 56: V6(2, 1, 1024, true);
    case 62: return launch_k11_v9<2, 1, 1024, true>(
        llr, internal, phase, table, table3, ext, new_internal, new_phase,
        n_stations, pairs, call_len, calls, map_len,
        (unsigned long long*)clock, (cudaStream_t)stream);
    case 63: return launch_k11_v9<1, 1, 512, true>(
        llr, internal, phase, table, table3, ext, new_internal, new_phase,
        n_stations, pairs, call_len, calls, map_len,
        (unsigned long long*)clock, (cudaStream_t)stream);
    case 64: return launch_k11_v9<2, 1, 512, true>(
        llr, internal, phase, table, table3, ext, new_internal, new_phase,
        n_stations, pairs, call_len, calls, map_len,
        (unsigned long long*)clock, (cudaStream_t)stream);
    case 65: return launch_k11_v9<1, 1, 256, true>(
        llr, internal, phase, table, table3, ext, new_internal, new_phase,
        n_stations, pairs, call_len, calls, map_len,
        (unsigned long long*)clock, (cudaStream_t)stream);
#undef V7
    default: return (int)cudaErrorInvalidValue;
  }
#undef V6
}

// the eighth round's designs: sorted [K, calls, n_valid], starts
// [K, calls, calls + K + 1]
extern "C" int k11_v8_variant(int design, const void* llr,
                              const void* internal, const void* phase,
                              const void* sorted, const void* starts,
                              int n_valid, void* ext, void* new_internal,
                              void* new_phase, int n_stations, int pairs,
                              int call_len, int calls, int map_len,
                              void* clock, void* stream) {
#define V8(K, TH)                                                            \
  return launch_k11_v8<K, TH>(llr, internal, phase, sorted, starts, n_valid, \
                              ext, new_internal, new_phase, n_stations,     \
                              pairs, call_len, calls, map_len,              \
                              (unsigned long long*)clock, (cudaStream_t)stream)
  switch (design) {
    case 57: V8(1, 512);
    case 58: V8(1, 1024);
    case 59: V8(2, 512);
    case 60: V8(2, 1024);
    case 61: V8(1, 256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef V8
}

// tenth round, K11: v10 — the table holds only the 2 entries a trellis
// step K7 reads from the call (the third input of a step is punctured, 0),
// table3 [K, calls, 2 steps] packed, so a thread step reads 2 SPC entries
// and writes 3 SPC outputs
template <int K, int THREADS, int SPC, int CUT>
__global__ void __launch_bounds__(THREADS) k11_v10(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const uint8_t* __restrict__ table3,
    int8_t* __restrict__ ext, int8_t* __restrict__ new_internal,
    int* __restrict__ new_phase, int pairs, int call_len, int calls,
    int map_len, unsigned long long* clock) {
  constexpr int NE = 2 * SPC, NO = 3 * SPC;
  extern __shared__ __align__(16) int8_t s10[];
  __shared__ uint64_t bar;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.x / groups, grp = blockIdx.x - s * groups;
  const int cta = blockIdx.x;
  stamp(clock, cta, 0);
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int8_t* rows = llr + (size_t)s * pairs * call_len;
  const int8_t* old = internal + (size_t)s * state_len;
  const int phase_s = phase[s];
  if (tid == 0) {
    bulk::init(&bar);
    bulk::expect(&bar, (calls + kn) * call_len);
    bulk::copy(s10 + calls * call_len, rows + (size_t)p0 * call_len,
               kn * call_len, &bar);
  }
  __syncthreads();
  const int ph0 = pmod(phase_s, calls), phf = pmod(ph0 + p0, calls);
  if (tid == 0) {
    const int8_t* run = nullptr;
    int start = 0;
    int d = phf == 0 ? calls : phf;
    for (int q = 0; q <= calls; ++q) {
      const int8_t* src = nullptr;
      if (q < calls) {
        const int pp = p0 - d;
        src = pp >= 0 ? rows + (size_t)pp * call_len : old + q * call_len;
        d = d == 1 ? calls : d - 1;
      }
      if (run && src != run + (size_t)(q - start) * call_len) {
        bulk::copy(s10 + start * call_len, run, (q - start) * call_len, &bar);
        run = nullptr;
      }
      if (!run && src) {
        run = src;
        start = q;
      }
    }
  }
  const int steps = map_len / 3, per = steps / SPC;  // chunks a pair
  auto row_of = [&](int k) {
    return table3 +
           ((size_t)k * calls + pmod(phf + k, calls)) * (size_t)(2 * steps) * 3;
  };
  auto entries = [&](int c, int (&e)[NE]) {
    if constexpr (CUT >= 2) {
#pragma unroll
      for (int j = 0; j < NE; ++j) e[j] = (c * 37 + j * 4099) & 0xffff;
    } else {
      packed3::load(row_of(c / per), c % per, e);
    }
  };
  int c = tid;
  int e[NE];
  if (c < kn * per) entries(c, e);
  bulk::wait(&bar);
  stamp(clock, cta, 1);
  if (tid == 0) {
    bulk::fence_shared();
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k)
      if (p0 + k + calls >= pairs)
        bulk::store(state + pmod(phf + k, calls) * call_len,
                    s10 + (calls + k) * call_len, call_len);
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);
      if (k >= pairs && (k - pairs) % groups == grp)
        bulk::store(state + q * call_len, s10 + q * call_len, call_len);
    }
    bulk::commit();
    if (grp == 0) new_phase[s] = pmod(ph0 + pairs, calls);
  }
  for (; c < kn * per; c += THREADS) {
    const int k = c / per, cl = c - k * per;
    int nxt[NE];
    const int cn = c + THREADS;
    if (cn < kn * per) entries(cn, nxt);
    uint32_t w[NO / 4];
#pragma unroll
    for (int q = 0; q < NO / 4; ++q) w[q] = 0u;
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int byte = 3 * (j >> 1) + 2 * (j & 1);
      const uint32_t v = CUT & 1 ? (uint32_t)(e[j] & 0xff)
                                 : (uint32_t)(uint8_t)s10[e[j]];
      w[byte >> 2] |= v << (8 * (byte & 3));
    }
    int8_t* dst = ext + ((size_t)s * pairs + p0 + k) * map_len +
                  (size_t)cl * NO;
    if constexpr (SPC == 16) {
      uint4* o = reinterpret_cast<uint4*>(dst);
      o[0] = make_uint4(w[0], w[1], w[2], w[3]);
      o[1] = make_uint4(w[4], w[5], w[6], w[7]);
      o[2] = make_uint4(w[8], w[9], w[10], w[11]);
    } else {
      static_assert(SPC == 8, "8 or 16 steps a thread step");
      uint2* o = reinterpret_cast<uint2*>(dst);
      o[0] = make_uint2(w[0], w[1]);
      o[1] = make_uint2(w[2], w[3]);
      o[2] = make_uint2(w[4], w[5]);
    }
#pragma unroll
    for (int j = 0; j < NE; ++j) e[j] = nxt[j];
  }
  if (tid == 0) bulk::wait_read();
  __syncthreads();
  stamp(clock, cta, 2);
}

template <int K, int THREADS, int SPC, int CUT>
int launch_k11_v10(const void* llr, const void* internal, const void* phase,
                   const void* table3, void* ext, void* new_internal,
                   void* new_phase, int n_stations, int pairs, int call_len,
                   int calls, int map_len, unsigned long long* clock,
                   cudaStream_t st) {
  auto kern = k11_v10<K, THREADS, SPC, CUT>;
  const int smem = (calls + K) * call_len;
  if ((map_len / 3) % SPC) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n_stations * ((pairs + K - 1) / K), THREADS, smem, st>>>(
      (const int8_t*)llr, (const int8_t*)internal, (const int*)phase,
      (const uint8_t*)table3, (int8_t*)ext, (int8_t*)new_internal,
      (int*)new_phase, pairs, call_len, calls, map_len, clock);
  return (int)cudaGetLastError();
}

// the tenth round's designs: table3 [K, calls, 2 steps] packed
extern "C" int k11_v10_variant(int design, const void* llr,
                               const void* internal, const void* phase,
                               const void* table3, void* ext,
                               void* new_internal, void* new_phase,
                               int n_stations, int pairs, int call_len,
                               int calls, int map_len, void* clock,
                               void* stream) {
#define V10(K, TH, SPC, CUT)                                                 \
  return launch_k11_v10<K, TH, SPC, CUT>(                                    \
      llr, internal, phase, table3, ext, new_internal, new_phase,            \
      n_stations, pairs, call_len, calls, map_len,                           \
      (unsigned long long*)clock, (cudaStream_t)stream)
  switch (design) {
    case 66: V10(2, 1024, 8, 0);
    case 67: V10(2, 1024, 16, 0);
    case 68: V10(2, 512, 8, 0);
    case 69: V10(1, 512, 8, 0);
    case 70: V10(4, 1024, 8, 0);
    case 71: V10(2, 1024, 8, 1);
    case 72: V10(2, 1024, 8, 2);
    case 73: V10(2, 1024, 8, 3);
    case 74: V10(1, 1024, 8, 0);
    case 75: V10(4, 1024, 16, 0);
    case 76: V10(2, 768, 8, 0);
    case 77: V10(2, 512, 16, 0);
    case 78: V10(2, 256, 8, 0);
    case 79: V10(2, 512, 8, 0);
    case 80: V10(2, 512, 8, 3);
    case 81: V10(2, 512, 8, 2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef V10
}
