// K8: the FEC epilogue of the FM and AM logical channels — kept bits,
// re-encode bit errors, descramble, pack.
//
// Replaces the JAX device functions after the Viterbi:
// nrsc5_tpu/ops/convolutional.py:viterbi_decode_chunked's keep-middle
// gather (line 489) and viterbi_decode's wrap drop, reencode_bit_errors
// (line 511; the reference's src/decode.c:234-277), decode_fm.py
// _descramble_dev (line 22) and ops/bits.py:pack_bits (line 22), for P1,
// PIDS, PX and the AM channels alike.
//
// Per frame b: bit t = bits[b, keep[t]] (K7's output, before descrambling);
// with pm (FM P1), the tail-biting re-encode of those bits — the register
// at t holds bits t-6..t mod T, newest at the MSB, output j = parity(reg &
// G_j) — is compared at every unpunctured mother-code site (code_map[3t+j]
// >= 0) with the hard decision pm[code_map[3t+j]] > 0, and the mismatches
// are counted; the output bit is bit t ^ keystream[t], as uint8, or packed
// 8 to a byte little-endian (bit k of byte q = output bit 8q+k).  Integer
// work only: bit-exact against the plain version.
//
// Bound on the H100: device-memory bytes.  P1 at 32 frames reads 5.5 MB of
// K7 bits and 11.8 MB of pm and writes 0.58 MB of packed bits (0.0058 ms at
// 3.35 TB/s).  The P1 interleaver scatters a frame's pm over the whole
// frame, so the forward gather (site -> pm byte) is a scattered one-byte
// read per site.  Design: the gather is inverted.
//   * The kept bits become a bitmap, a warp a group of 8 words: lane l
//     reads bit l of each word from K7's bytes (32 neighbouring bytes a
//     load) and one __ballot_sync makes the word.  keep is a few runs of
//     consecutive K7 bits (127 for P1, the chunk plan's segments; one for
//     PIDS and PX), passed as a run table; a group inside one run takes 8
//     loads at fixed offsets.  The same lanes then write the output, word
//     ^ packed keystream word: a coalesced byte each (packed), or the
//     byte's 8 bits as 8 bytes.
//   * Channels without pm (PIDS, PX, AM) launch one warp a group over every
//     (frame, group) of the call: no shared memory beyond the run table.
//   * FM P1 launches a thread-block cluster of CLUSTER = 8 CTAs a frame.
//     CTA c gathers quads [Q c / 8, Q (c + 1) / 8) of the frame's words
//     into shared memory and writes their output; after a cluster barrier
//     it copies the other slices from its peers' shared memory (distributed
//     shared memory, 16 bytes a load), so K7's bytes are read once.  It
//     then counts the re-encode errors of its 1/8 of the frame's pm, in
//     16-byte chunks, through the inverse site table inv[e] = 3t + j (-1
//     where no site reads entry e): the register t-6..t is a funnel shift
//     of two bitmap words, and a prefix word (the frame's last word) gives
//     the tail-biting wrap, so no site branches.  Lane l takes chunk k + 9 l
//     (LANE_STRIDE): over the P1 interleaver that spreads the 32 lanes'
//     bitmap reads over the banks (neighbouring chunks collide 8 ways).
//     The counts are summed over the warp by shuffles, over the CTA in
//     shared memory, and over the cluster by one shared-memory atomic a
//     CTA into rank 0, which writes errors[b] after a second cluster
//     barrier (integer sums: exact in any order).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COUNT_THREADS = 512;
constexpr int FLAT_THREADS = 256;
constexpr int MAX_RUNS = 256;
constexpr int CLUSTER = 8;  // slices of a frame with pm: one cluster
constexpr int GROUP = 8;    // bitmap words a warp gathers at once
// lane l of a warp counts the 16-byte chunk k + LANE_STRIDE * l: over the
// P1 interleaver's inverse sites the 32 lanes' bitmap words then fall in
// nearly 32 distinct shared-memory banks, where neighbouring chunks
// collide about 8 ways (tests/test_torch_fec_epilogue.py models both)
constexpr int LANE_STRIDE = 9;
// the bitmap in shared memory: frame word w at index OFF + w, the prefix
// word (frame word W-1, the tail-biting wrap) at OFF - 1, a zero word at
// OFF + W (the last funnel shift's right word); OFF = 4 keeps frame words
// 16-byte aligned, and slices are whole quads of words, for the cluster's
// 16-byte copies
constexpr int OFF = 4;

struct Args {
  const uint8_t* bits;       // K7's bits [B, bits_per_frame]
  const int* run_t;          // [n_runs + 1]: first frame bit of each run, T
  const int* run_src;        // [n_runs]: K7 bit of each run's first bit
  const int8_t* pm;          // soft bits (FM P1) or null
  const int* inv;            // [pm_len]: 3t + j of pm entry e, or -1
  const uint32_t* ks;        // packed keystream [W], little-endian bits
  uint8_t* out;              // [B, T] or [B, T/8]
  int* errors;               // [B] with pm
  long long group_stride, frame_stride;
  int bits_per_frame, n_runs, src0, frames_per_group, pm_len;
  int frame_len, words, n_frames, packed;
  uint32_t gens;             // g0 | g1 << 8 | g2 << 16
};

__device__ __forceinline__ int4 load_soft(const int8_t* fpm, bool aligned,
                                          int k) {
  if (aligned) return __ldg(reinterpret_cast<const int4*>(fpm) + k);
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[q] |= (uint32_t)(uint8_t)fpm[16 * k + 4 * q + e] << (8 * e);
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// 1 where the re-encode at ``site`` = 3t + j disagrees with the sign of
// soft byte ``byte`` of ``soft``, 0 there and at site -1.  The register
// t-6..t (bit i = frame bit t-6+i) is bits t-6+32 OFF .. t+32 OFF of the
// bitmap, whose prefix word supplies the wrap for t < 6.
__device__ __forceinline__ int site_error(const uint32_t* bm, int site,
                                          uint32_t soft, int byte,
                                          uint32_t gens) {
  const uint32_t s = (uint32_t)max(site, 0);
  const uint32_t t = __umulhi(s, 0xaaaaaaabu) >> 1;  // s / 3
  const uint32_t j = s - 3 * t;
  const uint32_t u = t - 6 + 32 * OFF;
  const uint32_t reg =
      __funnelshift_r(bm[u >> 5], bm[(u >> 5) + 1], u & 31);
  const uint32_t enc = __popc(reg & (gens >> (8 * j)) & 0x7fu) & 1;
  const int sb = (int)(soft << (24 - 8 * byte)) >> 24;
  return (int)((uint32_t)(sb > 0) ^ enc) & (site >= 0);
}

// the errors of 16-byte chunk k of the frame's pm and its 16 inverse sites
__device__ __forceinline__ int chunk_errors(const uint32_t* bm,
                                            const int8_t* fpm, bool aligned,
                                            const int* inv, int k,
                                            uint32_t gens) {
  const int4 sv = load_soft(fpm, aligned, k);
  const uint32_t soft[4] = {(uint32_t)sv.x, (uint32_t)sv.y, (uint32_t)sv.z,
                            (uint32_t)sv.w};
  const int4* iv = reinterpret_cast<const int4*>(inv) + 4 * k;
  int err = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 site = __ldg(iv + q);
    err += site_error(bm, site.x, soft[q], 0, gens);
    err += site_error(bm, site.y, soft[q], 1, gens);
    err += site_error(bm, site.z, soft[q], 2, gens);
    err += site_error(bm, site.w, soft[q], 3, gens);
  }
  return err;
}

// 8 bits -> 8 bytes of 0/1, bit k to byte k
__device__ __forceinline__ uint2 spread8(uint32_t v) {
  return make_uint2(((v & 0xfu) * 0x00204081u) & 0x01010101u,
                    (((v >> 4) & 0xfu) * 0x00204081u) & 0x01010101u);
}

// a lane's place in the run table: frame bits t < end are K7 bits src + t
struct Cursor {
  int r, end, src;
};

__device__ __forceinline__ Cursor find_run(const int* run_t,
                                           const int* run_src, int n_runs,
                                           int t) {
  int r = 0, hi = n_runs - 1;  // the last run that starts at or before t
  while (r < hi) {
    const int mid = (r + hi + 1) >> 1;
    if (run_t[mid] <= t) r = mid; else hi = mid - 1;
  }
  return {r, run_t[r + 1], run_src[r] - run_t[r]};
}

// a group of GROUP words of one frame, as one warp loads it: lane l holds
// bit l of each word (a K7 byte), and keystream word w + (l & 7)
struct Group {
  uint32_t ks;
  int v[GROUP];
};

// load frame words [w, w + GROUP) below w1, advancing the lane's cursor
__device__ __forceinline__ Group load_group(const Args& a, const int* run_t,
                                            const int* run_src, Cursor& cur,
                                            const uint8_t* fb, int w, int w1,
                                            int lane) {
  Group g;
  g.ks = w + (lane & 7) < w1 ? a.ks[w + (lane & 7)] : 0u;
  const int t0 = 32 * w + lane;
  if (__all_sync(0xffffffffu,
                 w + GROUP <= w1 && t0 + 32 * (GROUP - 1) < cur.end)) {
    const uint8_t* p = fb + cur.src + t0;  // the whole group in one run
#pragma unroll
    for (int i = 0; i < GROUP; ++i) g.v[i] = p[32 * i];
    return g;
  }
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const int t = 32 * (w + i) + lane;
    g.v[i] = 0;
    if (w + i < w1 && t < a.frame_len) {
      while (t >= cur.end) {
        ++cur.r;
        cur.end = run_t[cur.r + 1];
        cur.src = run_src[cur.r] - run_t[cur.r];
      }
      g.v[i] = fb[cur.src + t];
    }
  }
  return g;
}

// the group's words, one ballot each, to ``bm`` (if given) at OFF + w;
// lane l writes output byte 4w + l of frame b (packed), or that byte's 8
// bits as 8 bytes
__device__ __forceinline__ void store_group(const Args& a, const Group& g,
                                            int b, int w, int w1,
                                            uint32_t* bm, int lane) {
  uint32_t mine = 0;  // word lane / 4 of the group
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const uint32_t word = __ballot_sync(0xffffffffu, g.v[i] & 1);
    if (bm != nullptr && lane == i && w + i < w1) bm[OFF + w + i] = word;
    if ((lane >> 2) == i) mine = word;
  }
  const uint32_t x = mine ^ __shfl_sync(0xffffffffu, g.ks, lane >> 2);
  const uint32_t byte = (x >> (8 * (lane & 3))) & 0xffu;
  const int q = 4 * w + lane;
  if (q < 4 * w1 && q < a.frame_len / 8) {
    if (a.packed) {
      a.out[(long long)b * (a.frame_len / 8) + q] = (uint8_t)byte;
    } else {
      reinterpret_cast<uint2*>(a.out + (long long)b * a.frame_len)[q] =
          spread8(byte);
    }
  }
}

__device__ __forceinline__ void stage_runs(const Args& a, int* run_t,
                                           int* run_src) {
  for (int i = threadIdx.x; i <= a.n_runs; i += blockDim.x) {
    run_t[i] = a.run_t[i];
    if (i < a.n_runs) run_src[i] = a.run_src[i];
  }
}

// channels without pm: one warp a group of 8 words of one frame, over
// every (frame, group) of the call; a lone run needs no run table
__global__ void __launch_bounds__(FLAT_THREADS) fec_epilogue_flat_kernel(
    Args a) {
  __shared__ int run_t[MAX_RUNS + 1], run_src[MAX_RUNS];
  const bool runs = a.n_runs > 1;
  if (runs) {
    stage_runs(a, run_t, run_src);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int per_frame = (a.words + GROUP - 1) / GROUP;
  const long long gw = (long long)blockIdx.x * (FLAT_THREADS / 32)
                       + (threadIdx.x >> 5);
  if (gw >= (long long)per_frame * a.n_frames) return;
  const int b = (int)(gw / per_frame);
  const int w = GROUP * (int)(gw - (long long)b * per_frame);
  Cursor cur = runs ? find_run(run_t, run_src, a.n_runs, 32 * w + lane)
                    : Cursor{0, a.frame_len, a.src0};
  const Group g = load_group(a, run_t, run_src, cur,
                             a.bits + (long long)b * a.bits_per_frame, w,
                             a.words, lane);
  store_group(a, g, b, w, a.words, nullptr, lane);
}

// FM P1: the frame's CLUSTER CTAs each gather a slice of its bitmap and
// write that slice's output, share the bitmap, and count the re-encode
// errors of a slice of its pm.  Three CTAs fit an SM (at most 40
// registers), so all 32 clusters of a dispatch's 32 frames are resident at
// once: at two an SM the card's GPCs hold 30.
__global__ void __launch_bounds__(COUNT_THREADS, 3) fec_epilogue_count_kernel(
    Args a) {
  extern __shared__ uint4 bm4[];  // the bitmap (OFF)
  uint32_t* bm = reinterpret_cast<uint32_t*>(bm4);
  __shared__ int run_t[MAX_RUNS + 1], run_src[MAX_RUNS];
  __shared__ int warp_err[COUNT_THREADS / 32];
  __shared__ int cluster_err;

  const int c = blockIdx.x;  // slice
  const int b = blockIdx.y;  // frame
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int warps = COUNT_THREADS / 32;
  const int W = a.words, quads = W / 4;
  const int w0 = 4 * (quads * c / CLUSTER);
  const int w1 = 4 * (quads * (c + 1) / CLUSTER);

  stage_runs(a, run_t, run_src);
  if (tid == 0) {
    cluster_err = 0;
    bm[OFF + W] = 0;
  }
  __syncthreads();

  // the slice's words: each warp a contiguous run of groups
  const int groups = (w1 - w0 + GROUP - 1) / GROUP;
  const int ga = groups * warp / warps, gb = groups * (warp + 1) / warps;
  if (ga < gb) {
    const uint8_t* fb = a.bits + (long long)b * a.bits_per_frame;
    Cursor cur = find_run(run_t, run_src, a.n_runs,
                          32 * (w0 + GROUP * ga) + lane);
    for (int gi = ga; gi < gb; ++gi) {
      const int w = w0 + GROUP * gi;
      const Group g = load_group(a, run_t, run_src, cur, fb, w, w1, lane);
      store_group(a, g, b, w, w1, bm, lane);
    }
  }

  // the rest of the bitmap from the cluster's peers, a quad of words a
  // load (slice c holds quads [Q c / 8, Q (c + 1) / 8)), then the prefix
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int base = tid; base < quads; base += 2 * COUNT_THREADS) {
    uint4 got[2];
    int owner[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = base + u * COUNT_THREADS;
      owner[u] = (CLUSTER * q + CLUSTER - 1) / quads;
      if (q < quads && owner[u] != c)
        got[u] = cluster.map_shared_rank(bm4, owner[u])[OFF / 4 + q];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = base + u * COUNT_THREADS;
      if (q < quads && owner[u] != c) bm4[OFF / 4 + q] = got[u];
    }
  }
  __syncthreads();
  if (tid == 0) bm[OFF - 1] = bm[OFF + W - 1];
  __syncthreads();

  // the re-encode count: lane l of warp-step i counts chunk k0 + 32 S (i /
  // S) + i % S + S l (S = LANE_STRIDE) of the slice [k0, k1)
  const long long g = b / a.frames_per_group;
  const int8_t* fpm = a.pm + g * a.group_stride
                      + (b - g * a.frames_per_group) * a.frame_stride;
  const bool aligned = ((uintptr_t)fpm & 15) == 0;
  const int chunks = a.pm_len / 16;
  const int k0 = (int)((long long)chunks * c / CLUSTER);
  const int k1 = (int)((long long)chunks * (c + 1) / CLUSTER);
  const int steps = (k1 - k0 + 32 * LANE_STRIDE - 1) / (32 * LANE_STRIDE)
                    * LANE_STRIDE;
  int err = 0;
  for (int i = warp; i < steps; i += warps) {
    const int k = k0 + 32 * LANE_STRIDE * (i / LANE_STRIDE)
                  + i % LANE_STRIDE + LANE_STRIDE * lane;
    if (k < k1) err += chunk_errors(bm, fpm, aligned, a.inv, k, a.gens);
  }
  for (int o = 16; o > 0; o >>= 1) err += __shfl_xor_sync(0xffffffffu, err, o);
  if (lane == 0) warp_err[warp] = err;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < warps; ++w) total += warp_err[w];
    atomicAdd(cluster.map_shared_rank(&cluster_err, 0), total);
  }
  cluster.sync();
  if (c == 0 && tid == 0) a.errors[b] = cluster_err;
}

}  // namespace

extern "C" int fec_epilogue(const void* bits, const void* run_t,
                            const void* run_src, int n_runs, int src0,
                            int bits_per_frame, const void* pm,
                            const void* inv, int pm_len,
                            int frames_per_group, long long group_stride,
                            long long frame_stride, const void* keystream,
                            void* out, void* errors, int n_frames,
                            int frame_len, int packed, int g0, int g1,
                            int g2, void* stream) {
  const bool count = pm != nullptr;
  if (n_frames <= 0 || frame_len <= 0 || frame_len % 8 || n_runs <= 0
      || n_runs > MAX_RUNS || frames_per_group <= 0
      || count != (errors != nullptr) || count != (inv != nullptr)
      || (count && (pm_len <= 0 || pm_len % 16 || frame_len % 128)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bits = (const uint8_t*)bits;
  a.run_t = (const int*)run_t;
  a.run_src = (const int*)run_src;
  a.pm = (const int8_t*)pm;
  a.inv = (const int*)inv;
  a.ks = (const uint32_t*)keystream;
  a.out = (uint8_t*)out;
  a.errors = (int*)errors;
  a.group_stride = group_stride;
  a.frame_stride = frame_stride;
  a.bits_per_frame = bits_per_frame;
  a.n_runs = n_runs;
  a.src0 = src0;
  a.frames_per_group = frames_per_group;
  a.pm_len = pm_len;
  a.frame_len = frame_len;
  a.words = (frame_len + 31) / 32;
  a.n_frames = n_frames;
  a.packed = packed;
  a.gens = (uint32_t)(g0 & 0xff) | (uint32_t)(g1 & 0xff) << 8
           | (uint32_t)(g2 & 0xff) << 16;
  cudaStream_t st = (cudaStream_t)stream;
  if (!count) {
    const long long warps =
        (long long)(a.words + GROUP - 1) / GROUP * n_frames;
    const long long blocks = (warps + FLAT_THREADS / 32 - 1)
                             / (FLAT_THREADS / 32);
    fec_epilogue_flat_kernel<<<(unsigned)blocks, FLAT_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  // the bitmap: OFF words, the frame's W (a whole number of quads), one
  // zero word, padded to a quad
  const size_t smem = (size_t)(OFF + a.words + 4) * sizeof(uint32_t);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fec_epilogue_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, n_frames);
  cfg.blockDim = dim3(COUNT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fec_epilogue_count_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
