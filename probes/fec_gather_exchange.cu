// A design tried for K6's P1 gather (nrsc5_tpu_torch/csrc/fec_gather.cu),
// kept so that probes/k6_k9_variants.py can time it against the kernel the
// port runs: a thread-block cluster of K6_CLUSTER CTAs a frame (8 or 16,
// set with -DK6_CLUSTER=n) that exchange soft bits in 16-byte packets by
// distributed shared memory, then write the outputs from what they
// received.  Its host tables (send map, perm, meta) are built by
// probes/k6_k9_variants.py:exchange_tables.
//
// CTA c brings slice c of the frame's pm (368640 / K6_CLUSTER contiguous
// bytes) into shared memory in one bulk copy (bulk_copy.cuh).  After a
// cluster barrier it sends each CTA d (itself too) the soft bits of its
// slice that d's outputs read, each once: a warp a tile of 512 sorted
// offsets (the send map, two 16-byte loads a lane), lane l gathering
// entries l + 32 e and storing its 16 bytes into d's receive buffer in one
// 16-byte distributed-shared-memory store.  After a second cluster barrier
// each CTA writes its share of the frame's outputs (bounds multiples of
// 16), a warp a tile of 496 output bytes at 16-byte aligned addresses: a
// lane gathers a 16-entry chunk of perm (receive-buffer positions; a
// punctured site points at a zero byte past the buffer) into the warp's
// staging, and 31 lanes store an aligned group each, read from the staging
// at the frame's offset.  As many clusters run as the card holds at once,
// each taking its frames in turn.
//
// pm is [G, F, 368640] int8 with strides (group, frame); out is [G*F,
// 511683] int8, 16-byte aligned: the output of
// nrsc5_tpu_torch.ops.decode_fm.fec_gather(pm, "p1").

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../nrsc5_tpu_torch/csrc/bulk_copy.cuh"

namespace cg = cooperative_groups;

#ifndef K6_CLUSTER
#define K6_CLUSTER 16
#endif

namespace {

constexpr int CLUSTER = K6_CLUSTER;  // CTAs a P1 frame
// 16: 256 threads, four CTAs an SM; 8: 512 threads, two an SM
constexpr int P1_THREADS = CLUSTER >= 16 ? 256 : 512;
constexpr int P1_MIN_BLOCKS = CLUSTER >= 16 ? 4 : 2;
constexpr int TILE = 512;   // bytes a warp a step: 16 a lane
// a CTA's row of the plan: its part's start in the send map and its tile
// count, where each destination's tiles start (CLUSTER + 1), where each
// destination's receive buffer takes them (CLUSTER), its output bounds (2)
constexpr int META_PREFIX = 2;
constexpr int META_RECV = META_PREFIX + CLUSTER + 1;
constexpr int META_BOUNDS = META_RECV + CLUSTER;
constexpr int META = 40;
static_assert(META_BOUNDS + 2 <= META, "a CTA's row of the plan");
constexpr int PERM_LEAD = 16;  // zero-slot entries ahead of perm
constexpr int OUT_TILE = TILE - 16;  // output bytes a warp a step: 31
                                    // aligned groups from 32 chunks

struct Args {
  const int8_t* pm;
  const void* map;     // uint16 perm
  const int* aux;      // meta [CLUSTER][META], then the uint16 send map
  int8_t* out;
  long long group_stride, frame_stride;
  int frames_per_group, n_frames, pm_len, map_len, aux_len, recv_bytes;
};

__device__ __forceinline__ const int8_t* frame_pm(const Args& a, int b) {
  const int g = b / a.frames_per_group;
  return a.pm + g * a.group_stride
         + (long long)(b - g * a.frames_per_group) * a.frame_stride;
}

// the async proxy (the bulk copy) after this CTA's generic writes to shared
// memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(bulk::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 16 bytes into rank `rank`'s copy of the shared-memory address `addr`
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, uint32_t rank,
                                              const uint4& w) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile(
      "st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(remote),
      "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
      : "memory");
}

// 16 bytes of the frame's output at out + pos (16-byte aligned), little-
// endian in w: one store where all lie inside [lo, hi), else byte stores of
// those that do
__device__ __forceinline__ void store16(int8_t* out, long long pos,
                                        long long lo, long long hi,
                                        const uint4& w) {
  if (pos >= lo && pos + 16 <= hi) {
    *reinterpret_cast<uint4*>(out + pos) = w;
  } else {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (pos + e >= lo && pos + e < hi)
        out[pos + e] = (int8_t)(ws[e >> 2] >> (8 * (e & 3)));
  }
}

// the 16 bytes at s + 16 q (16-byte aligned) gathered through 16 uint16
// offsets into src, little-endian
__device__ __forceinline__ uint4 gather16(const uint8_t* src, int4 o0,
                                          int4 o1) {
  const uint32_t ow[8] = {(uint32_t)o0.x, (uint32_t)o0.y, (uint32_t)o0.z,
                          (uint32_t)o0.w, (uint32_t)o1.x, (uint32_t)o1.y,
                          (uint32_t)o1.z, (uint32_t)o1.w};
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    w[e >> 2] |= (uint32_t)src[(ow[e >> 1] >> (16 * (e & 1))) & 0xffffu]
                 << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(P1_THREADS, P1_MIN_BLOCKS) fec_gather_p1_kernel(
    Args a) {
  // slice c of the frame's pm (after the sends, the write phase's staging),
  // then the receive buffer
  extern __shared__ int4 smem[];
  __shared__ int meta[META];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = a.pm_len / CLUSTER;
  uint8_t* slice_s = reinterpret_cast<uint8_t*>(smem);
  const uint8_t* recv_s = slice_s + slice;
  if (tid == 0) bulk::init(&bar);
  if (tid < META) meta[tid] = __ldg(a.aux + META * c + tid);
  // the zero slot past the receive buffer, where perm sends punctured sites
  if (tid < 16) slice_s[slice + a.recv_bytes + tid] = 0;
  __syncthreads();

  // frames b, b + clusters, ...: a cluster takes its frames in turn
  const int clusters = gridDim.x / CLUSTER;
  for (int b = blockIdx.x / CLUSTER, it = 0; b < a.n_frames;
       b += clusters, ++it) {
    // the slice: one bulk copy where it is 16-byte aligned (the chain's pm
    // is), else byte loads.  The last frame's write phase, which staged in
    // the slice's space, is over (__syncthreads below it)
    const int8_t* src = frame_pm(a, b) + (long long)c * slice;
    if (((uintptr_t)src & 15) == 0) {
      if (tid == 0) {
        fence_proxy_async();  // after the last frame's staging writes
        bulk::expect(&bar, slice);
        bulk::copy(smem, src, slice, &bar);
      }
      wait_parity(&bar, it & 1);
    } else {
      if (tid == 0) bulk::expect(&bar, 0);  // the phase completes at once
      for (int i = tid; i < slice; i += P1_THREADS) slice_s[i] = src[i];
      wait_parity(&bar, it & 1);
    }
    // every slice loaded and every CTA past its last frame's write phase, so
    // that its receive buffer may be written
    cluster.sync();

    // send: tile t of this CTA's part goes to the CTA d whose list holds it;
    // lane l's 16 offsets (entries l + 32 e) lie at 16 l of the tile
    const uint16_t* send =
        reinterpret_cast<const uint16_t*>(a.aux + META * CLUSTER) + meta[0];
    const uint32_t recv_addr = bulk::smem_addr(recv_s);
    // each warp's next tile's offsets come in while it sends the current
    constexpr int WARPS = P1_THREADS / 32;
    const int n_tiles = meta[1];
    auto offsets = [&](int t, int4 (&o)[2]) {
      if (t < n_tiles) {
        const int4* sp = reinterpret_cast<const int4*>(
            send + (long long)t * TILE + 16 * lane);
        o[0] = __ldg(sp);
        o[1] = __ldg(sp + 1);
      }
    };
    int4 nxt[2];
    offsets(warp, nxt);
    for (int t = warp; t < n_tiles; t += WARPS) {
      const uint4 w = gather16(slice_s, nxt[0], nxt[1]);
      offsets(t + WARPS, nxt);
      int d = 0;
#pragma unroll
      for (int q = 1; q < CLUSTER; ++q) d += meta[META_PREFIX + q] <= t;
      const int dst = meta[META_RECV + d]
                      + (t - meta[META_PREFIX + d]) * TILE + 16 * lane;
      st_cluster_v4(recv_addr + dst, d, w);
    }
    cluster.sync();  // every receive buffer whole

    // write: outputs [bounds[c], bounds[c + 1]) of the frame, a warp a tile
    // of 496 bytes (31 groups) at 16-byte aligned addresses.  The 32
    // 16-entry chunks of perm from the one holding the tile's first byte
    // (frame positions) are gathered a lane a chunk into the warp's staging
    // (where the slice was), then lane l < 31 stores aligned group l, 16
    // bytes read from the staging at the tile's offset in its first chunk
    const uint16_t* perm = static_cast<const uint16_t*>(a.map) + PERM_LEAD;
    const long long lo = (long long)b * a.map_len;
    const long long r0 = lo + meta[META_BOUNDS];
    const long long r1 = lo + meta[META_BOUNDS + 1];
    const long long a0 = r0 & ~15LL, a1 = (r1 + 15) & ~15LL;
    const int tiles = (int)((a1 - a0 + OUT_TILE - 1) / OUT_TILE);
    uint8_t* st = slice_s + TILE * warp;
    // each warp's next tile's chunk of perm comes in while it writes the
    // current
    auto chunk = [&](int tile, int4 (&o)[2]) {
      if (tile < tiles) {
        // from -15: perm has PERM_LEAD entries ahead
        const int ms = (int)(a0 + (long long)tile * OUT_TILE - lo);
        const int4* pp =
            reinterpret_cast<const int4*>(perm + 16 * ((ms >> 4) + lane));
        o[0] = __ldg(pp);
        o[1] = __ldg(pp + 1);
      }
    };
    int4 pn[2];
    chunk(warp, pn);
    for (int tile = warp; tile < tiles; tile += WARPS) {
      const long long p0 = a0 + (long long)tile * OUT_TILE;
      const int r = (int)(p0 - lo) & 15;
      *reinterpret_cast<uint4*>(st + 16 * lane) =
          gather16(recv_s, pn[0], pn[1]);
      chunk(tile + WARPS, pn);
      __syncwarp();
      const uint32_t* sw =
          reinterpret_cast<const uint32_t*>(st + 16 * lane + (r & ~3));
      uint32_t x[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) x[i] = sw[i];
      const uint32_t sh = 8 * (r & 3);
      const uint4 w = make_uint4(__funnelshift_r(x[0], x[1], sh),
                                 __funnelshift_r(x[1], x[2], sh),
                                 __funnelshift_r(x[2], x[3], sh),
                                 __funnelshift_r(x[3], x[4], sh));
      if (lane < OUT_TILE / 16) store16(a.out, p0 + 16 * lane, r0, r1, w);
      __syncwarp();
    }
    __syncthreads();  // the staging free for the next frame's slice
  }
}

}  // namespace

// map: perm (uint16, PERM_LEAD zero-slot entries ahead); aux: meta, then the
// send map (aux_len int32 words); recv_bytes: the largest receive buffer
extern "C" int fec_gather_exchange(const void* pm, const void* map,
                                   const void* aux, void* out, int n_groups,
                                   int frames_per_group,
                                   long long group_stride,
                                   long long frame_stride, int pm_len,
                                   int map_len, int aux_len, int recv_bytes,
                                   void* stream) {
  if (n_groups <= 0 || frames_per_group <= 0 || map_len <= 0 || pm_len <= 0
      || aux == nullptr || map == nullptr || recv_bytes <= 0
      || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long frames = (long long)n_groups * frames_per_group;
  if (frames > (1 << 30)) return (int)cudaErrorInvalidValue;
  if (pm_len % (16 * CLUSTER) || pm_len / CLUSTER < TILE * P1_THREADS / 32
      || aux_len < META * CLUSTER || recv_bytes % 16 || recv_bytes >= 0xffff)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pm = (const int8_t*)pm;
  a.map = map;
  a.aux = (const int*)aux;
  a.out = (int8_t*)out;
  a.group_stride = group_stride;
  a.frame_stride = frame_stride;
  a.frames_per_group = frames_per_group;
  a.n_frames = (int)frames;
  a.pm_len = pm_len;
  a.map_len = map_len;
  a.aux_len = aux_len;
  a.recv_bytes = recv_bytes;
  const size_t smem = (size_t)(pm_len / CLUSTER) + (size_t)recv_bytes + 16;
  cudaError_t err = cudaFuncSetAttribute(
      fec_gather_p1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fec_gather_p1_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(P1_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as the card holds at once, each taking the same number
  // of frames (give or take one)
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, fec_gather_p1_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int rounds = (a.n_frames + resident - 1) / resident;
  cfg.gridDim = dim3(CLUSTER * ((a.n_frames + rounds - 1) / rounds));
  err = cudaLaunchKernelEx(&cfg, fec_gather_p1_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
