// A design tried for K6's P1 gather (nrsc5_tpu_torch/csrc/fec_gather.cu),
// kept so that probes/k6_k9_variants.py can time it against the kernel the
// port runs: a thread-block cluster of CLUSTER CTAs a frame (2, 4 or 8, set
// with -DCLUSTER=n), gathering every output byte from the owning CTA's
// shared memory by distributed shared memory.
//
// CTA c of frame b's cluster loads slice c of the frame's pm (368640 /
// CLUSTER contiguous bytes) into shared memory with 16-byte loads.  After a
// cluster barrier it writes its share of the frame's output groups (16
// outputs at a 16-byte aligned address, one store a thread a group), each
// byte pm[map[m]] or 0 where map[m] < 0, read from CTA map[m] / slice (a
// constant divide) at map[m] % slice.  A second cluster barrier keeps every
// slice alive until the last peer has read it.
//
// pm is [G, F, 368640] int8 with strides (group, frame); map is K6's
// k7_map (int32 [511683]); out is [G*F, 511683] int8, 16-byte aligned:
// the output of nrsc5_tpu_torch.ops.decode_fm.fec_gather(pm, "p1").

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#ifndef CLUSTER
#define CLUSTER 8
#endif

namespace {

constexpr int FRAME = 368640;  // soft bits a P1 frame
constexpr int SLICE = FRAME / CLUSTER;
constexpr int THREADS = 512;
static_assert(SLICE * CLUSTER == FRAME && SLICE % 16 == 0, "16-byte loads");

// the byte at shared address `addr` of cluster rank `rank`
__device__ __forceinline__ uint32_t ld_cluster_u8(uint32_t addr,
                                                  uint32_t rank) {
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u8 %0, [%1];"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v & 0xffu;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    fec_gather_cluster_kernel(const int8_t* __restrict__ pm,
                              const int* __restrict__ map,
                              int8_t* __restrict__ out,
                              long long group_stride, long long frame_stride,
                              int frames_per_group, int map_len) {
  extern __shared__ int4 slice_s[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / CLUSTER;
  const int g = b / frames_per_group;
  const int8_t* src = pm + g * group_stride
                      + (long long)(b - g * frames_per_group) * frame_stride
                      + (long long)c * SLICE;
  if (((uintptr_t)src & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int i = threadIdx.x; i < SLICE / 16; i += THREADS)
      slice_s[i] = __ldg(s4 + i);
  } else {
    int8_t* s1 = reinterpret_cast<int8_t*>(slice_s);
    for (int i = threadIdx.x; i < SLICE; i += THREADS) s1[i] = src[i];
  }
  cluster.sync();  // every slice loaded

  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(slice_s));
  const long long lo = (long long)b * map_len, hi = lo + map_len;
  const long long a0 = lo & ~15LL;
  const long long groups = ((((hi + 15) & ~15LL) - a0) >> 4);
  const long long q0 = groups * c / CLUSTER;
  const long long q1 = groups * (c + 1) / CLUSTER;
  for (long long q = q0 + threadIdx.x; q < q1; q += THREADS) {
    const long long p = a0 + 16 * q;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const long long m = p + e - lo;
      if (m >= 0 && m < map_len) {
        const int s = __ldg(map + m);
        if (s >= 0) {
          const int owner = s / SLICE;
          w[e >> 2] |= ld_cluster_u8(base + (s - owner * SLICE), owner)
                       << (8 * (e & 3));
        }
      }
    }
    if (p >= lo && p + 16 <= hi) {
      *reinterpret_cast<uint4*>(out + p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {  // a group shared with the frame before or after
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (p + e >= lo && p + e < hi)
          out[p + e] = (int8_t)(w[e >> 2] >> (8 * (e & 3)));
    }
  }
  cluster.sync();  // no slice leaves while a peer may read it
}

}  // namespace

extern "C" int fec_gather_cluster(const void* pm, const void* map, void* out,
                                  int n_groups, int frames_per_group,
                                  long long group_stride,
                                  long long frame_stride, int map_len,
                                  void* stream) {
  if (n_groups <= 0 || frames_per_group <= 0 || map_len <= 0
      || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const long long frames = (long long)n_groups * frames_per_group;
  if (frames * CLUSTER > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fec_gather_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SLICE);
  if (err != cudaSuccess) return (int)err;
  fec_gather_cluster_kernel<<<(unsigned)(frames * CLUSTER), THREADS, SLICE,
                              (cudaStream_t)stream>>>(
      (const int8_t*)pm, (const int*)map, (int8_t*)out, group_stride,
      frame_stride, frames_per_group, map_len);
  return (int)cudaGetLastError();
}
