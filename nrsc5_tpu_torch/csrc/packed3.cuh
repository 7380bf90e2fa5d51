// Tables of 3-byte entries: the form in which K11 (px_deinterleave.cu)
// and K15 (am_gather.cu) read their composed maps from L2.  The host packs
// entry e as e + 1 in 3 little-endian bytes, 0 where punctured
// (ops/decode_fm.py:pack3); these read it back as e, -1 where punctured.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace packed3 {

// entry i
__device__ __forceinline__ int entry(const uint8_t* __restrict__ map3,
                                     int i) {
  const uint8_t* b = map3 + 3 * i;
  return (int)(__ldg(b) | __ldg(b + 1) << 8 | __ldg(b + 2) << 16) - 1;
}

// entries [N c, N (c + 1)): 3 N bytes in 16-byte loads, all issued before
// any is unpacked.  N a multiple of 16, map3 16-byte aligned.
template <int N>
__device__ __forceinline__ void load(const uint8_t* __restrict__ map3, int c,
                                     int (&e)[N]) {
  static_assert(N % 16 == 0, "N entries must fill whole 16-byte loads");
  constexpr int LOADS = 3 * N / 16;
  const uint4* p = reinterpret_cast<const uint4*>(map3) + LOADS * c;
  uint4 v[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) v[i] = __ldg(p + i);
  uint32_t w[4 * LOADS + 1];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    w[4 * i] = v[i].x;
    w[4 * i + 1] = v[i].y;
    w[4 * i + 2] = v[i].z;
    w[4 * i + 3] = v[i].w;
  }
  w[4 * LOADS] = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int byte = 3 * k, q = byte >> 2, r = byte & 3;
    const uint32_t sel = (uint32_t)r | (uint32_t)(r + 1) << 4 |
                         (uint32_t)(r + 2) << 8 | 7u << 12;
    e[k] = (int)(__byte_perm(w[q], w[q + 1], sel) & 0xffffffu) - 1;
  }
}

}  // namespace packed3
