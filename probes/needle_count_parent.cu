// The needle count of K10 as it was before K10's redesign
// (nrsc5_tpu_torch/csrc/needle_count.cu at the parent commit), for
// probes/k10_k16b_variants.py: the cold start's needle count over integer
// CFOs x block offsets, one warp per (station, CFO), reading K3's derot.
//
// Replaces the needle match of the JAX device function
// nrsc5_tpu/ops/acquire_rc.py:detect_cfo_scan_rc (lines 140-157); its
// Costas half is K3 (costas_track.cu) on the n_cfo x n_refs lockstep
// tracks.  Per station s, CFO c and block offset o:
//   sign[k, r]   = Re derot[k, s, c*n_refs + r] > 0      (k < 32 symbols)
//   match[o, r]  = the signs, shifted cyclically by o (sign[(n+o) % 32]),
//                  equal the ref's needle, or its complement, at every
//                  known position n
//   count[s, c, o] = number of refs r that match
//
// Bound on the H100: device-memory bytes (the real halves of derot, 3.4 MB
// for 16 stations); the compare is a few integer operations a (ref,
// offset).  Design: each lane packs one ref's 32 signs into a word; for
// each offset the word is rotated (a funnel shift), held against the
// needle's value and known bit masks in both polarities, and the warp
// counts its matching lanes with __popc(__ballot_sync).  Integer results:
// exact.

#include <cuda_runtime.h>

namespace {

constexpr int NSYM = 32;
constexpr int WARPS = 8;

__global__ void needle_count_kernel(const float2* __restrict__ derot,
                                    const unsigned* __restrict__ needle_vals,
                                    const unsigned* __restrict__ needle_known,
                                    int* __restrict__ count, int n_stations,
                                    int n_cfo, int n_refs) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= n_stations * n_cfo) return;  // whole warps leave together
  const long long n_tracks = (long long)n_stations * n_cfo * n_refs;
  const bool live = lane < n_refs;

  unsigned word = 0, vals = 0, known = 0;
  if (live) {
    const long long track = (long long)w * n_refs + lane;
    for (int k = 0; k < NSYM; ++k)
      word |= (unsigned)(derot[k * n_tracks + track].x > 0.0f) << k;
    vals = needle_vals[lane];
    known = needle_known[lane];
  }
  int mine = 0;
  for (int o = 0; o < NSYM; ++o) {
    // bit n of rot is bit (n + o) % 32 of word
    const unsigned rot = __funnelshift_r(word, word, o);
    const bool eq = ((rot ^ vals) & known) == 0u;
    const bool neq = ((rot ^ ~vals) & known) == 0u;
    const int n = __popc(__ballot_sync(0xffffffffu, live && (eq || neq)));
    if (lane == o) mine = n;
  }
  count[(long long)w * NSYM + lane] = mine;
}

}  // namespace

extern "C" int needle_count_parent(const void* derot, const void* needle_vals,
                            const void* needle_known, void* count,
                            int n_stations, int n_cfo, int n_refs,
                            void* stream) {
  if (n_refs > 32) return (int)cudaErrorInvalidValue;
  const int warps = n_stations * n_cfo;
  dim3 block(32 * WARPS);
  dim3 grid((warps + WARPS - 1) / WARPS);
  needle_count_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float2*)derot, (const unsigned*)needle_vals,
      (const unsigned*)needle_known, (int*)count, n_stations, n_cfo, n_refs);
  return (int)cudaGetLastError();
}
