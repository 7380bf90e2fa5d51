// K11: the FM P3/P4 interleaver-IV deinterleave with carried state, the
// P3/P4 depuncture and the tail-biting wrap extension, for every block pair
// of a dispatch in one launch.
//
// Replaces the JAX device functions nrsc5_tpu/ops/decode_fm.py:px_iv_call
// (line 106) under the sequential pair scan of
// nrsc5_tpu/pipeline/scan_chain.py:px_scan_pairs (line 81, decode=False),
// and the wrap extension px_fec's Viterbi adds (line 131).
//
// The reference calls the deinterleaver once per block pair p, in order,
// at call phase ph = (phase0 + p) mod calls: position i of the call reads
// the N-entry state at r = read_idx[ph*L + i] (L = 2*frame_len) — the call's
// own fresh soft bit r - ph*L where hazard[ph*L + i] is set — and after the
// reads the call writes its L soft bits over region ph of the state.  The
// state enters only through that static permutation, and region q is
// written only by calls at phase q, so no loop is needed: pair p reading
// r in region q sees the newest pair p' < p of this dispatch at phase q
// (p' = p - d, d = (ph - q) mod calls, or calls where that is 0), else the
// state the dispatch began with; the new state at r is the newest pair of
// the dispatch at phase q, else the old state.  That holds for any number
// of pairs, more than a cycle included.
//
// Work: blocks [0, ext_blocks) write K7's input ext [S*P, (frame_len+64)*3]
// f32, element e reading call position k7_map[e] (the P3/P4 depuncture and
// the wrap composed on the host; -1 = punctured, 0.0); the other blocks
// write the new state [S, N] int8, and thread 0 of the first of them the
// new phases.  Every ext value is exactly float(int8) or 0.0, so K7's path
// metrics stay integers.
//
// Bound on the H100: device-memory bytes.  MP3, 16 stations x 16 pairs:
// reads 2.36 MB of LLRs, 2.36 MB of state and 0.6 MB of read_idx, writes
// 14.4 MB of K7 input and 2.36 MB of state (0.0066 ms at 3.35 TB/s).
// Design: one thread per output element, grid-stride, coalesced stores;
// the state and LLR reads are a gather through read_idx.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(THREADS) px_deinterleave_kernel(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const int* __restrict__ read_idx,
    const uint8_t* __restrict__ hazard, const int* __restrict__ k7_map,
    float* __restrict__ ext, int8_t* __restrict__ new_internal,
    int* __restrict__ new_phase, int n_stations, int pairs, int frame_len,
    int state_len, int calls, int map_len, int ext_blocks) {
  const int call_len = 2 * frame_len;
  if ((int)blockIdx.x < ext_blocks) {
    const long long total = (long long)n_stations * pairs * map_len;
    for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x;
         e < total; e += (long long)ext_blocks * THREADS) {
      const long long b = e / map_len;  // s * pairs + p
      const int m = (int)(e - b * map_len);
      const int s = (int)(b / pairs), p = (int)(b - (long long)s * pairs);
      const int i = k7_map[m];
      float v = 0.0f;
      if (i >= 0) {
        const int ph = pmod(phase[s] + p, calls);
        const int c = ph * call_len + i;
        const int r = read_idx[c];
        const int8_t* sl = llr + (long long)s * pairs * call_len;
        int8_t x;
        if (hazard[c]) {
          x = sl[(long long)p * call_len + (r - ph * call_len)];
        } else {
          const int q = r / call_len;
          int d = pmod(ph - q, calls);
          if (d == 0) d = calls;
          const int pp = p - d;
          x = pp >= 0 ? sl[(long long)pp * call_len + (r - q * call_len)]
                      : internal[(long long)s * state_len + r];
        }
        v = (float)x;
      }
      ext[e] = v;
    }
    return;
  }
  const int sb = blockIdx.x - ext_blocks, state_blocks = gridDim.x - ext_blocks;
  if (sb == 0 && threadIdx.x == 0)
    for (int s = 0; s < n_stations; ++s)
      new_phase[s] = pmod(phase[s] + pairs, calls);
  const long long total = (long long)n_stations * state_len;
  for (long long e = sb * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)state_blocks * THREADS) {
    const int s = (int)(e / state_len);
    const int r = (int)(e - (long long)s * state_len);
    const int q = r / call_len;
    const int k = pmod(q - phase[s], calls);  // first pair at phase q
    int8_t x;
    if (k < pairs) {
      const int pp = k + calls * ((pairs - 1 - k) / calls);  // the newest
      x = llr[((long long)s * pairs + pp) * call_len + (r - q * call_len)];
    } else {
      x = internal[e];
    }
    new_internal[e] = x;
  }
}

}  // namespace

extern "C" int px_deinterleave(const void* llr, const void* internal,
                               const void* phase, const void* read_idx,
                               const void* hazard, const void* k7_map,
                               void* ext, void* new_internal, void* new_phase,
                               int n_stations, int pairs, int frame_len,
                               int state_len, int calls, int map_len,
                               void* stream) {
  if (n_stations <= 0 || pairs <= 0 || calls <= 0 ||
      state_len != calls * 2 * frame_len)
    return (int)cudaErrorInvalidValue;
  const long long ext_total = (long long)n_stations * pairs * map_len;
  const long long state_total = (long long)n_stations * state_len;
  long long eb = (ext_total + THREADS - 1) / THREADS;
  long long sb = (state_total + THREADS - 1) / THREADS;
  if (eb > 132 * 24) eb = 132 * 24;
  if (sb > 132 * 8) sb = 132 * 8;
  px_deinterleave_kernel<<<(int)(eb + sb), THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const int8_t*)llr, (const int8_t*)internal, (const int*)phase,
      (const int*)read_idx, (const uint8_t*)hazard, (const int*)k7_map,
      (float*)ext, (int8_t*)new_internal, (int*)new_phase, n_stations, pairs,
      frame_len, state_len, calls, map_len, (int)eb);
  return (int)cudaGetLastError();
}
