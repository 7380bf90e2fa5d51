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
// A CTA takes a group of two consecutive pairs p0, p0 + 1 of a station and
// stages in shared memory the runs of L bytes their calls can read: region
// q of the state as p0 sees it at q*L, then the two pairs' own soft bits
// at (calls + k)*L.  Pair p0 + 1 sees region ph0 (p0's phase) as p0's soft
// bits and every other region as p0 does.  Consecutive regions whose
// sources lie back to back in memory (a run of earlier pairs' rows, a run
// of the entry state's regions) go in one bulk copy.  The host composes
// the depuncture, the wrap, read_idx, hazard and that remap into one table
// (ops/decode_fm.py:px_tables).  Of a trellis step's three K7 inputs the
// middle one is punctured at every step, so the table holds the other
// two: T[k][ph][2t + j] is the staged byte K7 input 3t + 2j of pair k of a
// group reads at call phase ph; the kernel reads it packed, e + 1 in 3
// bytes (packed3.cuh), and writes 0 for each middle input.  A pair's K7
// input row, int8, which K7 reads as it is.  The new state: region q is a
// whole copy of the newest pair at phase q's soft bits, or of the old
// region where no pair of the dispatch has phase q: bulk stores from the
// staged runs (a region no pair writes is the entry state's in every
// group's view).  The new phases by one thread a station.
//
// Bound on the H100: device-memory bytes.  MP3, 16 stations x 16 pairs:
// reads 2.36 MB of LLRs, 2.36 MB of state and one 0.45 MB table (a
// phase's row for the first pair of a group), writes 3.6 MB of K7 input in
// int8 and 2.36 MB of state (0.0033 ms at 3.35 TB/s; 0.0065 with float32
// output).  What costs is L2: the groups stage 18 runs of 9216 bytes each
// (21 MB on MP3; each call reads ~576 bytes spread over every 9216-byte
// region, so a gather from L2 would touch as many sectors) and read 7.2 MB
// of table rows.  Design (probes/k11_k15_variants.py): 512 threads a
// group; the group's own soft bits go out first (they need no phase), the
// regions' plan without a division a region; each thread takes 8 trellis
// steps at a time (three 16-byte table loads for 16 entries, its first
// while the copies land, 16 shared-memory byte loads, three 8-byte stores
// of 24 outputs).  Station and group come from the grid: no 64-bit
// division.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "packed3.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int K = 2;       // pairs a CTA
constexpr int STEPS = 8;   // trellis steps a thread step
constexpr int NE = 2 * STEPS, NO = 3 * STEPS;  // its entries, its outputs

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(THREADS) px_deinterleave_kernel(
    const int8_t* __restrict__ llr, const int8_t* __restrict__ internal,
    const int* __restrict__ phase, const uint8_t* __restrict__ table3,
    int8_t* __restrict__ ext, int8_t* __restrict__ new_internal,
    int* __restrict__ new_phase, int pairs, int call_len, int calls,
    int map_len) {
  extern __shared__ __align__(16) int8_t sm[];
  __shared__ uint64_t bar;
  const int groups = (pairs + K - 1) / K;
  const int s = blockIdx.x / groups, grp = blockIdx.x - s * groups;
  const int tid = threadIdx.x;
  const int p0 = grp * K, kn = min(K, pairs - p0);
  const int state_len = calls * call_len;
  const int8_t* rows = llr + (size_t)s * pairs * call_len;  // the station's
  const int8_t* old = internal + (size_t)s * state_len;
  const int phase_s = phase[s];  // its load under the first copy's issue
  if (tid == 0) {
    // the group's own soft bits need no phase: their copy goes out first
    bulk::init(&bar);
    bulk::expect(&bar, (calls + kn) * call_len);
    bulk::copy(sm + calls * call_len, rows + (size_t)p0 * call_len,
               kn * call_len, &bar);
  }
  __syncthreads();
  const int ph0 = pmod(phase_s, calls), phf = pmod(ph0 + p0, calls);
  if (tid == 0) {
    // region q's source: pair p0 - d's soft bits, d = (phf - q) mod calls
    // (calls where 0), which falls by one a region; else the entry state's
    // region q.  A run of sources back to back in memory goes in one copy.
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
        bulk::copy(sm + start * call_len, run, (q - start) * call_len, &bar);
        run = nullptr;
      }
      if (!run && src) {
        run = src;
        start = q;
      }
    }
  }
  const int steps = map_len / 3, per = steps / STEPS;  // chunks a pair
  // each thread's first table entries load while the copies land
  auto row_of = [&](int k) {
    return table3 + ((size_t)k * calls + pmod(phf + k, calls)) * steps * 6;
  };
  int c = tid;
  int e[NE];
  if (c < kn * per) packed3::load(row_of(c / per), c % per, e);
  bulk::wait(&bar);
  if (tid == 0) {
    // the new state from the staged runs, while the gathers run
    bulk::fence_shared();
    int8_t* state = new_internal + (size_t)s * state_len;
    for (int k = 0; k < kn; ++k)
      if (p0 + k + calls >= pairs)  // the newest pair at its phase
        bulk::store(state + pmod(phf + k, calls) * call_len,
                    sm + (calls + k) * call_len, call_len);
    for (int q = 0; q < calls; ++q) {
      const int k = pmod(q - ph0, calls);  // the first pair at phase q
      if (k >= pairs && (k - pairs) % groups == grp)
        bulk::store(state + q * call_len, sm + q * call_len, call_len);
    }
    bulk::commit();
    if (grp == 0) new_phase[s] = pmod(ph0 + pairs, calls);
  }
  for (; c < kn * per; c += THREADS) {
    const int k = c / per, cl = c - k * per;
    int nxt[NE];
    const int cn = c + THREADS;
    if (cn < kn * per) packed3::load(row_of(cn / per), cn % per, nxt);
    // step t's inputs: bytes 3t (entry 2t), 3t + 1 (0), 3t + 2 (entry 2t + 1)
    uint32_t w[NO / 4];
#pragma unroll
    for (int q = 0; q < NO / 4; ++q) w[q] = 0u;
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int byte = 3 * (j >> 1) + 2 * (j & 1);
      w[byte >> 2] |= (uint32_t)(uint8_t)sm[e[j]] << (8 * (byte & 3));
    }
    uint2* dst = reinterpret_cast<uint2*>(
        ext + ((size_t)s * pairs + p0 + k) * map_len + (size_t)cl * NO);
    dst[0] = make_uint2(w[0], w[1]);
    dst[1] = make_uint2(w[2], w[3]);
    dst[2] = make_uint2(w[4], w[5]);
#pragma unroll
    for (int j = 0; j < NE; ++j) e[j] = nxt[j];
  }
  // the stores must have read the staged runs before the CTA leaves
  if (tid == 0) bulk::wait_read();
  __syncthreads();
}

}  // namespace

// llr int8 [S, pairs, call_len]; internal int8 [S, calls * call_len];
// table3 uint8 [2, calls, 2 * steps * 3] (steps = map_len / 3); ext int8
// [S * pairs, map_len]; every pointer 16-byte aligned
extern "C" int px_deinterleave(const void* llr, const void* internal,
                               const void* phase, const void* table3,
                               void* ext, void* new_internal, void* new_phase,
                               int n_stations, int pairs, int call_len,
                               int calls, int map_len, void* stream) {
  const long long smem = (long long)(calls + K) * call_len;
  if (n_stations <= 0 || pairs <= 0 || calls <= 0 || call_len <= 0 ||
      call_len % 16 || map_len <= 0 || map_len % (3 * STEPS) ||
      map_len % 8 || smem > 232448 - 64)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      px_deinterleave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (pairs + K - 1) / K;
  px_deinterleave_kernel<<<n_stations * groups, THREADS, (size_t)smem,
                           (cudaStream_t)stream>>>(
      (const int8_t*)llr, (const int8_t*)internal, (const int*)phase,
      (const uint8_t*)table3, (int8_t*)ext, (int8_t*)new_internal,
      (int*)new_phase, pairs, call_len, calls, map_len);
  return (int)cudaGetLastError();
}
