// K16d: the 64-band QMF synthesis fold and the int16 output, for every lane
// and slot of a batch.
//
// Replaces the end of stage 5 of the JAX device function
// nrsc5_tpu/audio/batch.py:164 _make_device_fn -> fn (:484-503), after the
// synthesis modulation V = Xr SMr - Xi SMi (two matrix products and a
// subtraction, torch.matmul): out[s, i] = sum_d Vx[s + 9 - d, cidx[d, i]]
// W[d, i] over the 10 taps d in order, from Vx = [syn_hist (9 slots) | V
// (S slots)] of 128 values a slot; then round half to even and clip to
// int16.  The new history is the last 9 slots of V.
//
// Layout: v f32 [N, S, 128], syn_hist f32 [N, 9, 128], cidx int32 [10,
// 64], w f32 [10, 64].  Out: pcm int16 [N, 64 S], new syn_hist.  v,
// syn_hist and the new history move by bulk copies, so they must be
// 16-byte aligned.
//
// Bound on the H100: device-memory bytes.  At N = 128 and S = 256 it reads
// 16.8 MB of V and writes 4.2 MB of PCM (0.0063 ms at 3.35 TB/s); 20
// operations an output.  Design: one CTA a (lane, tile of 64 slots), the
// tile and the lane in the grid's coordinates (no division).  One thread
// brings the tile's 73 rows of Vx (37 KB: its 64 slots and the 9 before
// them, from syn_hist for the first tile) into shared memory by one or two
// bulk copies, while every thread loads its taps: a thread owns 4 adjacent
// columns of 8 consecutive slots and holds the 10 taps' weights of its
// columns in registers.  With the taps of _synthesis_taps (column c on
// even taps, 64 + c on odd ones), each of the thread's 17 rows is read
// once, by one 16-byte load of each half it needs, and every one of its
// slots that reads the row takes its term from the registers: 34 loads for
// 8 x 10 taps, against 80, which had bound the fold by shared-memory
// bandwidth.  The rows go from the last to the first, so each output still
// meets its taps in the order d = 0..9, and each product and sum is
// rounded apart (-fmad=false), as the plain version's.  Other tap columns
// take the general path, a load a tap and column.  rintf rounds half to
// even, as torch.round, and 4 int16 outputs go out in one 8-byte store.
// The tile that holds the last slot writes the new history from its staged
// rows by one bulk store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int HIST = 9;
constexpr int TAPS = 10;
constexpr int VROW = 128;                          // floats a slot of Vx
constexpr int TILE = 64;                           // slots a CTA
constexpr int COLS = 4;                            // columns a thread
constexpr int SLOTS = 8;                           // slots a thread
constexpr int THREADS = (64 / COLS) * (TILE / SLOTS);  // 128
constexpr int ROWS = TILE + HIST;                  // 73 rows, 37 KB

__device__ __forceinline__ uint32_t pcm_bits(float acc) {
  float r = rintf(acc);
  r = fminf(fmaxf(r, -32768.0f), 32767.0f);
  return (uint32_t)(uint16_t)(int16_t)r;
}

__global__ void __launch_bounds__(THREADS) qmf_synthesis_kernel(
    const float* __restrict__ v, const float* __restrict__ syn_hist,
    const int* __restrict__ cidx, const float* __restrict__ w,
    int16_t* __restrict__ pcm, float* __restrict__ new_hist, int n_slots) {
  __shared__ __align__(16) float vx[ROWS * VROW];
  __shared__ uint64_t bar;
  const int n = blockIdx.x, tid = threadIdx.x;
  const int s0 = blockIdx.y * TILE;
  const int s_end = min(s0 + TILE, n_slots);
  // Vx rows s0 .. s_end + 8 (local rows 0 ..): history rows below 9, V's
  // from 9
  const int h_rows = max(0, HIST - s0);
  const int v_first = max(s0, HIST) - HIST;
  const int v_rows = s_end - v_first;
  if (tid == 0) {
    bulk::init(&bar);
    bulk::expect(&bar, (h_rows + v_rows) * VROW * 4);
    if (h_rows)
      bulk::copy(vx, syn_hist + ((long long)n * HIST + s0) * VROW,
                 h_rows * VROW * 4, &bar);
    bulk::copy(vx + h_rows * VROW,
               v + ((long long)n * n_slots + v_first) * VROW,
               v_rows * VROW * 4, &bar);
  }

  // the thread's columns and slots, and its taps in registers
  const int c0 = (tid % (64 / COLS)) * COLS;
  const int sl0 = (tid / (64 / COLS)) * SLOTS;
  float wr[TAPS][COLS];
  bool paired = true;  // column c on even taps, 64 + c on odd ones
#pragma unroll
  for (int d = 0; d < TAPS; ++d) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      wr[d][j] = __ldg(w + d * 64 + c0 + j);
      paired = paired &&
               __ldg(cidx + d * 64 + c0 + j) == c0 + j + 64 * (d & 1);
    }
  }
  __syncthreads();  // the barrier's init, seen by every thread
  bulk::wait(&bar);

  float acc[SLOTS][COLS];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[q][j] = 0.0f;
  if (paired) {
    // rows sl0 + 16 down to sl0: slot q reads row r at tap d = q + 9 - r
#pragma unroll
    for (int step = 0; step < SLOTS + HIST; ++step) {
      const int r = SLOTS + HIST - 1 - step;
      const int q_lo = r - HIST > 0 ? r - HIST : 0;
      const int q_hi = r < SLOTS - 1 ? r : SLOTS - 1;
      bool even = false, odd = false;
#pragma unroll
      for (int q = q_lo; q <= q_hi; ++q) {
        if ((q + HIST - r) & 1)
          odd = true;
        else
          even = true;
      }
      const float* row = vx + (sl0 + r) * VROW + c0;
      float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
      if (even) lo = *reinterpret_cast<const float4*>(row);
      if (odd) hi = *reinterpret_cast<const float4*>(row + 64);
      const float xl[COLS] = {lo.x, lo.y, lo.z, lo.w};
      const float xh[COLS] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int q = q_lo; q <= q_hi; ++q) {
        const int d = q + HIST - r;
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          acc[q][j] = acc[q][j] + ((d & 1) ? xh[j] : xl[j]) * wr[d][j];
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
#pragma unroll
      for (int d = 0; d < TAPS; ++d) {
        const float* row = vx + (sl0 + q + HIST - d) * VROW;
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          acc[q][j] = acc[q][j] +
                      row[__ldg(cidx + d * 64 + c0 + j)] * wr[d][j];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    const int s = s0 + sl0 + q;
    if (s >= s_end) break;
    uint2 out;
    out.x = pcm_bits(acc[q][0]) | (pcm_bits(acc[q][1]) << 16);
    out.y = pcm_bits(acc[q][2]) | (pcm_bits(acc[q][3]) << 16);
    *reinterpret_cast<uint2*>(pcm + ((long long)n * n_slots + s) * 64 + c0) =
        out;
  }

  if (s_end == n_slots && tid == 0) {
    // the new history, Vx rows n_slots .. n_slots + 8, from the staged rows
    bulk::fence_shared();
    bulk::store(new_hist + (long long)n * HIST * VROW,
                vx + (n_slots - s0) * VROW, HIST * VROW * 4);
    bulk::commit();
    bulk::wait_read();
  }
}

}  // namespace

extern "C" int qmf_synthesis(const void* v, const void* syn_hist,
                             const void* cidx, const void* w, void* pcm,
                             void* new_hist, int n_lanes, int n_slots,
                             void* stream) {
  if (n_lanes <= 0 || n_slots < HIST) return (int)cudaErrorInvalidValue;
  const int tiles = (n_slots + TILE - 1) / TILE;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  qmf_synthesis_kernel<<<dim3((unsigned)n_lanes, (unsigned)tiles), THREADS,
                         0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)syn_hist, (const int*)cidx,
      (const float*)w, (int16_t*)pcm, (float*)new_hist, n_slots);
  return (int)cudaGetLastError();
}
