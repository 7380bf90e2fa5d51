// The port's K16a (window, overlap-add and QMF32 analysis) as it stood
// before its redesign, kept to time it against the port's kernel
// (probes/k12_k16a_variants.py): one CTA of 256 threads per (lane,
// packet), each thread summing 8 outputs over the 320 taps with a shared
// load of ext and a read-only load of KA a multiply-add.  Built with
// -DEXT_ONLY it builds ext and writes one ext sample an output in place of
// the tap loop, so that the tap loop's time is the whole's less that.  The
// rest of the file is the source it came from, its entry point renamed.

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
// operations, 0.020 ms at 67 TFLOP/s); it reads 8.4 MB of long products,
// 8.4 MB of short products and writes 8.4 MB of xl (0.0075 ms at 3.35
// TB/s).  Design: one CTA per (lane, packet).  The CTA builds the 1312
// samples of ext that its 32 slots read (window, short placement and
// overlap-add computed per sample, no [N, S, 320] window gather in device
// memory) in shared memory, then each thread sums the 320 taps of 8
// outputs in tap order, reading KA through the read-only cache (80 KB,
// over the 64 KB of constant memory; no table is a local array).
// Consecutive threads take consecutive k, so the KA reads coalesce and the
// ext reads broadcast.  -fmad=false keeps each product and sum rounded
// apart, as the plain PyTorch version rounds them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NSLOT = 32;
constexpr int TAPS = 320;
constexpr int QA_HIST = 288;           // TAPS - 32
constexpr int EXT = 32 * NSLOT + QA_HIST;  // 1312 samples a packet reads
constexpr int SHORT_OFF = 448;
constexpr int SHORT_LEN = 128;

// sample t in [0, 2048) of packet kk's windowed IMDCT output
__device__ __forceinline__ float windowed(
    const float* __restrict__ long_raw, const float* __restrict__ short_raw,
    const uint8_t* __restrict__ win_long_idx,
    const uint8_t* __restrict__ win_short_idx,
    const uint8_t* __restrict__ is_short,
    const float* __restrict__ lut_long, const float* __restrict__ lut_short,
    long long lk, int t) {
  if (!is_short[lk]) {
    return long_raw[lk * 2048 + t] *
           __ldg(lut_long + (int)win_long_idx[lk] * 2048 + t);
  }
  // the short windows cover [448 + 128 w, 448 + 128 w + 256); add in
  // window order onto 0, as the reference's scatter-adds do
  const int wi = (int)win_short_idx[lk];
  float acc = 0.0f;
  for (int w = 0; w < 8; ++w) {
    const int u = t - (SHORT_OFF + SHORT_LEN * w);
    if (u >= 0 && u < 256) {
      acc = acc + short_raw[(lk * 8 + w) * 256 + u] *
                      __ldg(lut_short + (wi * 8 + w) * 256 + u);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS) window_qmf_analysis_kernel(
    const float* __restrict__ long_raw, const float* __restrict__ short_raw,
    const uint8_t* __restrict__ win_long_idx,
    const uint8_t* __restrict__ win_short_idx,
    const uint8_t* __restrict__ is_short, const float* __restrict__ overlap,
    const float* __restrict__ qa_hist, const float* __restrict__ lut_long,
    const float* __restrict__ lut_short, const float* __restrict__ ka,
    float* __restrict__ xl, float* __restrict__ new_overlap,
    float* __restrict__ new_qa, int n_packets) {
  __shared__ float ext[EXT];
  const int k = blockIdx.x % n_packets;
  const long long n = blockIdx.x / n_packets;
  const long long lane_pk = n * n_packets;
  // ext[1024 k + e] for e in [0, 1312): qa_hist, or core of packet k - 1
  // or k (core = windowed[:1024] + previous windowed[1024:] or overlap)
  for (int e = threadIdx.x; e < EXT; e += THREADS) {
    const int g = 1024 * k + e;
    float v;
    if (g < QA_HIST) {
      v = qa_hist[n * QA_HIST + g];
    } else {
      const int c = g - QA_HIST;
      const int kk = c >> 10;
      const int i = c & 1023;
      const float head =
          windowed(long_raw, short_raw, win_long_idx, win_short_idx,
                   is_short, lut_long, lut_short, lane_pk + kk, i);
      const float tail =
          kk == 0 ? overlap[n * 1024 + i]
                  : windowed(long_raw, short_raw, win_long_idx,
                             win_short_idx, is_short, lut_long, lut_short,
                             lane_pk + kk - 1, 1024 + i);
      v = head + tail;
    }
    ext[e] = v;
  }
  __syncthreads();
  // 32 slots x 64 outputs, 8 a thread; tap order
  for (int o = threadIdx.x; o < NSLOT * 64; o += THREADS) {
    const int s = o >> 6;
    const int col = o & 63;
    const float* x = ext + 32 * s;
#ifdef EXT_ONLY
    const float acc = x[col];
#else
    float acc = 0.0f;
    for (int tau = 0; tau < TAPS; ++tau) {
      acc = acc + x[tau] * __ldg(ka + tau * 64 + col);
    }
#endif
    xl[((lane_pk + k) * NSLOT + s) * 64 + col] = acc;
  }
  if (k == n_packets - 1) {
    for (int i = threadIdx.x; i < 1024; i += THREADS) {
      new_overlap[n * 1024 + i] =
          windowed(long_raw, short_raw, win_long_idx, win_short_idx,
                   is_short, lut_long, lut_short, lane_pk + k, 1024 + i);
    }
    // the last 288 samples of ext are the new history
    for (int i = threadIdx.x; i < QA_HIST; i += THREADS) {
      new_qa[n * QA_HIST + i] = ext[1024 + i];
    }
  }
}

}  // namespace

extern "C" int aac_window_qmf_analysis_parent(
    const void* long_raw, const void* short_raw, const void* win_long_idx,
    const void* win_short_idx, const void* is_short, const void* overlap,
    const void* qa_hist, const void* lut_long, const void* lut_short,
    const void* ka, void* xl, void* new_overlap, void* new_qa, int n_lanes,
    int n_packets, void* stream) {
  if (n_lanes <= 0 || n_packets <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n_lanes * n_packets;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_qmf_analysis_kernel<<<(int)blocks, THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const float*)long_raw, (const float*)short_raw,
      (const uint8_t*)win_long_idx, (const uint8_t*)win_short_idx,
      (const uint8_t*)is_short, (const float*)overlap,
      (const float*)qa_hist, (const float*)lut_long,
      (const float*)lut_short, (const float*)ka, (float*)xl,
      (float*)new_overlap, (float*)new_qa, n_packets);
  return (int)cudaGetLastError();
}
