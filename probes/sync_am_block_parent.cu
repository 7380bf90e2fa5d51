// The port's K13 (the AM sync block) as it stood before its redesign,
// kept to time it against the port's kernel
// (probes/am_tone_k13_variants.py): one CTA per station, the whole 32 x
// 256 block (64 KB) in shared memory.  Built with -DLOAD_ONLY it stops
// after the load, so that the later phases' time is the whole's less
// that.  The rest of the file is the source it came from.

// K13: the AM sync block — sideband combine, reference bits, PIDS and
// partition training mults, sample-clock regression, interpolated
// equalizer and the QAM64/QAM16/QPSK Gray demaps, MA1 and MA3.
//
// Replaces the JAX device function
// nrsc5_tpu/pipeline/scan_chain_am_rc.py:143 sync_am_block_rc (with the
// tables and demaps of nrsc5_tpu/ops/sync_am.py:35-82, the interpolated
// equalizer AM_EQ_INTERP on), for all stations of a dispatch at once.
//
// spectra [S, 32, 256, 2] f32 (fftshifted, bin 128 the carrier) ->
//   codes [S, 4, 800] uint8 (pl, pu, s, t in (symbol, column) order),
//   pids [S, 32, 2] uint8, ref_bits [S, 32] uint8, samperr [S] int32.
// In order: the lower sideband (bins 128-81..128-1) negate-conjugated; in
// MA1 bins 128+1..128+53 add their mirror.  ref_bits = Im(bin 129) > 0.  A
// PIDS column's mult = 2*TRAIN_QAM16 / (row 8 + row 24) and a partition
// column's = 2*nominal / (row TRAIN1 + row TRAIN2), true divisions.
// samperr = round((sum wrap_half_pi(d arg pl) + sum wrap_half_pi(d arg pu))
// / 48 * 256 / 2pi), half to even.  Per partition the anchors lo = row
// min(TRAIN1, TRAIN2) and hi = 16 rows later give dphi = wrap_pi(arg lo -
// arg hi) and w = sqrt(|lo|^2 |hi|^2) + 1e-12; a w-weighted linear fit
// over the 25 columns gives fit(col), and symbol row r is equalized by
// mult * e^{i u fit}, u = (r - a_lo - 8) / 16, then demapped.  Every sum
// runs from the first column to the last, as the plain version's do; the
// build passes -fmad=false.
//
// Bound on the H100: device-memory bytes.  A block at 16 stations reads
// 1.05 MB of spectra and writes 53 KB (3200 codes, 64 PIDS codes, 32
// reference bits and a 4-byte samperr a station; about 0.00033 ms at 3.35
// TB/s); the arithmetic (~3200 equalized values a station, each a sincos
// and a few products) is far under the card's f32 rate.  Design: one CTA per
// station, the block's 32 x 256 spectra in 64 KB of shared memory; the
// 100 column mults and fits one thread each, the per-partition sums one
// thread each in column order, then one thread per output code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FFT = 256;
constexpr int NSYM = 32;
constexpr int W = 25;
constexpr int C = FFT / 2;
constexpr int MAX_INDEX = 81;
constexpr int PIDS_OUTER = 53;
constexpr int THREADS = 256;
constexpr float PI = 3.141592653589793f;
constexpr float TWO_PI = 6.283185307179586f;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// a / b as mul_conj(a, b) / |b|^2
__device__ __forceinline__ float2 cdiv(float2 a, float2 b) {
  const float d = b.x * b.x + b.y * b.y;
  return make_float2((a.x * b.x + a.y * b.y) / d, (a.y * b.x - a.x * b.y) / d);
}

__device__ __forceinline__ float abs2(float2 a) { return a.x * a.x + a.y * a.y; }

__device__ __forceinline__ float wrap_half_pi(float d) {
  return d - PI * rintf(d / PI);
}

__device__ __forceinline__ float wrap_pi(float d) {
  return d - TWO_PI * rintf(d / TWO_PI);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Gray demap: QAM64 (levels 8), QAM16 (4) or the QPSK signs (2).  The
// Gray tables (0,4,6,2,3,7,5,1 and 0,2,3,1) are packed into integers so
// that no table lives in local memory
__device__ __forceinline__ uint8_t demap(float2 z, int levels) {
  if (levels == 2) return (uint8_t)((z.x >= 0.0f) | ((z.y >= 0.0f) << 1));
  const int half = levels / 2;
  const int re = clampi((int)floorf(z.x) + half, 0, levels - 1);
  const int im = clampi((int)floorf(z.y) + half, 0, levels - 1);
  if (levels == 8) {
    constexpr unsigned G8 = 0x15732640u;  // nibble i = GRAY8[i]
    return (uint8_t)(((G8 >> (4 * re)) & 7) | (((G8 >> (4 * im)) & 7) << 3));
  }
  constexpr unsigned G4 = 0x78u;  // 2-bit field i = GRAY4[i]
  return (uint8_t)(((G4 >> (2 * re)) & 3) | (((G4 >> (2 * im)) & 3) << 2));
}

struct Partition {
  int first, step, levels;
  float2 nominal;  // 2 * the training point
};

// the data partitions in output order pl, pu, s, t (p = 0..3)
__device__ __forceinline__ Partition partition(int p, bool ma3) {
  const float2 q64 = make_float2(5.0f, -5.0f);
  if (ma3) {
    const int first = p == 0 ? C - 2 : p == 1 ? C + 2 : p == 2 ? C + 28
                                                                : C - 28;
    return {first, (p == 0 || p == 3) ? -1 : 1, 8, q64};
  }
  const int first = p == 0 ? C - 57 : p == 1 ? C + 57 : p == 2 ? C + 28
                                                              : C + 2;
  const int levels = p < 2 ? 8 : p == 2 ? 4 : 2;
  const float2 nominal = p < 2 ? q64
                         : p == 2 ? make_float2(3.0f, -1.0f)
                                  : make_float2(-1.0f, 1.0f);
  return {first, p == 0 ? -1 : 1, levels, nominal};
}

__global__ void __launch_bounds__(THREADS) sync_am_block_kernel(
    const float2* __restrict__ spectra, uint8_t* __restrict__ codes,
    uint8_t* __restrict__ pids, uint8_t* __restrict__ ref_bits,
    int* __restrict__ samperr, int ma3) {
  extern __shared__ float2 buf[];  // [32][256]
  __shared__ float2 mult[4][W];
  __shared__ float dph[4][W], wt[4][W], ang[2][W];
  __shared__ float fit_c[4], fit_d[4], fit_b[4];
  __shared__ float2 pids_mult[2];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const float2* in = spectra + (long long)s * NSYM * FFT;

  for (int i = tid; i < NSYM * FFT; i += THREADS) {
    float2 v = in[i];
    const int k = i & (FFT - 1);
    if (k >= C - MAX_INDEX && k <= C - 1) v.x = -v.x;  // -conj(v)
    buf[i] = v;
  }
  __syncthreads();
#ifdef LOAD_ONLY
  // the load alone; one read keeps every store to shared memory live
  if (tid == 0) samperr[s] = (int)buf[(s * 37) % (NSYM * FFT)].x;
  return;
#endif
  if (!ma3) {
    for (int i = tid; i < NSYM * PIDS_OUTER; i += THREADS) {
      const int r = i / PIDS_OUTER, j = 1 + i % PIDS_OUTER;
      buf[r * FFT + C + j] = cadd(buf[r * FFT + C + j], buf[r * FFT + C - j]);
    }
    __syncthreads();
  }

  const int pids_bin0 = ma3 ? C - 27 : C + 27;  // the two PIDS columns
  const int pids_bin1 = ma3 ? C + 27 : C + 53;
  if (tid < NSYM) {
    ref_bits[s * NSYM + tid] = buf[tid * FFT + C + 1].y > 0.0f;
  } else if (tid < NSYM + 2) {
    const int b = tid == NSYM ? pids_bin0 : pids_bin1;
    pids_mult[tid - NSYM] = cdiv(make_float2(3.0f, -1.0f),
                                 cadd(buf[8 * FFT + b], buf[24 * FFT + b]));
  } else if (tid >= 64 && tid < 64 + 4 * W) {
    const int p = (tid - 64) / W, col = (tid - 64) % W;
    const Partition pt = partition(p, ma3);
    const int bin = pt.first + pt.step * col;
    const int t1 = (5 + 11 * col) % 32, t2 = (21 + 11 * col) % 32;
    const float2 m = cdiv(pt.nominal, cadd(buf[t1 * FFT + bin],
                                           buf[t2 * FFT + bin]));
    mult[p][col] = m;
    const int a_lo = min(t1, t2);
    const float2 lo = buf[a_lo * FFT + bin], hi = buf[(a_lo + 16) * FFT + bin];
    dph[p][col] = wrap_pi(atan2f(lo.y, lo.x) - atan2f(hi.y, hi.x));
    wt[p][col] = sqrtf(abs2(lo) * abs2(hi)) + 1e-12f;
    if (p < 2) ang[p][col] = atan2f(m.y, m.x);
  }
  __syncthreads();

  if (tid < 4) {
    // the partition's weighted linear fit, sums in column order
    const int p = tid;
    float sw = wt[p][0], swc = wt[p][0] * 0.0f, swd = wt[p][0] * dph[p][0];
    for (int c = 1; c < W; ++c) {
      sw = sw + wt[p][c];
      swc = swc + wt[p][c] * (float)c;
      swd = swd + wt[p][c] * dph[p][c];
    }
    const float cbar = swc / sw, dbar = swd / sw;
    float sn = 0.0f, sq = 0.0f;
    for (int c = 0; c < W; ++c) {
      const float xc = (float)c - cbar;
      const float n = wt[p][c] * xc * (dph[p][c] - dbar);
      const float q = wt[p][c] * (xc * xc);
      sn = c ? sn + n : n;
      sq = c ? sq + q : q;
    }
    fit_c[p] = cbar;
    fit_d[p] = dbar;
    fit_b[p] = sn / (sq + 1e-12f);
  } else if (tid == 4) {
    float dp = 0.0f, du = 0.0f;
    for (int c = 0; c < W - 1; ++c) {
      const float a = wrap_half_pi(ang[0][c + 1] - ang[0][c]);
      const float b = wrap_half_pi(ang[1][c + 1] - ang[1][c]);
      dp = c ? dp + a : a;
      du = c ? du + b : b;
    }
    samperr[s] = (int)rintf((((dp + du) / 48.0f) * 256.0f) / TWO_PI);
  } else if (tid >= NSYM && tid < 3 * NSYM) {
    const int r = (tid - NSYM) >> 1, k = (tid - NSYM) & 1;
    pids[s * 2 * NSYM + r * 2 + k] =
        demap(cmul(buf[r * FFT + (k ? pids_bin1 : pids_bin0)], pids_mult[k]),
              4);
  }
  __syncthreads();

  for (int i = tid; i < 4 * NSYM * W; i += THREADS) {
    const int p = i / (NSYM * W), q = i % (NSYM * W);
    const int r = q / W, col = q % W;
    const Partition pt = partition(p, ma3);
    const float xc = (float)col - fit_c[p];
    const float fit = fit_d[p] + fit_b[p] * xc;
    const int a_lo = min((5 + 11 * col) % 32, (21 + 11 * col) % 32);
    const float u = (float)(r - a_lo - 8) / 16.0f;
    const float th = u * fit;
    const float2 m = cmul(mult[p][col], make_float2(cosf(th), sinf(th)));
    const float2 z = cmul(buf[r * FFT + pt.first + pt.step * col], m);
    codes[((long long)s * 4 + p) * NSYM * W + q] = demap(z, pt.levels);
  }
}

}  // namespace

extern "C" int sync_am_block_parent(const void* spectra, void* codes, void* pids,
                             void* ref_bits, void* samperr, int n_stations,
                             int ma3, void* stream) {
  if (n_stations <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NSYM * FFT * sizeof(float2);  // 64 KB
  // above 48 KB of dynamic shared memory the kernel must opt in; the
  // attribute belongs to the current device, so it is set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      sync_am_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sync_am_block_kernel<<<n_stations, THREADS, smem, (cudaStream_t)stream>>>(
      (const float2*)spectra, (uint8_t*)codes, (uint8_t*)pids,
      (uint8_t*)ref_bits, (int*)samperr, ma3);
  return (int)cudaGetLastError();
}
