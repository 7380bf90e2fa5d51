// The designs tried for K16b (the SBR HF generator), for
// probes/k10_k16b_variants.py, each bit-equal to sbr_hf_generate_plain.
// One kernel with its choices as knobs:
//
//   -DB_PK=n      packets a CTA, in turn (1, 2, 4): every packet's bulk
//                 copy is issued at the CTA's start, so the later packets'
//                 bytes arrive while the first ones' LPC and patch run, and
//                 each packet's tile leaves by a bulk store while the next
//                 one computes;
//   -DB_LPC_WARP0 the parent's LPC: warp 0 alone runs the 8 covariance
//                 sums of its band (the default spreads the 8 x 32 chains
//                 over the 8 warps, a warp a covariance, a lane a band);
//   -DB_LOADS     staging by 16-byte loads of all threads in place of the
//                 bulk copies;
//   -DB_DIRECT    the patch stores its complex outputs straight to device
//                 memory (8 bytes a store) in place of a tile in shared
//                 memory and one bulk store;
//   -DB_MINB=n    __launch_bounds__'s minimum of resident CTAs an SM;
//   -DB_V2        the second design, its own kernel: B_THREADS threads (128
//                 or 256) a (lane, packet), the window by bulk copies,
//                 the LPC and the predictors on warp 0 alone (each lane
//                 a band, its slots' values rolled through registers: two
//                 shared-memory loads a slot), then each warp a run of
//                 slots and each lane a bin, the bin's coefficients in
//                 registers and its source band's values rolled through
//                 registers, x_high stored straight to device memory (8
//                 bytes a lane, consecutive bins on consecutive lanes);
//                 the tails by the last warps while warp 0 sums;
//   -DCLOCK       the global timer at a CTA's entry, after its first
//                 packet's bytes landed, after that packet's sums, after
//                 its coefficients, after the last patch and at exit, 8
//                 int64 a CTA behind xh (the caller leaves room).
//
// Every choice runs the same float operations in the same order as the
// plain version: each covariance summed over the 32 slots in slot order,
// the predictors and the patch as stage.py writes them (-fmad=false).
//
// xl f32 [N, 32 K, 64], tail_r / tail_i [N, 2, 32], bwj [N, K, m],
// src_idx i32 [m], src_ok f32 [m] -> xh [N, K, 32, m, 2], new tails.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../nrsc5_tpu_torch/csrc/bulk_copy.cuh"

#ifndef B_PK
#define B_PK 1
#endif
#ifndef B_MINB
#define B_MINB 1
#endif
#ifndef B_THREADS
#define B_THREADS 128
#endif

namespace {

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int THREADS = 256;
constexpr int NSLOT = 32;
constexpr int ROW = 64;          // floats a slot row: 32 re, then 32 im
constexpr int ROW_BYTES = ROW * 4;
constexpr int PK = B_PK;
constexpr int VROWS = NSLOT * PK + 2;
constexpr int MAXM = 64;

__host__ __device__ constexpr int tile_floats(int m) {
#ifdef B_DIRECT
  return 0 * m;
#else
  return NSLOT * m * 2;
#endif
}

// dynamic shared memory: v rows, PK output tiles, sums [8][32], coef
// [4][64], src [64], ok [64], PK mbarriers
__host__ __device__ constexpr int smem_bytes(int m) {
  return VROWS * ROW_BYTES + PK * tile_floats(m) * 4 + 8 * 32 * 4
         + 4 * MAXM * 4 + 2 * MAXM * 4 + PK * 8;
}

#ifndef B_V2
__global__ void __launch_bounds__(THREADS, B_MINB) sbr_hf_generate_kernel(
    const float* __restrict__ xl, const float* __restrict__ tail_r,
    const float* __restrict__ tail_i, const float* __restrict__ bwj,
    const int* __restrict__ src_idx, const float* __restrict__ src_ok,
    float* __restrict__ xh, float* __restrict__ new_tail_r,
    float* __restrict__ new_tail_i, int n_packets, int m, int kx, float eps,
    float lpc_div) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  float* tiles = v + VROWS * ROW;
  float* sums = tiles + PK * tile_floats(m);
  float* coef = sums + 8 * 32;
  int* srcs = reinterpret_cast<int*>(coef + 4 * MAXM);
  float* oks = reinterpret_cast<float*>(srcs + MAXM);
  uint64_t* bar = reinterpret_cast<uint64_t*>(oks + MAXM);
  const int tid = threadIdx.x;
  const int groups = (n_packets + PK - 1) / PK;
  const long long n = blockIdx.x / groups;
  const int k0 = (blockIdx.x - (int)n * groups) * PK;
  const int np = min(PK, n_packets - k0);
  const long long pk0 = n * n_packets + k0;
#ifdef CLOCK
  const long long items = (long long)(gridDim.x / groups) * n_packets;
  long long* clk = reinterpret_cast<long long*>(xh + items * NSLOT * m * 2) +
                   8 * (long long)blockIdx.x;
  if (tid == 0) clk[0] = gtimer();
#endif

  // staging: the window of the first packet (its 2 rows before, from the
  // previous packet or the carried tails, and its 32), then each later
  // packet's 32 rows behind it
  const float* lane = xl + n * n_packets * NSLOT * ROW;
#ifdef B_LOADS
  for (int e = tid; e < (2 + NSLOT * np) * (ROW / 4); e += THREADS) {
    const int row = e / (ROW / 4);
    const int c4 = e - row * (ROW / 4);
    float4 x;
    if (row >= 2 || k0 > 0) {
      x = reinterpret_cast<const float4*>(
          lane + ((long long)k0 * NSLOT - 2 + row) * ROW)[c4];
    } else {
      const float* tl = c4 < 8 ? tail_r : tail_i;
      x = reinterpret_cast<const float4*>(tl + (n * 2 + row) * 32)[c4 & 7];
    }
    reinterpret_cast<float4*>(v + row * ROW)[c4] = x;
  }
#else
  if (tid == 0) {
    for (int p = 0; p < np; ++p) bulk::init(&bar[p]);
  }
  __syncthreads();
  if (tid == 0) {
    if (k0 == 0) {
      bulk::expect(&bar[0], NSLOT * ROW_BYTES + 4 * 128);
      for (int t = 0; t < 2; ++t) {
        bulk::copy(v + t * ROW, tail_r + (n * 2 + t) * 32, 128, &bar[0]);
        bulk::copy(v + t * ROW + 32, tail_i + (n * 2 + t) * 32, 128,
                   &bar[0]);
      }
      bulk::copy(v + 2 * ROW, lane, NSLOT * ROW_BYTES, &bar[0]);
    } else {
      bulk::expect(&bar[0], (NSLOT + 2) * ROW_BYTES);
      bulk::copy(v, lane + ((long long)k0 * NSLOT - 2) * ROW,
                 (NSLOT + 2) * ROW_BYTES, &bar[0]);
    }
    for (int p = 1; p < np; ++p) {
      bulk::expect(&bar[p], NSLOT * ROW_BYTES);
      bulk::copy(v + (2 + NSLOT * p) * ROW,
                 lane + (long long)(k0 + p) * NSLOT * ROW, NSLOT * ROW_BYTES,
                 &bar[p]);
    }
  }
#endif
  if (tid < m) {
    srcs[tid] = src_idx[tid];
    oks[tid] = src_ok[tid];
  }
#ifdef B_LOADS
  __syncthreads();
#endif

  // the covariance chain of this thread: (a, b) rows back from v0 and
  // whether it is an imaginary part, by warp
  const int cv = tid >> 5, j = tid & 31;
  const int da = cv == 0 || cv == 1 || cv == 2 ? 1 : 2;
  const int db = cv == 0 || cv == 1 || cv == 3 || cv == 4 ? 0
                 : cv == 2 || cv == 5 || cv == 6 ? 1 : 2;
  const bool im = cv == 1 || cv == 4 || cv == 6;
  for (int p = 0; p < np; ++p) {
    const float* vp = v + NSLOT * p * ROW;  // rows 0-33: the packet's window
#ifndef B_LOADS
    bulk::wait(&bar[p]);
    if (p == 0) __syncthreads();  // srcs and oks
#endif
#ifdef CLOCK
    if (tid == 0 && p == 0) clk[1] = gtimer();
#endif
#ifdef B_LPC_WARP0
    if (tid < 32) {
      float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int s = 0; s < NSLOT; ++s) {
        const float v0r = vp[(s + 2) * ROW + j], v0i = vp[(s + 2) * ROW + 32 + j];
        const float v1r = vp[(s + 1) * ROW + j], v1i = vp[(s + 1) * ROW + 32 + j];
        const float v2r = vp[s * ROW + j], v2i = vp[s * ROW + 32 + j];
        acc[0] = acc[0] + (v1r * v0r + v1i * v0i);
        acc[1] = acc[1] + (v1r * v0i - v1i * v0r);
        acc[2] = acc[2] + (v1r * v1r + v1i * v1i);
        acc[3] = acc[3] + (v2r * v0r + v2i * v0i);
        acc[4] = acc[4] + (v2r * v0i - v2i * v0r);
        acc[5] = acc[5] + (v2r * v1r + v2i * v1i);
        acc[6] = acc[6] + (v2r * v1i - v2i * v1r);
        acc[7] = acc[7] + (v2r * v2r + v2i * v2i);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) sums[c * 32 + j] = acc[c];
    }
#else
    {
      float acc = 0.0f;
#pragma unroll 8
      for (int s = 0; s < NSLOT; ++s) {
        const float* ra = vp + (s + 2 - da) * ROW;
        const float* rb = vp + (s + 2 - db) * ROW;
        const float ar = ra[j], ai = ra[32 + j];
        const float br = rb[j], bi = rb[32 + j];
        acc = acc + (im ? ar * bi - ai * br : ar * br + ai * bi);
      }
      sums[cv * 32 + j] = acc;
    }
#endif
    __syncthreads();
#ifdef CLOCK
    if (tid == 0 && p == 0) clk[2] = gtimer();
#endif
    // the predictors of each bin's source band, and its patch coefficients
    if (tid < m) {
      const int b = srcs[tid];
      const float p01r = sums[0 * 32 + b], p01i = sums[1 * 32 + b];
      const float p11 = sums[2 * 32 + b];
      const float p02r = sums[3 * 32 + b], p02i = sums[4 * 32 + b];
      const float p12r = sums[5 * 32 + b], p12i = sums[6 * 32 + b];
      const float p22 = sums[7 * 32 + b];
      const float d = p22 * p11 - (p12r * p12r + p12i * p12i) / lpc_div;
      const bool d_ok = fabsf(d) > eps;
      const float dd = d_ok ? d : 1.0f;
      float b1r = d_ok ? (p01r * p12r - p01i * p12i - p02r * p11) / dd : 0.0f;
      float b1i = d_ok ? (p01r * p12i + p01i * p12r - p02i * p11) / dd : 0.0f;
      const bool p_ok = fabsf(p11) > eps;
      const float pp = p_ok ? p11 : 1.0f;
      const float t0r = b1r * p12r - b1i * -p12i;
      const float t0i = b1r * -p12i + b1i * p12r;
      float b0r = p_ok ? -(p01r + t0r) / pp : 0.0f;
      float b0i = p_ok ? -(p01i + t0i) / pp : 0.0f;
      const bool big = (b0r * b0r + b0i * b0i >= 16.0f) ||
                       (b1r * b1r + b1i * b1i >= 16.0f);
      const int lim = kx + 1 < 32 ? kx + 1 : 32;
      const float mask = (!big && b >= 1 && b < lim) ? 1.0f : 0.0f;
      if (big) b0r = b0i = b1r = b1i = 0.0f;
      const float a0r = b0r * mask, a0i = b0i * mask;
      const float a1r = b1r * mask, a1i = b1i * mask;
      const float bw = bwj[(pk0 + p) * m + tid];
      const float bw2 = bw * bw;
      coef[0 * MAXM + tid] = bw * a0r;
      coef[1 * MAXM + tid] = bw * a0i;
      coef[2 * MAXM + tid] = bw2 * a1r;
      coef[3 * MAXM + tid] = bw2 * a1i;
    }
    __syncthreads();
#ifdef CLOCK
    if (tid == 0 && p == 0) clk[3] = gtimer();
#endif
    // the patch: consecutive threads on consecutive (slot, bin) outputs
#ifdef B_DIRECT
    float2* out = reinterpret_cast<float2*>(xh) + (pk0 + p) * NSLOT * m;
#else
    float2* out = reinterpret_cast<float2*>(tiles + p * tile_floats(m));
#endif
    for (int e = tid; e < NSLOT * m; e += THREADS) {
      const int t = e / m;
      const int i = e - t * m;
      const int src = srcs[i];
      const float c1r = coef[0 * MAXM + i], c1i = coef[1 * MAXM + i];
      const float c2r = coef[2 * MAXM + i], c2i = coef[3 * MAXM + i];
      const float s0r = vp[(t + 2) * ROW + src], s0i = vp[(t + 2) * ROW + 32 + src];
      const float s1r = vp[(t + 1) * ROW + src], s1i = vp[(t + 1) * ROW + 32 + src];
      const float s2r = vp[t * ROW + src], s2i = vp[t * ROW + 32 + src];
      const float hr =
          s0r + (c1r * s1r - c1i * s1i) + (c2r * s2r - c2i * s2i);
      const float hi =
          s0i + (c1r * s1i + c1i * s1r) + (c2r * s2i + c2i * s2r);
      const float ok = oks[i];
      out[e] = make_float2(hr * ok, hi * ok);
    }
#ifndef B_DIRECT
    bulk::fence_shared();
    __syncthreads();
    if (tid == 0) {
      bulk::store(xh + (pk0 + p) * NSLOT * m * 2, out, NSLOT * m * 8);
      bulk::commit();
    }
#else
    __syncthreads();
#endif
  }
#ifdef CLOCK
  if (tid == 0) clk[4] = gtimer();
#endif
  if (k0 + np == n_packets && tid < 64) {
    const int t = tid >> 5;
    const int c = tid & 31;
    const float* row = v + (NSLOT * np + t) * ROW;
    new_tail_r[(n * 2 + t) * 32 + c] = row[c];
    new_tail_i[(n * 2 + t) * 32 + c] = row[32 + c];
  }
#ifndef B_DIRECT
  if (tid == 0) bulk::wait_read();
#endif
#ifdef CLOCK
  __syncthreads();
  if (tid == 0) clk[5] = gtimer();
#endif
}

#else  // B_V2

constexpr int T2 = B_THREADS;
constexpr int W2 = T2 / 32;
constexpr int SLOTS2 = NSLOT / W2;  // slots a warp

__global__ void __launch_bounds__(T2, B_MINB) sbr_hf_generate_kernel(
    const float* __restrict__ xl, const float* __restrict__ tail_r,
    const float* __restrict__ tail_i, const float* __restrict__ bwj,
    const int* __restrict__ src_idx, const float* __restrict__ src_ok,
    float* __restrict__ xh, float* __restrict__ new_tail_r,
    float* __restrict__ new_tail_i, int n_packets, int m, int kx, float eps,
    float lpc_div) {
  __shared__ __align__(128) float v[(NSLOT + 2) * ROW];
  __shared__ float a[4][32];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int k = blockIdx.x % n_packets;
  const long long n = blockIdx.x / n_packets;
  const long long pk = n * n_packets + k;
#ifdef CLOCK
  long long* clk = reinterpret_cast<long long*>(
                       xh + (long long)gridDim.x * NSLOT * m * 2) +
                   8 * (long long)blockIdx.x;
  if (tid == 0) clk[0] = gtimer();
#endif
  if (tid == 0) bulk::init(&bar);
  __syncthreads();
  if (tid == 0) {
    const float* rows = xl + pk * NSLOT * ROW;
    if (k == 0) {
      bulk::expect(&bar, NSLOT * ROW_BYTES + 4 * 128);
      for (int t = 0; t < 2; ++t) {
        bulk::copy(v + t * ROW, tail_r + (n * 2 + t) * 32, 128, &bar);
        bulk::copy(v + t * ROW + 32, tail_i + (n * 2 + t) * 32, 128, &bar);
      }
      bulk::copy(v + 2 * ROW, rows, NSLOT * ROW_BYTES, &bar);
    } else {
      bulk::expect(&bar, (NSLOT + 2) * ROW_BYTES);
      bulk::copy(v, rows - 2 * ROW, (NSLOT + 2) * ROW_BYTES, &bar);
    }
  }
  // each lane's bins (lane, lane + 32): source band, mask and chirp
  int src[2];
  float ok[2], bw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    src[h] = i < m ? src_idx[i] : 0;
    ok[h] = i < m ? src_ok[i] : 0.0f;
    bw[h] = i < m ? bwj[pk * m + i] : 0.0f;
  }
  bulk::wait(&bar);
#ifdef CLOCK
  if (tid == 0) clk[1] = gtimer();
#endif
  if (w == 0) {
    const int j = lane;
    float p01r = 0.0f, p01i = 0.0f, p11 = 0.0f, p02r = 0.0f, p02i = 0.0f;
    float p12r = 0.0f, p12i = 0.0f, p22 = 0.0f;
    float v2r = v[j], v2i = v[32 + j];
    float v1r = v[ROW + j], v1i = v[ROW + 32 + j];
#pragma unroll 8
    for (int s = 0; s < NSLOT; ++s) {
      const float v0r = v[(s + 2) * ROW + j], v0i = v[(s + 2) * ROW + 32 + j];
      p01r = p01r + (v1r * v0r + v1i * v0i);
      p01i = p01i + (v1r * v0i - v1i * v0r);
      p11 = p11 + (v1r * v1r + v1i * v1i);
      p02r = p02r + (v2r * v0r + v2i * v0i);
      p02i = p02i + (v2r * v0i - v2i * v0r);
      p12r = p12r + (v2r * v1r + v2i * v1i);
      p12i = p12i + (v2r * v1i - v2i * v1r);
      p22 = p22 + (v2r * v2r + v2i * v2i);
      v2r = v1r;
      v2i = v1i;
      v1r = v0r;
      v1i = v0i;
    }
#ifdef CLOCK
    if (tid == 0) clk[2] = gtimer();
#endif
    const float d = p22 * p11 - (p12r * p12r + p12i * p12i) / lpc_div;
    const bool d_ok = fabsf(d) > eps;
    const float dd = d_ok ? d : 1.0f;
    float b1r = d_ok ? (p01r * p12r - p01i * p12i - p02r * p11) / dd : 0.0f;
    float b1i = d_ok ? (p01r * p12i + p01i * p12r - p02i * p11) / dd : 0.0f;
    const bool p_ok = fabsf(p11) > eps;
    const float pp = p_ok ? p11 : 1.0f;
    const float t0r = b1r * p12r - b1i * -p12i;
    const float t0i = b1r * -p12i + b1i * p12r;
    float b0r = p_ok ? -(p01r + t0r) / pp : 0.0f;
    float b0i = p_ok ? -(p01i + t0i) / pp : 0.0f;
    const bool big =
        (b0r * b0r + b0i * b0i >= 16.0f) || (b1r * b1r + b1i * b1i >= 16.0f);
    const int lim = kx + 1 < 32 ? kx + 1 : 32;
    const float mask = (!big && j >= 1 && j < lim) ? 1.0f : 0.0f;
    if (big) b0r = b0i = b1r = b1i = 0.0f;
    a[0][j] = b0r * mask;
    a[1][j] = b0i * mask;
    a[2][j] = b1r * mask;
    a[3][j] = b1i * mask;
  } else if (k == n_packets - 1 && tid >= T2 - 64) {
    const int t = (tid - (T2 - 64)) >> 5;
    new_tail_r[(n * 2 + t) * 32 + lane] = v[(NSLOT + t) * ROW + lane];
    new_tail_i[(n * 2 + t) * 32 + lane] = v[(NSLOT + t) * ROW + 32 + lane];
  }
  __syncthreads();
#ifdef CLOCK
  if (tid == 0) clk[3] = gtimer();
#endif
  // the patch: warp w the slots [SLOTS2 w, SLOTS2 (w + 1)), lane the bin
  float2* out = reinterpret_cast<float2*>(xh) + pk * NSLOT * m;
  const int t0 = SLOTS2 * w;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    if (i < m) {
      const int b = src[h];
      const float bw2 = bw[h] * bw[h];
      const float c1r = bw[h] * a[0][b], c1i = bw[h] * a[1][b];
      const float c2r = bw2 * a[2][b], c2i = bw2 * a[3][b];
      float s2r = v[t0 * ROW + b], s2i = v[t0 * ROW + 32 + b];
      float s1r = v[(t0 + 1) * ROW + b], s1i = v[(t0 + 1) * ROW + 32 + b];
#pragma unroll
      for (int q = 0; q < SLOTS2; ++q) {
        const float s0r = v[(t0 + q + 2) * ROW + b];
        const float s0i = v[(t0 + q + 2) * ROW + 32 + b];
        const float hr =
            s0r + (c1r * s1r - c1i * s1i) + (c2r * s2r - c2i * s2i);
        const float hi =
            s0i + (c1r * s1i + c1i * s1r) + (c2r * s2i + c2i * s2r);
        out[(t0 + q) * m + i] = make_float2(hr * ok[h], hi * ok[h]);
        s2r = s1r;
        s2i = s1i;
        s1r = s0r;
        s1i = s0i;
      }
    }
  }
#ifdef CLOCK
  __syncthreads();
  if (tid == 0) clk[4] = clk[5] = gtimer();
#endif
}

#endif  // B_V2

}  // namespace

extern "C" int sbr_hf_generate_variant(const void* xl, const void* tail_r,
                                       const void* tail_i, const void* bwj,
                                       const void* src_idx,
                                       const void* src_ok, void* xh,
                                       void* new_tail_r, void* new_tail_i,
                                       int n_lanes, int n_packets, int m,
                                       int kx, float eps, float lpc_div,
                                       void* stream) {
  if (n_lanes <= 0 || n_packets <= 0 || m <= 0 || m > MAXM)
    return (int)cudaErrorInvalidValue;
#ifdef B_V2
  const long long blocks = (long long)n_lanes * n_packets;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sbr_hf_generate_kernel<<<(int)blocks, T2, 0, (cudaStream_t)stream>>>(
      (const float*)xl, (const float*)tail_r, (const float*)tail_i,
      (const float*)bwj, (const int*)src_idx, (const float*)src_ok,
      (float*)xh, (float*)new_tail_r, (float*)new_tail_i, n_packets, m, kx,
      eps, lpc_div);
  return (int)cudaGetLastError();
#else
  const long long blocks =
      (long long)n_lanes * ((n_packets + PK - 1) / PK);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bytes = smem_bytes(m);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sbr_hf_generate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  sbr_hf_generate_kernel<<<(int)blocks, THREADS, bytes,
                           (cudaStream_t)stream>>>(
      (const float*)xl, (const float*)tail_r, (const float*)tail_i,
      (const float*)bwj, (const int*)src_idx, (const float*)src_ok,
      (float*)xh, (float*)new_tail_r, (float*)new_tail_i, n_packets, m, kx,
      eps, lpc_div);
  return (int)cudaGetLastError();
#endif
}
