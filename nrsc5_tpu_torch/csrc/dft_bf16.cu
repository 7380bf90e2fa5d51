// The block loop's 2048-point DFT as a bf16 tensor-core product: TMA loads
// into a ring of swizzled tiles, wgmma warpgroups, float32 accumulators in
// registers.
//
// Replaces the DFT of the JAX device function
// nrsc5_tpu/ops/acquire_rc.py:demod_rc (line 104, rc.dft(folded,
// shift=True), nrsc5_tpu/ops/rcplx.py:108-127): both operands in bfloat16,
// the products accumulated in float32.  A bf16 x bf16 product is exact in
// float32, so this kernel forms the same products as the JAX package and as
// the port's plain version (a float32 matmul on the bf16-rounded operands);
// only the order of the sums differs.
//
//   out f32 [R, W] = A bf16 [R, W] @ T^T,   T bf16 [W, W]  (W = 2n = 4096)
//
// A is K2's bf16 fold, [S*32, 2048, 2] seen as [R, 4096] with re and im
// interleaved; T is the interleaved DFT table with the fftshift folded into
// its columns (ops/rcplx.py:_dft_matrix), stored transposed (row c holds
// output column c's 4096 weights), so that both operands are K-major and
// load alike.  The output is the float32 spectra [S, 32, 2048, 2] K4 reads.
//
// Bound on the H100: the dense product the code runs, 2 * R * W^2 = 17.2
// GFLOP a block at R = 512, 0.0174 ms at the 989 TFLOP/s bf16 dense peak
// (by operations); the DFT as a DFT needs it (5 n log2 n a row, its rc input
// read and spectra written once) is bound by bytes at 0.0050 ms.  A GEMM
// rather than an FFT because an FFT is not the same function here: its
// twiddles would be rounded one by one, where the JAX package rounds each
// table entry to bf16, so its spectra would part from JAX's by ~2^-9.
//
// Design: one CTA per 128 x 128 output tile (R = 512 gives 4 x 32 = 128
// CTAs, one wave on 132 SMs), two warpgroups of 64 rows each issuing
// wgmma.m64n128k16 from shared memory.  A and T tiles of 128 rows x 64 k
// (16 KB each, 128 bytes a row, the 128-byte swizzle wgmma reads without
// bank conflicts) come into a 6-stage ring by TMA (cp.async.bulk.tensor, one
// thread issuing two copies a stage), each stage with a "full" mbarrier the
// copies complete and an "empty" one both warpgroups arrive on once their
// products have read it; rows past R are zero-filled by the TMA unit, so a
// ragged R such as one station's 32 rows works.  The tensor maps are
// encoded on the host at each launch (cuTensorMapEncodeTiled, looked up
// through the CUDA runtime, so nothing links libcuda) and passed by value
// as __grid_constant__ parameters, so a CUDA graph captures them with the
// launch.  The tensor cores sum each k tile's 64 products; the tiles'
// partial sums are added in k order with float32 adds on the CUDA cores
// (the tensor cores' own float32 accumulation drifted past 1e-5 of a row's
// largest magnitude over 4096 products of the fold).  The K order is fixed
// and there is no split-K and no atomic: two launches give the same bits,
// and a CUDA graph gives the eager bits.  The table (32 MB) fits in the 50
// MB L2 beside a block's 4 MB of A and 8 MB of output.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows of a CTA
constexpr int BN = 128;  // output columns of a CTA
constexpr int BK = 64;   // k of a ring stage: 128 bytes of bf16 a row
constexpr int STAGES = 6;
constexpr int THREADS = 256;  // two warpgroups
constexpr int TILE_BYTES = BM * BK * 2;  // 16 KB; BN == BM, so T's too
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
// the ring, 1 KB to align it (the 128-byte swizzle repeats every 1 KB),
// and a full and an empty mbarrier a stage
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
constexpr uint32_t SBO = 1024;  // 8 rows of 128 bytes: row-adjacent groups
static_assert(BN == BM, "A's and T's tiles share one shape");

// the matrix descriptor of a K-major tile with the 128-byte swizzle at
// shared address addr (the leading offset is unused in this mode: 16)
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16)
         | ((uint64_t)(SBO >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box (64 k x 128 rows) of a 2-D tensor map into shared memory at
// dst, completing on barrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// d = a b (scale_d 0) or d += a b (scale_d 1), asynchronously
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__global__ void __launch_bounds__(THREADS, 1)
    dft_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_t,
                    float* __restrict__ out, int rows, int width) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // this warpgroup's 64 rows of the tile
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_tiles = width / BK;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  // thread 0: k tile t of A and T into its stage
  auto load_stage = [&](int t) {
    const int s = t % STAGES;
    const uint32_t dst = base + s * STAGE_BYTES;
    mbar_expect_tx(full(s), STAGE_BYTES);
    tma_load(dst, &map_a, full(s), t * BK, m0);
    tma_load(dst + TILE_BYTES, &map_t, full(s), t * BK, n0);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < STAGES - 1 && t < k_tiles; ++t) load_stage(t);

  // the tensor cores sum a k tile's 64 products into part; the k tiles'
  // partial sums are added into acc with float32 adds, so that no
  // tensor-core accumulation chain runs over more than 64 products
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    // refill: tile kt + STAGES - 1 goes into the stage of tile kt - 1 once
    // both warpgroups have finished reading it
    if (tid == 0 && kt + STAGES - 1 < k_tiles) {
      if (kt > 0)
        mbar_wait(empty((kt - 1) % STAGES), ((kt - 1) / STAGES) & 1);
      load_stage(kt + STAGES - 1);
    }
    __syncwarp();
    mbar_wait(full(s), (kt / STAGES) & 1);
    __syncwarp();

    const uint32_t a_st = base + s * STAGE_BYTES + wg * 64 * 128;
    const uint32_t b_st = base + s * STAGE_BYTES + TILE_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)  // k steps of 16: 32 bytes a row
      wgmma_m64n128k16(part, descriptor(a_st + 32 * j),
                       descriptor(b_st + 32 * j), j > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      asm volatile("" : "+f"(part[i])::"memory");
      acc[i] = acc[i] + part[i];
    }
    if ((tid & 127) == 0) mbar_arrive(empty(s));
  }

  // the accumulator fragment: warp w of the warpgroup holds rows 16 w ..
  // 16 w + 15; for each 8-column chunk i, lane l holds (row l / 4, columns
  // 2 (l % 4) and + 1) in acc[4 i], acc[4 i + 1] and the row 8 below in
  // acc[4 i + 2], acc[4 i + 3]
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int r_lo = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col = n0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    if (r_lo < rows)
      *reinterpret_cast<float2*>(out + (size_t)r_lo * width + col + 8 * i) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
    if (r_lo + 8 < rows)
      *reinterpret_cast<float2*>(out + (size_t)(r_lo + 8) * width + col
                                 + 8 * i) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (nothing
// links libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [n_rows, width] row-major bf16 matrix in boxes of 64 k x 128 rows,
// 128-byte swizzled; rows past n_rows read as zeros
bool tensor_map(CUtensorMap* map, const void* ptr, int n_rows, int width) {
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)BM};
  const cuuint32_t step[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(ptr), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int dft_bf16(const void* a, const void* table, void* out,
                        int rows, int width, void* stream) {
  if (rows <= 0 || width <= 0 || width % BN || width % BK)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_a, map_t;
  if (!tensor_map(&map_a, a, rows, width)
      || !tensor_map(&map_t, table, width, width))
    return (int)cudaErrorInvalidValue;
  // the opt-in is a host-side call, made on every launch for the current
  // device rather than remembered once per process
  cudaError_t err = cudaFuncSetAttribute(
      dft_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(width / BN, (rows + BM - 1) / BM);
  dft_bf16_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      map_a, map_t, (float*)out, rows, width);
  return (int)cudaGetLastError();
}
