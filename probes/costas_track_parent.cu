// K3 as it was before K10's redesign (nrsc5_tpu_torch/csrc/costas_track.cu
// at the parent commit), for probes/k10_k16b_variants.py: the
// reference-subcarrier Costas PLL, one independent track per thread, with
// the cuts and the clock that split its time.
//
//   -DCUT=1  loads up front: the track's 32 refs into registers before
//            the chain (stores as the parent's);
//   -DCUT=2  no derot and phases stores: the track's 32 signs packed into
//            one word, written to phases[t] (loads as the parent's);
//   -DCLOCK  the global timer at each CTA's entry and exit, 2 int64 a CTA
//            into ph_out (which the tracks then do not write).
//
// refs [n_steps, n_tracks, 2] f32 (step-major), phase0/freq0/cfo_freq
// [n_tracks] f32 (cfo_freq may be null: 0) -> derot [n_steps, n_tracks, 2],
// phases [n_steps, n_tracks], ph_out, fr_out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../nrsc5_tpu_torch/csrc/costas.cuh"

namespace {

// the parent's whole step, from costas.cuh's three parts in its order
__device__ __forceinline__ float2 costas_step(float2 v, float& ph, float& fr,
                                             float cf, float alpha,
                                             float beta, float two_pi) {
  const float2 derot = nrsc5::costas_derot(v, ph);
  nrsc5::costas_advance(nrsc5::costas_angle(v), ph, fr, cf, alpha, beta,
                        two_pi);
  return derot;
}

__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void costas_track_kernel(const float2* __restrict__ refs,
                                    const float* __restrict__ phase0,
                                    const float* __restrict__ freq0,
                                    const float* __restrict__ cfo_freq,
                                    float2* __restrict__ derot,
                                    float* __restrict__ phases,
                                    float* __restrict__ ph_out,
                                    float* __restrict__ fr_out, int n_steps,
                                    int n_tracks, float alpha, float beta,
                                    float two_pi) {
#ifdef CLOCK
  long long t_in = 0;
  if (threadIdx.x == 0) t_in = gtimer();
#endif
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_tracks) {
    float ph = phase0[t];
    float fr = freq0[t];
    const float cf = cfo_freq ? cfo_freq[t] : 0.0f;
#if defined(CUT) && CUT == 1
    float2 v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k)
      v[k] = k < n_steps ? refs[(long long)k * n_tracks + t]
                         : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k >= n_steps) break;
      const long long at = (long long)k * n_tracks + t;
      phases[at] = ph;
      derot[at] = costas_step(v[k], ph, fr, cf, alpha, beta, two_pi);
    }
#elif defined(CUT) && CUT == 2
    unsigned word = 0;
    for (int k = 0; k < n_steps; ++k) {
      const long long at = (long long)k * n_tracks + t;
      const float2 d = costas_step(refs[at], ph, fr, cf, alpha, beta, two_pi);
      word |= (unsigned)(d.x > 0.0f) << (k & 31);
    }
    phases[t] = __uint_as_float(word);
#else
    for (int k = 0; k < n_steps; ++k) {
      const long long at = (long long)k * n_tracks + t;
      phases[at] = ph;
      derot[at] = costas_step(refs[at], ph, fr, cf, alpha, beta, two_pi);
    }
#endif
#ifndef CLOCK
    ph_out[t] = ph;
#endif
    fr_out[t] = fr;
  }
#ifdef CLOCK
  __syncthreads();
  if (threadIdx.x == 0) {
    long long* c = reinterpret_cast<long long*>(ph_out) + 2 * blockIdx.x;
    c[0] = t_in;
    c[1] = gtimer();
  }
#endif
}

}  // namespace

extern "C" int costas_track_parent(const void* refs, const void* phase0,
                                   const void* freq0, const void* cfo_freq,
                                   void* derot, void* phases, void* ph_out,
                                   void* fr_out, int n_steps, int n_tracks,
                                   float alpha, float beta, float two_pi,
                                   void* stream) {
  dim3 block(128);
  dim3 grid((n_tracks + 127) / 128);
  costas_track_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float2*)refs, (const float*)phase0, (const float*)freq0,
      (const float*)cfo_freq, (float2*)derot, (float*)phases, (float*)ph_out,
      (float*)fr_out, n_steps, n_tracks, alpha, beta, two_pi);
  return (int)cudaGetLastError();
}
