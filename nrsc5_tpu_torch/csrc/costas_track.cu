// K3: the reference-subcarrier Costas PLL, one independent track per thread.
//
// Replaces the JAX device function
// nrsc5_tpu/pipeline/scan_chain_rc.py:costas_track_rc (lines 107-125), a
// lax.scan over the 32 symbols of a block.  Per track and step k:
//   v2     = v*v
//   err    = 0.5 * wrap_pi(angle(v2) - 2*ph)
//   derot  = v * e^{-i ph}                      (output, with phases = ph)
//   fr     = clip(fr + BETA*err, -0.5, 0.5)
//   ph     = wrap_pi(ph + fr + cfo_freq + ALPHA*err)
// with wrap_pi(x) = x - 2pi*rint(x / 2pi) (round half to even, as jnp.round).
//
// refs [n_steps, n_tracks, 2] f32 (step-major, as the reference scans),
// phase0/freq0/cfo_freq [n_tracks] f32 (cfo_freq may be null: 0) ->
// derot [n_steps, n_tracks, 2], phases [n_steps, n_tracks], ph_out, fr_out.
//
// Bound on the H100: neither bytes nor operations — a track is a 32-step
// dependent chain (atan2f, sincosf, a divide, two rints per step), so the
// kernel is latency-bound: a few microseconds for any track count up to
// the card's width.  Design: the recurrence lives in registers; loads and
// stores of neighbouring tracks sit on neighbouring addresses.  f32 in the
// reference's order (the build passes -fmad=false); the constants come in
// as float arguments so nothing promotes to double.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float wrap_pi(float x, float two_pi) {
  return x - two_pi * rintf(x / two_pi);
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
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tracks) return;
  float ph = phase0[t];
  float fr = freq0[t];
  const float cf = cfo_freq ? cfo_freq[t] : 0.0f;
  for (int k = 0; k < n_steps; ++k) {
    const long long at = (long long)k * n_tracks + t;
    const float2 v = refs[at];
    const float v2r = v.x * v.x - v.y * v.y;
    const float v2i = v.x * v.y + v.y * v.x;
    const float err = 0.5f * wrap_pi(atan2f(v2i, v2r) - 2.0f * ph, two_pi);
    const float c = cosf(-ph), s = sinf(-ph);
    derot[at] = make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
    phases[at] = ph;
    fr = fminf(fmaxf(fr + beta * err, -0.5f), 0.5f);
    ph = wrap_pi(ph + fr + cf + alpha * err, two_pi);
  }
  ph_out[t] = ph;
  fr_out[t] = fr;
}

}  // namespace

extern "C" int costas_track(const void* refs, const void* phase0,
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
