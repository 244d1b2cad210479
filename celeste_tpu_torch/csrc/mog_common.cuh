// Device helpers shared by the MoG-field kernels (mog_field.cu) and the
// tiled field kernels (tiled_field.cu): the lambda floor, the NaN-keeping
// clamp, the base-2 exponential, the warp sum, and the opt-in to more than
// 48 KB of dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

namespace celeste {

constexpr float kLambdaMin = 1e-10f;    // likelihood/_pixel.py LAMBDA_MIN
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDefaultSmem = 48 * 1024;

// max(v, lo) that propagates NaN like jnp.maximum / torch.clamp
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}

// 2^x as one MUFU.EX2 (PTX ex2.approx.ftz.f32): at most 2 ulp from the
// correctly rounded result, subnormal results flushed to 0, and 2^0 = 1
// exactly.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Butterfly sum over the warp; every lane ends with the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Poisson log-likelihood of one pixel at lam (already clamped); `log_xt` is
// log max(counts, eps), read only when centered.
template <bool kCentered>
__device__ __forceinline__ float pixel_loglik(float lam, float cnt, float log_xt) {
  return kCentered ? cnt * (logf(lam) - log_xt) + (cnt - lam) : cnt * logf(lam) - lam;
}

// Allow the kernel more than the default dynamic shared memory when it needs
// it.  A failure is also cleared from the runtime's last-error slot, so that
// it cannot be reported again by the next launch's cudaGetLastError().
template <typename Kernel>
cudaError_t launch_prep(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace celeste
