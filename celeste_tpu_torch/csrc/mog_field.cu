// Fused MoG-field render + Poisson log-likelihood for Hopper (sm_90a):
// the forward kernel and its hand-written backward (K1), and the lambda
// render (K7).
//
// Replaces the TPU kernels of celeste_tpu/kernels/mog_field.py:
//   K1  _loglik_kernel (forward) and the autodiff of its dense mirror,
//       _loglik_bwd (backward);
//   K7  _render_kernel (launcher mog_field_render): the images
//       lam = sky + sum_c a_c exp(-q_c / 2) themselves, [B, P].
//
// Math.  Chain b carries C Gaussian components in precision form: amplitude
// a (flux, calibration, weight and normaliser folded in), centre (mx, my)
// and inverse-covariance entries (pa, pb, pc).  For pixel p at (x, y):
//   q_c   = pa dx^2 + 2 pb dx dy + pc dy^2,   dx = x - mx_c, dy = y - my_c
//   lam   = sky + sum_c a_c exp(-q_c / 2)
//   ll_b  = sum_p mask * pixel_loglik(max(lam, eps), counts, centered)
// and the backward, given the cotangent g_b of ll_b:
//   g_lam = g mask (counts / max(lam, eps) - 1) [lam > eps]
//   e_c = exp(-q_c / 2);  dq = -g_lam a_c e_c / 2
//   d a = sum_p g_lam e_c;  d pa = sum_p dq dx^2;  d pb = sum_p 2 dq dx dy;
//   d pc = sum_p dq dy^2;   d mx = sum_p -2 dq (pa dx + pb dy);
//   d my = sum_p -2 dq (pb dx + pc dy).
// The centered flag only adds parameter-free per-pixel terms, so the
// backward does not take it.
//
// What bounds it on the card.  Per chain the kernel reads 6 C 4 bytes of
// parameters and writes 4 bytes (the backward writes 6 C 4), while it does
// C exponentials and ~10 C FP32 operations for each of ~P = 640 pixels plus
// one logarithm per pixel.  Arithmetic intensity is thousands of operations
// per byte: the kernels are bound by the special-function unit (exp/log)
// and FP32 issue, not by memory.
//
// What the design does about that.  The five pixel arrays (12.8 KB for a
// 25x25 stamp) are staged once per block in shared memory and shared by the
// block's chains; the chain's components are staged once, pre-transformed
// (log a, -pa/2, -pb, -pc/2), so the inner loop is two subtractions, a few
// FMAs and one exp per (pixel, component).  One warp owns one chain, its
// lanes stride over pixels, and the per-chain sum is a shuffle tree.  Each
// chain owns its outputs, so there are no atomics.  The forward folds the
// amplitude into the exponent (exp(log a + ...)), which saves a multiply per
// (pixel, component); the backward multiplies a * e instead, so that a
// zero-amplitude component gives 0 and not 0 * inf = NaN.  Padded pixels
// (mask 0, sky 1) are read as they are and contribute exactly 0.
//
// K7 is bound by the same units: ~13 FP32 operations and one exponential per
// (pixel, component) against 4 bytes of lambda stored per pixel.  A block is
// 8 chains (a warp each) by one tile of kRenderTile pixels, so any stamp or
// field renders with no pixel cap; the tile's px, py and sky and the chains'
// components are staged in shared memory, and each warp's lanes store
// consecutive pixels of its chain's row (coalesced).  As the TPU body does,
// it multiplies a * exp(-q / 2) with the 2 pb cross term, so a
// zero-amplitude component adds exactly 0 and a zero-amplitude row renders
// exactly the sky.  It returns every one of the P (lane-padded) pixels.
//
// Interface: plain C, bound with ctypes.  Each entry launches on the given
// stream, allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "mog_common.cuh"

namespace {

using celeste::clamp_min;
using celeste::kLambdaMin;
using celeste::launch_prep;
using celeste::warp_sum;

constexpr int kWarps = 8;               // chains per block
constexpr int kThreads = kWarps * 32;

template <bool kCentered>
__global__ void __launch_bounds__(kThreads)
loglik_fwd_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
                  const float* __restrict__ my, const float* __restrict__ pa,
                  const float* __restrict__ pb, const float* __restrict__ pc,
                  const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ counts, const float* __restrict__ sky,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int n_chains, int n_comp, int n_pix) {
  extern __shared__ float smem[];
  float* s_px = smem;
  float* s_py = s_px + n_pix;
  float* s_cnt = s_py + n_pix;
  float* s_sky = s_cnt + n_pix;
  float* s_mask = s_sky + n_pix;
  float* s_lxt = s_mask + n_pix;         // log max(counts, eps), centered only
  float* s_par = s_lxt + n_pix;          // kWarps x 6 x C

  for (int i = threadIdx.x; i < n_pix; i += kThreads) {
    s_px[i] = px[i];
    s_py[i] = py[i];
    s_cnt[i] = counts[i];
    s_sky[i] = sky[i];
    s_mask[i] = mask[i];
    if (kCentered) s_lxt[i] = logf(clamp_min(counts[i], kLambdaMin));
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const int C = n_comp;
  float* w_la = s_par + warp * 6 * C;    // log a (log 0 = -inf: contributes 0)
  float* w_mx = w_la + C;
  float* w_my = w_mx + C;
  float* w_ha = w_my + C;                // -pa / 2
  float* w_hb = w_ha + C;                // -pb
  float* w_hc = w_hb + C;                // -pc / 2
  if (b < n_chains) {
    for (int c = lane; c < C; c += 32) {
      const size_t i = static_cast<size_t>(b) * C + c;
      w_la[c] = logf(amp[i]);
      w_mx[c] = mx[i];
      w_my[c] = my[i];
      w_ha[c] = -0.5f * pa[i];
      w_hb[c] = -pb[i];
      w_hc[c] = -0.5f * pc[i];
    }
  }
  __syncthreads();
  if (b >= n_chains) return;

  float acc = 0.0f;
  for (int p = lane; p < n_pix; p += 32) {
    const float x = s_px[p];
    const float y = s_py[p];
    float lam = s_sky[p];
    for (int c = 0; c < C; ++c) {
      const float dx = x - w_mx[c];
      const float dy = y - w_my[c];
      lam += expf(w_la[c] + w_ha[c] * dx * dx + w_hb[c] * dx * dy + w_hc[c] * dy * dy);
    }
    lam = clamp_min(lam, kLambdaMin);
    acc += celeste::pixel_loglik<kCentered>(lam, s_cnt[p], kCentered ? s_lxt[p] : 0.0f)
           * s_mask[p];
  }
  acc = warp_sum(acc);
  if (lane == 0) out[b] = acc;
}

__global__ void __launch_bounds__(kThreads)
loglik_bwd_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
                  const float* __restrict__ my, const float* __restrict__ pa,
                  const float* __restrict__ pb, const float* __restrict__ pc,
                  const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ counts, const float* __restrict__ sky,
                  const float* __restrict__ mask, const float* __restrict__ g,
                  float* __restrict__ d_amp, float* __restrict__ d_mx,
                  float* __restrict__ d_my, float* __restrict__ d_pa,
                  float* __restrict__ d_pb, float* __restrict__ d_pc,
                  int n_chains, int n_comp, int n_pix) {
  extern __shared__ float smem[];
  float* s_px = smem;
  float* s_py = s_px + n_pix;
  float* s_cnt = s_py + n_pix;
  float* s_sky = s_cnt + n_pix;
  float* s_mask = s_sky + n_pix;
  float* s_glam = s_mask + n_pix;        // kWarps x P
  float* s_par = s_glam + kWarps * n_pix;  // kWarps x 6 x C

  for (int i = threadIdx.x; i < n_pix; i += kThreads) {
    s_px[i] = px[i];
    s_py[i] = py[i];
    s_cnt[i] = counts[i];
    s_sky[i] = sky[i];
    s_mask[i] = mask[i];
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const int C = n_comp;
  float* w_a = s_par + warp * 6 * C;
  float* w_mx = w_a + C;
  float* w_my = w_mx + C;
  float* w_pa = w_my + C;
  float* w_pb = w_pa + C;
  float* w_pc = w_pb + C;
  float* w_glam = s_glam + warp * n_pix;
  if (b < n_chains) {
    for (int c = lane; c < C; c += 32) {
      const size_t i = static_cast<size_t>(b) * C + c;
      w_a[c] = amp[i];
      w_mx[c] = mx[i];
      w_my[c] = my[i];
      w_pa[c] = pa[i];
      w_pb[c] = pb[i];
      w_pc[c] = pc[i];
    }
  }
  __syncthreads();
  if (b >= n_chains) return;

  // pass 1: lambda per pixel -> the pixel cotangent g_lam, kept in shared memory
  const float gb = g[b];
  for (int p = lane; p < n_pix; p += 32) {
    const float x = s_px[p];
    const float y = s_py[p];
    float lam = s_sky[p];
    for (int c = 0; c < C; ++c) {
      const float dx = x - w_mx[c];
      const float dy = y - w_my[c];
      const float e = expf(-0.5f * w_pa[c] * dx * dx - w_pb[c] * dx * dy
                           - 0.5f * w_pc[c] * dy * dy);
      lam += w_a[c] * e;
    }
    const float active = lam > kLambdaMin ? 1.0f : 0.0f;
    const float lam_c = clamp_min(lam, kLambdaMin);
    w_glam[p] = (gb * s_mask[p]) * (s_cnt[p] / lam_c - 1.0f) * active;
  }
  __syncwarp();

  // pass 2: per component, the six parameter cotangents
  for (int c = 0; c < C; ++c) {
    const float a = w_a[c], cx = w_mx[c], cy = w_my[c];
    const float qa = w_pa[c], qb = w_pb[c], qc = w_pc[c];
    float s_a = 0.0f, s_mx = 0.0f, s_my = 0.0f, s_pa = 0.0f, s_pb = 0.0f, s_pc = 0.0f;
    for (int p = lane; p < n_pix; p += 32) {
      const float dx = s_px[p] - cx;
      const float dy = s_py[p] - cy;
      const float e = expf(-0.5f * qa * dx * dx - qb * dx * dy - 0.5f * qc * dy * dy);
      const float ge = w_glam[p] * e;
      const float dq = -0.5f * ge * a;
      s_a += ge;
      s_pa += dq * dx * dx;
      s_pb += 2.0f * dq * dx * dy;
      s_pc += dq * dy * dy;
      s_mx += dq * -2.0f * (qa * dx + qb * dy);
      s_my += dq * -2.0f * (qb * dx + qc * dy);
    }
    s_a = warp_sum(s_a);
    s_mx = warp_sum(s_mx);
    s_my = warp_sum(s_my);
    s_pa = warp_sum(s_pa);
    s_pb = warp_sum(s_pb);
    s_pc = warp_sum(s_pc);
    if (lane == 0) {
      const size_t i = static_cast<size_t>(b) * C + c;
      d_amp[i] = s_a;
      d_mx[i] = s_mx;
      d_my[i] = s_my;
      d_pa[i] = s_pa;
      d_pb[i] = s_pb;
      d_pc[i] = s_pc;
    }
  }
}

constexpr int kRenderTile = 1024;      // pixels per K7 block

__global__ void __launch_bounds__(kThreads)
render_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
              const float* __restrict__ my, const float* __restrict__ pa,
              const float* __restrict__ pb, const float* __restrict__ pc,
              const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ sky, float* __restrict__ out,
              int n_chains, int n_comp, int n_pix) {
  extern __shared__ float smem[];
  float* s_px = smem;
  float* s_py = s_px + kRenderTile;
  float* s_sky = s_py + kRenderTile;
  float* s_par = s_sky + kRenderTile;    // kWarps x 6 x C

  const int p0 = blockIdx.y * kRenderTile;
  const int n_tile = min(kRenderTile, n_pix - p0);
  for (int i = threadIdx.x; i < n_tile; i += kThreads) {
    s_px[i] = px[p0 + i];
    s_py[i] = py[p0 + i];
    s_sky[i] = sky[p0 + i];
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const int C = n_comp;
  float* w_a = s_par + warp * 6 * C;
  float* w_mx = w_a + C;
  float* w_my = w_mx + C;
  float* w_pa = w_my + C;
  float* w_pb = w_pa + C;
  float* w_pc = w_pb + C;
  if (b < n_chains) {
    for (int c = lane; c < C; c += 32) {
      const size_t i = static_cast<size_t>(b) * C + c;
      w_a[c] = amp[i];
      w_mx[c] = mx[i];
      w_my[c] = my[i];
      w_pa[c] = pa[i];
      w_pb[c] = pb[i];
      w_pc[c] = pc[i];
    }
  }
  __syncthreads();
  if (b >= n_chains) return;

  float* row = out + static_cast<size_t>(b) * n_pix + p0;
  for (int p = lane; p < n_tile; p += 32) {
    const float x = s_px[p];
    const float y = s_py[p];
    float lam = s_sky[p];
    for (int c = 0; c < C; ++c) {
      const float dx = x - w_mx[c];
      const float dy = y - w_my[c];
      const float q = w_pa[c] * dx * dx + 2.0f * w_pb[c] * dx * dy + w_pc[c] * dy * dy;
      lam += w_a[c] * expf(-0.5f * q);
    }
    row[p] = lam;
  }
}

// Shared-memory bytes each kernel needs for C components and P pixels; a
// size above the block's limit makes launch_prep fail, and the entry points
// return that error.
size_t fwd_smem_bytes(int n_comp, int n_pix) {
  return (6 * static_cast<size_t>(n_pix) + kWarps * 6 * static_cast<size_t>(n_comp))
         * sizeof(float);
}

size_t bwd_smem_bytes(int n_comp, int n_pix) {
  return ((5 + kWarps) * static_cast<size_t>(n_pix)
          + kWarps * 6 * static_cast<size_t>(n_comp)) * sizeof(float);
}

size_t render_smem_bytes(int n_comp) {
  return (3 * static_cast<size_t>(kRenderTile) + kWarps * 6 * static_cast<size_t>(n_comp))
         * sizeof(float);
}

}  // namespace

extern "C" {

int mog_field_loglik_fwd(const float* amp, const float* mx, const float* my,
                         const float* pa, const float* pb, const float* pc,
                         const float* px, const float* py, const float* counts,
                         const float* sky, const float* mask, float* out,
                         int n_chains, int n_comp, int n_pix, int centered,
                         void* stream) {
  const size_t smem = fwd_smem_bytes(n_comp, n_pix);
  const dim3 grid((n_chains + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (centered) {
    err = launch_prep(loglik_fwd_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    loglik_fwd_kernel<true><<<grid, kThreads, smem, s>>>(
        amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, out, n_chains, n_comp, n_pix);
  } else {
    err = launch_prep(loglik_fwd_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    loglik_fwd_kernel<false><<<grid, kThreads, smem, s>>>(
        amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, out, n_chains, n_comp, n_pix);
  }
  return static_cast<int>(cudaGetLastError());
}

int mog_field_loglik_bwd(const float* amp, const float* mx, const float* my,
                         const float* pa, const float* pb, const float* pc,
                         const float* px, const float* py, const float* counts,
                         const float* sky, const float* mask, const float* g,
                         float* d_amp, float* d_mx, float* d_my,
                         float* d_pa, float* d_pb, float* d_pc,
                         int n_chains, int n_comp, int n_pix, void* stream) {
  const size_t smem = bwd_smem_bytes(n_comp, n_pix);
  const dim3 grid((n_chains + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_prep(loglik_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  loglik_bwd_kernel<<<grid, kThreads, smem, s>>>(
      amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, g,
      d_amp, d_mx, d_my, d_pa, d_pb, d_pc, n_chains, n_comp, n_pix);
  return static_cast<int>(cudaGetLastError());
}

int mog_field_render(const float* amp, const float* mx, const float* my,
                     const float* pa, const float* pb, const float* pc,
                     const float* px, const float* py, const float* sky, float* out,
                     int n_chains, int n_comp, int n_pix, void* stream) {
  const size_t smem = render_smem_bytes(n_comp);
  const dim3 grid((n_chains + kWarps - 1) / kWarps, (n_pix + kRenderTile - 1) / kRenderTile);
  cudaError_t err = launch_prep(render_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  render_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      amp, mx, my, pa, pb, pc, px, py, sky, out, n_chains, n_comp, n_pix);
  return static_cast<int>(cudaGetLastError());
}

const char* mog_field_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
