// Block-sparse tiled field kernels for Hopper (sm_90a): the log-likelihood
// forward (K2), the forward that also keeps lambda (K3), the hand backward
// with its deterministic scatter (K4), and the sky-free lambda render of the
// source-sharded field (K5) with its backward (K6).
//
// Replaces the TPU kernels of celeste_tpu/kernels/tiled_field.py:
//   K2  _tiled_kernel             (launcher _tiled_pallas_raw)
//   K3  _tiled_kernel_with_lam    (launcher _tiled_pallas_fwd_lam)
//   K4  _tiled_bwd_kernel         (launcher _tiled_bwd_pallas) and the
//       segment_sum that scatters its output back to the plane columns.
//   K5  _tiled_render_kernel      (launcher _tiled_render_raw)
//   K6  _tiled_render_bwd_kernel  (launcher _tiled_render_bwd_pallas) and its
//       segment_sum.
//
// Layout.  Every chain b carries six [B, W_plane] planes in precision form
// (amp, mx, my, pa, pb, pc), source-major: slot s owns the n_comp columns
// s*n_comp .. s*n_comp + n_comp - 1, and the last slot is the all-zero
// sentinel.  A tile is 8x128 = 1024 pixels; tile t lists s_cap slots in
// tile_src[t, :], padded with the sentinel.  Pixels come tile-major as five
// [T, 1024] arrays (px, py, counts, sky, mask); padding pixels have mask 0
// and sky 1.
//
// Math (as in celeste_tpu/kernels/tiled_field.py:116-148).  For pixel p of
// tile t and the tile's K = s_cap * n_comp components k:
//   lam   = sky + sum_k a_k e_k,  e_k = exp(-(pa dx^2 + 2 pb dx dy + pc dy^2) / 2)
//   ll_b  = sum_t sum_p mask * pixel_loglik(max(lam, eps), counts, centered)
//   g_lam = g mask (counts / max(lam, eps) - 1) [lam > eps]
//   d a = sum_p g_lam e_k;  dq = -g_lam a e_k / 2;  d pa = sum_p dq dx^2;
//   d pb = sum_p 2 dq dx dy;  d pc = sum_p dq dy^2;
//   d mx = sum_p -2 dq (pa dx + pb dy);  d my = sum_p -2 dq (pb dx + pc dy).
// The plane cotangent of a column is the sum of the cotangents of every
// (tile, slot) entry that lists it; the sentinel is listed by many.
// K5 stores the sky-free sum_k a_k e_k and nothing else: the sharded path
// sums it over the source shards before sky and the logarithm.  K6 is K4
// with the per-pixel cotangent g[t, b, p] of that sum given in place of
// g_lam.
//
// What bounds it on the card.  Per (chain, tile) the forward does K
// exponentials and ~12 K FP32 operations for each of 1024 pixels, plus one
// logarithm per pixel, against 6 K * 4 bytes of gathered parameters: it is
// bound by the special-function unit and FP32 issue, not by memory.  K3
// also writes lambda, 4 KB per (chain, tile); K4 reads it back, which saves
// the backward one pass of exponentials.  K5 does K2's exponentials and
// writes 4 KB of lambda per (chain, tile), ~1% of its time at config 5's
// K ~ 110; K6 does K4's work and reads 4 KB of cotangent per (chain, tile):
// both stay bound by FP32 throughput.
//
// What the design does about that.  A block is one tile and 8 chains; one
// warp owns one chain and its lanes stride over the tile's 1024 pixels.  The
// tile's pixel arrays (20 KB) are staged once per block in shared memory.
// Each warp gathers its chain's K components straight from the planes by
// the tile's tile_src row (no gathered copy of the planes in device memory,
// which the TPU needed only because Mosaic cannot slice lanes by data) and
// stages them, pre-transformed (a, mx, my, -pa/2, -pb, -pc/2), in shared
// memory.  The inner loop is then two subtractions, a few FMAs, one exp and
// one multiply per (pixel, component); the amplitude multiplies e (a * e,
// not exp(log a + ...)), so the sentinel (a = 0 and a zero quadratic form)
// adds exactly 0 and its gradient stays finite.  The per-chain sum is a
// shuffle tree; per-tile partials [T, B] are summed by the caller in a fixed
// order.  K4 writes per-(tile, entry) cotangents [6, T * K, B] and a second
// kernel sums them into the plane columns through a host-built column ->
// entry list (CSR), in list order: no atomics, so two calls on the same
// inputs give bitwise-equal gradients.  K5 is a third instantiation of the
// forward kernel (lambda from 0, stored, no reduction) and K6 a second one
// of the backward kernel (the cotangent row read, not derived), so the
// render pair shares the gather, the staging, the scatter and the
// determinism of K2-K4.
//
// Interface: plain C, bound with ctypes.  Each entry launches on the given
// stream, allocates nothing and returns cudaGetLastError() after its last
// launch.

#include <cuda_runtime.h>

#include "mog_common.cuh"

namespace {

using celeste::clamp_min;
using celeste::kLambdaMin;
using celeste::launch_prep;
using celeste::warp_sum;

constexpr int kPix = 1024;              // parallel/tiles.py PIX_PER_TILE
constexpr int kWarps = 8;               // chains per block
constexpr int kThreads = kWarps * 32;
constexpr int kScatterThreads = 128;

// What the forward kernel produces: K2 the per-tile log-likelihood, K3 that
// and the pre-clamp lambda (sky included), K5 the sky-free lambda alone.
enum FwdMode { kLoglik, kLoglikLam, kRender };

// Stage chain b's gathered components of tile t, pre-transformed for the
// forward: a, mx, my, -pa/2, -pb, -pc/2 ([6][K] floats at w).
__device__ __forceinline__ void stage_components(
    const float* __restrict__ amp, const float* __restrict__ mx,
    const float* __restrict__ my, const float* __restrict__ pa,
    const float* __restrict__ pb, const float* __restrict__ pc,
    const int* __restrict__ src_row, float* w, int b, int plane_w, int n_comp,
    int n_k, int lane) {
  for (int k = lane; k < n_k; k += 32) {
    const int col = src_row[k / n_comp] * n_comp + k % n_comp;
    const size_t i = static_cast<size_t>(b) * plane_w + col;
    w[k] = amp[i];
    w[n_k + k] = mx[i];
    w[2 * n_k + k] = my[i];
    w[3 * n_k + k] = -0.5f * pa[i];
    w[4 * n_k + k] = -pb[i];
    w[5 * n_k + k] = -0.5f * pc[i];
  }
}

// K2 (kLoglik), K3 (kLoglikLam) and K5 (kRender).  Grid (tiles, chain
// blocks); K2 and K3 write partial[t, b]; K3 writes the pre-clamp lambda
// lam[t, b, p] with sky, K5 the sum of the components without it.  K5 reads
// only px and py of the pixel arrays (the others may be null).
template <bool kCentered, int kMode>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
                 const float* __restrict__ my, const float* __restrict__ pa,
                 const float* __restrict__ pb, const float* __restrict__ pc,
                 const int* __restrict__ tile_src, const float* __restrict__ px,
                 const float* __restrict__ py, const float* __restrict__ counts,
                 const float* __restrict__ sky, const float* __restrict__ mask,
                 float* __restrict__ partial, float* __restrict__ lam_out,
                 int n_chains, int plane_w, int s_cap, int n_comp) {
  constexpr bool kReduce = kMode != kRender;
  constexpr bool kStoreLam = kMode != kLoglik;
  extern __shared__ float smem[];
  float* s_px = smem;
  float* s_py = s_px + kPix;
  float* s_cnt = s_py + kPix;            // counts .. log max(counts, eps):
  float* s_sky = s_cnt + kPix;           // the log-likelihood's arrays,
  float* s_mask = s_sky + kPix;          // absent from K5's shared memory
  float* s_lxt = s_mask + kPix;          // (centered only)
  float* s_par = kReduce ? s_lxt + kPix : s_cnt;   // kWarps x 6 x K

  const int t = blockIdx.x;
  const size_t tile_off = static_cast<size_t>(t) * kPix;
  for (int i = threadIdx.x; i < kPix; i += kThreads) {
    s_px[i] = px[tile_off + i];
    s_py[i] = py[tile_off + i];
    if (kReduce) {
      s_cnt[i] = counts[tile_off + i];
      s_sky[i] = sky[tile_off + i];
      s_mask[i] = mask[tile_off + i];
      if (kCentered) s_lxt[i] = logf(clamp_min(counts[tile_off + i], kLambdaMin));
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * kWarps + warp;
  const int n_k = s_cap * n_comp;
  float* w = s_par + warp * 6 * n_k;
  if (b < n_chains) {
    stage_components(amp, mx, my, pa, pb, pc, tile_src + static_cast<size_t>(t) * s_cap, w,
                     b, plane_w, n_comp, n_k, lane);
  }
  __syncthreads();
  if (b >= n_chains) return;

  const float* w_a = w;
  const float* w_mx = w + n_k;
  const float* w_my = w + 2 * n_k;
  const float* w_ha = w + 3 * n_k;
  const float* w_hb = w + 4 * n_k;
  const float* w_hc = w + 5 * n_k;
  float* lam_row = kStoreLam ? lam_out + (static_cast<size_t>(t) * n_chains + b) * kPix
                             : nullptr;
  float acc = 0.0f;
  for (int p = lane; p < kPix; p += 32) {
    const float x = s_px[p];
    const float y = s_py[p];
    float lam = kReduce ? s_sky[p] : 0.0f;
    for (int k = 0; k < n_k; ++k) {
      const float dx = x - w_mx[k];
      const float dy = y - w_my[k];
      lam += w_a[k] * expf(w_ha[k] * dx * dx + w_hb[k] * dx * dy + w_hc[k] * dy * dy);
    }
    if (kStoreLam) lam_row[p] = lam;
    if (kReduce) {
      lam = clamp_min(lam, kLambdaMin);
      acc += celeste::pixel_loglik<kCentered>(lam, s_cnt[p], kCentered ? s_lxt[p] : 0.0f)
             * s_mask[p];
    }
  }
  if (kReduce) {
    acc = warp_sum(acc);
    if (lane == 0) partial[static_cast<size_t>(t) * n_chains + b] = acc;
  }
}

// K4 (kRender = false) and K6 (kRender = true), part 1.  Grid (tiles, chain
// blocks).  Pass 1 stages the pixel cotangent (shared memory, one row per
// warp): K4 derives g_lam from lambda, counts, mask and g [B]; K6 reads the
// given cotangent g [T, B, 1024] (counts, mask and lam_in may be null).
// Pass 2 sums the six cotangents of each of the tile's K entries over the
// pixels and writes them to d_part[q, t * K + k, b].
template <bool kRender>
__global__ void __launch_bounds__(kThreads)
tiled_bwd_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
                 const float* __restrict__ my, const float* __restrict__ pa,
                 const float* __restrict__ pb, const float* __restrict__ pc,
                 const int* __restrict__ tile_src, const float* __restrict__ px,
                 const float* __restrict__ py, const float* __restrict__ counts,
                 const float* __restrict__ mask, const float* __restrict__ lam_in,
                 const float* __restrict__ g, float* __restrict__ d_part,
                 int n_tiles, int n_chains, int plane_w, int s_cap, int n_comp) {
  extern __shared__ float smem[];
  float* s_px = smem;
  float* s_py = s_px + kPix;
  float* s_glam = s_py + kPix;           // kWarps x kPix

  const int t = blockIdx.x;
  const size_t tile_off = static_cast<size_t>(t) * kPix;
  for (int i = threadIdx.x; i < kPix; i += kThreads) {
    s_px[i] = px[tile_off + i];
    s_py[i] = py[tile_off + i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * kWarps + warp;
  if (b >= n_chains) return;

  float* w_glam = s_glam + warp * kPix;
  const size_t row = (static_cast<size_t>(t) * n_chains + b) * kPix;
  if (kRender) {
    for (int p = lane; p < kPix; p += 32) w_glam[p] = g[row + p];
  } else {
    const float gb = g[b];
    for (int p = lane; p < kPix; p += 32) {
      const float lam = lam_in[row + p];
      const float active = lam > kLambdaMin ? 1.0f : 0.0f;
      w_glam[p] = (gb * mask[tile_off + p])
                  * (counts[tile_off + p] / clamp_min(lam, kLambdaMin) - 1.0f) * active;
    }
  }
  __syncwarp();

  const int n_k = s_cap * n_comp;
  const size_t plane_stride = static_cast<size_t>(n_tiles) * n_k * n_chains;
  const int* src_row = tile_src + static_cast<size_t>(t) * s_cap;
  for (int k = 0; k < n_k; ++k) {
    const size_t i = static_cast<size_t>(b) * plane_w + src_row[k / n_comp] * n_comp
                     + k % n_comp;
    const float a = amp[i], cx = mx[i], cy = my[i];
    const float qa = pa[i], qb = pb[i], qc = pc[i];
    float s_a = 0.0f, s_mx = 0.0f, s_my = 0.0f, s_pa = 0.0f, s_pb = 0.0f, s_pc = 0.0f;
    for (int p = lane; p < kPix; p += 32) {
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
      const size_t o = (static_cast<size_t>(t) * n_k + k) * n_chains + b;
      d_part[o] = s_a;
      d_part[plane_stride + o] = s_mx;
      d_part[2 * plane_stride + o] = s_my;
      d_part[3 * plane_stride + o] = s_pa;
      d_part[4 * plane_stride + o] = s_pb;
      d_part[5 * plane_stride + o] = s_pc;
    }
  }
}

// K4, part 2: the deterministic scatter.  Grid (plane columns, chain
// blocks); thread b of column c sums d_part over the entries listed for c in
// col_ptr/col_ent, in list order, for each of the six planes, into
// d_planes[q, b, c].  A column that no tile lists gets 0.
__global__ void __launch_bounds__(kScatterThreads)
tiled_scatter_kernel(const float* __restrict__ d_part, const int* __restrict__ col_ptr,
                     const int* __restrict__ col_ent, float* __restrict__ d_planes,
                     int n_rows, int n_chains, int plane_w) {
  const int col = blockIdx.x;
  const int b = blockIdx.y * kScatterThreads + threadIdx.x;
  if (b >= n_chains) return;
  const int lo = col_ptr[col], hi = col_ptr[col + 1];
  const size_t part_stride = static_cast<size_t>(n_rows) * n_chains;
  const size_t out_stride = static_cast<size_t>(n_chains) * plane_w;
  const size_t o = static_cast<size_t>(b) * plane_w + col;
  for (int q = 0; q < 6; ++q) {
    const float* part = d_part + q * part_stride;
    float s = 0.0f;
    for (int e = lo; e < hi; ++e) s += part[static_cast<size_t>(col_ent[e]) * n_chains + b];
    d_planes[q * out_stride + o] = s;
  }
}

// The pixel arrays the forward stages (six for K2/K3, px and py for K5) and
// every warp's 6 x K components.
size_t fwd_smem_bytes(int n_k, int n_pixel_arrays) {
  return (n_pixel_arrays * static_cast<size_t>(kPix) + kWarps * 6 * static_cast<size_t>(n_k))
         * sizeof(float);
}

size_t bwd_smem_bytes() {
  return (2 + kWarps) * static_cast<size_t>(kPix) * sizeof(float);
}

template <bool kCentered, int kMode>
cudaError_t launch_fwd(const float* amp, const float* mx, const float* my, const float* pa,
                       const float* pb, const float* pc, const int* tile_src,
                       const float* px, const float* py, const float* counts,
                       const float* sky, const float* mask, float* partial, float* lam,
                       int n_tiles, int n_chains, int plane_w, int s_cap, int n_comp,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(s_cap * n_comp, kMode == kRender ? 2 : 6);
  const cudaError_t err = launch_prep(tiled_fwd_kernel<kCentered, kMode>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (n_chains + kWarps - 1) / kWarps);
  tiled_fwd_kernel<kCentered, kMode><<<grid, kThreads, smem, stream>>>(
      amp, mx, my, pa, pb, pc, tile_src, px, py, counts, sky, mask, partial, lam, n_chains,
      plane_w, s_cap, n_comp);
  return cudaGetLastError();
}

// Part 1 of K4 or K6, then the scatter of part 2 into d_planes.
template <bool kRender>
cudaError_t launch_bwd(const float* amp, const float* mx, const float* my, const float* pa,
                       const float* pb, const float* pc, const int* tile_src,
                       const float* px, const float* py, const float* counts,
                       const float* mask, const float* lam, const float* g,
                       const int* col_ptr, const int* col_ent, float* d_part, float* d_planes,
                       int n_tiles, int n_chains, int plane_w, int s_cap, int n_comp,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes();
  cudaError_t err = launch_prep(tiled_bwd_kernel<kRender>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (n_chains + kWarps - 1) / kWarps);
  tiled_bwd_kernel<kRender><<<grid, kThreads, smem, stream>>>(
      amp, mx, my, pa, pb, pc, tile_src, px, py, counts, mask, lam, g, d_part, n_tiles,
      n_chains, plane_w, s_cap, n_comp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sgrid(plane_w, (n_chains + kScatterThreads - 1) / kScatterThreads);
  tiled_scatter_kernel<<<sgrid, kScatterThreads, 0, stream>>>(
      d_part, col_ptr, col_ent, d_planes, n_tiles * s_cap * n_comp, n_chains, plane_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 (lam == nullptr) or K3 (lam != nullptr, [T, B, 1024]): per-tile
// partial log-likelihoods partial [T, B].
int tiled_field_fwd(const float* amp, const float* mx, const float* my, const float* pa,
                    const float* pb, const float* pc, const int* tile_src, const float* px,
                    const float* py, const float* counts, const float* sky,
                    const float* mask, float* partial, float* lam, int n_tiles,
                    int n_chains, int plane_w, int s_cap, int n_comp, int centered,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (centered) {
    err = lam ? launch_fwd<true, kLoglikLam>(amp, mx, my, pa, pb, pc, tile_src, px, py, counts,
                                             sky, mask, partial, lam, n_tiles, n_chains,
                                             plane_w, s_cap, n_comp, s)
              : launch_fwd<true, kLoglik>(amp, mx, my, pa, pb, pc, tile_src, px, py, counts,
                                          sky, mask, partial, lam, n_tiles, n_chains, plane_w,
                                          s_cap, n_comp, s);
  } else {
    err = lam ? launch_fwd<false, kLoglikLam>(amp, mx, my, pa, pb, pc, tile_src, px, py,
                                              counts, sky, mask, partial, lam, n_tiles,
                                              n_chains, plane_w, s_cap, n_comp, s)
              : launch_fwd<false, kLoglik>(amp, mx, my, pa, pb, pc, tile_src, px, py, counts,
                                           sky, mask, partial, lam, n_tiles, n_chains, plane_w,
                                           s_cap, n_comp, s);
  }
  return static_cast<int>(err);
}

// K4: the six plane cotangents d_planes [6, B, plane_w] (amp, mx, my, pa,
// pb, pc) from lambda [T, B, 1024] and g [B].  d_part is caller-provided
// scratch of 6 * T * s_cap * n_comp * B floats; col_ptr [plane_w + 1] and
// col_ent list, for each plane column, the rows t * K + k of the entries
// that reference it.
int tiled_field_bwd(const float* amp, const float* mx, const float* my, const float* pa,
                    const float* pb, const float* pc, const int* tile_src, const float* px,
                    const float* py, const float* counts, const float* mask,
                    const float* lam, const float* g, const int* col_ptr,
                    const int* col_ent, float* d_part, float* d_planes, int n_tiles,
                    int n_chains, int plane_w, int s_cap, int n_comp, void* stream) {
  return static_cast<int>(launch_bwd<false>(
      amp, mx, my, pa, pb, pc, tile_src, px, py, counts, mask, lam, g, col_ptr, col_ent, d_part,
      d_planes, n_tiles, n_chains, plane_w, s_cap, n_comp, static_cast<cudaStream_t>(stream)));
}

// K5: the sky-free lambda lam [T, B, 1024] of one table's tiles.
int tiled_field_render(const float* amp, const float* mx, const float* my, const float* pa,
                       const float* pb, const float* pc, const int* tile_src, const float* px,
                       const float* py, float* lam, int n_tiles, int n_chains, int plane_w,
                       int s_cap, int n_comp, void* stream) {
  return static_cast<int>(launch_fwd<false, kRender>(
      amp, mx, my, pa, pb, pc, tile_src, px, py, nullptr, nullptr, nullptr, nullptr, lam,
      n_tiles, n_chains, plane_w, s_cap, n_comp, static_cast<cudaStream_t>(stream)));
}

// K6: the six plane cotangents d_planes [6, B, plane_w] from the cotangent
// g [T, B, 1024] of K5's output; d_part, col_ptr and col_ent as for K4.
int tiled_field_render_bwd(const float* amp, const float* mx, const float* my,
                           const float* pa, const float* pb, const float* pc,
                           const int* tile_src, const float* px, const float* py,
                           const float* g, const int* col_ptr, const int* col_ent,
                           float* d_part, float* d_planes, int n_tiles, int n_chains,
                           int plane_w, int s_cap, int n_comp, void* stream) {
  return static_cast<int>(launch_bwd<true>(
      amp, mx, my, pa, pb, pc, tile_src, px, py, nullptr, nullptr, nullptr, g, col_ptr, col_ent,
      d_part, d_planes, n_tiles, n_chains, plane_w, s_cap, n_comp,
      static_cast<cudaStream_t>(stream)));
}

const char* tiled_field_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
