// Separable Poisson log-likelihood of isotropic mixtures for Hopper
// (sm_90a): the forward kernel and its hand-written backward (K8).
//
// Replaces the TPU kernel celeste_tpu/kernels/mog_field_sep.py::
// _sep_loglik_kernel (launcher _sep_pallas_raw) and the autodiff of its
// dense mirror, _sep_bwd (backward; JAX has no Pallas body for it).
//
// Math.  Chain b carries C isotropic components: amplitude a (flux,
// calibration, weight and the normaliser iv / 2 pi folded in), centre
// (cx, cy) and inverse variance iv.  An isotropic Gaussian factors over the
// pixel axes, so for column x_w and row y_h
//   row_c[w] = a_c ex_c[w],  ex_c[w] = exp(-iv_c (x_w - cx_c)^2 / 2)
//   col_c[h] = exp(-iv_c (y_h - cy_c)^2 / 2)
//   lam[h, w] = sky + sum_c col_c[h] row_c[w]
//   ll_b = sum_{h,w} mask * pixel_loglik(max(lam, eps), counts, centered)
// and the backward, given the cotangent g_b of ll_b, is separable too:
//   g_lam = g mask (counts / max(lam, eps) - 1) [lam > eps]
//   R_c[w] = sum_h g_lam[h, w] col_c[h],   G_c[h] = sum_w g_lam[h, w] row_c[w]
//   d a  = sum_w R_c ex_c;   d cx = iv sum_w R_c row_c dx;
//   d cy = iv sum_h G_c col_c dy;
//   d iv = -(sum_w R_c row_c dx^2 + sum_h G_c col_c dy^2) / 2.
// The centered flag only adds parameter-free per-pixel terms, so the
// backward does not take it.
//
// What bounds it on the card.  Per chain the forward does C (H + W)
// exponentials (150 for a 25x25 stamp with C = 3, against K1's 1875), then
// C multiply-adds and one logarithm per pixel; it reads 4 C 4 bytes of
// parameters and writes 4.  So it is bound by FP32 issue and the per-pixel
// logarithm, not by memory.  The backward adds one division per pixel and
// 4 C multiply-adds per pixel for the two contractions.
//
// What the design does about that.  One warp owns one chain (8 per block).
// The stamp's counts, sky and mask are staged once per block in shared
// memory, a band of rows at a time (below); each warp computes its chain's
// C (H + W) factors once into shared memory, then its lanes stride over the
// flat pixels of the band (not over a 25-wide row, which would idle 7 of
// 32 lanes; nothing of the TPU's (B_TILE, W_pad) lane layout is kept), and
// the per-chain sum is a shuffle tree.  The
// backward keeps the chain's g_lam of a band in shared memory, contracts
// it into R_c (lanes over w) and G_c (lanes over h), and finishes with short
// sums over W and H.  Rows are a * ex, never exp(log a + ...), so a zero
// amplitude contributes exactly 0 and its cotangents stay finite.  Each
// chain owns its outputs: no atomics, and repeated calls are bitwise equal.
//
// The stamp's per-pixel arrays (and the backward's g_lam) are staged in
// bands of whole rows, as many rows as fit kBandPix pixels (at least one),
// so shared memory does not grow with H W: a block walks the bands in row
// order with one code path for every size.  Row factors and their
// cotangent sums are local to a band; the column contractions R_c[w]
// accumulate across bands in band order in shared memory, so the sums keep
// a fixed order and a stamp of at most kBandPix pixels (config 1's 25x25)
// runs as before, in one band.  What remains in shared memory is the
// factors, kWarps C (H + W) floats (the backward kWarps C (3 W + H + 2)),
// beside the bands: with C = 3 the forward takes W + H up to about 2100 and
// the backward 3 W + H up to about 1480 (a square stamp up to about
// 370x370).  Beyond that the launch fails and the wrapper raises.
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
constexpr int kBandPix = 2048;          // pixels of the rows staged per band

// Rows per band of a stamp w pixels wide: as many as fit kBandPix, at most
// h, and at least one, so that an empty stamp still takes one (empty) band.
__host__ __device__ inline int band_rows(int h, int w) {
  const int rows = w > 0 ? kBandPix / w : h;
  return rows > h ? (h > 0 ? h : 1) : (rows < 1 ? 1 : rows);
}

template <bool kCentered>
__global__ void __launch_bounds__(kThreads)
sep_fwd_kernel(const float* __restrict__ amp, const float* __restrict__ cx,
               const float* __restrict__ cy, const float* __restrict__ iv,
               const float* __restrict__ xs, const float* __restrict__ ys,
               const float* __restrict__ counts, const float* __restrict__ sky,
               const float* __restrict__ mask, float* __restrict__ out,
               int n_chains, int n_comp, int h, int w) {
  extern __shared__ float smem[];
  const int rows_per_band = band_rows(h, w);
  const int band_pix = rows_per_band * w;
  float* s_cnt = smem;
  float* s_sky = s_cnt + band_pix;
  float* s_mask = s_sky + band_pix;
  float* s_lxt = s_mask + band_pix;      // log max(counts, eps), centered only
  float* s_fac = s_lxt + band_pix;       // kWarps x C x (W + H)

  // stage the band of rows from h0; band 0 goes before the factors, so
  // that its loads are in flight while they take their exponentials
  auto stage = [&](int h0) {
    const int n_band = min(rows_per_band, h - h0) * w;
    const size_t off = static_cast<size_t>(h0) * w;
    for (int i = threadIdx.x; i < n_band; i += kThreads) {
      s_cnt[i] = counts[off + i];
      s_sky[i] = sky[off + i];
      s_mask[i] = mask[off + i];
      if (kCentered) s_lxt[i] = logf(clamp_min(counts[off + i], kLambdaMin));
    }
  };
  stage(0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const bool valid = b < n_chains;
  const int C = n_comp;
  float* rows = s_fac + warp * C * (w + h);   // C x W: a ex
  float* cols = rows + C * w;                 // C x H
  if (valid) {
    for (int i = lane; i < C * w; i += 32) {
      const int c = i / w;
      const size_t k = static_cast<size_t>(b) * C + c;
      const float dx = xs[i - c * w] - cx[k];
      rows[i] = amp[k] * expf(-0.5f * iv[k] * dx * dx);
    }
    for (int i = lane; i < C * h; i += 32) {
      const int c = i / h;
      const size_t k = static_cast<size_t>(b) * C + c;
      const float dy = ys[i - c * h] - cy[k];
      cols[i] = expf(-0.5f * iv[k] * dy * dy);
    }
  }

  float acc = 0.0f;
  for (int h0 = 0; h0 == 0 || h0 < h; h0 += rows_per_band) {
    const int n_band = min(rows_per_band, h - h0) * w;
    if (h0 != 0) {
      __syncthreads();                   // the last band is read
      stage(h0);
    }
    __syncthreads();                     // the band (and the factors) ready
    if (!valid) continue;
    for (int p = lane; p < n_band; p += 32) {
      const int hh = h0 + p / w;
      const int ww = p - (hh - h0) * w;
      float lam = s_sky[p];
      for (int c = 0; c < C; ++c) lam += cols[c * h + hh] * rows[c * w + ww];
      lam = clamp_min(lam, kLambdaMin);
      acc += celeste::pixel_loglik<kCentered>(lam, s_cnt[p], kCentered ? s_lxt[p] : 0.0f)
             * s_mask[p];
    }
  }
  acc = warp_sum(acc);
  if (valid && lane == 0) out[b] = acc;
}

__global__ void __launch_bounds__(kThreads)
sep_bwd_kernel(const float* __restrict__ amp, const float* __restrict__ cx,
               const float* __restrict__ cy, const float* __restrict__ iv,
               const float* __restrict__ xs, const float* __restrict__ ys,
               const float* __restrict__ counts, const float* __restrict__ sky,
               const float* __restrict__ mask, const float* __restrict__ g,
               float* __restrict__ d_amp, float* __restrict__ d_cx,
               float* __restrict__ d_cy, float* __restrict__ d_iv,
               int n_chains, int n_comp, int h, int w) {
  extern __shared__ float smem[];
  const int rows_per_band = band_rows(h, w);
  const int band_pix = rows_per_band * w;
  const int C = n_comp;
  float* s_cnt = smem;
  float* s_sky = s_cnt + band_pix;
  float* s_mask = s_sky + band_pix;
  float* s_glam = s_mask + band_pix;            // kWarps x band
  float* s_fac = s_glam + kWarps * band_pix;    // kWarps x (C (3 W + H) + 2 C)

  // as the forward: band 0 is staged before the factors
  auto stage = [&](int h0) {
    const int n_band = min(rows_per_band, h - h0) * w;
    const size_t off = static_cast<size_t>(h0) * w;
    for (int i = threadIdx.x; i < n_band; i += kThreads) {
      s_cnt[i] = counts[off + i];
      s_sky[i] = sky[off + i];
      s_mask[i] = mask[off + i];
    }
  };
  stage(0);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const bool valid = b < n_chains;
  float* glam = s_glam + warp * band_pix;
  float* ex = s_fac + warp * C * (3 * w + h + 2);   // C x W
  float* rows = ex + C * w;                     // C x W: a ex
  float* cols = rows + C * w;                   // C x H
  float* r_sum = cols + C * h;                  // C x W: R_c[w], summed over the bands
  float* cy_sum = r_sum + C * w;                // C: sum_h G_c col_c dy, over the bands
  float* vy_sum = cy_sum + C;                   // C: sum_h G_c col_c dy^2, over the bands
  if (valid) {
    for (int i = lane; i < C * w; i += 32) {
      const int c = i / w;
      const size_t k = static_cast<size_t>(b) * C + c;
      const float dx = xs[i - c * w] - cx[k];
      const float e = expf(-0.5f * iv[k] * dx * dx);
      ex[i] = e;
      rows[i] = amp[k] * e;
      r_sum[i] = 0.0f;
    }
    for (int i = lane; i < C * h; i += 32) {
      const int c = i / h;
      const size_t k = static_cast<size_t>(b) * C + c;
      const float dy = ys[i - c * h] - cy[k];
      cols[i] = expf(-0.5f * iv[k] * dy * dy);
    }
    for (int c = lane; c < C; c += 32) {
      cy_sum[c] = 0.0f;
      vy_sum[c] = 0.0f;
    }
  }

  const float gb = valid ? g[b] : 0.0f;
  for (int h0 = 0; h0 == 0 || h0 < h; h0 += rows_per_band) {
    const int n_rows = min(rows_per_band, h - h0);
    const int n_band = n_rows * w;
    if (h0 != 0) {
      __syncthreads();                   // the last band is read
      stage(h0);
    }
    __syncthreads();                     // the band (and the factors) ready
    if (!valid) continue;

    // pass 1: lambda per pixel -> the pixel cotangent g_lam of the band
    for (int p = lane; p < n_band; p += 32) {
      const int hh = h0 + p / w;
      const int ww = p - (hh - h0) * w;
      float lam = s_sky[p];
      for (int c = 0; c < C; ++c) lam += cols[c * h + hh] * rows[c * w + ww];
      const float active = lam > kLambdaMin ? 1.0f : 0.0f;
      const float lam_c = clamp_min(lam, kLambdaMin);
      glam[p] = (gb * s_mask[p]) * (s_cnt[p] / lam_c - 1.0f) * active;
    }
    __syncwarp();

    // pass 2: per component, the band's share of R_c (over its rows, lanes
    // over w) and G_c (over the columns, lanes over the band's rows); in
    // the last band R_c is complete, and the column sums and the four
    // cotangents follow in the same loop
    const bool last = h0 + n_rows == h;
    for (int c = 0; c < C; ++c) {
      const size_t k = static_cast<size_t>(b) * C + c;
      const float cxc = cx[k], cyc = cy[k], ivc = iv[k];
      const float* ex_c = ex + c * w;
      const float* row_c = rows + c * w;
      const float* col_c = cols + c * h;
      float* r_c = r_sum + c * w;
      float s_a = 0.0f, s_cx = 0.0f, s_vx = 0.0f;
      for (int x = lane; x < w; x += 32) {
        float r = r_c[x];
        for (int y = 0; y < n_rows; ++y) r += glam[y * w + x] * col_c[h0 + y];
        if (last) {
          const float dx = xs[x] - cxc;
          const float rr = r * row_c[x];
          s_a += r * ex_c[x];
          s_cx += rr * dx;
          s_vx += rr * dx * dx;
        } else {
          r_c[x] = r;
        }
      }
      float s_cy = 0.0f, s_vy = 0.0f;
      for (int y = lane; y < n_rows; y += 32) {
        float s = 0.0f;
        for (int x = 0; x < w; ++x) s += glam[y * w + x] * row_c[x];
        const float dy = ys[h0 + y] - cyc;
        const float gg = s * col_c[h0 + y];
        s_cy += gg * dy;
        s_vy += gg * dy * dy;
      }
      s_cy = warp_sum(s_cy);
      s_vy = warp_sum(s_vy);
      if (last) {
        s_a = warp_sum(s_a);
        s_cx = warp_sum(s_cx);
        s_vx = warp_sum(s_vx);
        if (lane == 0) {
          d_amp[k] = s_a;
          d_cx[k] = ivc * s_cx;
          d_cy[k] = ivc * (cy_sum[c] + s_cy);
          d_iv[k] = -0.5f * (s_vx + (vy_sum[c] + s_vy));
        }
      } else if (lane == 0) {
        cy_sum[c] += s_cy;
        vy_sum[c] += s_vy;
      }
    }
    __syncwarp();
  }
}

// Shared-memory bytes each kernel needs for C components on an H x W
// stamp: one band of rows and the factors.  A size above the block's limit
// makes launch_prep fail, and the entry points return that error.
size_t fwd_smem_bytes(int n_comp, int h, int w) {
  return (4 * static_cast<size_t>(band_rows(h, w)) * w
          + kWarps * static_cast<size_t>(n_comp) * (w + h)) * sizeof(float);
}

size_t bwd_smem_bytes(int n_comp, int h, int w) {
  return ((3 + kWarps) * static_cast<size_t>(band_rows(h, w)) * w
          + kWarps * static_cast<size_t>(n_comp) * (3 * w + h + 2)) * sizeof(float);
}

}  // namespace

extern "C" {

int mog_field_sep_fwd(const float* amp, const float* cx, const float* cy, const float* iv,
                      const float* xs, const float* ys, const float* counts,
                      const float* sky, const float* mask, float* out,
                      int n_chains, int n_comp, int h, int w, int centered, void* stream) {
  const size_t smem = fwd_smem_bytes(n_comp, h, w);
  const dim3 grid((n_chains + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (centered) {
    err = launch_prep(sep_fwd_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sep_fwd_kernel<true><<<grid, kThreads, smem, s>>>(
        amp, cx, cy, iv, xs, ys, counts, sky, mask, out, n_chains, n_comp, h, w);
  } else {
    err = launch_prep(sep_fwd_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sep_fwd_kernel<false><<<grid, kThreads, smem, s>>>(
        amp, cx, cy, iv, xs, ys, counts, sky, mask, out, n_chains, n_comp, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

int mog_field_sep_bwd(const float* amp, const float* cx, const float* cy, const float* iv,
                      const float* xs, const float* ys, const float* counts,
                      const float* sky, const float* mask, const float* g,
                      float* d_amp, float* d_cx, float* d_cy, float* d_iv,
                      int n_chains, int n_comp, int h, int w, void* stream) {
  const size_t smem = bwd_smem_bytes(n_comp, h, w);
  const dim3 grid((n_chains + kWarps - 1) / kWarps);
  cudaError_t err = launch_prep(sep_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sep_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      amp, cx, cy, iv, xs, ys, counts, sky, mask, g, d_amp, d_cx, d_cy, d_iv,
      n_chains, n_comp, h, w);
  return static_cast<int>(cudaGetLastError());
}

const char* mog_field_sep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
