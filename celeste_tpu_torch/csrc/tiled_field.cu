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
// What bounds it on the card.  Every (pixel, component) term needs one
// exponential, and the special-function unit gives 16 per clock per SM
// against 128 FP32 lanes (CUDA Programming Guide, arithmetic throughput,
// compute capability 9.0): at config 5's ~6.7e8 terms per call that alone
// is ~0.16 ms at 1.98 GHz.  A term's FP32 work (the offsets, the quadratic
// form, the amplitude's multiply-add; in the backward the six pixel moments)
// competes with the exponential for the SM's four issue slots per clock, so
// the kernels are bound by instruction issue, never by memory: per (chain,
// tile) they read 32 K bytes of parameters against ~1024 K exponentials.
// On the H100 (PERF.md) K3 runs only ~10% faster with its exponential taken
// out: issue, not the special-function unit, sets the pace, reached at
// ~60% because each term is a chain of dependent instructions and config
// 5's grid gives each scheduler ~4-6 warps.  K3 writes lambda (4 KB per chain and tile)
// and K4 reads it back, which spares the backward a second pass of
// exponentials; K5 writes the sky-free lambda and K6 reads its cotangent.
//
// What the design does about that.  A block is one tile and 8 chains; one
// warp owns one chain.  The tile's pixel arrays are staged once per block in
// shared memory, and each warp gathers its chain's K components straight
// from the planes by the tile's tile_src row (no gathered copy of the planes
// in device memory, which the TPU needed only because Mosaic cannot slice
// lanes by data) into shared memory as two float4 per component,
// (a, mx, my, column) and (qa, qb, qc, 0), with the quadratic form's
// coefficients in base 2 (qa = -pa log2e / 2, qb = -pb log2e,
// qc = -pc log2e / 2) so that e = 2^(qa dx^2 + qb dx dy + qc dy^2) is one
// ex2.approx (mog_common.cuh): one MUFU.EX2 and no FP32 range reduction.
// The amplitude multiplies e (a * e, not 2^(log2 a + ...)), so the zero
// sentinel (a = 0 and a zero form, 2^0 = 1 exactly) adds exactly 0 and its
// gradient stays finite.
//   Forward (K2, K3, K5): a lane keeps kFwdPix of its 32 pixels in
// registers (x, y and lambda) and walks the components with two broadcast
// 16-byte shared loads per component for all of them, so a term costs ~8
// FP32 instructions and one MUFU.EX2, with no shared load of its own.  Each
// pixel adds its components in index order, its Poisson term is taken with
// the accurate logf, and the per-chain sum is a shuffle tree over lanes that
// each summed their pixels in index order; K2 and K3 write per-tile partials
// [T, B] that the caller sums in a fixed order.
//   Backward (K4, K6), in moment form.  With ge = g_lam e summed over the
// pixels into S0 = sum ge, Sx = sum ge dx, Sy = sum ge dy, Sxx = sum ge dx^2,
// Sxy = sum ge dx dy and Syy = sum ge dy^2, an entry's cotangents are
//   d a = S0,  d pa = -a Sxx / 2,  d pb = -a Sxy,  d pc = -a Syy / 2,
//   d mx = a (pa Sx + pb Sy),  d my = a (pb Sx + pc Sy):
// the algebra above with the constant -a/2 taken out of the sums, and the
// products dx^2, dx dy, dy^2 shared by the exponent and the moments.  Lanes
// stride over the pixels; each pass over a lane's pixels serves kBwdEntries
// entries, so one load of (px, py) and of g_lam feeds that many terms, and
// the 6 kBwdEntries moments are then summed over the warp by halving (each
// butterfly level sends half of a lane's values and keeps the other half),
// after which the lanes holding an entry's first or second moments write
// its three cotangents of each kind.  K4 writes per-(tile, entry)
// cotangents [6, T * K, B] and a second kernel sums them into the plane
// columns through a host-built column -> entry list (CSR), in list order,
// transposing through shared memory so that its reads and its writes both
// move whole rows: no atomics, so two calls on the same inputs give
// bitwise-equal gradients.
// K5 is a third instantiation of the forward kernel (lambda from 0, stored,
// no reduction) and K6 a second one of the backward kernel (the cotangent row
// read, not derived), so the render pair shares the gather, the staging, the
// loops, the scatter and the determinism of K2-K4.  The staged components
// take 32 bytes per component and warp of shared memory, which caps a tile
// at about 800 components in the forward and 740 in the backward (config 5
// has 114).
//
// Interface: plain C, bound with ctypes.  Each entry launches on the given
// stream, allocates nothing and returns cudaGetLastError() after its last
// launch.

#include <cuda_runtime.h>

#include "mog_common.cuh"

namespace {

using celeste::clamp_min;
using celeste::ex2_approx;
using celeste::halving_levels;
using celeste::kLambdaMin;
using celeste::kLog2e;
using celeste::launch_prep;
using celeste::warp_sum;
using celeste::warp_sum_halving;

constexpr int kPix = 1024;              // parallel/tiles.py PIX_PER_TILE
constexpr int kWarps = 8;               // chains per block
constexpr int kThreads = kWarps * 32;
constexpr int kScatterThreads = 256;
constexpr int kScatterTile = 32;        // plane columns and chains per scatter block
constexpr int kFwdPix = 16;             // pixels a lane of the forward keeps in registers
constexpr int kBwdEntries = 8;          // entries per pixel pass of the backward
static_assert(kPix % (32 * kFwdPix) == 0, "a lane's pixels split into register blocks");
static_assert(kBwdEntries == 1 || kBwdEntries == 2 || kBwdEntries == 4 || kBwdEntries == 8
              || kBwdEntries == 16, "the halving sum takes 6 * 2^m moments");

// What the forward kernel produces: K2 the per-tile log-likelihood, K3 that
// and the pre-clamp lambda (sky included), K5 the sky-free lambda alone.
enum FwdMode { kLoglik, kLoglikLam, kRender };

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Stage chain b's gathered components of tile t as two float4 each,
// w[2k] = (a, mx, my, plane column as int bits) and w[2k+1] = (qa, qb, qc, 0)
// with the form in base 2 (qa = -pa log2e / 2, qb = -pb log2e,
// qc = -pc log2e / 2); entries n_k .. n_pad - 1 are all zero.
__device__ __forceinline__ void stage_components(
    const float* __restrict__ amp, const float* __restrict__ mx,
    const float* __restrict__ my, const float* __restrict__ pa,
    const float* __restrict__ pb, const float* __restrict__ pc,
    const int* __restrict__ src_row, float4* w, int b, int plane_w, int n_comp,
    int n_k, int n_pad, int lane) {
  for (int k = lane; k < n_pad; k += 32) {
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 q = c;
    if (k < n_k) {
      const int col = src_row[k / n_comp] * n_comp + k % n_comp;
      const size_t i = static_cast<size_t>(b) * plane_w + col;
      c = make_float4(amp[i], mx[i], my[i], __int_as_float(col));
      q = make_float4(-0.5f * kLog2e * pa[i], -kLog2e * pb[i], -0.5f * kLog2e * pc[i], 0.0f);
    }
    w[2 * k] = c;
    w[2 * k + 1] = q;
  }
}

// K2 (kLoglik), K3 (kLoglikLam) and K5 (kRender).  Grid (tiles, chain
// blocks); K2 and K3 write partial[t, b]; K3 writes the pre-clamp lambda
// lam[t, b, p] with sky, K5 the sum of the components without it.  K5 reads
// only px and py of the pixel arrays (the others may be null).  Lane l owns
// pixels l + 32 j, j = 0 .. 31, taken kFwdPix at a time.
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
  extern __shared__ __align__(16) float smem[];
  float* s_px = smem;
  float* s_py = s_px + kPix;
  float* s_cnt = s_py + kPix;            // counts .. log max(counts, eps):
  float* s_sky = s_cnt + kPix;           // the log-likelihood's arrays,
  float* s_mask = s_sky + kPix;          // absent from K5's shared memory
  float* s_lxt = s_mask + kPix;          // (centered only)
  float* s_par = kReduce ? s_lxt + kPix : s_cnt;   // kWarps x 2K float4

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
  float4* w = reinterpret_cast<float4*>(s_par) + warp * 2 * n_k;
  if (b < n_chains) {
    stage_components(amp, mx, my, pa, pb, pc, tile_src + static_cast<size_t>(t) * s_cap, w,
                     b, plane_w, n_comp, n_k, n_k, lane);
  }
  __syncthreads();
  if (b >= n_chains) return;

  float* lam_row = kStoreLam ? lam_out + (static_cast<size_t>(t) * n_chains + b) * kPix
                             : nullptr;
  float acc = 0.0f;
  for (int p0 = lane; p0 < kPix; p0 += 32 * kFwdPix) {
    float x[kFwdPix], y[kFwdPix], lam[kFwdPix];
#pragma unroll
    for (int r = 0; r < kFwdPix; ++r) {
      x[r] = s_px[p0 + 32 * r];
      y[r] = s_py[p0 + 32 * r];
      lam[r] = kReduce ? s_sky[p0 + 32 * r] : 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < n_k; ++k) {
      const float4 c = w[2 * k];
      const float4 q = w[2 * k + 1];
#pragma unroll
      for (int r = 0; r < kFwdPix; ++r) {
        const float dx = x[r] - c.y;
        const float dy = y[r] - c.z;
        const float u = fmaf(q.x, dx, q.y * dy);                 // qa dx + qb dy
        lam[r] = fmaf(c.x, ex2_approx(fmaf(u, dx, q.z * dy * dy)), lam[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kFwdPix; ++r) {
      const int p = p0 + 32 * r;
      if (kStoreLam) lam_row[p] = lam[r];
      if (kReduce) {
        const float l = clamp_min(lam[r], kLambdaMin);
        acc += celeste::pixel_loglik<kCentered>(l, logf(l), s_cnt[p],
                                                kCentered ? s_lxt[p] : 0.0f) * s_mask[p];
      }
    }
  }
  if (kReduce) {
    acc = warp_sum(acc);
    if (lane == 0) partial[static_cast<size_t>(t) * n_chains + b] = acc;
  }
}

// the halving levels of the backward's moment sum
constexpr int kHalvings = halving_levels(kBwdEntries);

// K4 (kRender = false) and K6 (kRender = true), part 1.  Grid (tiles, chain
// blocks).  Each warp stages its chain's components and its pixel cotangent
// (one row of shared memory per warp): K4 derives g_lam from lambda,
// counts, mask and g [B]; K6 reads the given cotangent g [T, B, 1024]
// (counts, mask and lam_in may be null).  Then, kBwdEntries entries at a
// time, it sums the six pixel moments over the tile and writes each entry's
// six cotangents to d_part[q, t * K + k, b].  Moments are kept in v as
// triples: entry j's (S0, Sx, Sy) at 6j and (Sxx, Sxy, Syy) at 6j + 3.
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
  constexpr int kE = kBwdEntries;
  extern __shared__ __align__(16) float smem[];
  float2* s_xy = reinterpret_cast<float2*>(smem);                      // kPix
  float* s_glam = smem + 2 * kPix;                                     // kWarps x kPix
  float4* s_par = reinterpret_cast<float4*>(s_glam + kWarps * kPix);  // kWarps x 2 n_pad

  const int t = blockIdx.x;
  const size_t tile_off = static_cast<size_t>(t) * kPix;
  for (int i = threadIdx.x; i < kPix; i += kThreads) {
    s_xy[i] = make_float2(px[tile_off + i], py[tile_off + i]);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * kWarps + warp;
  const int n_k = s_cap * n_comp;
  const int n_pad = round_up(n_k, kE);
  float4* w = s_par + warp * 2 * n_pad;
  float* w_glam = s_glam + warp * kPix;
  const size_t row = (static_cast<size_t>(t) * n_chains + b) * kPix;
  if (b < n_chains) {
    stage_components(amp, mx, my, pa, pb, pc, tile_src + static_cast<size_t>(t) * s_cap, w,
                     b, plane_w, n_comp, n_k, n_pad, lane);
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
  }
  __syncthreads();
  if (b >= n_chains) return;

  const size_t plane_stride = static_cast<size_t>(n_tiles) * n_k * n_chains;
  // after the halving sum this lane holds triple `mine`: entry mine / 2 of
  // the pass, first moments if mine is even, second moments if odd
  const int mine = lane >> (5 - kHalvings);
  const bool writer = (lane & ((1 << (5 - kHalvings)) - 1)) == 0;
  for (int k0 = 0; k0 < n_k; k0 += kE) {
    float cx[kE], cy[kE], qa[kE], qb[kE], qc[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const float4 c = w[2 * (k0 + j)];
      const float4 q = w[2 * (k0 + j) + 1];
      cx[j] = c.y;
      cy[j] = c.z;
      qa[j] = q.x;
      qb[j] = q.y;
      qc[j] = q.z;
    }
    float v[6 * kE];
#pragma unroll
    for (int i = 0; i < 6 * kE; ++i) v[i] = 0.0f;
#pragma unroll 2
    for (int p = lane; p < kPix; p += 32) {
      const float2 xy = s_xy[p];
      const float gl = w_glam[p];
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const float dx = xy.x - cx[j];
        const float dy = xy.y - cy[j];
        const float dxx = dx * dx, dxy = dx * dy, dyy = dy * dy;
        const float ge = gl * ex2_approx(fmaf(qa[j], dxx, fmaf(qb[j], dxy, qc[j] * dyy)));
        v[6 * j] += ge;
        v[6 * j + 1] = fmaf(ge, dx, v[6 * j + 1]);
        v[6 * j + 2] = fmaf(ge, dy, v[6 * j + 2]);
        v[6 * j + 3] = fmaf(ge, dxx, v[6 * j + 3]);
        v[6 * j + 4] = fmaf(ge, dxy, v[6 * j + 4]);
        v[6 * j + 5] = fmaf(ge, dyy, v[6 * j + 5]);
      }
    }
    warp_sum_halving(v, lane);
    const int k = k0 + mine / 2;
    if (writer && k < n_k) {
      const float4 c = w[2 * k];
      const float a = c.x;
      const size_t o = (static_cast<size_t>(t) * n_k + k) * n_chains + b;
      if (mine & 1) {
        d_part[3 * plane_stride + o] = -0.5f * a * v[0];
        d_part[4 * plane_stride + o] = -a * v[1];
        d_part[5 * plane_stride + o] = -0.5f * a * v[2];
      } else {
        const size_t i = static_cast<size_t>(b) * plane_w + __float_as_int(c.w);
        const float ea = pa[i], eb = pb[i], ec = pc[i];
        d_part[o] = v[0];
        d_part[plane_stride + o] = a * fmaf(ea, v[1], eb * v[2]);
        d_part[2 * plane_stride + o] = a * fmaf(eb, v[1], ec * v[2]);
      }
    }
  }
}

// K4, part 2: the deterministic scatter.  Grid (plane columns / 32, chains /
// 32); a block sums d_part over the entries listed for each of its 32
// columns in col_ptr/col_ent, in list order, for 32 chains and the six
// planes, reading along the chains (one warp per column) into shared memory,
// then writes d_planes[q, b, c] along the columns (one warp per chain), so
// that reads and writes both move whole rows.  A column that no tile lists
// gets 0.
__global__ void __launch_bounds__(kScatterThreads)
tiled_scatter_kernel(const float* __restrict__ d_part, const int* __restrict__ col_ptr,
                     const int* __restrict__ col_ent, float* __restrict__ d_planes,
                     int n_rows, int n_chains, int plane_w) {
  __shared__ float sums[6][kScatterTile][kScatterTile + 1];
  const int c0 = blockIdx.x * kScatterTile;
  const int b0 = blockIdx.y * kScatterTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t part_stride = static_cast<size_t>(n_rows) * n_chains;
  for (int i = warp; i < kScatterTile; i += kScatterThreads / 32) {
    const int col = c0 + i;
    const int b = b0 + lane;
    float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (col < plane_w && b < n_chains) {
      const int lo = col_ptr[col], hi = col_ptr[col + 1];
#pragma unroll 4
      for (int e = lo; e < hi; ++e) {
        const float* part = d_part + static_cast<size_t>(col_ent[e]) * n_chains + b;
#pragma unroll
        for (int q = 0; q < 6; ++q) s[q] += part[q * part_stride];
      }
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) sums[q][i][lane] = s[q];
  }
  __syncthreads();
  const size_t out_stride = static_cast<size_t>(n_chains) * plane_w;
  for (int i = warp; i < kScatterTile; i += kScatterThreads / 32) {
    const int b = b0 + i;
    const int col = c0 + lane;
    if (b < n_chains && col < plane_w) {
      const size_t o = static_cast<size_t>(b) * plane_w + col;
#pragma unroll
      for (int q = 0; q < 6; ++q) d_planes[q * out_stride + o] = sums[q][lane][i];
    }
  }
}

// The pixel arrays the forward stages (six for K2/K3, px and py for K5) and
// every warp's 2 K float4 of components.
size_t fwd_smem_bytes(int n_k, int n_pixel_arrays) {
  return n_pixel_arrays * static_cast<size_t>(kPix) * sizeof(float)
         + kWarps * 2 * static_cast<size_t>(n_k) * sizeof(float4);
}

// (px, py) pairs, every warp's pixel cotangent row and its components,
// padded to whole passes of kBwdEntries.
size_t bwd_smem_bytes(int n_k) {
  return (2 + kWarps) * static_cast<size_t>(kPix) * sizeof(float)
         + kWarps * 2 * static_cast<size_t>(round_up(n_k, kBwdEntries)) * sizeof(float4);
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
  const size_t smem = bwd_smem_bytes(s_cap * n_comp);
  cudaError_t err = launch_prep(tiled_bwd_kernel<kRender>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (n_chains + kWarps - 1) / kWarps);
  tiled_bwd_kernel<kRender><<<grid, kThreads, smem, stream>>>(
      amp, mx, my, pa, pb, pc, tile_src, px, py, counts, mask, lam, g, d_part, n_tiles,
      n_chains, plane_w, s_cap, n_comp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sgrid((plane_w + kScatterTile - 1) / kScatterTile,
                   (n_chains + kScatterTile - 1) / kScatterTile);
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
