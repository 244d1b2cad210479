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
// and the backward, given the cotangent g_b of ll_b, in moment form over the
// columns: with g_lam = g mask (counts / max(lam, eps) - 1) [lam > eps] and
// dx = x_w - cx_c, dy = y_h - cy_c, each column w sums over the rows
//   R_c[w] = sum_h g_lam col_c[h],  Y1_c[w] = sum_h g_lam col_c[h] dy,
//   Y2_c[w] = sum_h g_lam col_c[h] dy^2
// and then
//   d a  = sum_w R_c ex_c;   d cx = iv sum_w R_c row_c dx;
//   d cy = iv sum_w row_c Y1_c;
//   d iv = -(sum_w R_c row_c dx^2 + sum_w row_c Y2_c) / 2
// (term by term the sums of kernels/mog_field_sep.py _sep_loglik_bwd_torch;
// _sep_loglik_bwd_moments_torch there is this form in PyTorch).  The
// centered flag only adds parameter-free per-pixel terms, so the backward
// does not take it.
//
// What bounds it on the card.  Per chain the forward does C (H + W)
// exponentials (150 for a 25x25 stamp with C = 3, against K1's 1875), then
// C multiply-adds and one logarithm per pixel; it reads 4 C 4 bytes of
// parameters and writes 4.  So it is bound by instruction issue, not by
// memory: the per-pixel instructions are the cost.  The backward takes a
// reciprocal per pixel and 3 C multiply-adds for the moments.
//
// What the design does about that.
//   Lanes over columns, rows walked.  One warp owns one chain (8 per
// block); lane l owns column w0 + l of a block of 32 columns (a stamp wider
// than 32 walks its column blocks in order; at 25 columns 7 lanes idle) and
// walks the rows.  The lane keeps its C row factors a_c ex_c[w] in
// registers; the chain's column factors sit in the warp's shared memory as
// one float4 per row (the backward: three, col, col dy and col dy^2), so a
// broadcast 16-byte load per row feeds every component.  The stamp's
// counts, sky, mask and (centered) log max(counts, eps) are staged once per
// block as one float4 per pixel, read by consecutive lanes: one 16-byte
// load per pixel, no integer division.  Blocks are persistent: as many as
// the card holds at once, each walking chain groups g, g + grid, ..., so a
// stamp that fits one band is staged once per block, not once per 8
// chains.
//   Fast arithmetic.  Factors are a * ex2.approx of the exponent in base 2
// (-iv log2e / 2 folded into one constant), so a zero amplitude adds
// exactly 0 and its cotangents stay finite (rows are a * ex, never
// exp(log a + ...)).  The Poisson term takes log_newton (mog_common.cuh),
// as K1 does; the backward's counts / lambda one MUFU.RCP (rcp.approx).
//   Converged warps.  No branch splits a warp: the last chain group's spare
// warps redo the last chain and store nothing, and a lane past the last
// column walks the last column and adds nothing, so the warp sums need no
// collective synchronisation.
//   Backward in registers.  Per row the lane forms lambda and g_lam in
// registers and adds g_lam col, g_lam col dy and g_lam col dy^2 to its
// column's R, Y1, Y2; after a column block it folds them with its column's
// factors into 4 C partial cotangents, and at the chain's end the warp sums
// the 4 C partials in one halving butterfly (warp_sum_halving).  g_lam never
// goes through shared memory, and no serial contraction over a row or a
// column remains.  The cotangent g multiplies the sums at the end.
//   C of any size.  C <= 4 (a star's PSF has 3) is a template with the
// components in registers, as above.  Larger C takes the components in
// chunks of 4: a first pass sums each chunk's terms into the lane's lambda
// of every row of the band (lane-private shared memory), then the forward
// adds the Poisson terms, and the backward takes each chunk's moments
// (g_lam recomputed from lambda in registers), sums the chunk's 16 partial
// cotangents over the warp and adds them to the chain's outputs.
//   Bands.  The stamp is staged in bands of whole rows (as many as fit
// kBandPix pixels, at most kMaxBandRows, at least one), so shared memory
// does not grow with H: a block walks the bands in row order.  Shared
// memory is one band of pixels (16 bytes each) and the warps' factor rows,
// so a stamp up to about 14000 columns of any height runs; beyond that the
// launch fails and the wrapper raises.  kernels/mog_field_sep.py
// k8_lane_walk writes the walk out.
//   Deterministic sums.  Each lane adds its pixels in row order, column
// blocks and bands in order, then one warp butterfly; no atomics, so two
// calls on the same inputs are bitwise equal.
//
// Interface: plain C, bound with ctypes.  Each entry launches on the given
// stream, allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

#include "mog_common.cuh"

namespace {

using celeste::clamp_min;
using celeste::ex2_approx;
using celeste::kLambdaMin;
using celeste::kLog2e;
using celeste::launch_prep;
using celeste::log_newton;
using celeste::warp_sum;
using celeste::warp_sum_halving;

constexpr int kWarps = 8;               // chains per block at a time
constexpr int kThreads = kWarps * 32;
constexpr int kBandPix = 2048;          // pixels of the rows staged per band
constexpr int kMaxBandRows = 32;        // rows per band at most
constexpr int kChunk = 4;               // components in registers

// Rows per band of an h x w stamp: as many as fit kBandPix pixels, at most
// kMaxBandRows and h, and at least one.
__host__ __device__ inline int band_rows(int h, int w) {
  int rows = w > 0 ? kBandPix / w : kMaxBandRows;
  rows = rows < kMaxBandRows ? rows : kMaxBandRows;
  rows = rows < h ? rows : h;
  return rows > 1 ? rows : 1;
}

// Entry i of a float4 (i a compile-time constant after unrolling).
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// N components of chain b from k0: amplitude, centre and the base-2
// exponent's constant k = -iv log2e / 2; entries past C are zero.
template <int N>
struct Comps {
  float a[N], cx[N], cy[N], k[N];
};

template <int N>
__device__ __forceinline__ Comps<N> load_comps(const float* __restrict__ amp,
                                               const float* __restrict__ cx,
                                               const float* __restrict__ cy,
                                               const float* __restrict__ iv, int b, int k0,
                                               int n_comp) {
  Comps<N> p;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool in = k0 + i < n_comp;
    const size_t e = static_cast<size_t>(b) * n_comp + k0 + i;
    p.a[i] = in ? amp[e] : 0.0f;
    p.cx[i] = in ? cx[e] : 0.0f;
    p.cy[i] = in ? cy[e] : 0.0f;
    p.k[i] = in ? -0.5f * kLog2e * iv[e] : 0.0f;
  }
  return p;
}

// Stage rows [h0, h0 + nr) of the stamp as one float4 per pixel: (counts,
// sky, mask, log max(counts, eps) when kLxt else 0).
template <bool kLxt>
__device__ __forceinline__ void stage_band(const float* __restrict__ counts,
                                           const float* __restrict__ sky,
                                           const float* __restrict__ mask, float4* s_pix,
                                           int h0, int nr, int w) {
  const size_t off = static_cast<size_t>(h0) * w;
  for (int i = threadIdx.x; i < nr * w; i += kThreads) {
    const float cnt = counts[off + i];
    s_pix[i] = make_float4(cnt, sky[off + i], mask[off + i],
                           kLxt ? logf(clamp_min(cnt, kLambdaMin)) : 0.0f);
  }
}

// The warp's column factors of N components for the band's nr rows from h0,
// lanes over rows: per row one float4 col_c (kMoments: three, col_c,
// col_c dy and col_c dy^2).  Called by the whole warp.
template <int N, bool kMoments>
__device__ __forceinline__ void col_factors(const float* __restrict__ ys, const Comps<N>& p,
                                            float4* w_col, int h0, int nr, int lane) {
  __syncwarp();                          // the last factors are read
  for (int r = lane; r < nr; r += 32) {
    const float y = ys[h0 + r];
    float e[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ed[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float edd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float dy = y - p.cy[c];
      e[c] = ex2_approx(p.k[c] * dy * dy);
      ed[c] = e[c] * dy;
      edd[c] = ed[c] * dy;
    }
    if (kMoments) {
      w_col[3 * r] = make_float4(e[0], e[1], e[2], e[3]);
      w_col[3 * r + 1] = make_float4(ed[0], ed[1], ed[2], ed[3]);
      w_col[3 * r + 2] = make_float4(edd[0], edd[1], edd[2], edd[3]);
    } else {
      w_col[r] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  __syncwarp();
}

// The lane's column factors of N components at column x: dx, ex and the row
// factor a ex.
template <int N>
struct Column {
  float dx[N], ex[N], row[N];
};

template <int N>
__device__ __forceinline__ Column<N> column(const Comps<N>& p, float x) {
  Column<N> f;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    f.dx[c] = x - p.cx[c];
    f.ex[c] = ex2_approx(p.k[c] * f.dx[c] * f.dx[c]);
    f.row[c] = p.a[c] * f.ex[c];
  }
  return f;
}

// 1 / x as one MUFU.RCP (PTX rcp.approx.ftz.f32, at most 1 ulp from the
// correctly rounded result; x >= eps here, so no subnormal input).
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The lane's pixel cotangent over g: mask (counts / max(lam, eps) - 1)
// [lam > eps], for the pixel q = (counts, sky, mask, .).
__device__ __forceinline__ float glam_over_g(float lam, const float4& q) {
  const float active = lam > kLambdaMin ? 1.0f : 0.0f;
  return q.z * fmaf(q.x, rcp_approx(clamp_min(lam, kLambdaMin)), -1.0f) * active;
}

// Fold the column's moments R, Y1, Y2 of N components into the 4 N partial
// cotangent sums v (a, cx, cy, iv; entry q N + c).
template <int N, int M>
__device__ __forceinline__ void fold_column(const Column<N>& f, const float (&r)[N],
                                            const float (&y1)[N], const float (&y2)[N],
                                            float (&v)[M]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const float rr = r[c] * f.row[c];
    v[c] = fmaf(r[c], f.ex[c], v[c]);
    v[N + c] = fmaf(rr, f.dx[c], v[N + c]);
    v[2 * N + c] = fmaf(f.row[c], y1[c], v[2 * N + c]);
    v[3 * N + c] += fmaf(rr * f.dx[c], f.dx[c], f.row[c] * y2[c]);
  }
}

// Padding of 4 N partial sums (N <= 4) for warp_sum_halving (3 * 2^m
// entries) and its halving levels m.
__host__ __device__ constexpr int halving_pad(int n) { return n <= 6 ? 6 : n <= 12 ? 12 : 24; }
__host__ __device__ constexpr int pad_levels(int n) { return n == 6 ? 1 : n == 12 ? 2 : 3; }

// Sum the lanes' partial cotangents v (entry q N + c for components k0 + c)
// over the warp and write them, scaled by g (and iv, and -1/2), to chain
// b's outputs unless the chain is not `valid`; kAdd adds them to what the
// outputs hold.  Called by the whole warp.
template <int N, bool kAdd, int M>
__device__ __forceinline__ void write_cotangents(float (&v)[M], int lane, bool valid, int b,
                                                 int k0, int n_comp, float gb,
                                                 const float* __restrict__ iv,
                                                 float* __restrict__ d_amp,
                                                 float* __restrict__ d_cx,
                                                 float* __restrict__ d_cy,
                                                 float* __restrict__ d_iv) {
  constexpr int kLevels = pad_levels(M);
  warp_sum_halving(v, lane);
  if (!valid || (lane & ((1 << (5 - kLevels)) - 1)) != 0) return;
  const int i = lane >> (5 - kLevels);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int j = 3 * i + t;
    const int q = j / N;
    const int c = k0 + j - q * N;
    if (j >= 4 * N || c >= n_comp) continue;
    const size_t e = static_cast<size_t>(b) * n_comp + c;
    float* out = q == 0 ? d_amp : q == 1 ? d_cx : q == 2 ? d_cy : d_iv;
    const float scale = q == 0 ? gb : q == 3 ? -0.5f * gb : gb * iv[e];
    out[e] = kAdd ? out[e] + scale * v[t] : scale * v[t];
  }
}

// The shared memory of both kernels, carved from one buffer: the band of
// pixels (nr_max w float4), each warp's column factors (nr_max float4, the
// backward 3 nr_max) and, for C > 4, each lane's lambda of the band's rows.
struct Smem {
  float4* pix;
  float4* col;                           // this warp's
  float* lam;                            // this lane's, stride 32
};

__device__ __forceinline__ Smem carve(float4* smem, int nr_max, int w, int col_per_row,
                                      int warp, int lane) {
  Smem s;
  s.pix = smem;
  float4* cols = s.pix + nr_max * w;
  s.col = cols + warp * nr_max * col_per_row;
  s.lam = reinterpret_cast<float*>(cols + kWarps * nr_max * col_per_row)
          + warp * nr_max * 32 + lane;
  return s;
}

size_t smem_bytes(bool general, int col_per_row, int h, int w) {
  const size_t nr = band_rows(h, w);
  return nr * w * sizeof(float4) + kWarps * nr * col_per_row * sizeof(float4)
         + (general ? kWarps * nr * 32 * sizeof(float) : 0);
}

// For C > 4: lambda of the lane's column x at rows [h0, h0 + nr) into
// s.lam, the components taken 4 at a time (at least one chunk, so C = 0
// gives the sky).  Called by the whole warp.
__device__ __forceinline__ void general_lambda(
    const float* __restrict__ amp, const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ iv, const float* __restrict__ xs, const float* __restrict__ ys,
    const Smem& s, int b, int n_comp, int h0, int nr, int w, int x, int lane) {
  for (int k0 = 0; k0 == 0 || k0 < n_comp; k0 += kChunk) {
    const Comps<kChunk> p = load_comps<kChunk>(amp, cx, cy, iv, b, k0, n_comp);
    col_factors<kChunk, false>(ys, p, s.col, h0, nr, lane);
    const Column<kChunk> f = column(p, xs[x]);
    for (int r = 0; r < nr; ++r) {
      const float4 cf = s.col[r];
      float lam = k0 == 0 ? s.pix[r * w + x].y : s.lam[32 * r];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) lam = fmaf(at(cf, c), f.row[c], lam);
      s.lam[32 * r] = lam;
    }
  }
}

// K8 forward: out[b] = chain b's log-likelihood.  kC = 1..4 keeps the
// components in registers; kC = 0 takes any C in chunks.
template <int kC, bool kCentered>
__global__ void __launch_bounds__(kThreads)
sep_fwd_kernel(const float* __restrict__ amp, const float* __restrict__ cx,
               const float* __restrict__ cy, const float* __restrict__ iv,
               const float* __restrict__ xs, const float* __restrict__ ys,
               const float* __restrict__ counts, const float* __restrict__ sky,
               const float* __restrict__ mask, float* __restrict__ out,
               int n_chains, int n_comp, int h, int w) {
  extern __shared__ __align__(16) float4 k8_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nr_max = band_rows(h, w);
  const Smem s = carve(k8_smem, nr_max, w, 1, warp, lane);
  const bool one_band = nr_max >= h;
  if (one_band) {
    stage_band<kCentered>(counts, sky, mask, s.pix, 0, h, w);
    __syncthreads();
  }
  const int n_groups = (n_chains + kWarps - 1) / kWarps;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    // the last group's spare warps redo the last chain and store nothing,
    // so that no branch splits a warp (its shuffles need no collective)
    const bool valid = grp * kWarps + warp < n_chains;
    const int b = valid ? grp * kWarps + warp : n_chains - 1;
    float acc = 0.0f;
    for (int h0 = 0; h0 < h; h0 += nr_max) {
      const int nr = min(nr_max, h - h0);
      if (!one_band) {
        __syncthreads();                 // the last band is read
        stage_band<kCentered>(counts, sky, mask, s.pix, h0, nr, w);
        __syncthreads();
      }
      if constexpr (kC > 0) {
        const Comps<kC> p = load_comps<kC>(amp, cx, cy, iv, b, 0, kC);
        col_factors<kC, false>(ys, p, s.col, h0, nr, lane);
        for (int w0 = 0; w0 < w; w0 += 32) {
          // a lane past the last column walks the last column and adds nothing
          const int x = min(w0 + lane, w - 1);
          const Column<kC> f = column(p, xs[x]);
          const float4* pix = s.pix + x;
          float col = 0.0f;
#pragma unroll 4
          for (int r = 0; r < nr; ++r) {
            const float4 cf = s.col[r];
            const float4 q = pix[r * w];
            float lam = q.y;
#pragma unroll
            for (int c = 0; c < kC; ++c) lam = fmaf(at(cf, c), f.row[c], lam);
            const float l = clamp_min(lam, kLambdaMin);
            col = fmaf(celeste::pixel_loglik<kCentered>(l, log_newton(l), q.x, q.w), q.z, col);
          }
          acc += w0 + lane < w ? col : 0.0f;
        }
      } else {
        for (int w0 = 0; w0 < w; w0 += 32) {
          const int x = min(w0 + lane, w - 1);
          general_lambda(amp, cx, cy, iv, xs, ys, s, b, n_comp, h0, nr, w, x, lane);
          float col = 0.0f;
          for (int r = 0; r < nr; ++r) {
            const float4 q = s.pix[r * w + x];
            const float l = clamp_min(s.lam[32 * r], kLambdaMin);
            col = fmaf(celeste::pixel_loglik<kCentered>(l, log_newton(l), q.x, q.w), q.z, col);
          }
          acc += w0 + lane < w ? col : 0.0f;
        }
      }
    }
    acc = warp_sum(acc);
    if (valid && lane == 0) out[b] = acc;
  }
}

// K8 backward: the four [B, C] plane cotangents.  kC = 1..4: one pass with
// the moments and the partial cotangents in registers, one warp sum per
// chain; kC = 0: any C in chunks, one warp sum per chunk, column block and
// band, added to the outputs in that order.  Held to 3 blocks per SM (80
// registers): left free it took 128 and ran 2 blocks, 4% slower at config
// 1's stamp and B=65536.
template <int kC>
__global__ void __launch_bounds__(kThreads, 3)
sep_bwd_kernel(const float* __restrict__ amp, const float* __restrict__ cx,
               const float* __restrict__ cy, const float* __restrict__ iv,
               const float* __restrict__ xs, const float* __restrict__ ys,
               const float* __restrict__ counts, const float* __restrict__ sky,
               const float* __restrict__ mask, const float* __restrict__ g,
               float* __restrict__ d_amp, float* __restrict__ d_cx,
               float* __restrict__ d_cy, float* __restrict__ d_iv,
               int n_chains, int n_comp, int h, int w) {
  constexpr int kN = kC > 0 ? kC : kChunk;          // components per pass
  constexpr int kM = halving_pad(4 * kN);
  extern __shared__ __align__(16) float4 k8_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nr_max = band_rows(h, w);
  const Smem s = carve(k8_smem, nr_max, w, 3, warp, lane);
  const bool one_band = nr_max >= h;
  if (one_band) {
    stage_band<false>(counts, sky, mask, s.pix, 0, h, w);
    __syncthreads();
  }
  const int n_groups = (n_chains + kWarps - 1) / kWarps;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    // as the forward: spare warps redo the last chain and store nothing
    const bool valid = grp * kWarps + warp < n_chains;
    const int b = valid ? grp * kWarps + warp : n_chains - 1;
    const float gb = g[b];
    float v[kM];
#pragma unroll
    for (int i = 0; i < kM; ++i) v[i] = 0.0f;
    if (kC == 0 && valid) {
      for (int c = lane; c < n_comp; c += 32) {
        const size_t e = static_cast<size_t>(b) * n_comp + c;
        d_amp[e] = d_cx[e] = d_cy[e] = d_iv[e] = 0.0f;
      }
      __syncwarp();
    }
    for (int h0 = 0; h0 < h; h0 += nr_max) {
      const int nr = min(nr_max, h - h0);
      if (!one_band) {
        __syncthreads();                 // the last band is read
        stage_band<false>(counts, sky, mask, s.pix, h0, nr, w);
        __syncthreads();
      }
      if constexpr (kC > 0) {
        const Comps<kC> p = load_comps<kC>(amp, cx, cy, iv, b, 0, kC);
        col_factors<kC, true>(ys, p, s.col, h0, nr, lane);
        for (int w0 = 0; w0 < w; w0 += 32) {
          // a lane past the last column walks the last column and adds nothing
          const int x = min(w0 + lane, w - 1);
          const Column<kC> f = column(p, xs[x]);
          float r[kC], y1[kC], y2[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) r[c] = y1[c] = y2[c] = 0.0f;
          const float4* pix = s.pix + x;
#pragma unroll 2
          for (int row = 0; row < nr; ++row) {
            const float4 q = pix[row * w];
            const float4 c0 = s.col[3 * row];
            const float4 c1 = s.col[3 * row + 1];
            const float4 c2 = s.col[3 * row + 2];
            float lam = q.y;
#pragma unroll
            for (int c = 0; c < kC; ++c) lam = fmaf(at(c0, c), f.row[c], lam);
            const float gl = glam_over_g(lam, q);
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              r[c] = fmaf(gl, at(c0, c), r[c]);
              y1[c] = fmaf(gl, at(c1, c), y1[c]);
              y2[c] = fmaf(gl, at(c2, c), y2[c]);
            }
          }
          if (w0 + lane < w) fold_column(f, r, y1, y2, v);
        }
      } else {
        for (int w0 = 0; w0 < w; w0 += 32) {
          const int x = min(w0 + lane, w - 1);
          general_lambda(amp, cx, cy, iv, xs, ys, s, b, n_comp, h0, nr, w, x, lane);
          for (int k0 = 0; k0 < n_comp; k0 += kChunk) {
            const Comps<kChunk> p = load_comps<kChunk>(amp, cx, cy, iv, b, k0, n_comp);
            col_factors<kChunk, true>(ys, p, s.col, h0, nr, lane);
            const Column<kChunk> f = column(p, xs[x]);
            float r[kChunk], y1[kChunk], y2[kChunk];
#pragma unroll
            for (int c = 0; c < kChunk; ++c) r[c] = y1[c] = y2[c] = 0.0f;
            for (int row = 0; row < nr; ++row) {
              const float4 q = s.pix[row * w + x];
              const float4 c0 = s.col[3 * row];
              const float4 c1 = s.col[3 * row + 1];
              const float4 c2 = s.col[3 * row + 2];
              const float gl = glam_over_g(s.lam[32 * row], q);
#pragma unroll
              for (int c = 0; c < kChunk; ++c) {
                r[c] = fmaf(gl, at(c0, c), r[c]);
                y1[c] = fmaf(gl, at(c1, c), y1[c]);
                y2[c] = fmaf(gl, at(c2, c), y2[c]);
              }
            }
#pragma unroll
            for (int i = 0; i < kM; ++i) v[i] = 0.0f;
            if (w0 + lane < w) fold_column(f, r, y1, y2, v);
            write_cotangents<kChunk, true>(v, lane, valid, b, k0, n_comp, gb, iv, d_amp, d_cx,
                                           d_cy, d_iv);
          }
        }
      }
    }
    if (kC > 0) {
      write_cotangents<kN, false>(v, lane, valid, b, 0, n_comp, gb, iv, d_amp, d_cx, d_cy,
                                  d_iv);
    }
  }
}

// Blocks the card holds at once for this kernel and shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), asked once
// per (device, kernel, shared memory).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<int, std::pair<const void*, size_t>>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_pair(dev, std::make_pair(reinterpret_cast<const void*>(kernel), smem));
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = per_sm * sms;
  known.emplace(key, *blocks);
  return cudaSuccess;
}

// One persistent launch: min(chain groups, resident blocks) blocks.
template <typename... Params, typename... Args>
cudaError_t launch_k8(void (*kernel)(Params...), int n_chains, size_t smem, void* stream,
                      Args... args) {
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(kernel, smem, &blocks);
  if (err != cudaSuccess) return err;
  const int n_groups = (n_chains + kWarps - 1) / kWarps;
  kernel<<<n_groups < blocks ? n_groups : blocks, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

template <bool kCentered>
cudaError_t launch_fwd(int n_comp, int h, int w, size_t smem_fast, size_t smem_general,
                       int n_chains, void* stream, const float* amp, const float* cx,
                       const float* cy, const float* iv, const float* xs, const float* ys,
                       const float* counts, const float* sky, const float* mask, float* out) {
#define K8_FWD(KC, SMEM)                                                                    \
  launch_k8(sep_fwd_kernel<KC, kCentered>, n_chains, SMEM, stream, amp, cx, cy, iv, xs, ys, \
            counts, sky, mask, out, n_chains, n_comp, h, w)
  switch (n_comp) {
    case 1: return K8_FWD(1, smem_fast);
    case 2: return K8_FWD(2, smem_fast);
    case 3: return K8_FWD(3, smem_fast);
    case 4: return K8_FWD(4, smem_fast);
    default: return K8_FWD(0, smem_general);
  }
#undef K8_FWD
}

}  // namespace

extern "C" {

int mog_field_sep_fwd(const float* amp, const float* cx, const float* cy, const float* iv,
                      const float* xs, const float* ys, const float* counts,
                      const float* sky, const float* mask, float* out,
                      int n_chains, int n_comp, int h, int w, int centered, void* stream) {
  const size_t fast = smem_bytes(false, 1, h, w), general = smem_bytes(true, 1, h, w);
  return static_cast<int>(centered
      ? launch_fwd<true>(n_comp, h, w, fast, general, n_chains, stream, amp, cx, cy, iv, xs, ys,
                         counts, sky, mask, out)
      : launch_fwd<false>(n_comp, h, w, fast, general, n_chains, stream, amp, cx, cy, iv, xs,
                          ys, counts, sky, mask, out));
}

int mog_field_sep_bwd(const float* amp, const float* cx, const float* cy, const float* iv,
                      const float* xs, const float* ys, const float* counts,
                      const float* sky, const float* mask, const float* g,
                      float* d_amp, float* d_cx, float* d_cy, float* d_iv,
                      int n_chains, int n_comp, int h, int w, void* stream) {
  const size_t fast = smem_bytes(false, 3, h, w), general = smem_bytes(true, 3, h, w);
#define K8_BWD(KC, SMEM)                                                                      \
  launch_k8(sep_bwd_kernel<KC>, n_chains, SMEM, stream, amp, cx, cy, iv, xs, ys, counts, sky, \
            mask, g, d_amp, d_cx, d_cy, d_iv, n_chains, n_comp, h, w)
  cudaError_t err;
  switch (n_comp) {
    case 1: err = K8_BWD(1, fast); break;
    case 2: err = K8_BWD(2, fast); break;
    case 3: err = K8_BWD(3, fast); break;
    case 4: err = K8_BWD(4, fast); break;
    default: err = K8_BWD(0, general);
  }
#undef K8_BWD
  return static_cast<int>(err);
}

const char* mog_field_sep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
