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
// and the backward, given the cotangent g_b of ll_b, in moment form: with
//   g_lam = g mask (counts / max(lam, eps) - 1) [lam > eps],  ge = g_lam e_c
// summed over the pixels into S0 = sum ge, Sx = sum ge dx, Sy = sum ge dy,
// Sxx = sum ge dx^2, Sxy = sum ge dx dy and Syy = sum ge dy^2,
//   d a = S0,  d pa = -a Sxx / 2,  d pb = -a Sxy,  d pc = -a Syy / 2,
//   d mx = a (pa Sx + pb Sy),  d my = a (pb Sx + pc Sy).
// The centered flag only adds parameter-free per-pixel terms, so the
// backward does not take it.
//
// What bounds K1 on the card.  Per chain it reads 6 C 4 bytes of parameters
// and writes 4 (the backward 6 C 4), while it takes C exponentials and ~11
// FP32 operations (the backward ~23) for each of P pixels, plus a logarithm
// (the backward a division) per pixel: thousands of operations per byte, so
// it is bound by instruction issue and the special-function unit, never by
// memory.  At the samplers' 32-64 chains a second bound comes first: with
// one warp per chain and 8 chains per block, 32 chains fill 4 of 132 SMs,
// and one warp walks 961 pixels x 48 components with nothing to hide its
// latency.
//
// What the design does about that.
//   Geometry.  A block is 8 warps split between CB chains and 8 / CB warps
// per chain, and a thread-block cluster of T blocks (T <= 8, the portable
// size) splits the same chains' pixels further.  The Python wrapper picks
// (CB, T) from (B, P) (kernels/mog_field.py k1_geometry): CB = 8, T = 1 at
// B = 65536, where the pixel arrays staged once serve 8 chains, and CB = 1
// with T = 4-8 at B = 32-64 (256 blocks, not 4).  The stamp is cut into
// groups of 32 pixels (a pixel per lane); rank r of the cluster owns groups
// [r G / T, (r + 1) G / T) of the G = ceil(P / 32), and warp w of a chain
// takes groups w, w + 8 / CB, ... of each chunk (k1_pixel_slices in
// kernels/mog_field.py mirrors this).  The ranks meet in distributed shared
// memory (cooperative_groups this_cluster, map_shared_rank, cluster.sync;
// cudaLaunchKernelEx with a cluster dimension), so a call stays one launch:
// a second kernel or a host-side sum of partials costs ~20 us of host time
// per call on the sampler paths, more than the kernel.  The launch asks
// cudaOccupancyMaxActiveClusters whether the cluster fits with the kernel's
// shared memory and returns an error if not: no other shape is tried.
//   Chunked staging, no pixel cap.  A block walks its groups in chunks of
// 1024 pixels staged in shared memory (x and y as a float2, counts, sky,
// mask and, centered, log max(counts, eps)); pixels past P read as padding
// (mask 0, sky 1) and add exactly 0.  Shared memory then depends on C
// alone, through the staged components: the forward takes ~24 KB + 32 C CB
// bytes (up to ~800 components at CB = 8), the general backward ~53 KB +
// 448 C at CB = 8 (32 C CB of components and 24 C per warp of moment sums:
// up to ~400 components; config 5's dense field has 126), the one-pass
// backward ~21 KB.  Beyond that the launch fails and the wrapper raises.
//   Forward, as the tiled forward (tiled_field.cu).  Components are staged
// as two float4 each, (a, mx, my, 0) and (qa, qb, qc, 0), with the
// quadratic form in base 2 (qa = -pa log2e / 2, qb = -pb log2e,
// qc = -pc log2e / 2), so a term is a * ex2.approx(form) (mog_common.cuh):
// one MUFU.EX2, no FP32 range reduction, and a zero amplitude adds exactly
// 0.  A lane keeps up to 8 of its pixels in registers (x, y, lambda) and
// walks the components with two broadcast 16-byte loads each; each pixel
// adds its components in index order, then its Poisson term with a
// logarithm of one MUFU.LG2 and one Newton step (mog_common.cuh log_newton): at a star's
// 3 components the accurate logf would be half of a pixel's instructions.  The
// forward is held to 64 registers, 4 blocks per SM: blocks are short (a
// chunk or less per warp), and with 2 blocks per SM their staging loads
// went unhidden.
//   Backward.  With C <= 4 (a star's PSF has 3) one pass does it all: the
// chain's components sit in registers, and per pixel the C exponentials
// give lambda, g_lam and then the 6 C moments, which a lane sums in
// registers over all its pixels; one exponential per term, not two (held to
// 3 blocks per SM, 80 registers, at the price of a small spill).  With
// more components, per chunk, pass 1 derives g_lam of the warp's pixels
// into shared memory (the forward's loop) and pass 2 takes the components
// 8 at a time, so one read of (x, y, g_lam) feeds 8 terms, and sums their
// 48 moments over the warp with one halving butterfly (mog_common.cuh) into
// the warp's rows of moment sums.
//   Deterministic sums.  Lanes add their pixels in index order, then the
// warp butterfly, the chain's warps in warp order and the cluster's ranks
// in rank order; no atomics on values, so two calls on the same inputs are
// bitwise equal, forward and backward.
//
// K7 is bound by the same units: ~11 FP32 operations and one exponential per
// (pixel, component) against 4 bytes of lambda stored per pixel.  It runs
// K1's forward loop itself (lam_groups in its third mode, LamOut::kStore):
// the same staged components (two float4 each, the base-2 form), R pixels
// per lane in registers, one ex2.approx per term; where K1 adds a Poisson
// term, K7 stores lambda, a warp 32 consecutive pixels of one chain per
// store (coalesced).  With no sum over pixels it needs no cluster: the grid
// is ceil(B / CB) chain groups times T pixel tiles, from
// kernels/mog_field.py k7_geometry (CB = 8, T = 1 at B = 65536, where a
// staged chunk serves 8 chains; CB = 1 and T = 4-8 at the PPC's 32 draws,
// 256 blocks, where the old kernel launched 4), and tile r of T takes the
// 32-pixel groups [r G / T, (r + 1) G / T), staged in chunks of 1024 as K1
// stages them, so there is no pixel cap; components are capped by the
// staging as in K1's forward (~800 at CB = 8), above which the launch fails
// and the wrapper raises.  A zero-amplitude component adds exactly 0, so a
// zero-amplitude row renders exactly the sky.  It returns every one of the
// P (lane-padded) pixels, padding included, as the TPU body does.

// Pixel sets.  The pixel arrays (px, py, counts, sky, mask) are [S, P]: one
// set of P pixels per cutout or fit group, and chain b reads set
// b / rows_per_set, the rows of a set contiguous (B = S rows_per_set).  The
// stamp's own [1, P] call is S = 1 with rows_per_set = B.  A block's cb
// chains stage one pixel chunk that they all read, so with S > 1 the
// geometry takes cb dividing rows_per_set (kernels/mog_field.py
// k1_geometry, k7_geometry) and only the pixel base pointers move to the
// block's set: the loop, the cluster sum, the store and the moment-form
// backward are the ones above.

// Interface: plain C, bound with ctypes.  Each entry launches on the given
// stream, allocates nothing and returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

#include "mog_common.cuh"

namespace cg = cooperative_groups;

namespace {

using celeste::clamp_min;
using celeste::ex2_approx;
using celeste::halving_levels;
using celeste::kLambdaMin;
using celeste::kLog2e;
using celeste::launch_prep;
using celeste::log_newton;
using celeste::warp_sum;
using celeste::warp_sum_halving;

constexpr int kWarps = 8;               // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;          // blocks per cluster, the portable limit
constexpr int kChunkGroups = 32;        // 32-pixel groups staged per chunk
constexpr int kChunk = 32 * kChunkGroups;
constexpr int kFwdGroups = 8;           // groups (pixels) a lane keeps in registers
constexpr int kBwdEntries = 8;          // components per pixel pass, general backward
constexpr int kHalvings = halving_levels(kBwdEntries);
static_assert(kChunkGroups % kFwdGroups == 0, "a warp's chunk splits into register blocks");

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Groups [lo, hi) of the ceil(P / 32) 32-pixel groups of the stamp.
struct Groups {
  int lo, hi;
};

// Rank `rank` of a cluster of t blocks owns an even share of the groups.
__device__ __forceinline__ Groups rank_groups(int n_pix, int rank, int t) {
  const long long g = (n_pix + 31) / 32;
  return {static_cast<int>(g * rank / t), static_cast<int>(g * (rank + 1) / t)};
}

// The block's chains, warps and pixel tile.  Grid: ceil(B / cb) chain
// groups of t blocks each, block `rank` of its group taking pixel tile
// `rank` (K1: one cluster per chain group, rank its rank in the cluster).
struct Layout {
  int t, rank, n_sub, warp, lane, j, sub, b0;
  bool valid;
};

__device__ __forceinline__ Layout block_layout(int t, int rank, int cb, int n_chains) {
  Layout l;
  l.t = t;
  l.rank = rank;
  l.n_sub = kWarps / cb;                 // warps per chain
  l.warp = threadIdx.x >> 5;
  l.lane = threadIdx.x & 31;
  l.j = l.warp / l.n_sub;                // the warp's chain in the block
  l.sub = l.warp - l.j * l.n_sub;        // the warp's place among its chain's
  l.b0 = (blockIdx.x / t) * cb;
  l.valid = l.b0 + l.j < n_chains;
  return l;
}

// The offset of the block's pixel set in the [S, P] pixel arrays: the set
// of its first chain, which every chain of the block shares.
__device__ __forceinline__ size_t set_offset(const Layout& l, int rows_per_set, int n_pix) {
  return static_cast<size_t>(l.b0 / rows_per_set) * n_pix;
}

__device__ __forceinline__ Layout cluster_layout(const cg::cluster_group& cluster, int cb,
                                                 int n_chains) {
  return block_layout(static_cast<int>(cluster.num_blocks()),
                      static_cast<int>(cluster.block_rank()), cb, n_chains);
}

// What lam_groups does with each pixel's lambda: add its Poisson term to a
// sum (K1's forward), store its cotangent g_lam (K1's backward, pass 1), or
// store lambda itself (K7).
enum class LamOut { kLoglik, kGlam, kStore };

// Stage pixels p0 .. p0 + n - 1 in shared memory; pixels at or past n_pix
// read as padding (x = y = 0, counts 0, sky 1, mask 0), which adds exactly 0
// to the log-likelihood and has g_lam = 0.  kLxt also stages
// log max(counts, eps) for the centered forward; kPoisson = false (K7)
// stages x, y and sky alone.
template <bool kLxt, bool kPoisson = true>
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ counts, const float* __restrict__ sky,
    const float* __restrict__ mask, float2* s_xy, float* s_cnt, float* s_sky, float* s_mask,
    float* s_lxt, int p0, int n, int n_pix) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int p = p0 + i;
    const bool in = p < n_pix;
    s_xy[i] = in ? make_float2(px[p], py[p]) : make_float2(0.0f, 0.0f);
    s_sky[i] = in ? sky[p] : 1.0f;
    if (kPoisson) {
      const float cnt = in ? counts[p] : 0.0f;
      s_cnt[i] = cnt;
      s_mask[i] = in ? mask[p] : 0.0f;
      if (kLxt) s_lxt[i] = logf(clamp_min(cnt, kLambdaMin));
    }
  }
}

// Stage the components of chains b0 .. b0 + cb - 1 as two float4 each,
// (a, mx, my, 0) and (qa, qb, qc, 0) with the form in base 2; chains past
// n_chains and entries n_comp .. n_pad - 1 are all zero.
__device__ __forceinline__ void stage_components(
    const float* __restrict__ amp, const float* __restrict__ mx,
    const float* __restrict__ my, const float* __restrict__ pa,
    const float* __restrict__ pb, const float* __restrict__ pc, float4* s_comp, int b0,
    int cb, int n_chains, int n_comp, int n_pad) {
  for (int i = threadIdx.x; i < cb * n_pad; i += kThreads) {
    const int j = i / n_pad;
    const int k = i - j * n_pad;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 q = c;
    if (b0 + j < n_chains && k < n_comp) {
      const size_t e = static_cast<size_t>(b0 + j) * n_comp + k;
      c = make_float4(amp[e], mx[e], my[e], 0.0f);
      q = make_float4(-0.5f * kLog2e * pa[e], -kLog2e * pb[e], -0.5f * kLog2e * pc[e], 0.0f);
    }
    s_comp[2 * i] = c;
    s_comp[2 * i + 1] = q;
  }
}

// The staged chunk.
struct Chunk {
  const float2* xy;
  const float* cnt;                      // K1 only
  const float* sky;
  const float* mask;                     // K1 only
  const float* lxt;                      // centered forward only
  int n_in;                              // K7: pixels of the chunk inside the stamp
};

// This lane's pixels of the R groups g0, g0 + step, ... of the chunk:
// lambda over the n_comp staged components in index order; then, by kOut,
// each pixel's Poisson term is added to acc in group order (kLoglik), its
// cotangent g_lam (gb = g of the chain) stored to dst (kGlam, shared
// memory), or lambda stored to dst (kStore, the chain's row of the output
// from the chunk's first pixel on; pixels past the stamp are not stored).
template <int R, bool kCentered, LamOut kOut>
__device__ __forceinline__ void lam_groups(const Chunk& ch, const float4* w, int n_comp, int g0,
                                           int step, int lane, float gb, float* dst,
                                           float& acc) {
  float x[R], y[R], lam[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = (g0 + step * r) * 32 + lane;
    const float2 xy = ch.xy[p];
    x[r] = xy.x;
    y[r] = xy.y;
    lam[r] = ch.sky[p];
  }
#pragma unroll 2
  for (int k = 0; k < n_comp; ++k) {
    const float4 c = w[2 * k];
    const float4 q = w[2 * k + 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float dx = x[r] - c.y;
      const float dy = y[r] - c.z;
      const float u = fmaf(q.x, dx, q.y * dy);                 // qa dx + qb dy
      lam[r] = fmaf(c.x, ex2_approx(fmaf(u, dx, q.z * dy * dy)), lam[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = (g0 + step * r) * 32 + lane;
    if (kOut == LamOut::kStore) {
      if (p < ch.n_in) dst[p] = lam[r];
    } else if (kOut == LamOut::kGlam) {
      const float active = lam[r] > kLambdaMin ? 1.0f : 0.0f;
      dst[p] = (gb * ch.mask[p])
               * (__fdividef(ch.cnt[p], clamp_min(lam[r], kLambdaMin)) - 1.0f) * active;
    } else {
      const float l = clamp_min(lam[r], kLambdaMin);
      acc += celeste::pixel_loglik<kCentered>(l, log_newton(l), ch.cnt[p],
                                              kCentered ? ch.lxt[p] : 0.0f) * ch.mask[p];
    }
  }
}

// Every group of the chunk's n_cg that warp `sub` of its chain's n_sub
// takes (sub, sub + n_sub, ...): kFwdGroups at a time, the rest in blocks
// of 4, 2 and 1.
template <bool kCentered, LamOut kOut>
__device__ __forceinline__ void lam_chunk(const Chunk& ch, const float4* w, int n_comp, int n_cg,
                                          int sub, int n_sub, int lane, float gb, float* dst,
                                          float& acc) {
  const int n_mine = sub < n_cg ? (n_cg - sub + n_sub - 1) / n_sub : 0;
  int k = 0;
  for (; k + kFwdGroups <= n_mine; k += kFwdGroups) {
    lam_groups<kFwdGroups, kCentered, kOut>(ch, w, n_comp, sub + n_sub * k, n_sub, lane, gb, dst,
                                            acc);
  }
  if (k + 4 <= n_mine) {
    lam_groups<4, kCentered, kOut>(ch, w, n_comp, sub + n_sub * k, n_sub, lane, gb, dst, acc);
    k += 4;
  }
  if (k + 2 <= n_mine) {
    lam_groups<2, kCentered, kOut>(ch, w, n_comp, sub + n_sub * k, n_sub, lane, gb, dst, acc);
    k += 2;
  }
  if (k < n_mine) {
    lam_groups<1, kCentered, kOut>(ch, w, n_comp, sub + n_sub * k, n_sub, lane, gb, dst, acc);
  }
}

// K1 forward: out[b] = chain b's log-likelihood.
template <bool kCentered>
__global__ void __launch_bounds__(kThreads, 4)
loglik_fwd_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
                  const float* __restrict__ my, const float* __restrict__ pa,
                  const float* __restrict__ pb, const float* __restrict__ pc,
                  const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ counts, const float* __restrict__ sky,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int n_chains, int n_comp, int n_pix, int cb, int rows_per_set) {
  extern __shared__ __align__(16) float k1_smem[];
  float4* s_comp = reinterpret_cast<float4*>(k1_smem);                // cb x 2 C
  float2* s_xy = reinterpret_cast<float2*>(s_comp + 2 * cb * n_comp);  // kChunk
  float* s_cnt = reinterpret_cast<float*>(s_xy + kChunk);
  float* s_sky = s_cnt + kChunk;
  float* s_mask = s_sky + kChunk;
  float* s_lxt = s_mask + kChunk;
  float* s_warp = s_lxt + kChunk;        // kWarps: each warp's sum
  float* s_chain = s_warp + kWarps;      // cb: each chain's sum over the block's pixels

  const cg::cluster_group cluster = cg::this_cluster();
  const Layout l = cluster_layout(cluster, cb, n_chains);
  const size_t set = set_offset(l, rows_per_set, n_pix);
  px += set;
  py += set;
  counts += set;
  sky += set;
  mask += set;
  stage_components(amp, mx, my, pa, pb, pc, s_comp, l.b0, cb, n_chains, n_comp, n_comp);
  const float4* w = s_comp + 2 * l.j * n_comp;
  const Chunk ch{s_xy, s_cnt, s_sky, s_mask, s_lxt, 0};
  const Groups gr = rank_groups(n_pix, l.rank, l.t);
  float acc = 0.0f;
  for (int g0 = gr.lo; g0 < gr.hi; g0 += kChunkGroups) {
    const int n_cg = min(kChunkGroups, gr.hi - g0);
    if (g0 != gr.lo) __syncthreads();    // the last chunk is read
    stage_chunk<kCentered>(px, py, counts, sky, mask, s_xy, s_cnt, s_sky, s_mask, s_lxt,
                           32 * g0, 32 * n_cg, n_pix);
    __syncthreads();                     // the chunk (and the components) staged
    if (l.valid) {
      lam_chunk<kCentered, LamOut::kLoglik>(ch, w, n_comp, n_cg, l.sub, l.n_sub, l.lane, 0.0f,
                                            nullptr, acc);
    }
  }
  acc = warp_sum(acc);
  if (l.lane == 0) s_warp[l.warp] = acc;
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < cb) {
    const float* sums = s_warp + tid * l.n_sub;
    float v = sums[0];
    for (int i = 1; i < l.n_sub; ++i) v += sums[i];
    s_chain[tid] = v;
  }
  cluster.sync();
  if (l.rank == 0 && tid < cb && l.b0 + tid < n_chains) {
    float v = *cluster.map_shared_rank(s_chain + tid, 0);
    for (int r = 1; r < l.t; ++r) v += *cluster.map_shared_rank(s_chain + tid, r);
    out[l.b0 + tid] = v;
  }
  cluster.sync();                        // every rank's sums stay until rank 0 has read them
}

// The end of both backwards.  s_acc holds kWarps x n_pad rows of six
// moments (S0, Sx, Sy, Sxx, Sxy, Syy).  Each chain's rows are summed over
// its warps in warp order into its first warp's rows, then over the
// cluster's ranks in rank order, and the moment-form epilogue writes the six
// cotangents; rank r takes the (chain, component) pairs r kThreads + i,
// r kThreads + i + t kThreads, ...
__device__ __forceinline__ void finish_bwd(
    const cg::cluster_group& cluster, const Layout& l, float* s_acc, int n_pad, int cb,
    const float* __restrict__ amp, const float* __restrict__ pa,
    const float* __restrict__ pb, const float* __restrict__ pc, float* __restrict__ d_amp,
    float* __restrict__ d_mx, float* __restrict__ d_my, float* __restrict__ d_pa,
    float* __restrict__ d_pb, float* __restrict__ d_pc, int n_chains, int n_comp) {
  __syncthreads();
  const int rows = n_pad * 6;
  for (int i = threadIdx.x; i < cb * rows; i += kThreads) {
    const int j = i / rows;
    float* first = s_acc + j * l.n_sub * rows + (i - j * rows);
    float v = first[0];
    for (int w = 1; w < l.n_sub; ++w) v += first[w * rows];
    first[0] = v;
  }
  cluster.sync();
  for (int i = l.rank * kThreads + threadIdx.x; i < cb * n_comp; i += l.t * kThreads) {
    const int j = i / n_comp;
    const int c = i - j * n_comp;
    if (l.b0 + j >= n_chains) continue;
    float* mine = s_acc + (j * l.n_sub * n_pad + c) * 6;
    float m[6];
    const float* src = cluster.map_shared_rank(mine, 0);
#pragma unroll
    for (int q = 0; q < 6; ++q) m[q] = src[q];
    for (int r = 1; r < l.t; ++r) {
      src = cluster.map_shared_rank(mine, r);
#pragma unroll
      for (int q = 0; q < 6; ++q) m[q] += src[q];
    }
    const size_t e = static_cast<size_t>(l.b0 + j) * n_comp + c;
    const float a = amp[e], ea = pa[e], eb = pb[e], ec = pc[e];
    d_amp[e] = m[0];
    d_mx[e] = a * fmaf(ea, m[1], eb * m[2]);
    d_my[e] = a * fmaf(eb, m[1], ec * m[2]);
    d_pa[e] = -0.5f * a * m[3];
    d_pb[e] = -a * m[4];
    d_pc[e] = -0.5f * a * m[5];
  }
  cluster.sync();                        // every rank's moments stay until they are read
}

// K1 backward for any C: per chunk, pass 1 (g_lam of the warp's pixels)
// and pass 2 (the moments of kBwdEntries components per pixel pass).  Held
// to two blocks per SM (128 registers), as the tiled backward runs.
__global__ void __launch_bounds__(kThreads, 2)
loglik_bwd_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
                  const float* __restrict__ my, const float* __restrict__ pa,
                  const float* __restrict__ pb, const float* __restrict__ pc,
                  const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ counts, const float* __restrict__ sky,
                  const float* __restrict__ mask, const float* __restrict__ g,
                  float* __restrict__ d_amp, float* __restrict__ d_mx,
                  float* __restrict__ d_my, float* __restrict__ d_pa,
                  float* __restrict__ d_pb, float* __restrict__ d_pc,
                  int n_chains, int n_comp, int n_pix, int cb, int rows_per_set) {
  constexpr int kE = kBwdEntries;
  const int n_pad = round_up(n_comp, kE);
  extern __shared__ __align__(16) float k1_smem[];
  float4* s_comp = reinterpret_cast<float4*>(k1_smem);                // cb x 2 n_pad
  float2* s_xy = reinterpret_cast<float2*>(s_comp + 2 * cb * n_pad);   // kChunk
  float* s_cnt = reinterpret_cast<float*>(s_xy + kChunk);
  float* s_sky = s_cnt + kChunk;
  float* s_mask = s_sky + kChunk;
  float* s_glam = s_mask + kChunk;       // cb x kChunk
  float* s_acc = s_glam + cb * kChunk;   // kWarps x n_pad x 6

  const cg::cluster_group cluster = cg::this_cluster();
  const Layout l = cluster_layout(cluster, cb, n_chains);
  const size_t set = set_offset(l, rows_per_set, n_pix);
  px += set;
  py += set;
  counts += set;
  sky += set;
  mask += set;
  stage_components(amp, mx, my, pa, pb, pc, s_comp, l.b0, cb, n_chains, n_comp, n_pad);
  for (int i = threadIdx.x; i < kWarps * n_pad * 6; i += kThreads) s_acc[i] = 0.0f;
  const float4* w = s_comp + 2 * l.j * n_pad;
  float* w_glam = s_glam + l.j * kChunk;
  float* w_acc = s_acc + l.warp * n_pad * 6;
  const float gb = l.valid ? g[l.b0 + l.j] : 0.0f;
  const Chunk ch{s_xy, s_cnt, s_sky, s_mask, nullptr, 0};
  // after the halving sum this lane holds triple `mine`: entry mine / 2 of
  // the pass, first moments if mine is even, second moments if odd
  const int mine = l.lane >> (5 - kHalvings);
  const bool writer = (l.lane & ((1 << (5 - kHalvings)) - 1)) == 0;
  const Groups gr = rank_groups(n_pix, l.rank, l.t);
  float unused = 0.0f;
  for (int g0 = gr.lo; g0 < gr.hi; g0 += kChunkGroups) {
    const int n_cg = min(kChunkGroups, gr.hi - g0);
    if (g0 != gr.lo) __syncthreads();    // the last chunk is read
    stage_chunk<false>(px, py, counts, sky, mask, s_xy, s_cnt, s_sky, s_mask, nullptr, 32 * g0,
                       32 * n_cg, n_pix);
    __syncthreads();                     // the chunk (and the zeroed sums) staged
    if (!l.valid || l.sub >= n_cg) continue;
    lam_chunk<false, LamOut::kGlam>(ch, w, n_comp, n_cg, l.sub, l.n_sub, l.lane, gb, w_glam,
                                    unused);
    __syncwarp();
    for (int k0 = 0; k0 < n_pad; k0 += kE) {
      float cx[kE], cy[kE], qa[kE], qb[kE], qc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float4 c = w[2 * (k0 + e)];
        const float4 q = w[2 * (k0 + e) + 1];
        cx[e] = c.y;
        cy[e] = c.z;
        qa[e] = q.x;
        qb[e] = q.y;
        qc[e] = q.z;
      }
      float v[6 * kE];
#pragma unroll
      for (int i = 0; i < 6 * kE; ++i) v[i] = 0.0f;
#pragma unroll 2
      for (int gi = l.sub; gi < n_cg; gi += l.n_sub) {
        const int p = gi * 32 + l.lane;
        const float2 xy = s_xy[p];
        const float gl = w_glam[p];
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float dx = xy.x - cx[e];
          const float dy = xy.y - cy[e];
          const float dxx = dx * dx, dxy = dx * dy, dyy = dy * dy;
          const float ge = gl * ex2_approx(fmaf(qa[e], dxx, fmaf(qb[e], dxy, qc[e] * dyy)));
          v[6 * e] += ge;
          v[6 * e + 1] = fmaf(ge, dx, v[6 * e + 1]);
          v[6 * e + 2] = fmaf(ge, dy, v[6 * e + 2]);
          v[6 * e + 3] = fmaf(ge, dxx, v[6 * e + 3]);
          v[6 * e + 4] = fmaf(ge, dxy, v[6 * e + 4]);
          v[6 * e + 5] = fmaf(ge, dyy, v[6 * e + 5]);
        }
      }
      warp_sum_halving(v, l.lane);
      if (writer) {
        float* row = w_acc + (k0 + mine / 2) * 6 + 3 * (mine & 1);
        row[0] += v[0];
        row[1] += v[1];
        row[2] += v[2];
      }
    }
  }
  finish_bwd(cluster, l, s_acc, n_pad, cb, amp, pa, pb, pc, d_amp, d_mx, d_my, d_pa, d_pb, d_pc,
             n_chains, n_comp);
}

// K1 backward for C = kC <= 4 in one pass: the chain's components in
// registers; per pixel the kC exponentials give lambda, g_lam and the 6 kC
// moments, which each lane sums over all its pixels, then the warp once at
// the end (entries padded to kE, a power of two, for the halving sum).
template <int kC>
__global__ void __launch_bounds__(kThreads, 3)
loglik_bwd_small_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
                        const float* __restrict__ my, const float* __restrict__ pa,
                        const float* __restrict__ pb, const float* __restrict__ pc,
                        const float* __restrict__ px, const float* __restrict__ py,
                        const float* __restrict__ counts, const float* __restrict__ sky,
                        const float* __restrict__ mask, const float* __restrict__ g,
                        float* __restrict__ d_amp, float* __restrict__ d_mx,
                        float* __restrict__ d_my, float* __restrict__ d_pa,
                        float* __restrict__ d_pb, float* __restrict__ d_pc,
                        int n_chains, int n_pix, int cb, int rows_per_set) {
  constexpr int kE = kC == 1 ? 1 : kC == 2 ? 2 : 4;
  constexpr int kLevels = halving_levels(kE);
  extern __shared__ __align__(16) float k1_smem[];
  float2* s_xy = reinterpret_cast<float2*>(k1_smem);                  // kChunk
  float* s_cnt = reinterpret_cast<float*>(s_xy + kChunk);
  float* s_sky = s_cnt + kChunk;
  float* s_mask = s_sky + kChunk;
  float* s_acc = s_mask + kChunk;        // kWarps x kE x 6

  const cg::cluster_group cluster = cg::this_cluster();
  const Layout l = cluster_layout(cluster, cb, n_chains);
  const size_t set = set_offset(l, rows_per_set, n_pix);
  px += set;
  py += set;
  counts += set;
  sky += set;
  mask += set;
  for (int i = threadIdx.x; i < kWarps * kE * 6; i += kThreads) s_acc[i] = 0.0f;
  float a[kC], cx[kC], cy[kC], qa[kC], qb[kC], qc[kC];
  float gb = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const size_t e = static_cast<size_t>(l.valid ? l.b0 + l.j : 0) * kC + c;
    a[c] = amp[e];
    cx[c] = mx[e];
    cy[c] = my[e];
    qa[c] = -0.5f * kLog2e * pa[e];
    qb[c] = -kLog2e * pb[e];
    qc[c] = -0.5f * kLog2e * pc[e];
  }
  if (l.valid) gb = g[l.b0 + l.j];
  float v[6 * kE];
#pragma unroll
  for (int i = 0; i < 6 * kE; ++i) v[i] = 0.0f;
  const Groups gr = rank_groups(n_pix, l.rank, l.t);
  for (int g0 = gr.lo; g0 < gr.hi; g0 += kChunkGroups) {
    const int n_cg = min(kChunkGroups, gr.hi - g0);
    if (g0 != gr.lo) __syncthreads();    // the last chunk is read
    stage_chunk<false>(px, py, counts, sky, mask, s_xy, s_cnt, s_sky, s_mask, nullptr, 32 * g0,
                       32 * n_cg, n_pix);
    __syncthreads();                     // the chunk (and the zeroed sums) staged
    if (!l.valid) continue;
#pragma unroll 2
    for (int gi = l.sub; gi < n_cg; gi += l.n_sub) {
      const int p = gi * 32 + l.lane;
      const float2 xy = s_xy[p];
      float dx[kC], dy[kC], e[kC];
      float lam = s_sky[p];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        dx[c] = xy.x - cx[c];
        dy[c] = xy.y - cy[c];
        const float u = fmaf(qa[c], dx[c], qb[c] * dy[c]);
        e[c] = ex2_approx(fmaf(u, dx[c], qc[c] * dy[c] * dy[c]));
        lam = fmaf(a[c], e[c], lam);
      }
      const float active = lam > kLambdaMin ? 1.0f : 0.0f;
      const float gl = (gb * s_mask[p])
                       * (__fdividef(s_cnt[p], clamp_min(lam, kLambdaMin)) - 1.0f) * active;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float ge = gl * e[c];
        const float gx = ge * dx[c], gy = ge * dy[c];
        v[6 * c] += ge;
        v[6 * c + 1] += gx;
        v[6 * c + 2] += gy;
        v[6 * c + 3] = fmaf(gx, dx[c], v[6 * c + 3]);
        v[6 * c + 4] = fmaf(gx, dy[c], v[6 * c + 4]);
        v[6 * c + 5] = fmaf(gy, dy[c], v[6 * c + 5]);
      }
    }
  }
  if (l.valid) {
    warp_sum_halving(v, l.lane);
    const int mine = l.lane >> (5 - kLevels);
    if ((l.lane & ((1 << (5 - kLevels)) - 1)) == 0) {
      float* row = s_acc + (l.warp * kE + mine / 2) * 6 + 3 * (mine & 1);
      row[0] = v[0];
      row[1] = v[1];
      row[2] = v[2];
    }
  }
  finish_bwd(cluster, l, s_acc, kE, cb, amp, pa, pb, pc, d_amp, d_mx, d_my, d_pa, d_pb, d_pc,
             n_chains, kC);
}

// K7: lambda [B, P] of chains b0 .. b0 + cb - 1 over the block's pixel tile,
// through K1's forward loop in its store mode.
__global__ void __launch_bounds__(kThreads, 4)
render_kernel(const float* __restrict__ amp, const float* __restrict__ mx,
              const float* __restrict__ my, const float* __restrict__ pa,
              const float* __restrict__ pb, const float* __restrict__ pc,
              const float* __restrict__ px, const float* __restrict__ py,
              const float* __restrict__ sky, float* __restrict__ out,
              int n_chains, int n_comp, int n_pix, int cb, int t, int rows_per_set) {
  extern __shared__ __align__(16) float k7_smem[];
  float4* s_comp = reinterpret_cast<float4*>(k7_smem);                // cb x 2 C
  float2* s_xy = reinterpret_cast<float2*>(s_comp + 2 * cb * n_comp);  // kChunk
  float* s_sky = reinterpret_cast<float*>(s_xy + kChunk);

  const Layout l = block_layout(t, static_cast<int>(blockIdx.x % t), cb, n_chains);
  const size_t set = set_offset(l, rows_per_set, n_pix);
  px += set;
  py += set;
  sky += set;
  stage_components(amp, mx, my, pa, pb, pc, s_comp, l.b0, cb, n_chains, n_comp, n_comp);
  const float4* w = s_comp + 2 * l.j * n_comp;
  float* row = out + static_cast<size_t>(l.b0 + l.j) * n_pix;
  const Groups gr = rank_groups(n_pix, l.rank, l.t);
  float unused = 0.0f;
  for (int g0 = gr.lo; g0 < gr.hi; g0 += kChunkGroups) {
    const int n_cg = min(kChunkGroups, gr.hi - g0);
    if (g0 != gr.lo) __syncthreads();    // the last chunk is read
    stage_chunk<false, false>(px, py, nullptr, sky, nullptr, s_xy, nullptr, s_sky, nullptr,
                              nullptr, 32 * g0, 32 * n_cg, n_pix);
    __syncthreads();                     // the chunk (and the components) staged
    if (l.valid) {
      const Chunk ch{s_xy, nullptr, s_sky, nullptr, nullptr, n_pix - 32 * g0};
      lam_chunk<false, LamOut::kStore>(ch, w, n_comp, n_cg, l.sub, l.n_sub, l.lane, 0.0f,
                                       row + 32 * g0, unused);
    }
  }
}

// Shared-memory bytes of each K1 kernel for cb chains per block and C
// components (the one-pass backward's depend on neither); a size above the
// block's limit makes launch_prep fail, and the entry points return that
// error.
constexpr size_t kChunkBytes = kChunk * (sizeof(float2) + 3 * sizeof(float));

size_t fwd_smem_bytes(int cb, int n_comp) {
  return 2 * static_cast<size_t>(cb) * n_comp * sizeof(float4) + kChunkBytes
         + (kChunk + kWarps + cb) * sizeof(float);
}

size_t bwd_smem_bytes(int cb, int n_comp) {
  const size_t n_pad = round_up(n_comp, kBwdEntries);
  return 2 * cb * n_pad * sizeof(float4) + kChunkBytes
         + (static_cast<size_t>(cb) * kChunk + kWarps * n_pad * 6) * sizeof(float);
}

constexpr size_t kBwdSmallSmem = kChunkBytes + kWarps * 4 * 6 * sizeof(float);

size_t render_smem_bytes(int cb, int n_comp) {
  return 2 * static_cast<size_t>(cb) * n_comp * sizeof(float4)
         + kChunk * (sizeof(float2) + sizeof(float));
}

bool valid_geometry(int cb, int t) {
  return (cb == 1 || cb == 2 || cb == 4 || cb == 8) && t >= 1 && t <= kMaxCluster;
}

// Rows per pixel set for n_sets sets of n_chains rows, or 0 if the sets do
// not split the rows evenly or (S > 1) a block's cb chains would span two
// sets.  One set serves every row.
int rows_per_set(int n_chains, int n_sets, int cb) {
  if (n_sets < 1 || n_chains % n_sets != 0) return 0;
  if (n_sets == 1) return n_chains > 0 ? n_chains : 1;
  const int r = n_chains / n_sets;
  return r % cb == 0 ? r : 0;
}

// Whether a cluster of this kernel fits on the current device with cfg's
// block, cluster and shared-memory sizes (cudaOccupancyMaxActiveClusters),
// asked once per (device, kernel, shared memory, cluster size).
template <typename Kernel>
cudaError_t cluster_fits(Kernel kernel, const cudaLaunchConfig_t& cfg) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t, unsigned>, cudaError_t> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(kernel),
                                   cfg.dynamicSmemBytes, cfg.attrs[0].val.clusterDim.x);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int n_clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
  } else if (n_clusters < 1) {
    err = cudaErrorLaunchOutOfResources;
  }
  known.emplace(key, err);
  return err;
}

// One launch of a K1 kernel: ceil(B / cb) chain groups of t blocks each,
// one cluster of t per chain group.
template <typename... Params, typename... Args>
cudaError_t launch_k1(void (*kernel)(Params...), int n_chains, int cb, int t, size_t smem,
                      void* stream, Args... args) {
  cudaError_t err = launch_prep(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = t;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_chains + cb - 1) / cb * t);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cluster_fits(kernel, cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// K1 forward; chains_per_block (1, 2, 4 or 8) and cluster (1-8) are the
// geometry kernels/mog_field.py k1_geometry picked; n_sets pixel sets of
// n_pix each (1: the stamp's).
int mog_field_loglik_fwd(const float* amp, const float* mx, const float* my,
                         const float* pa, const float* pb, const float* pc,
                         const float* px, const float* py, const float* counts,
                         const float* sky, const float* mask, float* out,
                         int n_chains, int n_comp, int n_pix, int n_sets, int centered,
                         int chains_per_block, int cluster, void* stream) {
  const int cb = chains_per_block;
  const int r = rows_per_set(n_chains, n_sets, cb);
  if (!valid_geometry(cb, cluster) || r == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem_bytes(cb, n_comp);
  return static_cast<int>(centered
      ? launch_k1(loglik_fwd_kernel<true>, n_chains, cb, cluster, smem, stream, amp, mx, my,
                  pa, pb, pc, px, py, counts, sky, mask, out, n_chains, n_comp, n_pix, cb, r)
      : launch_k1(loglik_fwd_kernel<false>, n_chains, cb, cluster, smem, stream, amp, mx, my,
                  pa, pb, pc, px, py, counts, sky, mask, out, n_chains, n_comp, n_pix, cb, r));
}

// K1 backward: the six [B, C] plane cotangents; the one-pass kernel for
// C <= 4, the two-pass kernel otherwise.
int mog_field_loglik_bwd(const float* amp, const float* mx, const float* my,
                         const float* pa, const float* pb, const float* pc,
                         const float* px, const float* py, const float* counts,
                         const float* sky, const float* mask, const float* g,
                         float* d_amp, float* d_mx, float* d_my,
                         float* d_pa, float* d_pb, float* d_pc,
                         int n_chains, int n_comp, int n_pix, int n_sets,
                         int chains_per_block, int cluster, void* stream) {
  const int cb = chains_per_block;
  const int t = cluster;
  const int r = rows_per_set(n_chains, n_sets, cb);
  if (!valid_geometry(cb, t) || r == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (n_comp) {
    case 1:
      err = launch_k1(loglik_bwd_small_kernel<1>, n_chains, cb, t, kBwdSmallSmem, stream, amp,
                      mx, my, pa, pb, pc, px, py, counts, sky, mask, g, d_amp, d_mx, d_my, d_pa,
                      d_pb, d_pc, n_chains, n_pix, cb, r);
      break;
    case 2:
      err = launch_k1(loglik_bwd_small_kernel<2>, n_chains, cb, t, kBwdSmallSmem, stream, amp,
                      mx, my, pa, pb, pc, px, py, counts, sky, mask, g, d_amp, d_mx, d_my, d_pa,
                      d_pb, d_pc, n_chains, n_pix, cb, r);
      break;
    case 3:
      err = launch_k1(loglik_bwd_small_kernel<3>, n_chains, cb, t, kBwdSmallSmem, stream, amp,
                      mx, my, pa, pb, pc, px, py, counts, sky, mask, g, d_amp, d_mx, d_my, d_pa,
                      d_pb, d_pc, n_chains, n_pix, cb, r);
      break;
    case 4:
      err = launch_k1(loglik_bwd_small_kernel<4>, n_chains, cb, t, kBwdSmallSmem, stream, amp,
                      mx, my, pa, pb, pc, px, py, counts, sky, mask, g, d_amp, d_mx, d_my, d_pa,
                      d_pb, d_pc, n_chains, n_pix, cb, r);
      break;
    default:
      err = launch_k1(loglik_bwd_kernel, n_chains, cb, t, bwd_smem_bytes(cb, n_comp), stream,
                      amp, mx, my, pa, pb, pc, px, py, counts, sky, mask, g, d_amp, d_mx, d_my,
                      d_pa, d_pb, d_pc, n_chains, n_comp, n_pix, cb, r);
  }
  return static_cast<int>(err);
}

// K7; chains_per_block (1, 2, 4 or 8) and tiles (pixel tiles per chain,
// at least 1) are the geometry kernels/mog_field.py k7_geometry picked.
int mog_field_render(const float* amp, const float* mx, const float* my,
                     const float* pa, const float* pb, const float* pc,
                     const float* px, const float* py, const float* sky, float* out,
                     int n_chains, int n_comp, int n_pix, int n_sets, int chains_per_block,
                     int tiles, void* stream) {
  const int cb = chains_per_block;
  const int r = rows_per_set(n_chains, n_sets, cb);
  const long long blocks = static_cast<long long>((n_chains + cb - 1) / cb) * tiles;
  if (!valid_geometry(cb, 1) || r == 0 || tiles < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = render_smem_bytes(cb, n_comp);
  cudaError_t err = launch_prep(render_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  render_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      amp, mx, my, pa, pb, pc, px, py, sky, out, n_chains, n_comp, n_pix, cb, tiles, r);
  return static_cast<int>(cudaGetLastError());
}

const char* mog_field_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
