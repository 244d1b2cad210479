// Plane preparation of the tiled crowded field for Hopper (sm_90a): every
// source and band of a gradient's planes in one forward launch, and their
// vector-Jacobian product in one backward launch.
//
// Replaces no TPU kernel.  The JAX package builds the planes in plain jnp
// (celeste_tpu/kernels/tiled_field.py scene_planes_blocked / _padded over
// kernels/mog_field.py _field_planes), which XLA fuses under jit; the port's
// plain version of that graph (the same functions in celeste_tpu_torch) is
// hundreds of small elementwise launches per source and band, and its
// galaxy profile copies its tables from the host on every call.  This pair
// is the port's counterpart of XLA's fusion.
//
// Layout.  States are [B, D_total] float32, every source's unconstrained
// block packed in scene order (a star [du_e, du_n, log_flux_0..nb-1], a
// galaxy that and [logit_theta, log_sigma, logit_ab, phi]).  The planes of
// plane band q are six [B, W] arrays (amp, mx, my, pa, pb, pc) at
// planes + (q * 6 + p) * B * W.  Source s owns the src_w columns
// s * src_w .. (s + 1) * src_w - 1, and the columns after S * src_w are the
// zero sentinel slot.  A scene of two kinds takes the block-slot layout:
// src_w = N_GAL * K (K PSF components; a star fills its first K columns and
// leaves the rest zero) and a sentinel of K columns.  A scene of one kind
// takes the source-major layout: src_w = K (stars) or N_GAL * K (galaxies)
// and a sentinel one source wide.  Within a source, column
// j * K + k is galaxy profile component j convolved with PSF component k.
//
// Math, formula for formula as model/render.py, model/galaxy.py, mog.py and
// _field_planes have it, per (chain, source, band):
//   p = wcs_p0 + wcs_A u;  flux_b = exp(log_flux_b)
//   galaxy: theta = sigmoid, sigma = exp, ab = sigmoid of their slots;
//     W_sky = R(phi) diag(sigma^2, (ab sigma)^2) R(phi)^T, W = A W_sky A^T
//   per column (j, k): w = prof_w_j psf_w_k with prof_w = (1 - theta) exp_j
//     or theta dev_j, S = var_j W + psf_cov_k (a star: w = psf_w_k,
//     S = psf_cov_k), mu = psf_mu_k + p;
//   det = S00 S11 - S01 S10, (pa, pb, pc) = (S11, -S01, S00) / det,
//   lognorm = -log(2 pi) - log(det) / 2, amp = iota flux_b w exp(lognorm).
// The backward chains the cotangents of the six planes through the same
// formulas by hand (see scene_planes_bwd_kernel).
//
// What bounds it on the card: bytes.  Per (chain, column) the forward does
// ~30 FP32 operations, a logarithm and an exponential, and writes 24 bytes;
// config 5's planes (12 sources: W = 579, of which 126 live) are 13.9 KB a
// chain and band, 0.91 GB at 65536 chains, 0.27 ms at 3.35 TB/s.  The
// backward reads only the live columns' cotangents (3 KB a chain and band)
// and writes D_total floats a chain.
//
// What the design does about that.  Forward: a block takes kFwdChains
// chains; it stages the band constants in shared memory, computes each
// (chain, source, band)'s scalars (pixel position, iota flux, theta and the
// pixel-space shape W) once into shared memory, then its threads walk the
// block's kFwdChains * W columns of each plane band, which are contiguous in
// every plane: neighbouring threads store neighbouring 4-byte words.
// Backward: one warp owns one (chain, source) block of the gradient, so no
// atomics are needed; its lanes walk the source's live columns of each band
// (coalesced reads of one row), recompute the forward's quantities from the
// states, accumulate the cotangents of the source's scalars, and sum them
// over the warp in a fixed butterfly order, so two calls give equal bits.
// Only the states are saved for the backward, never the planes.
//
// Numerics: float32, the accurate expf, logf and sincosf, IEEE division.
// The library is built with -fmad=false (kernels/scene_planes.py), so every
// product and sum of the forward is rounded on its own, as the plain
// version's separate elementwise operations round it.

#include <cuda_runtime.h>

#include "mog_common.cuh"

namespace {

constexpr int kNExp = 6;          // model/galaxy.py N_EXP
constexpr int kNGal = 16;         // N_GAL: exp and deV components
constexpr int kMaxBands = 8;      // plane bands and state bands
constexpr int kFwdThreads = 256;
constexpr int kFwdChains = 8;     // chains a forward block, at most
constexpr int kBwdWarps = 8;      // (chain, source) tasks a backward block
constexpr int kScalars = 7;       // SourceBand's floats
constexpr int kSmemMax = 232448;  // the H100's 227 KB a block
constexpr float kLog2Pi = 1.8378770664093453f;

// Constants, uploaded once per log density.  Floats: per plane band q, at
// q * band_stride with band_stride = 7 + 7 K: wcs_A (a00, a01, a10, a11),
// wcs_p0 (x, y), iota, then per PSF component k: w, mu_x, mu_y, cov00,
// cov01, cov10, cov11; after the bands the N_GAL profile amplitudes (exp
// then deV) and the N_GAL variances.  Ints: per source s, kind (0 star,
// 1 galaxy) and offset in the state at 2 s, 2 s + 1; then per plane band q
// its state band index at 2 S + q.
struct Dims {
  int n_chains, d_total, n_src, n_bands, n_pb, n_comp, src_w, plane_w;
  __host__ __device__ int band_stride() const { return 7 + 7 * n_comp; }
  __host__ __device__ int n_consts() const { return n_pb * band_stride() + 2 * kNGal; }
  __host__ __device__ int n_table() const { return 2 * n_src + n_pb; }
};

// the output or cotangent planes of every plane band, p = q * 6 + plane
struct PlanePtrs {
  const float* p[6 * kMaxBands];
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// One (chain, source, band)'s scalars: the pixel position, iota * flux_b,
// and for a galaxy theta and the pixel-space shape W = A W_sky A^T.
struct SourceBand {
  float px, py, amp0, theta, oxx, oxy, oyy;
};

__device__ SourceBand source_band(const float* v, bool galaxy, int band, int n_bands,
                                  const float* bc) {
  SourceBand r;
  const float a = bc[0], b = bc[1], c = bc[2], d = bc[3];
  r.px = bc[4] + (a * v[0] + b * v[1]);
  r.py = bc[5] + (c * v[0] + d * v[1]);
  r.amp0 = bc[6] * expf(v[2 + band]);
  r.theta = r.oxx = r.oxy = r.oyy = 0.0f;
  if (galaxy) {
    r.theta = sigmoid(v[2 + n_bands]);
    const float sigma = expf(v[3 + n_bands]);
    const float ab = sigmoid(v[4 + n_bands]);
    float sn, cs;
    sincosf(v[5 + n_bands], &sn, &cs);
    const float maj = sigma * sigma;
    const float abs_ = ab * sigma;
    const float mnr = abs_ * abs_;
    const float wxx = cs * cs * maj + sn * sn * mnr;
    const float wyy = sn * sn * maj + cs * cs * mnr;
    const float wxy = cs * sn * (maj - mnr);
    const float r0x = a * wxx + b * wxy, r0y = a * wxy + b * wyy;
    const float r1x = c * wxx + d * wxy, r1y = c * wxy + d * wyy;
    r.oxx = r0x * a + r0y * b;
    r.oxy = r0x * c + r0y * d;
    r.oyy = r1x * c + r1y * d;
  }
  return r;
}

// One column's component in precision form.  psf: the component's 7
// constants; prof: the profile amplitudes then variances.
struct Column {
  float w, mx, my, s00, s01, s10, s11, inv, pa, pb, pc, e, amp;
};

__device__ __forceinline__ Column column(const SourceBand& sb, bool galaxy, int j,
                                         const float* psf, const float* prof) {
  Column r;
  if (galaxy) {
    const float pw = j < kNExp ? (1.0f - sb.theta) * prof[j] : sb.theta * prof[j];
    const float var = prof[kNGal + j];
    r.w = pw * psf[0];
    r.s00 = var * sb.oxx + psf[3];
    r.s01 = var * sb.oxy + psf[4];
    r.s10 = var * sb.oxy + psf[5];
    r.s11 = var * sb.oyy + psf[6];
  } else {
    r.w = psf[0];
    r.s00 = psf[3];
    r.s01 = psf[4];
    r.s10 = psf[5];
    r.s11 = psf[6];
  }
  r.mx = psf[1] + sb.px;
  r.my = psf[2] + sb.py;
  const float det = r.s00 * r.s11 - r.s01 * r.s10;
  r.inv = 1.0f / det;
  r.pa = r.s11 * r.inv;
  r.pb = -r.s01 * r.inv;
  r.pc = r.s00 * r.inv;
  r.e = expf(-kLog2Pi - 0.5f * logf(det));
  r.amp = sb.amp0 * r.w * r.e;
  return r;
}

__device__ __forceinline__ void stage_consts(const float* consts, const int* table,
                                             float* s_consts, int* s_table, const Dims& dm) {
  for (int i = threadIdx.x; i < dm.n_consts(); i += blockDim.x) s_consts[i] = consts[i];
  for (int i = threadIdx.x; i < dm.n_table(); i += blockDim.x) s_table[i] = table[i];
}

__global__ void __launch_bounds__(kFwdThreads)
scene_planes_fwd_kernel(const float* __restrict__ vecs, const float* __restrict__ consts,
                        const int* __restrict__ table, float* __restrict__ planes, Dims dm,
                        int n_ch) {
  extern __shared__ float smem[];
  float* s_consts = smem;
  int* s_table = reinterpret_cast<int*>(smem + dm.n_consts());
  float* s_scal = smem + dm.n_consts() + dm.n_table();
  stage_consts(consts, table, s_consts, s_table, dm);
  __syncthreads();

  const int chain0 = blockIdx.x * n_ch;
  const int n_here = min(n_ch, dm.n_chains - chain0);
  const int stride = dm.band_stride();
  for (int t = threadIdx.x; t < n_here * dm.n_src; t += blockDim.x) {
    const int ch = t / dm.n_src, s = t - ch * dm.n_src;
    const bool galaxy = s_table[2 * s];
    const float* v = vecs + static_cast<size_t>(chain0 + ch) * dm.d_total + s_table[2 * s + 1];
    for (int q = 0; q < dm.n_pb; ++q) {
      const SourceBand sb = source_band(v, galaxy, s_table[2 * dm.n_src + q], dm.n_bands,
                                        s_consts + q * stride);
      float* o = s_scal + (static_cast<size_t>(t) * dm.n_pb + q) * kScalars;
      o[0] = sb.px;
      o[1] = sb.py;
      o[2] = sb.amp0;
      o[3] = sb.theta;
      o[4] = sb.oxx;
      o[5] = sb.oxy;
      o[6] = sb.oyy;
    }
  }
  __syncthreads();

  const float* prof = s_consts + dm.n_pb * stride;
  const size_t plane_n = static_cast<size_t>(dm.n_chains) * dm.plane_w;
  const int n_items = n_here * dm.plane_w;
  for (int q = 0; q < dm.n_pb; ++q) {
    float* out = planes + q * 6 * plane_n + static_cast<size_t>(chain0) * dm.plane_w;
    for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
      const int ch = i / dm.plane_w, c = i - ch * dm.plane_w;
      const int s = c / dm.src_w;
      float vals[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (s < dm.n_src) {                       // else the sentinel
        const int rem = c - s * dm.src_w;
        const int j = rem / dm.n_comp, k = rem - j * dm.n_comp;
        const bool galaxy = s_table[2 * s];
        if (galaxy || j == 0) {                 // else a star's unused slot
          const float* o = s_scal + (static_cast<size_t>(ch * dm.n_src + s) * dm.n_pb + q) *
                                        kScalars;
          const SourceBand sb = {o[0], o[1], o[2], o[3], o[4], o[5], o[6]};
          const Column cf = column(sb, galaxy, j, s_consts + q * stride + 7 + 7 * k, prof);
          vals[0] = cf.amp;
          vals[1] = cf.mx;
          vals[2] = cf.my;
          vals[3] = cf.pa;
          vals[4] = cf.pb;
          vals[5] = cf.pc;
        }
      }
#pragma unroll
      for (int p = 0; p < 6; ++p) out[p * plane_n + i] = vals[p];
    }
  }
}

// The gradient [B, D_total] from the planes' cotangents.  Per column, with
// t = g_amp amp (amp is linear in flux_b and in exp(lognorm)):
//   d log_flux_b += t;  d p += (g_mx, g_my);
//   galaxy: d theta += g_amp iota flux_b psf_w e (-exp_j or +dev_j),
//     d det = -(g_pa pa + g_pb pb + g_pc pc) / det - t / (2 det),
//     d S00 = g_pc / det + d det S11,  d S11 = g_pa / det + d det S00,
//     d S01 = -g_pb / det - d det S10,  d S10 = -d det S01,
//     d W += var_j (d S00, d S01 + d S10, d S11);
// then per band d u = A^T d p and d W_sky = the congruence's transpose, and
// per source the bijection: d logit_theta = d theta theta (1 - theta),
// d log_sigma = sigma (2 sigma d maj + 2 ab^2 sigma d mnr),
// d logit_ab = 2 ab sigma^2 d mnr ab (1 - ab), d phi = -sin d cos + cos d sin.
__global__ void __launch_bounds__(kBwdWarps * 32)
scene_planes_bwd_kernel(const float* __restrict__ vecs, const float* __restrict__ consts,
                        const int* __restrict__ table, PlanePtrs g, float* __restrict__ grad,
                        Dims dm) {
  extern __shared__ float smem[];
  float* s_consts = smem;
  int* s_table = reinterpret_cast<int*>(smem + dm.n_consts());
  stage_consts(consts, table, s_consts, s_table, dm);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long task = static_cast<long long>(blockIdx.x) * kBwdWarps + (threadIdx.x >> 5);
  if (task >= static_cast<long long>(dm.n_chains) * dm.n_src) return;   // whole warps
  const int chain = static_cast<int>(task / dm.n_src);
  const int s = static_cast<int>(task - static_cast<long long>(chain) * dm.n_src);
  const bool galaxy = s_table[2 * s];
  const float* v = vecs + static_cast<size_t>(chain) * dm.d_total + s_table[2 * s + 1];
  const int stride = dm.band_stride();
  const float* prof = s_consts + dm.n_pb * stride;
  const int n_live = galaxy ? kNGal * dm.n_comp : dm.n_comp;
  const size_t row = static_cast<size_t>(chain) * dm.plane_w + static_cast<size_t>(s) * dm.src_w;

  // this lane's sums: d u, d W_sky (xx, xy, yy), d theta, d log_flux per band
  float acc[6 + kMaxBands];
#pragma unroll
  for (int i = 0; i < 6 + kMaxBands; ++i) acc[i] = 0.0f;
  for (int q = 0; q < dm.n_pb; ++q) {
    const float* bc = s_consts + q * stride;
    const int band = s_table[2 * dm.n_src + q];
    const SourceBand sb = source_band(v, galaxy, band, dm.n_bands, bc);
    float gpx = 0.0f, gpy = 0.0f, gxx = 0.0f, gxy = 0.0f, gyy = 0.0f, glf = 0.0f;
    for (int col = lane; col < n_live; col += 32) {
      const int j = col / dm.n_comp, k = col - j * dm.n_comp;
      float gp[6];
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        const float* src = g.p[q * 6 + p];
        gp[p] = src ? src[row + col] : 0.0f;
      }
      const float* psf = bc + 7 + 7 * k;
      const Column cf = column(sb, galaxy, j, psf, prof);
      const float t = gp[0] * cf.amp;
      glf += t;
      gpx += gp[1];
      gpy += gp[2];
      if (galaxy) {
        const float dw = sb.amp0 * psf[0] * cf.e;
        acc[5] += gp[0] * dw * (j < kNExp ? -prof[j] : prof[j]);
        const float gdet = -cf.inv * (gp[3] * cf.pa + gp[4] * cf.pb + gp[5] * cf.pc) -
                           0.5f * cf.inv * t;
        const float var = prof[kNGal + j];
        gxx += var * (gp[5] * cf.inv + gdet * cf.s11);
        gxy += var * ((-gp[4] * cf.inv - gdet * cf.s10) - gdet * cf.s01);
        gyy += var * (gp[3] * cf.inv + gdet * cf.s00);
      }
    }
    const float a = bc[0], b = bc[1], c = bc[2], d = bc[3];
    acc[0] += a * gpx + c * gpy;
    acc[1] += b * gpx + d * gpy;
    acc[2] += a * a * gxx + a * c * gxy + c * c * gyy;
    acc[3] += 2.0f * a * b * gxx + (b * c + a * d) * gxy + 2.0f * c * d * gyy;
    acc[4] += b * b * gxx + b * d * gxy + d * d * gyy;
#pragma unroll
    for (int i = 0; i < kMaxBands; ++i)
      if (i == band) acc[6 + i] += glf;
  }
#pragma unroll
  for (int i = 0; i < 6 + kMaxBands; ++i)
    if (i < 6 + dm.n_bands) acc[i] = celeste::warp_sum(acc[i]);   // the state's bands only
  if (lane != 0) return;

  float* out = grad + static_cast<size_t>(chain) * dm.d_total + s_table[2 * s + 1];
  out[0] = acc[0];
  out[1] = acc[1];
#pragma unroll
  for (int i = 0; i < kMaxBands; ++i)
    if (i < dm.n_bands) out[2 + i] = acc[6 + i];
  if (!galaxy) return;
  const int nb = dm.n_bands;
  const float theta = sigmoid(v[2 + nb]);
  const float sigma = expf(v[3 + nb]);
  const float ab = sigmoid(v[4 + nb]);
  float sn, cs;
  sincosf(v[5 + nb], &sn, &cs);
  const float maj = sigma * sigma;
  const float abs_ = ab * sigma;
  const float mnr = abs_ * abs_;
  const float gwxx = acc[2], gwxy = acc[3], gwyy = acc[4];
  const float g_maj = cs * cs * gwxx + sn * sn * gwyy + cs * sn * gwxy;
  const float g_mnr = sn * sn * gwxx + cs * cs * gwyy - cs * sn * gwxy;
  const float g_cs = 2.0f * cs * maj * gwxx + 2.0f * cs * mnr * gwyy + sn * (maj - mnr) * gwxy;
  const float g_sn = 2.0f * sn * mnr * gwxx + 2.0f * sn * maj * gwyy + cs * (maj - mnr) * gwxy;
  out[2 + nb] = acc[5] * theta * (1.0f - theta);
  out[3 + nb] = (2.0f * sigma * g_maj + 2.0f * abs_ * ab * g_mnr) * sigma;
  out[4 + nb] = 2.0f * abs_ * sigma * g_mnr * ab * (1.0f - ab);
  out[5 + nb] = -sn * g_cs + cs * g_sn;
}

cudaError_t check_dims(const Dims& dm) {
  if (dm.n_chains < 0 || dm.n_src < 1 || dm.n_comp < 1 || dm.n_pb < 1 ||
      dm.n_pb > kMaxBands || dm.n_bands < 1 || dm.n_bands > kMaxBands ||
      dm.src_w < dm.n_comp || dm.plane_w < dm.n_src * dm.src_w + dm.n_comp)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

Dims make_dims(int n_chains, int d_total, int n_src, int n_bands, int n_pb, int n_comp,
               int src_w, int plane_w) {
  return Dims{n_chains, d_total, n_src, n_bands, n_pb, n_comp, src_w, plane_w};
}

}  // namespace

extern "C" {

// The planes [n_pb, 6, B, W] of the states vecs [B, D_total].
int scene_planes_fwd(const float* vecs, const float* consts, const int* table, float* planes,
                     int n_chains, int d_total, int n_src, int n_bands, int n_pb, int n_comp,
                     int src_w, int plane_w, void* stream) {
  const Dims dm = make_dims(n_chains, d_total, n_src, n_bands, n_pb, n_comp, src_w, plane_w);
  cudaError_t err = check_dims(dm);
  if (err != cudaSuccess || n_chains == 0) return static_cast<int>(err);
  const size_t fixed = (dm.n_consts() + dm.n_table()) * sizeof(float);
  const size_t per_chain = static_cast<size_t>(n_src) * n_pb * kScalars * sizeof(float);
  int n_ch = kFwdChains;
  while (n_ch > 1 && fixed + n_ch * per_chain > static_cast<size_t>(celeste::kDefaultSmem))
    n_ch >>= 1;
  const size_t smem = fixed + n_ch * per_chain;
  if (smem > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  err = celeste::launch_prep(scene_planes_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_chains + n_ch - 1) / n_ch;
  scene_planes_fwd_kernel<<<blocks, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      vecs, consts, table, planes, dm, n_ch);
  return static_cast<int>(cudaGetLastError());
}

// The gradient grad [B, D_total] from the cotangents cot[q * 6 + p] [B, W]
// of plane p of plane band q (a null pointer is a zero cotangent).
int scene_planes_bwd(const float* vecs, const float* consts, const int* table,
                     const void* const* cot, float* grad, int n_chains, int d_total, int n_src,
                     int n_bands, int n_pb, int n_comp, int src_w, int plane_w, void* stream) {
  const Dims dm = make_dims(n_chains, d_total, n_src, n_bands, n_pb, n_comp, src_w, plane_w);
  cudaError_t err = check_dims(dm);
  if (err != cudaSuccess || n_chains == 0) return static_cast<int>(err);
  PlanePtrs g = {};
  for (int i = 0; i < 6 * n_pb; ++i) g.p[i] = static_cast<const float*>(cot[i]);
  const size_t smem = (dm.n_consts() + dm.n_table()) * sizeof(float);
  if (smem > static_cast<size_t>(celeste::kDefaultSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tasks = static_cast<long long>(n_chains) * n_src;
  const long long blocks = (tasks + kBwdWarps - 1) / kBwdWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  scene_planes_bwd_kernel<<<static_cast<unsigned>(blocks), kBwdWarps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(vecs, consts, table, g, grad,
                                                                  dm);
  return static_cast<int>(cudaGetLastError());
}

const char* scene_planes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
