// The crowded field's prior for Hopper (sm_90a): every source's prior and
// log |det J| of a batch of joint states in one forward launch, and the
// states' gradient in one backward launch.
//
// Replaces no TPU kernel.  The JAX package evaluates the prior in plain jnp
// (celeste_tpu/parallel/crowded.py _crowded_logprior over model/priors.py
// and model/params.py), which XLA fuses under jit; the port's plain version
// of that graph (the same functions in celeste_tpu_torch) is ~70-95 small
// elementwise launches a source, and its colour prior copies its means and
// standard deviations from the host on every call.  This pair is the port's
// counterpart of XLA's fusion.
//
// Layout.  States are [B, D_total] float32, every source's unconstrained
// block packed in scene order (a star [du_e, du_n, x_0..x_{nb-1}], a galaxy
// that and [logit_theta, log_sigma, logit_ab, phi]; x_b the log-fluxes).
// The forward writes one float a chain, the backward a [B, D_total]
// gradient.
//
// Math, per (chain, source), formula for formula and in the order of
// model/priors.py SourcePriors and model/params.py log_det_jacobian:
//   f_b = exp(x_b), lf_b = log(f_b)   (not cancelled to x_b);
//   flux = N(lf_ref; m, s) + sum_b N(lf_b - lf_{b+1}; cm_b, cs_b) - sum_b lf_b
//     with N(x; m, s) = -z^2 / 2 - log s - log sqrt(2 pi), z = (x - m) / s;
//   position = -1/2 sum_i (max(|u_i| - hw, 0) / rolloff)^2 (NaN kept);
//   galaxy: theta = sigmoid, sigma = exp, ab = sigmoid of their slots,
//     shape = Beta(theta) + N(log sigma) - log sigma + Beta(ab) - log pi,
//     Beta(x; a, b) = (a - 1) log x + (b - 1) log1p(-x) + log B(a, b)^-1
//     (the (a - 1) and (b - 1) terms kept when they are 0, so a saturated
//     sigmoid gives NaN as the plain graph does);
//   log |det J| = sum_b x_b, and for a galaxy + sig_ljd(logit_theta)
//     + log_sigma + sig_ljd(logit_ab), sig_ljd(x) = -x - 2 softplus(-x)
//     (softplus with torch's threshold of 20);
//   a chain's value: total = (total + prior_s) + log |det J|_s over s.
// Where the plain graph divides by a Python float (the reference flux's and
// log sigma's standard deviations, the roll-off), PyTorch's CUDA division
// multiplies by the float32 reciprocal, and so do these kernels; the colour
// standard deviations are a tensor, and they divide.  The backward chains
// the per-chain cotangent g through the same formulas by hand, in the order
// autograd takes them (see source_grad): the clamp passes the gradient
// where |u| - hw >= 0, abs takes sign(u), d lf_b / d x_b = (1 / f_b) f_b.
//
// What bounds it on the card: bytes.  Per chain the forward reads D_total
// floats and writes one, the backward reads D_total + 1 and writes D_total:
// 11.5 / 23.1 MB at c5_r's 65536 x 44, 8.9 / 17.8 MB at c5_gri's
// 32768 x 68, 2.7-6.9 us at 3.35 TB/s.  The arithmetic, ~10 accurate
// special functions a galaxy and two a star band, is a few us more.  What
// limits it in practice is latency: a chain's sources are one thread's
// serial walk, and B / 32 warps (8-16 an SM at these shapes) hide little
// of it; 25-39 us a launch, under 0.1% of a gradient.
//
// What the design does about that.  A block takes kChains chains, one
// thread each.  It stages its chains' rows in shared memory with coalesced
// loads (the row stride made odd, so that the threads' reads of one column
// fall in distinct banks) beside the constants and the per-source table;
// each thread walks the sources in scene order, so its sums run in one fixed
// order and two calls give equal bits.  The backward writes each row's
// gradient over its staged row and the block stores the rows with
// coalesced stores.  Only the states are saved for the backward.
//
// Numerics: float32, the accurate expf, logf and log1pf, IEEE division.
// The library is built with -fmad=false (kernels/scene_prior.py), so every
// product and sum is rounded on its own, as the plain version's separate
// elementwise operations round it.

#include <cuda_runtime.h>

#include "mog_common.cuh"

namespace {

constexpr int kMaxBands = 8;                   // state bands
constexpr int kChains = 64;                    // chains (threads) a block
constexpr int kSmemMax = 232448;               // the H100's 227 KB a block
constexpr float kHalfLog2Pi = 0.9189385332046727f;
constexpr float kSoftplusThreshold = 20.0f;    // F.softplus's default

// Constants, uploaded once per log density (kernels/scene_prior.py
// pack_constants).  Floats: the kNFixed scalars at these indices, then the
// n_bands - 1 colour means, standard deviations and logs of the standard
// deviations.  Ints: per source s, kind (0 star, 1 galaxy) and offset in
// the state at 2 s, 2 s + 1.
enum : int {
  kRefMean, kRefInvStd, kRefLogStd,            // FluxPrior's reference band
  kHalfwidth, kInvRolloff,                     // PositionPrior
  kThetaA1, kThetaB1, kThetaNorm,              // Beta(theta): a - 1, b - 1, log-normaliser
  kSigmaMean, kSigmaInvStd, kSigmaLogStd,      // log sigma's normal
  kAbA1, kAbB1, kAbNorm,                       // Beta(ab)
  kLogPi,                                      // phi's flat density
  kNFixed
};

struct Dims {
  int n_chains, d_total, n_src, n_bands, ref;
  __host__ __device__ int n_consts() const { return kNFixed + 3 * (n_bands - 1); }
  __host__ __device__ int n_table() const { return 2 * n_src; }
  __host__ __device__ int row_stride() const { return d_total | 1; }
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float softplus(float x) {
  return x > kSoftplusThreshold ? x : log1pf(expf(x));
}

// log d sigmoid / dx, and g times its derivative as autograd chains it
__device__ __forceinline__ float sig_ljd(float x) { return -x - 2.0f * softplus(-x); }

__device__ __forceinline__ float sig_ljd_grad(float x, float g) {
  const float y = -x;
  const float gs = -g * 2.0f;
  const float z = expf(y);
  const float gy = y > kSoftplusThreshold ? gs : gs * z / (z + 1.0f);
  return -g + -gy;
}

// _normal_logpdf of the standardised z
__device__ __forceinline__ float normal_lp(float z, float log_std) {
  return -0.5f * z * z - log_std - kHalfLog2Pi;
}

__device__ __forceinline__ float beta_lp(float x, float a1, float b1, float norm) {
  return a1 * logf(x) + b1 * log1pf(-x) + norm;
}

__device__ __forceinline__ float beta_grad(float x, float a1, float b1, float g) {
  return (g * a1) / x + -((g * b1) / (-x + 1.0f));
}

// A source's (prior, log |det J|) at its block v.
__device__ float2 source_logp(const float* v, bool galaxy, const float* c, const Dims& dm) {
  const int nb = dm.n_bands;
  const float* cm = c + kNFixed;
  const float* cs = cm + (nb - 1);
  const float* cls = cs + (nb - 1);
  float lf[kMaxBands];
  float ref = 0.0f, sum_lf = 0.0f, ljd = 0.0f;
#pragma unroll
  for (int b = 0; b < kMaxBands; ++b) {
    if (b < nb) {
      lf[b] = logf(expf(v[2 + b]));
      if (b == dm.ref) ref = lf[b];
    }
  }
  float flux = normal_lp((ref - c[kRefMean]) * c[kRefInvStd], c[kRefLogStd]);
  if (nb > 1) {
    float colours = 0.0f;
#pragma unroll
    for (int b = 0; b < kMaxBands - 1; ++b)
      if (b < nb - 1) colours += normal_lp((lf[b] - lf[b + 1] - cm[b]) / cs[b], cls[b]);
    flux = flux + colours;
  }
#pragma unroll
  for (int b = 0; b < kMaxBands; ++b)
    if (b < nb) {
      sum_lf += lf[b];
      ljd += v[2 + b];
    }
  flux = flux - sum_lf;
  float pos = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float d = fabsf(v[i]) - c[kHalfwidth];
    const float t = celeste::clamp_min(d, 0.0f) * c[kInvRolloff];
    pos += t * t;
  }
  float lp = flux + -0.5f * pos;
  if (galaxy) {
    const float lt = v[2 + nb], ls = v[3 + nb], la = v[4 + nb];
    const float theta = sigmoid(lt), sigma = expf(ls), ab = sigmoid(la);
    const float lsig = logf(sigma);
    float shape = beta_lp(theta, c[kThetaA1], c[kThetaB1], c[kThetaNorm]);
    shape = shape + normal_lp((lsig - c[kSigmaMean]) * c[kSigmaInvStd], c[kSigmaLogStd]) - lsig;
    shape = shape + beta_lp(ab, c[kAbA1], c[kAbB1], c[kAbNorm]);
    lp = lp + (shape - c[kLogPi]);
    ljd = ljd + sig_ljd(lt) + ls + sig_ljd(la);
  }
  return make_float2(lp, ljd);
}

// g times the gradient of a source's prior + log |det J|, written over its
// block v (read first).  Per term, as autograd's backward formulas take it:
//   N(x): d x = -(g z) / s (times the reciprocal where the forward multiplies);
//   d lf_b = -g + [b = ref] d N + d colour_b - d colour_{b-1};
//   d x_b = (d lf_b / f_b) f_b + g;
//   d u_i = [|u_i| - hw >= 0] (-g / 2) (2 t) / rolloff sign(u_i);
//   d theta = (g (a - 1)) / theta - (g (b - 1)) / (1 - theta), then
//     d logit = (d theta (1 - theta)) theta + d sig_ljd;
//   d log sigma = (d N / sigma - g / sigma) sigma + g;  d phi = 0.
__device__ void source_grad(float* v, bool galaxy, const float* c, const Dims& dm, float g) {
  const int nb = dm.n_bands;
  const float* cm = c + kNFixed;
  const float* cs = cm + (nb - 1);
  float f[kMaxBands], lf[kMaxBands], glf[kMaxBands];
#pragma unroll
  for (int b = 0; b < kMaxBands; ++b) {
    if (b < nb) {
      f[b] = expf(v[2 + b]);
      lf[b] = logf(f[b]);
      glf[b] = -g;
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxBands; ++b) {
    if (b < nb && b == dm.ref) {
      const float z = (lf[b] - c[kRefMean]) * c[kRefInvStd];
      glf[b] += -(g * z) * c[kRefInvStd];
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxBands - 1; ++b) {
    if (b < nb - 1) {
      const float z = (lf[b] - lf[b + 1] - cm[b]) / cs[b];
      const float gc = -(g * z) / cs[b];
      glf[b] += gc;
      glf[b + 1] += -gc;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float u = v[i];
    const float d = fabsf(u) - c[kHalfwidth];
    const float t = celeste::clamp_min(d, 0.0f) * c[kInvRolloff];
    const float ge = g * -0.5f * (2.0f * t) * c[kInvRolloff];
    const float sgn = static_cast<float>((u > 0.0f) - (u < 0.0f));
    v[i] = (d >= 0.0f ? ge : 0.0f) * sgn;
  }
  if (galaxy) {
    const float lt = v[2 + nb], ls = v[3 + nb], la = v[4 + nb];
    const float theta = sigmoid(lt), sigma = expf(ls), ab = sigmoid(la);
    const float lsig = logf(sigma);
    const float z = (lsig - c[kSigmaMean]) * c[kSigmaInvStd];
    const float g_lsig = -(g * z) * c[kSigmaInvStd];
    const float g_theta = beta_grad(theta, c[kThetaA1], c[kThetaB1], g);
    const float g_ab = beta_grad(ab, c[kAbA1], c[kAbB1], g);
    v[2 + nb] = g_theta * (1.0f - theta) * theta + sig_ljd_grad(lt, g);
    v[3 + nb] = (g_lsig / sigma + -g / sigma) * sigma + g;
    v[4 + nb] = g_ab * (1.0f - ab) * ab + sig_ljd_grad(la, g);
    v[5 + nb] = 0.0f;
  }
#pragma unroll
  for (int b = 0; b < kMaxBands; ++b)
    if (b < nb) v[2 + b] = glf[b] / f[b] * f[b] + g;
}

// Stage the constants, the table and the block's rows (coalesced; row
// stride odd) in shared memory: [kChains rows][consts][table].
__device__ __forceinline__ void stage(const float* vecs, const float* consts, const int* table,
                                      float* s_rows, float* s_consts, int* s_table,
                                      const Dims& dm, int chain0, int n_here) {
  for (int i = threadIdx.x; i < dm.n_consts(); i += blockDim.x) s_consts[i] = consts[i];
  for (int i = threadIdx.x; i < dm.n_table(); i += blockDim.x) s_table[i] = table[i];
  const int d = dm.d_total, ld = dm.row_stride();
  const float* src = vecs + static_cast<size_t>(chain0) * d;
  for (int i = threadIdx.x; i < n_here * d; i += blockDim.x) {
    const int r = i / d;
    s_rows[r * ld + (i - r * d)] = src[i];
  }
}

__global__ void __launch_bounds__(kChains)
scene_prior_fwd_kernel(const float* __restrict__ vecs, const float* __restrict__ consts,
                       const int* __restrict__ table, float* __restrict__ out, Dims dm) {
  extern __shared__ float smem[];
  const int ld = dm.row_stride();
  float* s_rows = smem;
  float* s_consts = smem + kChains * ld;
  int* s_table = reinterpret_cast<int*>(s_consts + dm.n_consts());
  const int chain0 = blockIdx.x * kChains;
  const int n_here = min(kChains, dm.n_chains - chain0);
  stage(vecs, consts, table, s_rows, s_consts, s_table, dm, chain0, n_here);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= n_here) return;
  const float* row = s_rows + threadIdx.x * ld;
  float total = 0.0f;
  for (int s = 0; s < dm.n_src; ++s) {
    const float2 t = source_logp(row + s_table[2 * s + 1], s_table[2 * s], s_consts, dm);
    total = total + t.x + t.y;
  }
  out[chain0 + threadIdx.x] = total;
}

__global__ void __launch_bounds__(kChains)
scene_prior_bwd_kernel(const float* __restrict__ vecs, const float* __restrict__ g_out,
                       const float* __restrict__ consts, const int* __restrict__ table,
                       float* __restrict__ grad, Dims dm) {
  extern __shared__ float smem[];
  const int ld = dm.row_stride();
  float* s_rows = smem;
  float* s_consts = smem + kChains * ld;
  int* s_table = reinterpret_cast<int*>(s_consts + dm.n_consts());
  const int chain0 = blockIdx.x * kChains;
  const int n_here = min(kChains, dm.n_chains - chain0);
  stage(vecs, consts, table, s_rows, s_consts, s_table, dm, chain0, n_here);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n_here) {
    float* row = s_rows + threadIdx.x * ld;
    const float g = g_out[chain0 + threadIdx.x];
    for (int s = 0; s < dm.n_src; ++s)
      source_grad(row + s_table[2 * s + 1], s_table[2 * s], s_consts, dm, g);
  }
  __syncthreads();
  const int d = dm.d_total;
  float* dst = grad + static_cast<size_t>(chain0) * d;
  for (int i = threadIdx.x; i < n_here * d; i += blockDim.x) {
    const int r = i / d;
    dst[i] = s_rows[r * ld + (i - r * d)];
  }
}

cudaError_t check_dims(const Dims& dm) {
  if (dm.n_chains < 0 || dm.n_src < 1 || dm.n_bands < 1 || dm.n_bands > kMaxBands ||
      dm.ref < 0 || dm.ref >= dm.n_bands || dm.d_total < dm.n_src * (2 + dm.n_bands))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Dims& dm, size_t* smem, int* blocks) {
  cudaError_t err = check_dims(dm);
  if (err != cudaSuccess) return err;
  *smem = (static_cast<size_t>(kChains) * dm.row_stride() + dm.n_consts() + dm.n_table()) *
          sizeof(float);
  if (*smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  *blocks = (dm.n_chains + kChains - 1) / kChains;
  return celeste::launch_prep(kernel, *smem);
}

}  // namespace

extern "C" {

// The prior + log |det J| out [B] of the states vecs [B, D_total].
int scene_prior_fwd(const float* vecs, const float* consts, const int* table, float* out,
                    int n_chains, int d_total, int n_src, int n_bands, int ref, void* stream) {
  const Dims dm{n_chains, d_total, n_src, n_bands, ref};
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare(scene_prior_fwd_kernel, dm, &smem, &blocks);
  if (err != cudaSuccess || n_chains == 0) return static_cast<int>(err);
  scene_prior_fwd_kernel<<<blocks, kChains, smem, static_cast<cudaStream_t>(stream)>>>(
      vecs, consts, table, out, dm);
  return static_cast<int>(cudaGetLastError());
}

// The gradient grad [B, D_total] of sum_c g[c] out[c] at the states vecs.
int scene_prior_bwd(const float* vecs, const float* g, const float* consts, const int* table,
                    float* grad, int n_chains, int d_total, int n_src, int n_bands, int ref,
                    void* stream) {
  const Dims dm{n_chains, d_total, n_src, n_bands, ref};
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare(scene_prior_bwd_kernel, dm, &smem, &blocks);
  if (err != cudaSuccess || n_chains == 0) return static_cast<int>(err);
  scene_prior_bwd_kernel<<<blocks, kChains, smem, static_cast<cudaStream_t>(stream)>>>(
      vecs, g, consts, table, grad, dm);
  return static_cast<int>(cudaGetLastError());
}

const char* scene_prior_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
