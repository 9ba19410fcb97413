// The sampler's u-space density around the potential in two launches: potentials.tempered_value_and_grad's
// bijector, prior and tempering.
//
// A port-only kernel pair: the JAX package has no Pallas counterpart, since XLA fuses the density into the
// sampler's program. In the port the density ran as some 80 eager PyTorch operations on (C, D) and (C,)
// tensors around every potential call (Bijector.forward_and_grads, MultipleIndependent.log_prob_and_grad, the
// tempering sum and the chain rule), each a launch of about a microsecond on the card behind tens of
// microseconds of host dispatch.
//
// density_pre_kernel, before the potential, for every chain c (C chains, D dimensions):
//   theta = the bijector's forward(u): u (real), exp(u) (positive), lo + span * sigmoid(u) (interval);
//   lpld = log prior(theta) + log_det(u), the prior summed group by group as MultipleIndependent sums it
//   (0.0 + sum(group 1) + sum(group 2) ...), each group's sum and the log-det's taken over the row in
//   PyTorch's order (torch_order.cuh);
//   with the gradient: dtheta/du, d log_det/du and the prior's gradient g_lp at theta.
// density_post_kernel, after the potential's ll (C,) and g_ll (C, D):
//   value = lpld + (beta / T) * ll; with the gradient, grad = (g_lp + (beta / T) * g_ll) * dtheta + dlog_det.
//
// The arithmetic is the plain path's in its order and rounding: every product, quotient, sum and difference is
// rounded once (__fmul_rn, __fdiv_rn, __fadd_rn, __fsub_rn: never contracted into an FMA); the Python scalars
// and thresholds enter at float32, as PyTorch's type promotion gives them; beta / T is beta times the float32
// reciprocal of T, as PyTorch's CUDA division by a CPU scalar computes it; expf, logf and log1pf are the math
// library's (no fast-math intrinsics), and sigmoid, logsigmoid and clamp are written as PyTorch's CUDA kernels
// write them (clamp lets NaN through). sdm_density_unary runs each of those one-input functions over a range of
// float32 bit patterns, so that tests hold them to PyTorch's over every float32.
//
// Per-dimension behaviour comes from tables that ops/density_cuda.py builds once from the prior and the
// bijector (SdmDensityTables): no branch here names a model. What bounds it: the launch. A chain moves a few
// hundred bytes, so it is a thread a chain in blocks of up to MAX_THREADS, as the NUTS leaf kernel is.

#include <cuda_runtime.h>
#include <math.h>

#include "torch_order.cuh"

// The prior's and the bijector's tables, on the device. Column d's constants are k[d * K_STRIDE + i]:
// i = 0..2 the bijector's lo, span and log(span); from i = 3 the prior family's (family[d]):
//   Uniform (0): lo, hi, -log(hi - lo);
//   Normal (1): mu, sigma, -log(sigma) - log(sqrt(2 pi)), sigma * sigma;
//   Beta (2): a - 1, b - 1, log B(a, b);
//   LogNormal (3): mu, sigma, log(sigma), log(sqrt(2 pi)).
// The prior's groups are summed in turn: group g holds the columns order[group_start[g] .. group_start[g + 1]),
// in the order of the group's own (C, width) tensor.
struct SdmDensityTables {
  const int* code;         // (D,): the bijector's support, 0 real, 1 positive, 2 interval
  const int* family;       // (D,)
  const float* k;          // (D, K_STRIDE)
  const int* group_start;  // (G + 1,)
  const int* order;        // (D,)
  int D, G;
  int zero_start;          // 1: the prior's sum starts from 0.0 + the first group (MultipleIndependent)
};

namespace {

constexpr int MAX_D = 128;  // ops/density_cuda.py refuses D >= MAX_D
constexpr int K_STRIDE = 7;
constexpr float TINY = (float)1e-37;            // the clamps' and the gradients' lower threshold
constexpr float BETA_HI = (float)(1.0 - 1e-7);  // Beta's upper clamp

__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.sigmoid's float32 CUDA kernel: 1 / (1 + exp(-x)).
__device__ __forceinline__ float torch_sigmoid(float x) { return fdiv(1.0f, add(1.0f, expf(-x))); }

// torch.nn.functional.logsigmoid's float32 CUDA kernel: min(0, x) - log1p(exp(-|x|)), std::min's NaN rule.
__device__ __forceinline__ float torch_logsigmoid(float x) {
  const float lo = x < 0.0f ? x : 0.0f;
  return sub(lo, log1pf(expf(-fabsf(x))));
}

// torch.clamp(x, lo, hi) and torch.clamp(x, min=lo) of a float32 tensor: NaN passes through.
__device__ __forceinline__ float torch_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float torch_clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }

// One column of the prior at theta x: its term of the group's sum (*lp) and its gradient (*g), as the
// family's log_prob_and_grad in distributions.py computes them.
__device__ __forceinline__ void prior_column(int family, const float* k, float x, float* lp, float* g) {
  switch (family) {
    case 0: {  // Uniform: where((x >= lo) & (x <= hi), -log width, -inf); gradient 0
      *lp = (x >= k[0] && x <= k[1]) ? k[2] : -INFINITY;
      *g = 0.0f;
      return;
    }
    case 1: {  // Normal: (-log sigma - log sqrt(2 pi)) - 0.5 z**2, z = (x - mu) / sigma; -(x - mu) / sigma^2
      const float d = sub(x, k[0]);
      const float z = fdiv(d, k[1]);
      *lp = sub(k[2], mul(0.5f, mul(z, z)));
      *g = fdiv(-d, k[3]);
      return;
    }
    case 2: {  // Beta
      const float xc = torch_clamp(x, TINY, BETA_HI);
      const float v = sub(add(mul(k[0], logf(xc)), mul(k[1], log1pf(-xc))), k[2]);
      const bool ok = x > 0.0f && x < 1.0f;
      *lp = ok ? v : -INFINITY;
      *g = (ok && x <= BETA_HI && x >= TINY) ? sub(fdiv(k[0], xc), fdiv(k[1], sub(1.0f, xc))) : 0.0f;
      return;
    }
    default: {  // LogNormal
      const float xc = torch_clamp_min(x, TINY);
      const float logx = logf(xc);
      const float zs = fdiv(sub(logx, k[0]), k[1]);
      const float v = sub(sub(sub(-logx, k[2]), k[3]), mul(mul(0.5f, zs), zs));
      *lp = x > 0.0f ? v : -INFINITY;
      *g = x >= TINY ? fdiv(sub(-1.0f, fdiv(zs, k[1])), xc) : 0.0f;
      return;
    }
  }
}

// A thread a chain. u, theta, dtheta, dlog_det, g_lp (C, D), lpld (C,), row-major float32; the gradient terms
// are written only with need_grad.
__global__ void __launch_bounds__(MAX_THREADS) density_pre_kernel(SdmDensityTables t, const float* u, float* theta,
                                                                  float* lpld, float* dtheta, float* dlog_det,
                                                                  float* g_lp, int C, int need_grad) {
  const int D = t.D;
  float lp_col[MAX_D], ld_col[MAX_D];
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C; c += gridDim.x * blockDim.x) {
    const long long cd = (long long)c * D;
    for (int d = 0; d < D; ++d) {
      const float* k = t.k + d * K_STRIDE;
      const int code = t.code[d];
      const float x = u[cd + d];
      const float s = torch_sigmoid(x);
      const float e = expf(x);
      const float th = code == 0 ? x : code == 1 ? e : add(k[0], mul(k[1], s));
      theta[cd + d] = th;
      ld_col[d] = code == 0 ? 0.0f : code == 1 ? x : add(add(k[2], torch_logsigmoid(x)), torch_logsigmoid(-x));
      float g;
      prior_column(t.family[d], k + 3, th, &lp_col[d], &g);
      if (need_grad) {
        dtheta[cd + d] = code == 0 ? 1.0f : code == 1 ? e : mul(k[1], mul(s, sub(1.0f, s)));
        dlog_det[cd + d] = code == 0 ? 0.0f : code == 1 ? 1.0f : sub(1.0f, mul(2.0f, s));
        g_lp[cd + d] = g;
      }
    }
    float lp = 0.0f;
    for (int gi = 0; gi < t.G; ++gi) {
      const int* cols = t.order + t.group_start[gi];
      const float part = torch_order_sum(t.group_start[gi + 1] - t.group_start[gi], c,
                                         [&](int j) { return lp_col[cols[j]]; });
      lp = (gi == 0 && !t.zero_start) ? part : add(lp, part);
    }
    const float log_det = torch_order_sum(D, c, [&](int d) { return ld_col[d]; });
    lpld[c] = add(lp, log_det);
  }
}

// A thread a chain: value (C,) and, with need_grad, grad (C, D); inv_t is float32(1) / float32(T).
__global__ void __launch_bounds__(MAX_THREADS) density_post_kernel(const float* lpld, const float* ll,
                                                                   const float* g_ll, const float* beta, float inv_t,
                                                                   const float* g_lp, const float* dtheta,
                                                                   const float* dlog_det, float* value, float* grad,
                                                                   int C, int D, int need_grad) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C; c += gridDim.x * blockDim.x) {
    const float bt = mul(beta[c], inv_t);
    value[c] = add(lpld[c], mul(bt, ll[c]));
    if (!need_grad) continue;
    const long long cd = (long long)c * D;
    for (int d = 0; d < D; ++d) {
      grad[cd + d] = add(mul(add(g_lp[cd + d], mul(bt, g_ll[cd + d])), dtheta[cd + d]), dlog_det[cd + d]);
    }
  }
}

// The one-input functions above, on the float32 with bit pattern first + i (mod 2^32): x[i] and f(x[i]).
__global__ void density_unary_kernel(int fn, unsigned int first, long long n, float* x, float* y) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const float v = __uint_as_float(first + (unsigned int)i);
    float r;
    switch (fn) {
      case 0: r = torch_sigmoid(v); break;
      case 1: r = expf(v); break;
      case 2: r = logf(v); break;
      case 3: r = log1pf(v); break;
      case 4: r = torch_logsigmoid(v); break;
      case 5: r = torch_clamp(v, TINY, BETA_HI); break;
      default: r = torch_clamp_min(v, TINY); break;
    }
    x[i] = v;
    y[i] = r;
  }
}

}  // namespace

extern "C" {

const char* sdm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The density before the potential call (density_pre_kernel); every pointer on the current device.
int sdm_density_pre(const SdmDensityTables* t, const float* u, float* theta, float* lpld, float* dtheta,
                    float* dlog_det, float* g_lp, int C, int need_grad, void* stream) {
  if (t->D < 1 || t->D >= MAX_D || t->G < 1 || C < 1) return (int)cudaErrorInvalidValue;
  int threads;
  const dim3 grid = blocks_for(C, &threads);
  density_pre_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*t, u, theta, lpld, dtheta, dlog_det, g_lp, C,
                                                                  need_grad);
  return (int)cudaGetLastError();
}

// The density's value and gradient after the potential call (density_post_kernel).
int sdm_density_post(const float* lpld, const float* ll, const float* g_ll, const float* beta, float inv_t,
                     const float* g_lp, const float* dtheta, const float* dlog_det, float* value, float* grad, int C,
                     int D, int need_grad, void* stream) {
  if (D < 1 || D >= MAX_D || C < 1) return (int)cudaErrorInvalidValue;
  int threads;
  const dim3 grid = blocks_for(C, &threads);
  density_post_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(lpld, ll, g_ll, beta, inv_t, g_lp, dtheta,
                                                                   dlog_det, value, grad, C, D, need_grad);
  return (int)cudaGetLastError();
}

// Test entry point: fn (0 sigmoid, 1 exp, 2 log, 3 log1p, 4 logsigmoid, 5 clamp(x, 1e-37, 1 - 1e-7),
// 6 clamp(x, min=1e-37)) on the n float32 bit patterns from first, into x and y (n each).
int sdm_density_unary(int fn, unsigned int first, long long n, float* x, float* y, void* stream) {
  if (fn < 0 || fn > 6 || n < 1) return (int)cudaErrorInvalidValue;
  density_unary_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(fn, first, n, x, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
