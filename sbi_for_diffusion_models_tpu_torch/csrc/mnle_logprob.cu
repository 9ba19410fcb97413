// K2 and K3: the fused MNLE log-prob forward and its recompute-VJP backward.
//
// Replace the Pallas TPU kernels of
// sbi_for_diffusion_models_tpu/ops/mnle_pallas.py (make_fused_logprob:
// _fwd_kernel and _bwd_kernel, row function _rows_logp). Per row, with
// standardized RT t, choice one-hot oh (C) and context ctx (D):
//   categorical MLP D -> H -> ... -> C, log-softmax, picked by oh;
//   trunk MLP [ctx, oh] -> H -> ... -> H, ReLU on every layer (the embedding);
//   one head matmul H -> HO = T*S (+2): T spline parameter blocks of S = 3K-1
//   values and, with cond_affine, the affine pair (mu, log sigma);
//   z = (t - mu) exp(-clip(log sigma, -7, 7)), then T rational-quadratic
//   splines on [-B, B] with identity tails, then the standard normal base;
//   out = cat_lp + m (log_det + base), m = 1 - oh[censored] when the model
//   censors (rows with m = 0 skip the flow and take cat_lp alone).
// K3 recomputes that forward for a tile of rows and pulls a cotangent g back
// to dt (N) and dctx (N, D). It gives no weight gradients.
//
// What bounds them on the card: the matrix products. A row costs about
// 2*(D*H + H*H + H*C + (D+C)*H + 2*H*H + H*HO) = 0.33 MFLOP forward (D = 85,
// H = 128, HO = 712) and about twice that again backward, against ~700 bytes
// of row input: far above the memory roofline, so the limit is the rate of
// FP32 FMAs (no tensor cores: the products run in full FP32, as the JAX
// kernel runs them at Precision.HIGHEST) and, at the main path's 1,200 rows,
// how many SMs have work at all. The spline chain is a serial walk of
// 10 x 24 bins per row and costs little beside the products.
//
// Design, simple first:
// - One block of 128 threads per tile of ROWS = 16 rows. The tile's
//   activations live in shared memory. In a product, thread j computes
//   output unit j for all 16 rows (16 accumulators in registers), streams
//   column j of W (in, out) from global memory/L2 (coalesced across j:
//   neighbouring threads read neighbouring columns) and reads the
//   activations as shared-memory broadcasts. The backward kernel multiplies
//   by W^T and reads the (out, in) copies the wrapper packs, so its loads
//   are coalesced too.
// - The per-row work (log-softmax, the affine layer, the spline chain and
//   their derivatives) runs one thread per row on the row's slice of the
//   head output in shared memory (16 x 712 x 4 B = 45 KB). A spline finds
//   its bin by walking the cumulative widths once; knots are not stored.
//   The bin rule is that of the JAX masked lookup: z == knot[j+1] falls in
//   bin j+1 and the top edge in bin K-1.
// - K3 keeps every layer's activation of the tile (ReLU masks) and the
//   per-row z before each transform (at most 16 transforms). The spline
//   backward overwrites each transform's parameters with their gradients in
//   place, and those gradients flow back through the head, trunk and
//   categorical products. Shared memory: ~114 KB per block at the
//   flagship's widths, so two blocks fit on an SM.
// - All arithmetic is FP32 (FMAs allowed); no TF32, no fast math.

#include "mnle_common.cuh"

namespace {

constexpr float kLogSqrt2Pi = 0.91893853320467274178f;

// The bin of z (|z| <= B) and its knots/derivatives, walking the cumulative
// widths and heights once.
__device__ __forceinline__ Bin find_bin(const float* P, const MnleParams& p, const SoftmaxStats& s,
                                        float z) {
  const int K = p.K;
  const float B = p.tail_bound, total = 2.0f * p.tail_bound;
  float cw = 0.0f, ch = 0.0f;
  Bin b;
  b.xk = -B;
  b.yk = -B;
  b.k = K - 1;
  for (int j = 0; j < K; ++j) {
    cw += p.min_w + p.scale_w * (expf(P[j] - s.max_w) / s.sum_w);
    ch += p.min_h + p.scale_h * (expf(P[K + j] - s.max_h) / s.sum_h);
    const bool last = j == K - 1;
    const float xk1 = last ? B : cw * total - B;
    const float yk1 = last ? B : ch * total - B;
    if (last || z < xk1) {
      b.k = j;
      b.xk1 = xk1;
      b.yk1 = yk1;
      break;
    }
    b.xk = xk1;
    b.yk = yk1;
  }
  b.dk = b.k == 0 ? 1.0f : p.min_d + softplus(P[2 * K + b.k - 1]);
  b.dk1 = b.k == K - 1 ? 1.0f : p.min_d + softplus(P[2 * K + b.k]);
  return b;
}

// Forward RQ spline: returns y, adds log|dy/dx| to *ld.
__device__ float spline_fwd(const float* P, const MnleParams& p, float x, float* ld) {
  const float B = p.tail_bound;
  if (!(x >= -B && x <= B)) return x;  // identity tail, zero log-det
  const SoftmaxStats s = softmax_stats(P, p.K);
  const Bin b = find_bin(P, p, s, x);
  const float w = b.xk1 - b.xk, h = b.yk1 - b.yk, sl = h / w;
  const float xi = (x - b.xk) / w, xi1m = 1.0f - xi;
  const float num = h * (sl * xi * xi + b.dk * xi * xi1m);
  const float den = sl + (b.dk1 + b.dk - 2.0f * sl) * xi * xi1m;
  const float dnum = sl * sl * (b.dk1 * xi * xi + 2.0f * sl * xi * xi1m + b.dk * xi1m * xi1m);
  *ld += logf(dnum) - 2.0f * logf(den);
  return b.yk + num / den;
}

// Backward RQ spline at input x with upstream gradients gy (of y) and gl
// (of the log-det). Overwrites P[0, S) with dL/dP and returns dL/dx.
__device__ float spline_bwd(float* P, const MnleParams& p, float x, float gy, float gl) {
  const int K = p.K, S = 3 * p.K - 1;
  const float B = p.tail_bound, total = 2.0f * p.tail_bound;
  if (!(x >= -B && x <= B)) {
    for (int i = 0; i < S; ++i) P[i] = 0.0f;
    return gy;
  }
  const SoftmaxStats s = softmax_stats(P, K);
  const Bin b = find_bin(P, p, s, x);
  const int k = b.k;
  const float w = b.xk1 - b.xk, h = b.yk1 - b.yk, sl = h / w;
  const float xi = (x - b.xk) / w, xi1m = 1.0f - xi, q = xi * xi1m;
  const float c2 = b.dk1 + b.dk - 2.0f * sl;
  const float nn = sl * xi * xi + b.dk * q;
  const float den = sl + c2 * q;
  const float A = b.dk1 * xi * xi + 2.0f * sl * q + b.dk * xi1m * xi1m;
  const float den2 = den * den;
  // d/dxi
  const float dnn_dxi = 2.0f * sl * xi + b.dk * (1.0f - 2.0f * xi);
  const float dden_dxi = c2 * (1.0f - 2.0f * xi);
  const float dA_dxi = 2.0f * b.dk1 * xi + 2.0f * sl * (1.0f - 2.0f * xi) - 2.0f * b.dk * xi1m;
  const float g_xi = gy * h * (dnn_dxi * den - nn * dden_dxi) / den2 + gl * (dA_dxi / A - 2.0f * dden_dxi / den);
  // d/dslope (y and log-det through s, A and den)
  const float g_s = gy * h * (xi * xi * den - nn * (1.0f - 2.0f * q)) / den2 +
                    gl * (2.0f / sl + 2.0f * q / A - 2.0f * (1.0f - 2.0f * q) / den);
  // d/d derivatives at the bin edges
  const float g_dk = gy * h * q * (den - nn) / den2 + gl * (xi1m * xi1m / A - 2.0f * q / den);
  const float g_dk1 = -gy * h * nn * q / den2 + gl * (xi * xi / A - 2.0f * q / den);
  // bin height h (directly and through s = h / w), bin width w (s and xi)
  const float g_h = gy * nn / den + g_s / w;
  const float g_w = -g_s * sl / w - g_xi * xi / w;
  const float dx = g_xi / w;
  // Knot gradients; the end knots (index 0 and K) are constants.
  const float gxk = k > 0 ? -g_xi / w - g_w : 0.0f;
  const float gxk1 = k + 1 < K ? g_w : 0.0f;
  const float gyk = k > 0 ? gy - g_h : 0.0f;
  const float gyk1 = k + 1 < K ? g_h : 0.0f;
  // knot j (0 < j < K) = total * sum_{i < j} width_i - B, so
  // dL/dwidth_i = total * (gxk [i < k] + gxk1 [i <= k]).
  float sw_lo = 0.0f, sw_k = 0.0f, sh_lo = 0.0f, sh_k = 0.0f;  // softmax mass of bins < k, bin k
  for (int i = 0; i <= k; ++i) {
    const float smw = expf(P[i] - s.max_w) / s.sum_w;
    const float smh = expf(P[K + i] - s.max_h) / s.sum_h;
    if (i < k) {
      sw_lo += smw;
      sh_lo += smh;
    } else {
      sw_k = smw;
      sh_k = smh;
    }
  }
  const float gw_lo = total * (gxk + gxk1), gw_k = total * gxk1;
  const float gh_lo = total * (gyk + gyk1), gh_k = total * gyk1;
  const float dot_w = p.scale_w * (gw_lo * sw_lo + gw_k * sw_k);
  const float dot_h = p.scale_h * (gh_lo * sh_lo + gh_k * sh_k);
  for (int i = 0; i < K; ++i) {
    const float smw = expf(P[i] - s.max_w) / s.sum_w;
    const float smh = expf(P[K + i] - s.max_h) / s.sum_h;
    const float gw = i < k ? gw_lo : (i == k ? gw_k : 0.0f);
    const float gh = i < k ? gh_lo : (i == k ? gh_k : 0.0f);
    P[i] = smw * (p.scale_w * gw - dot_w);
    P[K + i] = smh * (p.scale_h * gh - dot_h);
  }
  for (int m = 0; m < K - 1; ++m) {
    const float g = m == k - 1 ? g_dk : (m == k ? g_dk1 : 0.0f);
    P[2 * K + m] = g != 0.0f ? g * sigmoid(P[2 * K + m]) : 0.0f;
  }
  return dx;
}

__device__ __forceinline__ float clip7(float v) { return fminf(fmaxf(v, -7.0f), 7.0f); }

// log_det + base of the flow for one row; zs (optional) receives the input
// of each transform.
__device__ float flow_forward(const float* sp, const MnleParams& p, float t, float* zs) {
  const int S = 3 * p.K - 1;
  float z = t, ld = 0.0f;
  if (p.cond_affine) {
    const float mu = sp[p.T * S], ls = clip7(sp[p.T * S + 1]);
    z = (z - mu) * expf(-ls);
    ld -= ls;
  }
  for (int i = 0; i < p.T; ++i) {
    if (zs != nullptr) zs[i] = z;
    z = spline_fwd(sp + i * S, p, z, &ld);
  }
  return ld + (-kLogSqrt2Pi - 0.5f * z * z);
}

__global__ void __launch_bounds__(THREADS) mnle_logprob_fwd_kernel(
    MnleParams p, const float* __restrict__ t, const float* __restrict__ oh,
    const float* __restrict__ ctx, float* __restrict__ out, int N) {
  extern __shared__ float smem[];
  const int DC = p.D + p.C, H = p.H, L = p.n_layers;
  float* x0 = smem;
  float* buf[2] = {x0 + ROWS * DC, x0 + ROWS * DC + ROWS * H};
  float* logits = buf[1] + ROWS * H;
  float* sp = logits + ROWS * p.C;
  const int row0 = blockIdx.x * ROWS;
  load_rows(ctx, oh, x0, row0, N, p);

  // Categorical MLP on ctx = x0[:, :D].
  const float* in = x0;
  int in_ld = DC, in_w = p.D;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    float* o = last ? logits : buf[l % 2];
    const int ow = last ? p.C : H;
    dense(in, in_ld, in_w, p.cat_w[l], ow, p.cat_b[l], o, ow, ow, !last, nullptr, 0, false);
    in = o;
    in_ld = in_w = ow;
  }
  const int r = threadIdx.x;
  float cat_lp = 0.0f;
  if (r < ROWS) cat_lp = cat_logprob(logits + r * p.C, x0 + r * DC + p.D, p.C);

  // Flow trunk on [ctx, onehot], ReLU on every layer, then the head product.
  in = x0;
  in_ld = in_w = DC;
  for (int l = 0; l < L; ++l) {
    dense(in, in_ld, in_w, p.trunk_w[l], H, p.trunk_b[l], buf[l % 2], H, H, true, nullptr, 0, false);
    in = buf[l % 2];
    in_ld = in_w = H;
  }
  dense(in, H, H, p.head_w, p.HO, p.head_b, sp, p.HO, p.HO, false, nullptr, 0, false);

  const int row = row0 + r;
  if (r < ROWS && row < N) {
    float keep = 1.0f;
    if (p.censored_col >= 0) keep = 1.0f - x0[r * DC + p.D + p.censored_col];
    float lp = cat_lp;
    if (keep > 0.0f) lp += keep * flow_forward(sp + r * p.HO, p, t[row], nullptr);
    out[row] = lp;
  }
}

__global__ void __launch_bounds__(THREADS) mnle_logprob_bwd_kernel(
    MnleParams p, const float* __restrict__ t, const float* __restrict__ oh,
    const float* __restrict__ ctx, const float* __restrict__ g, float* __restrict__ dt,
    float* __restrict__ dctx, int N) {
  extern __shared__ float smem[];
  const int DC = p.D + p.C, H = p.H, L = p.n_layers, S = 3 * p.K - 1;
  float* x0 = smem;                        // ROWS x DC
  float* cat_act = x0 + ROWS * DC;         // (L-1) x ROWS x H
  float* trunk_act = cat_act + (L - 1) * ROWS * H;  // L x ROWS x H
  float* logits = trunk_act + L * ROWS * H;         // ROWS x C
  float* sp = logits + ROWS * p.C;                  // ROWS x HO
  float* gbuf[2] = {sp + ROWS * p.HO, sp + ROWS * p.HO + ROWS * H};
  float* dx0 = gbuf[1] + ROWS * H;                  // ROWS x D
  const int row0 = blockIdx.x * ROWS;
  load_rows(ctx, oh, x0, row0, N, p);

  // Forward, keeping every activation.
  const float* in = x0;
  int in_ld = DC, in_w = p.D;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    float* o = last ? logits : cat_act + l * ROWS * H;
    const int ow = last ? p.C : H;
    dense(in, in_ld, in_w, p.cat_w[l], ow, p.cat_b[l], o, ow, ow, !last, nullptr, 0, false);
    in = o;
    in_ld = in_w = ow;
  }
  in = x0;
  in_ld = in_w = DC;
  for (int l = 0; l < L; ++l) {
    float* o = trunk_act + l * ROWS * H;
    dense(in, in_ld, in_w, p.trunk_w[l], H, p.trunk_b[l], o, H, H, true, nullptr, 0, false);
    in = o;
    in_ld = in_w = H;
  }
  dense(in, H, H, p.head_w, p.HO, p.head_b, sp, p.HO, p.HO, false, nullptr, 0, false);

  // Per row: d logits (in place) and the flow backward (d head output in
  // place, dt to global memory).
  const int r = threadIdx.x, row = row0 + r;
  if (r < ROWS) {
    const float gr = row < N ? g[row] : 0.0f;
    const float* ohr = x0 + r * DC + p.D;
    cat_logprob_grad(logits + r * p.C, ohr, p.C, gr);

    float* spr = sp + r * p.HO;
    float keep = 1.0f;
    if (p.censored_col >= 0) keep = 1.0f - ohr[p.censored_col];
    const float gm = gr * keep;
    float dtr = 0.0f;
    if (keep > 0.0f && row < N) {
      const float tr = t[row];
      float zs[MAX_TRANSFORMS];
      float mu = 0.0f, ls_raw = 0.0f, e = 1.0f;
      if (p.cond_affine) {
        mu = spr[p.T * S];
        ls_raw = spr[p.T * S + 1];
        e = expf(-clip7(ls_raw));
      }
      float ld = 0.0f;
      float z = p.cond_affine ? (tr - mu) * e : tr;
      for (int i = 0; i < p.T; ++i) {
        zs[i] = z;
        z = spline_fwd(spr + i * S, p, z, &ld);
      }
      float gz = -gm * z;  // d base / dz
      for (int i = p.T - 1; i >= 0; --i) gz = spline_bwd(spr + i * S, p, zs[i], gz, gm);
      if (p.cond_affine) {
        dtr = gz * e;
        spr[p.T * S] = -gz * e;
        const float g_ls = -gz * (tr - mu) * e - gm;  // through exp(-ls) and log_det -= ls
        spr[p.T * S + 1] = (ls_raw > -7.0f && ls_raw < 7.0f) ? g_ls : 0.0f;
      } else {
        dtr = gz;
      }
    } else {
      for (int i = 0; i < p.HO; ++i) spr[i] = 0.0f;
    }
    if (row < N) dt[row] = dtr;
  }
  __syncthreads();

  // Trunk backward: d emb = d sp . head_w^T, masked by ReLU, down to d ctx.
  dense(sp, p.HO, p.HO, p.head_wt, H, nullptr, gbuf[0], H, H, false, trunk_act + (L - 1) * ROWS * H, H,
        false);
  int cur = 0;
  for (int l = L - 1; l >= 1; --l) {
    dense(gbuf[cur], H, H, p.trunk_wt[l], H, nullptr, gbuf[1 - cur], H, H, false,
          trunk_act + (l - 1) * ROWS * H, H, false);
    cur = 1 - cur;
  }
  dense(gbuf[cur], H, H, p.trunk_wt[0], DC, nullptr, dx0, p.D, p.D, false, nullptr, 0, false);

  // Categorical backward: d logits . W^T, masked by ReLU, added to d ctx.
  const float* gin = logits;
  int gin_w = p.C;
  cur = 0;
  for (int l = L - 1; l >= 1; --l) {
    dense(gin, gin_w, gin_w, p.cat_wt[l], H, nullptr, gbuf[cur], H, H, false,
          cat_act + (l - 1) * ROWS * H, H, false);
    gin = gbuf[cur];
    gin_w = H;
    cur = 1 - cur;
  }
  dense(gin, gin_w, gin_w, p.cat_wt[0], p.D, nullptr, dx0, p.D, p.D, false, nullptr, 0, true);

  for (int idx = threadIdx.x; idx < ROWS * p.D; idx += blockDim.x) {
    const int rr = idx / p.D, k = idx % p.D;
    if (row0 + rr < N) dctx[(size_t)(row0 + rr) * p.D + k] = dx0[idx];
  }
}

size_t fwd_smem_bytes(const MnleParams& p) {
  return sizeof(float) * (size_t)ROWS * (p.D + p.C + 2 * p.H + p.C + p.HO);
}

size_t bwd_smem_bytes(const MnleParams& p) {
  return sizeof(float) * (size_t)ROWS *
         (p.D + p.C + (2 * p.n_layers - 1) * p.H + p.C + p.HO + 2 * p.H + p.D);
}

}  // namespace

extern "C" {

const char* sdm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int sdm_mnle_logprob_fwd(const MnleParams* p, const float* t, const float* oh, const float* ctx,
                         float* out, int N, void* stream) {
  if (N <= 0) return 0;
  const size_t smem = fwd_smem_bytes(*p);
  cudaError_t err = cudaFuncSetAttribute(mnle_logprob_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + ROWS - 1) / ROWS;
  mnle_logprob_fwd_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(*p, t, oh, ctx, out, N);
  return (int)cudaGetLastError();
}

int sdm_mnle_logprob_bwd(const MnleParams* p, const float* t, const float* oh, const float* ctx,
                         const float* g, float* dt, float* dctx, int N, void* stream) {
  if (N <= 0) return 0;
  if (p->T > MAX_TRANSFORMS || p->n_layers > MAX_LAYERS || p->n_layers < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(*p);
  cudaError_t err = cudaFuncSetAttribute(mnle_logprob_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + ROWS - 1) / ROWS;
  mnle_logprob_bwd_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(*p, t, oh, ctx, g, dt,
                                                                           dctx, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
