// K2p and K3p: the fused MNLE log-prob of the pulse-grid RT representation
// (absolute anchor) and its recompute-VJP backward.
//
// Replace the Pallas TPU kernels of
// sbi_for_diffusion_models_tpu/ops/mnle_pallas.py run with the row function
// _rows_logp_pulse (make_fused_logprob: _fwd_kernel, pallas_call at :333, and
// _bwd_kernel, pallas_call at :361). Per row, with phase phi, choice one-hot
// oh (C), context ctx (D), flow-head features kf (F = 3: normalized slot,
// sin and cos of t_nd's grid phase) and slot index kv (a float):
//   categorical MLP D -> H -> ... -> C, log-softmax, picked by oh;
//   trunk MLP [ctx, oh] -> H -> ... -> H, ReLU on every layer (emb);
//   slot head emb -> NS logits, log-softmax, picked at int(kv) (0 when
//   int(kv) is outside [0, NS));
//   one head matmul [emb, kf] -> HO = T*(3K+1): T circular spline blocks;
//   z = phi, then T circular RQ splines on [0, 1): z <- f(clip((z - rot)
//   mod 1, 0, 1 - 1e-6)) with the bin position xi clipped to [0, 1], and a
//   uniform base (log p = 0);
//   out = cat_lp + m (slot_lp + log_det), m = 1 - oh[censored] (rows with
//   m = 0 skip the rest and take cat_lp alone).
// K3p recomputes that forward for a tile of rows and pulls a cotangent g back
// to dphi (N), dctx (N, D) and dkf (N, F). It gives no weight gradients.
//
// What bounds them on the card: the matrix products. A row costs
// 2*(D*H + H*H + H*C + (D+C)*H + 2*H*H + H*NS + (H+F)*HO) = 0.355 MFLOP
// forward (D = 85, H = 128, NS = 80, HO = 730) and as much again backward
// (input gradients only), against about 380 bytes of row input and 0.71 MB
// of weights read once: the compute bound exceeds the memory bound at every
// row count, so the limit is the rate of FP32 FMAs (no tensor cores: the
// JAX kernel runs its products at Precision.HIGHEST) and, at the main
// path's 1,200 rows (75 tiles), how many SMs have work at all. At the
// H100's 67 TFLOP/s FP32 peak the bound is 0.0064 ms (K2p) and 0.0127 ms
// (K3p) for 1,200 rows, 0.611 ms and 1.220 ms for 115,200 rows
// (chip_smoke.py's mnle_bound). The design below accepts 75 busy SMs of
// 132 at 1,200 rows for now.
//
// Design, simple first (the structure of K2/K3, mnle_common.cuh):
// - One block of 128 threads per tile of ROWS = 16 rows, activations in
//   shared memory, thread j computes output unit j of a product for all 16
//   rows. The trunk output is stored with a leading dimension of H + F and
//   kf is written into its last F columns, so the head product reads
//   [emb, kf] as one (16, H + F) operand.
// - The per-row work (the two log-softmaxes, the spline chain and their
//   derivatives) runs one thread per row. A circular spline finds its bin by
//   walking the cumulative widths once (knots are not stored); z == knot[j+1]
//   falls in bin j+1, the top edge in bin K-1, as in the JAX masked lookup.
// - The mod is floor-mod (x - floorf(x), never fmodf): its gradient is 1
//   w.r.t. z and -1 w.r.t. the rotation. Each clip passes the gradient
//   inside its bounds, none outside, and half of it where the value equals a
//   bound, the rule of jnp.clip (maximum, then minimum) and of the plain
//   version's clip.
// - K3p overwrites each transform's parameters with their gradients in place
//   (through softmax widths and heights, their cumulative sums, softplus
//   derivatives with the shared d_K = d_0, which takes gradient from either
//   end, and the sigmoid rotation) and the slot logits with theirs. Then
//   d emb = d sp . head_w[:H]^T + d slot . slot_w^T (ReLU-masked) flows back
//   through the trunk and d kf = d sp . head_w[H:]^T is read from the
//   transposed head copy's last F columns. Shared memory: ~121 KB per block
//   at the full widths (the head output is 16 x 730 floats), so one block
//   per SM; the forward takes ~82 KB.
// - Censored rows skip the flow and the slot head with a branch, not a
//   product, so a non-finite term there never reaches the value or the
//   gradient.
// - All arithmetic is FP32 (FMAs allowed; no TF32, no fast math), except the
//   softmax normalizers and the cumulative widths and heights behind the
//   knots, which are summed in double (mnle_common.cuh, softmax_stats).

#include "mnle_common.cuh"

namespace {

constexpr float kPhaseHi = 0.999999f;  // 1 - 1e-6, the top of the phase clip

// d clip(x, lo, hi) / dx: 1 inside, 1/2 on a bound, 0 outside.
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  return (x > lo && x < hi) ? 1.0f : ((x == lo || x == hi) ? 0.5f : 0.0f);
}

// The circular bin of z in [0, 1) and its knots/derivatives: knots are
// [0, cumsum(widths)[:K-1], 1], derivatives d_0 .. d_{K-1}, d_K = d_0. The
// cumulative sums run in double and each knot is rounded to float32 once
// (see softmax_stats).
__device__ __forceinline__ Bin find_circular_bin(const float* P, const MnleParams& p,
                                                 const SoftmaxStats& s, float z) {
  const int K = p.K;
  double cw = 0.0, ch = 0.0;
  Bin b;
  b.xk = 0.0f;
  b.yk = 0.0f;
  b.k = K - 1;
  for (int j = 0; j < K; ++j) {
    cw += p.min_w + p.scale_w * (expf(P[j] - s.max_w) / s.sum_w);
    ch += p.min_h + p.scale_h * (expf(P[K + j] - s.max_h) / s.sum_h);
    const bool last = j == K - 1;
    const float xk1 = last ? 1.0f : (float)cw;
    const float yk1 = last ? 1.0f : (float)ch;
    if (last || z < xk1) {
      b.k = j;
      b.xk1 = xk1;
      b.yk1 = yk1;
      break;
    }
    b.xk = xk1;
    b.yk = yk1;
  }
  b.dk = p.min_d + softplus(P[2 * K + b.k]);
  b.dk1 = p.min_d + softplus(P[2 * K + (b.k + 1) % K]);
  return b;
}

// The rotated, clipped phase a spline bins: clip((x - rot) mod 1, 0, 1 - 1e-6).
struct Phase {
  float rot, m, z;
};

__device__ __forceinline__ Phase rotate(const float* P, int K, float x) {
  Phase ph;
  ph.rot = sigmoid(P[3 * K]);
  const float a = x - ph.rot;
  ph.m = a - floorf(a);
  ph.z = fminf(fmaxf(ph.m, 0.0f), kPhaseHi);
  return ph;
}

// Forward circular RQ spline: returns y, adds log|dy/dx| to *ld.
__device__ float circular_fwd(const float* P, const MnleParams& p, float x, float* ld) {
  const SoftmaxStats s = softmax_stats(P, p.K);
  const Phase ph = rotate(P, p.K, x);
  const Bin b = find_circular_bin(P, p, s, ph.z);
  const float w = b.xk1 - b.xk, h = b.yk1 - b.yk, sl = h / w;
  const float xi = fminf(fmaxf((ph.z - b.xk) / w, 0.0f), 1.0f), xi1m = 1.0f - xi;
  const float num = h * (sl * xi * xi + b.dk * xi * xi1m);
  const float den = sl + (b.dk1 + b.dk - 2.0f * sl) * xi * xi1m;
  const float dnum = sl * sl * (b.dk1 * xi * xi + 2.0f * sl * xi * xi1m + b.dk * xi1m * xi1m);
  *ld += logf(dnum) - 2.0f * logf(den);
  return b.yk + num / den;
}

// Backward circular RQ spline at input x with upstream gradients gy (of y)
// and gl (of the log-det). Overwrites P[0, 3K+1) with dL/dP, returns dL/dx.
__device__ float circular_bwd(float* P, const MnleParams& p, float x, float gy, float gl) {
  const int K = p.K;
  const SoftmaxStats s = softmax_stats(P, K);
  const Phase ph = rotate(P, K, x);
  const Bin b = find_circular_bin(P, p, s, ph.z);
  const int k = b.k;
  const float w = b.xk1 - b.xk, h = b.yk1 - b.yk, sl = h / w;
  const float xr = (ph.z - b.xk) / w;
  const float xi = fminf(fmaxf(xr, 0.0f), 1.0f), xi1m = 1.0f - xi, q = xi * xi1m;
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
  const float g_xr = g_xi * clip_grad(xr, 0.0f, 1.0f);  // through the clip of xi
  // d/dslope (y and log-det through s, A and den)
  const float g_s = gy * h * (xi * xi * den - nn * (1.0f - 2.0f * q)) / den2 +
                    gl * (2.0f / sl + 2.0f * q / A - 2.0f * (1.0f - 2.0f * q) / den);
  // d/d derivatives at the bin edges
  const float g_dk = gy * h * q * (den - nn) / den2 + gl * (xi1m * xi1m / A - 2.0f * q / den);
  const float g_dk1 = -gy * h * nn * q / den2 + gl * (xi * xi / A - 2.0f * q / den);
  // bin height h (directly and through s = h / w), bin width w (s and xr)
  const float g_h = gy * nn / den + g_s / w;
  const float g_w = -g_s * sl / w - g_xr * xr / w;
  const float g_z = g_xr / w;
  // Knot gradients; the end knots (0 and 1) are constants.
  const float gxk = k > 0 ? -g_xr / w - g_w : 0.0f;
  const float gxk1 = k + 1 < K ? g_w : 0.0f;
  const float gyk = k > 0 ? gy - g_h : 0.0f;
  const float gyk1 = k + 1 < K ? g_h : 0.0f;
  // knot j (0 < j < K) = sum_{i < j} width_i, so
  // dL/dwidth_i = gxk [i < k] + gxk1 [i <= k].
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
  const float gw_lo = gxk + gxk1, gw_k = gxk1;
  const float gh_lo = gyk + gyk1, gh_k = gyk1;
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
  // Derivatives d_m = min_d + softplus(raw_m); bin k uses d_k and d_{(k+1) mod K}.
  const int k1 = (k + 1) % K;
  for (int m = 0; m < K; ++m) {
    const float g = (m == k ? g_dk : 0.0f) + (m == k1 ? g_dk1 : 0.0f);
    P[2 * K + m] = g != 0.0f ? g * sigmoid(P[2 * K + m]) : 0.0f;
  }
  // Through the phase clip and the floor-mod: d/dx = 1, d/drot = -1.
  const float g_m = g_z * clip_grad(ph.m, 0.0f, kPhaseHi);
  P[3 * K] = -g_m * ph.rot * (1.0f - ph.rot);
  return g_m;
}

// The slot head's log-probability of slot int(kv) (0 outside [0, NS)).
__device__ float slot_logprob(const float* sl, int NS, float kv) {
  const int ki = (int)kv;
  if (!(ki >= 0 && ki < NS)) return 0.0f;
  float mx = -INFINITY;
  for (int j = 0; j < NS; ++j) mx = fmaxf(mx, sl[j]);
  float se = 0.0f;
  for (int j = 0; j < NS; ++j) se += expf(sl[j] - mx);
  return sl[ki] - mx - logf(se);
}

// Cotangent gm of slot_logprob pulled back to the logits, in place.
__device__ void slot_logprob_grad(float* sl, int NS, float kv, float gm) {
  const int ki = (int)kv;
  if (!(ki >= 0 && ki < NS)) {
    for (int j = 0; j < NS; ++j) sl[j] = 0.0f;
    return;
  }
  float mx = -INFINITY;
  for (int j = 0; j < NS; ++j) mx = fmaxf(mx, sl[j]);
  float se = 0.0f;
  for (int j = 0; j < NS; ++j) se += expf(sl[j] - mx);
  for (int j = 0; j < NS; ++j) sl[j] = gm * ((j == ki ? 1.0f : 0.0f) - expf(sl[j] - mx) / se);
}

// Writes kf of the tile's rows into columns [H, H + F) of emb (leading
// dimension H + F), zeros past the last row.
__device__ void load_features(const float* __restrict__ kf, float* emb, int row0, int N,
                              const MnleParams& p) {
  const int HF = p.H + p.F;
  for (int idx = threadIdx.x; idx < ROWS * p.F; idx += blockDim.x) {
    const int r = idx / p.F, f = idx % p.F, row = row0 + r;
    emb[r * HF + p.H + f] = row < N ? kf[(size_t)row * p.F + f] : 0.0f;
  }
  __syncthreads();
}

// Forward products of the tile: categorical logits, the trunk into emb
// (leading dimension H + F, kf in the last F columns), the slot logits and
// the head output. Hidden layer l of each MLP goes to slot l % slots of
// `cat_act`/`trunk_act` (ROWS x H each): slots = 2 alternates two buffers,
// slots >= n_layers - 1 keeps every activation for the backward.
__device__ void forward_products(const MnleParams& p, const float* x0, float* cat_act, float* trunk_act,
                                 int slots, float* emb, float* logits, float* slot, float* sp,
                                 const float* __restrict__ kf, int row0, int N) {
  const int DC = p.D + p.C, H = p.H, L = p.n_layers, HF = p.H + p.F;
  const float* in = x0;
  int in_ld = DC, in_w = p.D;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    float* o = last ? logits : cat_act + (l % slots) * ROWS * H;
    const int ow = last ? p.C : H;
    dense(in, in_ld, in_w, p.cat_w[l], ow, p.cat_b[l], o, ow, ow, !last, nullptr, 0, false);
    in = o;
    in_ld = in_w = ow;
  }
  in = x0;
  in_ld = in_w = DC;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    float* o = last ? emb : trunk_act + (l % slots) * ROWS * H;
    dense(in, in_ld, in_w, p.trunk_w[l], H, p.trunk_b[l], o, last ? HF : H, H, true, nullptr, 0, false);
    in = o;
    in_ld = in_w = H;
  }
  load_features(kf, emb, row0, N, p);
  dense(emb, HF, H, p.slot_w, p.NS, p.slot_b, slot, p.NS, p.NS, false, nullptr, 0, false);
  dense(emb, HF, HF, p.head_w, p.HO, p.head_b, sp, p.HO, p.HO, false, nullptr, 0, false);
}

__device__ __forceinline__ float keep_factor(const float* ohr, const MnleParams& p) {
  return p.censored_col >= 0 ? 1.0f - ohr[p.censored_col] : 1.0f;
}

__global__ void __launch_bounds__(THREADS) mnle_pulse_fwd_kernel(
    MnleParams p, const float* __restrict__ phi, const float* __restrict__ oh,
    const float* __restrict__ ctx, const float* __restrict__ kf, const float* __restrict__ kv,
    float* __restrict__ out, int N) {
  extern __shared__ float smem[];
  const int DC = p.D + p.C, H = p.H, S = 3 * p.K + 1;
  float* x0 = smem;                        // ROWS x DC
  float* hid = x0 + ROWS * DC;             // 2 x ROWS x H, ping-pong hidden layers
  float* emb = hid + 2 * ROWS * H;         // ROWS x (H + F)
  float* logits = emb + ROWS * (H + p.F);  // ROWS x C
  float* slot = logits + ROWS * p.C;       // ROWS x NS
  float* sp = slot + ROWS * p.NS;          // ROWS x HO
  const int row0 = blockIdx.x * ROWS;
  load_rows(ctx, oh, x0, row0, N, p);
  forward_products(p, x0, hid, hid, 2, emb, logits, slot, sp, kf, row0, N);

  const int r = threadIdx.x, row = row0 + r;
  if (r < ROWS && row < N) {
    const float* ohr = x0 + r * DC + p.D;
    const float keep = keep_factor(ohr, p);
    float lp = cat_logprob(logits + r * p.C, ohr, p.C);
    if (keep > 0.0f) {
      float z = phi[row], ld = 0.0f;
      const float* spr = sp + r * p.HO;
      for (int i = 0; i < p.T; ++i) z = circular_fwd(spr + i * S, p, z, &ld);
      lp += keep * (slot_logprob(slot + r * p.NS, p.NS, kv[row]) + ld);
    }
    out[row] = lp;
  }
}

__global__ void __launch_bounds__(THREADS) mnle_pulse_bwd_kernel(
    MnleParams p, const float* __restrict__ phi, const float* __restrict__ oh,
    const float* __restrict__ ctx, const float* __restrict__ kf, const float* __restrict__ kv,
    const float* __restrict__ g, float* __restrict__ dphi, float* __restrict__ dctx,
    float* __restrict__ dkf, int N) {
  extern __shared__ float smem[];
  const int DC = p.D + p.C, H = p.H, L = p.n_layers, S = 3 * p.K + 1, HF = p.H + p.F;
  float* x0 = smem;                                  // ROWS x DC
  float* cat_act = x0 + ROWS * DC;                   // (L-1) x ROWS x H
  float* trunk_act = cat_act + (L - 1) * ROWS * H;   // (L-1) x ROWS x H
  float* emb = trunk_act + (L - 1) * ROWS * H;       // ROWS x (H + F)
  float* logits = emb + ROWS * HF;                   // ROWS x C
  float* slot = logits + ROWS * p.C;                 // ROWS x NS
  float* sp = slot + ROWS * p.NS;                    // ROWS x HO
  float* gbuf[2] = {sp + ROWS * p.HO, sp + ROWS * p.HO + ROWS * H};
  float* dkf_s = gbuf[1] + ROWS * H;                 // ROWS x F
  float* dx0 = dkf_s + ROWS * p.F;                   // ROWS x D
  const int row0 = blockIdx.x * ROWS;
  load_rows(ctx, oh, x0, row0, N, p);
  forward_products(p, x0, cat_act, trunk_act, max(L - 1, 1), emb, logits, slot, sp, kf, row0, N);

  // Per row: d logits and d slot logits (in place), the flow backward (d
  // head output in place) and dphi to global memory.
  const int r = threadIdx.x, row = row0 + r;
  if (r < ROWS) {
    const float gr = row < N ? g[row] : 0.0f;
    const float* ohr = x0 + r * DC + p.D;
    cat_logprob_grad(logits + r * p.C, ohr, p.C, gr);
    float* spr = sp + r * p.HO;
    float* slr = slot + r * p.NS;
    const float keep = keep_factor(ohr, p);
    float dz = 0.0f;
    if (keep > 0.0f && row < N) {
      const float gm = gr * keep;
      slot_logprob_grad(slr, p.NS, kv[row], gm);
      float zs[MAX_TRANSFORMS];
      float z = phi[row], ld = 0.0f;
      for (int i = 0; i < p.T; ++i) {
        zs[i] = z;
        z = circular_fwd(spr + i * S, p, z, &ld);
      }
      // Uniform base: the last z carries no gradient; each log-det gets gm.
      for (int i = p.T - 1; i >= 0; --i) dz = circular_bwd(spr + i * S, p, zs[i], dz, gm);
    } else {
      for (int j = 0; j < p.NS; ++j) slr[j] = 0.0f;
      for (int i = 0; i < p.HO; ++i) spr[i] = 0.0f;
    }
    if (row < N) dphi[row] = dz;
  }
  __syncthreads();

  // d emb = d sp . head_w[:H]^T + d slot . slot_w^T, masked by the ReLU;
  // d kf = d sp . head_w[H:]^T (the last F columns of the transposed copy).
  dense(sp, p.HO, p.HO, p.head_wt, HF, nullptr, gbuf[0], H, H, false, emb, HF, false);
  dense(slot, p.NS, p.NS, p.slot_wt, H, nullptr, gbuf[0], H, H, false, emb, HF, true);
  dense(sp, p.HO, p.HO, p.head_wt + H, HF, nullptr, dkf_s, p.F, p.F, false, nullptr, 0, false);

  // Trunk backward down to d ctx.
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
  for (int idx = threadIdx.x; idx < ROWS * p.F; idx += blockDim.x) {
    const int rr = idx / p.F, f = idx % p.F;
    if (row0 + rr < N) dkf[(size_t)(row0 + rr) * p.F + f] = dkf_s[idx];
  }
}

size_t fwd_smem_bytes(const MnleParams& p) {
  return sizeof(float) * (size_t)ROWS * (p.D + p.C + 2 * p.H + p.H + p.F + p.C + p.NS + p.HO);
}

size_t bwd_smem_bytes(const MnleParams& p) {
  return sizeof(float) * (size_t)ROWS *
         (p.D + p.C + 2 * (p.n_layers - 1) * p.H + p.H + p.F + p.C + p.NS + p.HO + 2 * p.H + p.F + p.D);
}

bool params_ok(const MnleParams* p) {
  return p->T <= MAX_TRANSFORMS && p->n_layers >= 1 && p->n_layers <= MAX_LAYERS && p->K >= 1 &&
         p->NS >= 1 && p->F >= 0 && p->HO == p->T * (3 * p->K + 1);
}

}  // namespace

extern "C" {

const char* sdm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int sdm_mnle_pulse_fwd(const MnleParams* p, const float* phi, const float* oh, const float* ctx,
                       const float* kf, const float* kv, float* out, int N, void* stream) {
  if (N <= 0) return 0;
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(*p);
  cudaError_t err = cudaFuncSetAttribute(mnle_pulse_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + ROWS - 1) / ROWS;
  mnle_pulse_fwd_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(*p, phi, oh, ctx, kf, kv,
                                                                         out, N);
  return (int)cudaGetLastError();
}

int sdm_mnle_pulse_bwd(const MnleParams* p, const float* phi, const float* oh, const float* ctx,
                       const float* kf, const float* kv, const float* g, float* dphi, float* dctx,
                       float* dkf, int N, void* stream) {
  if (N <= 0) return 0;
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(*p);
  cudaError_t err = cudaFuncSetAttribute(mnle_pulse_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + ROWS - 1) / ROWS;
  mnle_pulse_bwd_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(*p, phi, oh, ctx, kf, kv,
                                                                         g, dphi, dctx, dkf, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
