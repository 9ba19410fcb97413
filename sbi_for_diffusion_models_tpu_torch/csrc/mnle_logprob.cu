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
// K3 recomputes that forward for a tile of rows, writes the value as K2
// does, and pulls a cotangent g back to dt (N) and dctx (N, D). It gives no
// weight gradients.
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
// Design, for the H100. (The first design of both kernels ran 16-row tiles
// on 128 threads: it left 57 of the 132 SMs without a block at the main
// path's 1,200 rows, kept one warp per scheduler with nothing to hide the
// weights' L2 latency, issued a shared-memory load per FMA and ran the
// per-row phase on 16 of 128 threads.)
// - Tiles of TILE_ROWS = 8 rows on 256 threads (150 blocks at 1,200 rows).
//   Every product runs through tile_dense (mnle_tile.cuh): weights staged
//   by cp.async, double-buffered, activations k-major, register
//   micro-tiles, one fixed summation order. The backward products multiply
//   by W^T and stage the (out, in) copies the wrapper packs, so their rows
//   are contiguous too.
// - K2 runs the forward products (K2Products: K3Products' first 2L + 1)
//   through two hidden buffers in turn: 66,656 B of shared memory at the
//   flagship's widths, three blocks an SM. K3 runs the same products first
//   and keeps every layer's activation (ReLU masks) for its backward:
//   89,856 B, two blocks an SM.
// - The per-row phase runs one warp per row, lane i on bin i (K <= 32): the
//   softmax max and normalizers by shuffles (the sums in double), the knots
//   by an inclusive warp scan in double rounded once each, the bin by a
//   ballot; the bin rule is that of the JAX masked lookup (z == knot[j+1]
//   falls in bin j+1, the top edge in bin K-1). One function, warp_row_logp,
//   computes a row's value from the tile's logits and head output, and K2
//   and K3 both call it on the same products' bits, so K3's value equals
//   K2's bit for bit: a gradient call launches K3 alone. K3 keeps each
//   transform's bin and input in the registers of lane `transform`, and its
//   softmax weights over the transform's width and height parameters, for
//   the backward, which overwrites the parameters with their gradients in
//   place; those flow back through the head, trunk and categorical
//   products. The chain over the transforms stays serial. (Finding every
//   transform's softmaxes and knots first, four at a time with their
//   shuffle chains interleaved, was slower on the H100.)
// - All arithmetic is FP32 (FMAs allowed; no TF32, no fast math), except the
//   softmax normalizers and the cumulative widths and heights behind the
//   knots, which are summed in double (mnle_warp.cuh).

#include "mnle_common.cuh"
#include "mnle_tile.cuh"
#include "mnle_warp.cuh"

namespace {


constexpr float kLogSqrt2Pi = 0.91893853320467274178f;

__device__ __forceinline__ float clip7(float v) { return fminf(fmaxf(v, -7.0f), 7.0f); }

// The bin of x (|x| <= B) for one row on one warp, lane i holding bin i
// (K <= 32). The spline's parameters are P[i * ld]. The softmax normalizers
// and the knots' running sums are taken in double (a butterfly and an
// inclusive scan), each knot rounded to float32 once; the bin is the first
// whose upper knot exceeds x (the JAX masked lookup: x == knot[j+1] falls in
// bin j+1, the top edge in bin K-1). Writes the softmax weights of the
// widths and heights over P[0, 2K), which K3's backward reads.
__device__ __forceinline__ Bin warp_find_bin(float* P, int ld, const MnleParams& p, float x, int lane) {
  const int K = p.K;
  const float B = p.tail_bound, total = 2.0f * p.tail_bound;
  const bool on = lane < K;
  const float pw = on ? P[lane * ld] : -INFINITY, ph = on ? P[(K + lane) * ld] : -INFINITY;
  const float max_w = warp_max(pw), max_h = warp_max(ph);
  const float ew = on ? expf(pw - max_w) : 0.0f, eh = on ? expf(ph - max_h) : 0.0f;
  const float sum_w = (float)warp_sum((double)ew), sum_h = (float)warp_sum((double)eh);
  const float sw = ew / sum_w, sh = eh / sum_h;
  if (on) {
    P[lane * ld] = sw;
    P[(K + lane) * ld] = sh;
  }
  const double wd = on ? (double)(p.min_w + p.scale_w * sw) : 0.0;
  const double hd = on ? (double)(p.min_h + p.scale_h * sh) : 0.0;
  const double cw = warp_inclusive_scan(wd, lane);
  const double ch = warp_inclusive_scan(hd, lane);
  // Upper knots of bin `lane`; the last one is B exactly.
  const float xu = lane == K - 1 ? B : (float)(cw * (double)total - (double)B);
  const float yu = lane == K - 1 ? B : (float)(ch * (double)total - (double)B);
  const unsigned below = __ballot_sync(kFull, lane < K - 1 && x < xu);
  Bin b;
  b.k = below != 0u ? __ffs(below) - 1 : K - 1;
  const int lo = max(b.k - 1, 0);
  const float xl = __shfl_sync(kFull, xu, lo), yl = __shfl_sync(kFull, yu, lo);
  b.xk = b.k == 0 ? -B : xl;
  b.yk = b.k == 0 ? -B : yl;
  b.xk1 = __shfl_sync(kFull, xu, b.k);
  b.yk1 = __shfl_sync(kFull, yu, b.k);
  b.dk = b.k == 0 ? 1.0f : p.min_d + softplus(P[(2 * K + b.k - 1) * ld]);
  b.dk1 = b.k == K - 1 ? 1.0f : p.min_d + softplus(P[(2 * K + b.k) * ld]);
  return b;
}

// The RQ spline in bin b: returns y, adds log|dy/dx| to *ld.
__device__ __forceinline__ float rq_forward(const Bin& b, float x, float* ld) {
  const float w = b.xk1 - b.xk, h = b.yk1 - b.yk, sl = h / w;
  const float xi = (x - b.xk) / w, xi1m = 1.0f - xi;
  const float num = h * (sl * xi * xi + b.dk * xi * xi1m);
  const float den = sl + (b.dk1 + b.dk - 2.0f * sl) * xi * xi1m;
  const float dnum = sl * sl * (b.dk1 * xi * xi + 2.0f * sl * xi * xi1m + b.dk * xi1m * xi1m);
  *ld += logf(dnum) - 2.0f * logf(den);
  return b.yk + num / den;
}

// What the forward of one row's flow leaves for K3's backward.
struct FlowState {
  float mu, ls_raw, e;  // the affine layer: mu, the raw log sigma, exp(-clip(log sigma, -7, 7))
  float z;              // the base's input
  Bin mine;             // transform `lane`'s bin (k = -1: identity tail) ...
  float mine_z;         // ... and input
};

// log_det + base of one row's flow on its warp, every lane with the same
// bits: the affine layer (cond_affine), then the T splines with identity
// tails, then the standard normal. The row's head output is spr[j *
// TILE_ROWS]; warp_find_bin writes each transform's softmax weights there.
__device__ __forceinline__ float warp_flow_forward(float* spr, const MnleParams& p, float t, FlowState& f, int lane) {
  constexpr int R = TILE_ROWS;
  const int S = 3 * p.K - 1;
  const float B = p.tail_bound;
  float z = t, ld = 0.0f;
  f.mu = 0.0f;
  f.ls_raw = 0.0f;
  f.e = 1.0f;
  if (p.cond_affine) {
    f.mu = spr[p.T * S * R];
    f.ls_raw = spr[(p.T * S + 1) * R];
    const float ls = clip7(f.ls_raw);
    f.e = expf(-ls);
    z = (z - f.mu) * f.e;
    ld -= ls;
  }
  f.mine.k = -1;
  f.mine_z = 0.0f;
  for (int i = 0; i < p.T; ++i) {
    Bin b;
    b.k = -1;
    const float zi = z;
    if (z >= -B && z <= B) {
      b = warp_find_bin(spr + i * S * R, R, p, z, lane);
      z = rq_forward(b, z, &ld);
    }
    if (lane == i) {
      f.mine = b;
      f.mine_z = zi;
    }
  }
  f.z = z;
  return ld + (-kLogSqrt2Pi - 0.5f * z * z);
}

// One row's log-prob on its warp from the tile's logits (lg[j * TILE_ROWS])
// and head output (spr): cat_lp + m (log_det + base), m = 1 - oh[censored],
// the flow skipped where m = 0. Lane 0 holds the value (it alone reads the
// logits). K2 and K3 both take a row's value from here.
__device__ __forceinline__ float warp_row_logp(const float* lg, const float* ohr, float* spr, const MnleParams& p,
                                               float t, FlowState& f, int lane) {
  const float cat_lp = lane == 0 ? cat_logprob_strided(lg, ohr, TILE_ROWS, p.C) : 0.0f;
  const float keep = keep_factor(ohr, p);
  float lp = cat_lp;
  if (keep > 0.0f) lp += keep * warp_flow_forward(spr, p, t, f, lane);
  return lp;
}

// Backward of one RQ spline on one warp at input x in bin b (from
// warp_find_bin, whose softmax weights are in P[0, 2K)), with upstream
// gradients gy (of y) and gl (of the log-det). Overwrites P[0, 3K-1) with
// dL/dP and returns dL/dx.
__device__ __forceinline__ float warp_spline_bwd(float* P, int ld, const MnleParams& p, const Bin& b, float x,
                                                 float gy, float gl, int lane) {
  const int K = p.K, k = b.k;
  const float total = 2.0f * p.tail_bound;
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
  // dL/dwidth_i = total * (gxk [i < k] + gxk1 [i <= k]), lane i's share.
  const float gw = lane < k ? total * (gxk + gxk1) : (lane == k ? total * gxk1 : 0.0f);
  const float gh = lane < k ? total * (gyk + gyk1) : (lane == k ? total * gyk1 : 0.0f);
  const bool on = lane < K;
  const float sw = on ? P[lane * ld] : 0.0f, sh = on ? P[(K + lane) * ld] : 0.0f;
  // Softmax VJP: d param_i = sm_i (scale g_i - scale sum_j g_j sm_j).
  const float dot_w = p.scale_w * (float)warp_sum((double)(gw * sw));
  const float dot_h = p.scale_h * (float)warp_sum((double)(gh * sh));
  if (on) {
    P[lane * ld] = sw * (p.scale_w * gw - dot_w);
    P[(K + lane) * ld] = sh * (p.scale_h * gh - dot_h);
  }
  if (lane < K - 1) {
    const float g = lane == k - 1 ? g_dk : (lane == k ? g_dk1 : 0.0f);
    float* d = P + (2 * K + lane) * ld;
    *d = g != 0.0f ? g * sigmoid(*d) : 0.0f;
  }
  return dx;
}

// K3's products in the order it runs them: the categorical MLP and the
// trunk, the head, the head and trunk transposed (the (out, in) copies the
// wrapper packs, down to the D context columns), the categorical MLP
// transposed. Each entry is one product whole: weights, bias and ReLU (the
// backward products have neither; their ReLU masks are the forward's
// activations, which the call passes).
struct K3Products {
  const MnleParams& p;
  __device__ int count() const { return 4 * p.n_layers + 2; }
  __device__ TileProduct operator()(int i) const {
    const int L = p.n_layers, H = p.H, DC = p.D + p.C;
    if (i < L) {
      const bool last = i == L - 1;
      return {p.cat_w[i], p.cat_b[i], last ? p.C : H, i == 0 ? p.D : H, last ? p.C : H, !last};
    }
    i -= L;
    if (i < L) return {p.trunk_w[i], p.trunk_b[i], H, i == 0 ? DC : H, H, true};
    i -= L;
    if (i == 0) return {p.head_w, p.head_b, p.head_ld, H, p.HO, false};
    if (i == 1) return {p.head_wt, nullptr, p.head_t_ld, p.HO, H, false};
    i -= 2;
    if (i < L) {
      const int l = L - 1 - i;
      return {p.trunk_wt[l], nullptr, l == 0 ? DC : H, H, l == 0 ? p.D : H, false};
    }
    const int l = L - 1 - (i - L);
    return {p.cat_wt[l], nullptr, l == 0 ? p.D : H, l == L - 1 ? p.C : H, l == 0 ? p.D : H, false};
  }
};

// K2's products: the forward, K3's first 2L + 1.
struct K2Products {
  const MnleParams& p;
  __device__ int count() const { return 2 * p.n_layers + 1; }
  __device__ TileProduct operator()(int i) const { return K3Products{p}(i); }
};

// ---------------------------------------------------------------------------
// K2: the forward products through two hidden buffers, then a warp per row.
// ---------------------------------------------------------------------------

size_t fwd_smem_bytes(const MnleParams& p) {
  return sizeof(float) * ((size_t)TILE_STAGES * TILE_WBUF + (size_t)TILE_ROWS * (p.D + p.C + 2 * p.H + p.C + p.HO));
}

__global__ void __launch_bounds__(TILE_THREADS, FWD_BLOCKS_PER_SM) mnle_logprob_fwd_kernel(
    const __grid_constant__ MnleParams p, const float* __restrict__ t, const float* __restrict__ oh,
    const float* __restrict__ ctx, float* __restrict__ out, int N) {
  extern __shared__ float4 smem4[];
  constexpr int R = TILE_ROWS;
  const int DC = p.D + p.C, H = p.H, L = p.n_layers;
  // Every array is k-major: element (k, r) at a[k * R + r].
  float* ws = reinterpret_cast<float*>(smem4);         // TILE_STAGES x TILE_WBUF weight staging
  float* x0 = ws + TILE_STAGES * TILE_WBUF;            // DC x R: [ctx | onehot]
  float* hid[2] = {x0 + DC * R, x0 + DC * R + H * R};  // H x R each, the hidden layers in turn
  float* logits = hid[1] + H * R;                      // C x R
  float* sp = logits + p.C * R;                        // HO x R
  const int row0 = blockIdx.x * R;
  WeightStream<K2Products> ws_stream(K2Products{p}, ws);  // starts loading the first products' weights
  load_tile_rows(ctx, p.D, oh, p.C, x0, row0, N);

  const float* in = x0;
  for (int l = 0; l < L; ++l) {
    float* o = l == L - 1 ? logits : hid[l % 2];
    tile_dense(ws_stream, in, o, nullptr, false);
    in = o;
  }
  in = x0;
  for (int l = 0; l < L; ++l) {
    tile_dense(ws_stream, in, hid[l % 2], nullptr, false);
    in = hid[l % 2];
  }
  tile_dense(ws_stream, in, sp, nullptr, false);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += TILE_THREADS / 32) {
    const int row = row0 + r;
    if (row >= N) continue;
    FlowState f;
    const float v = warp_row_logp(logits + r, x0 + p.D * R + r, sp + r, p, t[row], f, lane);
    if (lane == 0) out[row] = v;
  }
}

// ---------------------------------------------------------------------------
// K3: the same forward keeping every activation, the row's value, then the
// backward.
// ---------------------------------------------------------------------------

size_t bwd_smem_bytes(const MnleParams& p) {
  return sizeof(float) * ((size_t)TILE_STAGES * TILE_WBUF +
                          (size_t)TILE_ROWS * (p.D + p.C + (2 * p.n_layers - 1) * p.H + p.C + p.HO + 2 * p.H + p.D));
}

__global__ void __launch_bounds__(TILE_THREADS, 2) mnle_logprob_bwd_kernel(
    const __grid_constant__ MnleParams p, const float* __restrict__ t, const float* __restrict__ oh,
    const float* __restrict__ ctx, const float* __restrict__ g, float* __restrict__ out,
    float* __restrict__ dt, float* __restrict__ dctx, int N) {
  extern __shared__ float4 smem4[];
  constexpr int R = TILE_ROWS;
  const int DC = p.D + p.C, H = p.H, L = p.n_layers, S = 3 * p.K - 1;
  // Every array is k-major: element (k, r) at a[k * R + r].
  float* ws = reinterpret_cast<float*>(smem4);   // TILE_STAGES x TILE_WBUF weight staging
  float* x0 = ws + TILE_STAGES * TILE_WBUF;      // DC x R: [ctx | onehot]
  float* cat_act = x0 + DC * R;                  // (L-1) x H x R
  float* trunk_act = cat_act + (L - 1) * H * R;  // L x H x R
  float* logits = trunk_act + L * H * R;         // C x R
  float* sp = logits + p.C * R;                  // HO x R
  float* gbuf[2] = {sp + p.HO * R, sp + p.HO * R + H * R};
  float* dx0 = gbuf[1] + H * R;                  // D x R
  const int row0 = blockIdx.x * R;
  WeightStream<K3Products> ws_stream(K3Products{p}, ws);  // starts loading the first products' weights
  load_tile_rows(ctx, p.D, oh, p.C, x0, row0, N);

  // Forward, keeping every activation.
  const float* in = x0;
  for (int l = 0; l < L; ++l) {
    float* o = l == L - 1 ? logits : cat_act + l * H * R;
    tile_dense(ws_stream, in, o, nullptr, false);
    in = o;
  }
  in = x0;
  for (int l = 0; l < L; ++l) {
    float* o = trunk_act + l * H * R;
    tile_dense(ws_stream, in, o, nullptr, false);
    in = o;
  }
  tile_dense(ws_stream, in, sp, nullptr, false);
  __syncthreads();

  // Per row, one warp: the value (as K2 writes it), then d logits (in
  // place) and the flow backward (d head output in place, dt to global
  // memory). Lane i holds bin i of each spline, and lane j keeps transform
  // j's bin and input between the forward and the backward; the chain over
  // the transforms stays serial.
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += TILE_THREADS / 32) {
    const int row = row0 + r;
    const float* ohr = x0 + p.D * R + r;
    float* spr = sp + r;
    FlowState f;
    if (row < N) {
      const float lp = warp_row_logp(logits + r, ohr, spr, p, t[row], f, lane);
      if (lane == 0) out[row] = lp;
    }
    const float gr = row < N ? g[row] : 0.0f;
    if (lane == 0) cat_grad_strided(logits + r, ohr, R, p.C, gr);
    const float keep = keep_factor(ohr, p);
    const float gm = gr * keep;
    float dtr = 0.0f;
    if (keep > 0.0f && row < N) {
      float gz = -gm * f.z;  // d base / dz
      for (int i = p.T - 1; i >= 0; --i) {
        float* P = spr + i * S * R;
        const Bin b = shfl_bin(f.mine, i);
        const float zi = __shfl_sync(kFull, f.mine_z, i);
        if (b.k < 0) {
          for (int j = lane; j < S; j += 32) P[j * R] = 0.0f;
        } else {
          gz = warp_spline_bwd(P, R, p, b, zi, gz, gm, lane);
        }
      }
      if (p.cond_affine) {
        dtr = gz * f.e;
        if (lane == 0) {
          spr[p.T * S * R] = -gz * f.e;
          const float g_ls = -gz * (t[row] - f.mu) * f.e - gm;  // through exp(-ls) and log_det -= ls
          spr[(p.T * S + 1) * R] = (f.ls_raw > -7.0f && f.ls_raw < 7.0f) ? g_ls : 0.0f;
        }
      } else {
        dtr = gz;
      }
    } else {
      for (int i = lane; i < p.HO; i += 32) spr[i * R] = 0.0f;
    }
    if (lane == 0 && row < N) dt[row] = dtr;
  }

  // Trunk backward: d emb = d sp . head_w^T, masked by ReLU, down to d ctx.
  tile_dense(ws_stream, sp, gbuf[0], trunk_act + (L - 1) * H * R, false);
  int cur = 0;
  for (int l = L - 1; l >= 1; --l) {
    tile_dense(ws_stream, gbuf[cur], gbuf[1 - cur], trunk_act + (l - 1) * H * R, false);
    cur = 1 - cur;
  }
  tile_dense(ws_stream, gbuf[cur], dx0, nullptr, false);

  // Categorical backward: d logits . W^T, masked by ReLU, added to d ctx.
  const float* gin = logits;
  cur = 0;
  for (int l = L - 1; l >= 1; --l) {
    tile_dense(ws_stream, gin, gbuf[cur], cat_act + (l - 1) * H * R, false);
    gin = gbuf[cur];
    cur = 1 - cur;
  }
  tile_dense(ws_stream, gin, dx0, nullptr, true);
  __syncthreads();

  for (int idx = threadIdx.x; idx < R * p.D; idx += TILE_THREADS) {
    const int r = idx / p.D, k = idx % p.D;
    if (row0 + r < N) dctx[(size_t)(row0 + r) * p.D + k] = dx0[k * R + r];
  }
}

// One bin per lane of a warp; the head's leading dimensions cover its columns.
bool params_ok(const MnleParams* p) {
  return p->T <= MAX_TRANSFORMS && p->n_layers >= 1 && p->n_layers <= MAX_LAYERS && p->K >= 2 && p->K <= 32 &&
         p->head_ld >= p->HO && p->head_t_ld >= p->H;
}

}  // namespace

extern "C" {

const char* sdm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int sdm_mnle_logprob_fwd(const MnleParams* p, const float* t, const float* oh, const float* ctx,
                         float* out, int N, void* stream) {
  if (N <= 0) return 0;
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(*p);
  cudaError_t err = cudaFuncSetAttribute(mnle_logprob_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + TILE_ROWS - 1) / TILE_ROWS;
  mnle_logprob_fwd_kernel<<<blocks, TILE_THREADS, smem, (cudaStream_t)stream>>>(*p, t, oh, ctx, out, N);
  return (int)cudaGetLastError();
}

int sdm_mnle_logprob_bwd(const MnleParams* p, const float* t, const float* oh, const float* ctx,
                         const float* g, float* out, float* dt, float* dctx, int N, void* stream) {
  if (N <= 0) return 0;
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(*p);
  cudaError_t err = cudaFuncSetAttribute(mnle_logprob_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + TILE_ROWS - 1) / TILE_ROWS;
  mnle_logprob_bwd_kernel<<<blocks, TILE_THREADS, smem, (cudaStream_t)stream>>>(*p, t, oh, ctx, g, out, dt,
                                                                                  dctx, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
