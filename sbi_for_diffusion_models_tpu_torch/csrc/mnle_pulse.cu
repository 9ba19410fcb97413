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
// K3p recomputes that forward for a tile of rows, writes the value as K2p
// does, and pulls a cotangent g back to dphi (N), dctx (N, D) and dkf (N,
// F). It gives no weight gradients.
//
// What bounds them on the card: the matrix products. A row costs
// 2*(D*H + H*H + H*C + (D+C)*H + 2*H*H + H*NS + (H+F)*HO) = 0.355 MFLOP
// forward (D = 85, H = 128, NS = 80, HO = 730) and as much again backward
// (input gradients only), against about 380 bytes of row input and 0.71 MB
// of weights read once: the compute bound exceeds the memory bound at every
// row count, so the limit is the rate of FP32 FMAs (no tensor cores: the
// JAX kernel runs its products at Precision.HIGHEST) and, at the main
// path's 1,200 rows, how many SMs have work at all. At the H100's 67
// TFLOP/s FP32 peak the bound is 0.0064 ms (K2p) and 0.0127 ms (K3p) for
// 1,200 rows, 0.611 ms and 1.220 ms for 115,200 rows (chip_smoke.py's
// mnle_bound).
//
// Design, for the H100. (The first design of both kernels ran 16-row tiles
// on 128 threads, thread j computing output unit j for all 16 rows, the
// per-row phase one thread per row: 75 of the 132 SMs had a block at 1,200
// rows; split on the card, K3p in that design was 38.8 % per-row phase,
// 30.4 % backward products.)
// - Tiles of TILE_ROWS = 8 rows on 256 threads (150 blocks at 1,200 rows).
//   Every product runs through tile_dense (mnle_tile.cuh): weights staged
//   by cp.async, double-buffered, activations k-major, register
//   micro-tiles, one fixed summation order. kf's F columns sit right after
//   the trunk's last activation, so [emb; kf] is one (H + F) x 8 operand of
//   the head and the slot head reads its first H rows. The head's weights
//   come in copies whose rows are padded to a multiple of 4 floats (head_ld
//   = 732, head_t_ld = 132) so that they take 16-byte copies; the padding is
//   never read into an output.
// - K2p runs the forward products (K2pProducts: K3pProducts' first 2L + 2)
//   through two hidden buffers in turn, the trunk's last layer landing in
//   the one kf follows: 69,888 B of shared memory at the pulse model's
//   widths, three blocks an SM. K3p keeps every activation for its
//   backward: 93,184 B, two blocks an SM.
// - The per-row phase runs one warp per row, lane i on bin i (K <= 32):
//   softmax max and normalizers by shuffles (summed in double), the knots
//   by an inclusive warp scan in double rounded once each, the bin by a
//   ballot (z == knot[j+1] falls in bin j+1, the top edge in bin K-1, as in
//   the JAX masked lookup), the slot head's log-softmax on the warp, three
//   logits a lane. One function, warp_pulse_row_logp, computes a row's
//   value, and K2p and K3p both call it on the same products' bits, so
//   K3p's value equals K2p's bit for bit: a gradient call launches K3p
//   alone. K3p keeps each transform's bin, input and rotation in lane
//   `transform`'s registers for the backward, and its softmax weights over
//   its width and height parameters; the softmax VJP is one double shuffle
//   reduction, and d kf runs on the warps too (warp_dkf: as a product of
//   the list, 3 columns over 730 inputs, it took 19 % of the kernel).
// - The circular rules are those of the plain version: knots [0,
//   cumsum(w)[:K-1], 1], derivatives d_0 .. d_{K-1} with d_K = d_0 (bin
//   K-1's right edge sends its gradient to lane 0's parameter), the
//   rotation sigmoid(P[3K]), the floor-mod (x - floorf(x), never fmodf) with
//   gradient +1 for z and -1 for the rotation, the clips of the phase to
//   [0, 1 - 1e-6] and of xi to [0, 1] with jnp.clip's gradient (all inside,
//   half on a bound, none outside). Censored rows skip the flow and the
//   slot head with a branch, not a product, so a non-finite term there
//   never reaches the value.
// - All arithmetic is FP32 (FMAs allowed; no TF32, no fast math), except the
//   softmax normalizers and the cumulative widths and heights behind the
//   knots, which are summed in double (mnle_warp.cuh).

#include "mnle_common.cuh"
#include "mnle_tile.cuh"
#include "mnle_warp.cuh"

namespace {

constexpr float kPhaseHi = 0.999999f;  // 1 - 1e-6, the top of the phase clip

// d clip(x, lo, hi) / dx: 1 inside, 1/2 on a bound, 0 outside.
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  return (x > lo && x < hi) ? 1.0f : ((x == lo || x == hi) ? 0.5f : 0.0f);
}

// The phase a circular spline bins: m = (x - rot) mod 1 (floor-mod) and
// zc = clip(m, 0, 1 - 1e-6).
__device__ __forceinline__ void circular_phase(float x, float rot, float* m, float* zc) {
  const float a = x - rot;
  *m = a - floorf(a);
  *zc = fminf(fmaxf(*m, 0.0f), kPhaseHi);
}

// The circular bin of z in [0, 1) for one row on one warp, lane i holding
// bin i (K <= 32). The spline's parameters are P[i * ld]. The softmax
// normalizers and the knots' running sums are taken in double (a butterfly
// and an inclusive scan), each knot rounded to float32 once; the knots are
// [0, cumsum(widths)[:K-1], 1], the derivatives d_0 .. d_{K-1}, d_K = d_0.
// The bin is the first whose upper knot exceeds z (z == knot[j+1] falls in
// bin j+1, the top edge in bin K-1). Writes the softmax weights of the
// widths and heights over P[0, 2K), which K3p's backward reads.
__device__ __forceinline__ Bin warp_circular_bin(float* P, int ld, const MnleParams& p, float z, int lane) {
  const int K = p.K;
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
  const double cw = warp_inclusive_scan(on ? (double)(p.min_w + p.scale_w * sw) : 0.0, lane);
  const double ch = warp_inclusive_scan(on ? (double)(p.min_h + p.scale_h * sh) : 0.0, lane);
  // Upper knots of bin `lane`; the last one is 1 exactly.
  const float xu = lane >= K - 1 ? 1.0f : (float)cw;
  const float yu = lane >= K - 1 ? 1.0f : (float)ch;
  const unsigned below = __ballot_sync(kFull, lane < K - 1 && z < xu);
  Bin b;
  b.k = below != 0u ? __ffs(below) - 1 : K - 1;
  const int lo = max(b.k - 1, 0);
  const float xl = __shfl_sync(kFull, xu, lo), yl = __shfl_sync(kFull, yu, lo);
  b.xk = b.k == 0 ? 0.0f : xl;
  b.yk = b.k == 0 ? 0.0f : yl;
  b.xk1 = __shfl_sync(kFull, xu, b.k);
  b.yk1 = __shfl_sync(kFull, yu, b.k);
  b.dk = p.min_d + softplus(P[(2 * K + b.k) * ld]);
  b.dk1 = p.min_d + softplus(P[(2 * K + (b.k + 1) % K) * ld]);
  return b;
}

// The circular RQ spline in bin b at the clipped phase zc, with xi clipped
// to [0, 1]: returns y, adds log|dy/dx| to *ld.
__device__ __forceinline__ float circular_forward(const Bin& b, float zc, float* ld) {
  const float w = b.xk1 - b.xk, h = b.yk1 - b.yk, sl = h / w;
  const float xi = fminf(fmaxf((zc - b.xk) / w, 0.0f), 1.0f), xi1m = 1.0f - xi;
  const float num = h * (sl * xi * xi + b.dk * xi * xi1m);
  const float den = sl + (b.dk1 + b.dk - 2.0f * sl) * xi * xi1m;
  const float dnum = sl * sl * (b.dk1 * xi * xi + 2.0f * sl * xi * xi1m + b.dk * xi1m * xi1m);
  *ld += logf(dnum) - 2.0f * logf(den);
  return b.yk + num / den;
}

// What the forward of one row leaves for K3p's backward.
struct PulseState {
  float slot_max, slot_sum;  // the slot head's log-softmax: max and normalizer
  Bin mine;                  // transform `lane`'s bin ...
  float mine_x, mine_rot;    // ... input and rotation
};

// The slot head's log-probability of slot int(kv) (0 outside [0, NS)) on
// one warp, lane l on logits l, l + 32, ... (the row's logits at sl[j *
// ld]), the normalizer summed in double; every lane the same bits. Leaves
// the max and the normalizer in s for the backward.
__device__ __forceinline__ float warp_slot_logprob(const float* sl, int ld, int NS, float kv, PulseState& s,
                                                   int lane) {
  const int ki = (int)kv;
  if (!(ki >= 0 && ki < NS)) return 0.0f;
  float mx = -INFINITY;
  for (int j = lane; j < NS; j += 32) mx = fmaxf(mx, sl[j * ld]);
  mx = warp_max(mx);
  double se = 0.0;
  for (int j = lane; j < NS; j += 32) se += (double)expf(sl[j * ld] - mx);
  s.slot_max = mx;
  s.slot_sum = (float)warp_sum(se);
  return sl[ki * ld] - mx - logf(s.slot_sum);
}

// log_det of one row's circular spline chain on its warp, z = phi through
// the T transforms (a uniform base adds nothing), every lane with the same
// bits. The row's head output is spr[j * TILE_ROWS]; warp_circular_bin
// writes each transform's softmax weights there.
__device__ __forceinline__ float warp_circular_flow(float* spr, const MnleParams& p, float phi, PulseState& s,
                                                    int lane) {
  constexpr int R = TILE_ROWS;
  const int K = p.K, S = 3 * p.K + 1;
  s.mine = Bin{};
  s.mine_x = 0.0f;
  s.mine_rot = 0.0f;
  float z = phi, ld = 0.0f;
  for (int i = 0; i < p.T; ++i) {
    float* P = spr + i * S * R;
    const float rot = sigmoid(P[3 * K * R]);
    float m, zc;
    circular_phase(z, rot, &m, &zc);
    const Bin b = warp_circular_bin(P, R, p, zc, lane);
    if (lane == i) {
      s.mine = b;
      s.mine_x = z;
      s.mine_rot = rot;
    }
    z = circular_forward(b, zc, &ld);
  }
  return ld;
}

// One row's log-prob on its warp from the tile's logits (lg[j *
// TILE_ROWS]), slot logits (slr) and head output (spr): cat_lp + m
// (slot_lp + log_det), m = 1 - oh[censored], the slot head and the flow
// skipped where m = 0. Lane 0 holds the value (it alone reads the logits).
// K2p and K3p both take a row's value from here.
__device__ __forceinline__ float warp_pulse_row_logp(const float* lg, const float* ohr, const float* slr,
                                                     float* spr, const MnleParams& p, float phi, float kv,
                                                     PulseState& s, int lane) {
  const float cat_lp = lane == 0 ? cat_logprob_strided(lg, ohr, TILE_ROWS, p.C) : 0.0f;
  const float keep = keep_factor(ohr, p);
  float lp = cat_lp;
  if (keep > 0.0f) {
    const float slot_lp = warp_slot_logprob(slr, TILE_ROWS, p.NS, kv, s, lane);
    lp += keep * (slot_lp + warp_circular_flow(spr, p, phi, s, lane));
  }
  return lp;
}

// Backward of one circular RQ spline on one warp at input x, rotation rot
// and bin b (from warp_circular_bin, whose softmax weights are in P[0,
// 2K)), with upstream gradients gy (of y) and gl (of the log-det).
// Overwrites P[0, 3K+1) with dL/dP and returns dL/dx.
__device__ __forceinline__ float warp_circular_bwd(float* P, int ld, const MnleParams& p, const Bin& b, float rot,
                                                   float x, float gy, float gl, int lane) {
  const int K = p.K, k = b.k;
  float m, zc;
  circular_phase(x, rot, &m, &zc);
  const float w = b.xk1 - b.xk, h = b.yk1 - b.yk, sl = h / w;
  const float xr = (zc - b.xk) / w;
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
  // dL/dwidth_i = gxk [i < k] + gxk1 [i <= k], lane i's share.
  const float gw = lane < k ? gxk + gxk1 : (lane == k ? gxk1 : 0.0f);
  const float gh = lane < k ? gyk + gyk1 : (lane == k ? gyk1 : 0.0f);
  const bool on = lane < K;
  const float sw = on ? P[lane * ld] : 0.0f, sh = on ? P[(K + lane) * ld] : 0.0f;
  // Softmax VJP: d param_i = sm_i (scale g_i - scale sum_j g_j sm_j).
  const float dot_w = p.scale_w * (float)warp_sum((double)(gw * sw));
  const float dot_h = p.scale_h * (float)warp_sum((double)(gh * sh));
  if (on) {
    P[lane * ld] = sw * (p.scale_w * gw - dot_w);
    P[(K + lane) * ld] = sh * (p.scale_h * gh - dot_h);
    // Derivatives d_m = min_d + softplus(raw_m); bin k uses d_k and
    // d_{(k+1) mod K}, so lane 0 takes bin K-1's right edge too.
    const float g = (lane == k ? g_dk : 0.0f) + (lane == (k + 1) % K ? g_dk1 : 0.0f);
    float* d = P + (2 * K + lane) * ld;
    *d = g != 0.0f ? g * sigmoid(*d) : 0.0f;
  }
  // Through the phase clip and the floor-mod: d/dx = 1, d/drot = -1.
  const float g_m = g_z * clip_grad(m, 0.0f, kPhaseHi);
  if (lane == 0) P[3 * K * ld] = -g_m * rot * (1.0f - rot);
  return g_m;
}

// The cotangent gm of the slot head's log-softmax at int(kv) pulled back
// to the row's NS logits sl[j * ld], in place, on one warp (lane l on
// logits l, l + 32, ...), with the forward's max and normalizer (s): zeros
// where int(kv) is outside [0, NS).
__device__ __forceinline__ void warp_slot_grad(float* sl, int ld, int NS, float kv, float gm, const PulseState& s,
                                               int lane) {
  const int ki = (int)kv;
  if (!(ki >= 0 && ki < NS)) {
    for (int j = lane; j < NS; j += 32) sl[j * ld] = 0.0f;
    return;
  }
  for (int j = lane; j < NS; j += 32)
    sl[j * ld] = gm * ((j == ki ? 1.0f : 0.0f) - expf(sl[j * ld] - s.slot_max) / s.slot_sum);
}

constexpr int kMaxF = 4;  // flow-head features a warp's d kf holds in registers

// d kf = d sp . head_w[H:H+F]^T of one row on one warp, the row's d sp at
// dsp[k * ld], its F outputs to out[f * TILE_ROWS], in tile_dense's
// summation order: lane c takes the partial sum of inputs [32c, 32c + 32)
// (fmaf, k ascending) and the partials are added in order, so the result
// has the bits of the same product through tile_dense. (As a product of the
// list, 3 columns over HO inputs, it took 19 % of K3p's time on the H100
// for 0.4 % of its FLOP: 23 chunks of weights staged for 24 outputs.) The
// rows of the padded head_w are 16-byte aligned, so the weights come as
// float4.
__device__ __forceinline__ void warp_dkf(const float* dsp, int ld, const MnleParams& p, float* out, int lane) {
  float acc[kMaxF] = {};
  for (int base = 0; base < p.HO; base += 32 * 32) {
    const int k0 = base + 32 * lane;
    float part[kMaxF] = {};
    if (k0 + 32 <= p.HO) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float4 wq[kMaxF];
#pragma unroll
        for (int f = 0; f < kMaxF; ++f)
          if (f < p.F)
            wq[f] = __ldg(reinterpret_cast<const float4*>(p.head_w + (size_t)(p.H + f) * p.head_ld + k0) + q);
        const float v[4] = {dsp[(k0 + 4 * q) * ld], dsp[(k0 + 4 * q + 1) * ld], dsp[(k0 + 4 * q + 2) * ld],
                            dsp[(k0 + 4 * q + 3) * ld]};
#pragma unroll
        for (int f = 0; f < kMaxF; ++f) {
          if (f < p.F) {
            part[f] = fmaf(v[0], wq[f].x, part[f]);
            part[f] = fmaf(v[1], wq[f].y, part[f]);
            part[f] = fmaf(v[2], wq[f].z, part[f]);
            part[f] = fmaf(v[3], wq[f].w, part[f]);
          }
        }
      }
    } else {
      for (int k = k0; k < p.HO; ++k) {
        const float v = dsp[k * ld];
#pragma unroll
        for (int f = 0; f < kMaxF; ++f)
          if (f < p.F) part[f] = fmaf(v, __ldg(p.head_w + (size_t)(p.H + f) * p.head_ld + k), part[f]);
      }
    }
    const int parts = min(32, (p.HO - base + 31) / 32);
    for (int c = 0; c < parts; ++c) {
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) acc[f] += __shfl_sync(kFull, part[f], c);
    }
  }
  if (lane < p.F) {
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f == lane) out[f * TILE_ROWS] = acc[f];
  }
}

// K3p's products in the order it runs them: the categorical MLP and the
// trunk, the slot head and the head on [emb; kf]; then d emb from the head
// (the padded transposed copy's first H columns), d emb from the slot head
// (accumulated), the trunk transposed down to the D context columns, the
// categorical MLP transposed. Each entry is one product whole: weights,
// bias and ReLU. (d kf is warp_dkf's.)
struct K3pProducts {
  const MnleParams& p;
  __device__ int count() const { return 4 * p.n_layers + 4; }
  __device__ TileProduct operator()(int i) const {
    const int L = p.n_layers, H = p.H, DC = p.D + p.C;
    if (i < L) {
      const bool last = i == L - 1;
      return {p.cat_w[i], p.cat_b[i], last ? p.C : H, i == 0 ? p.D : H, last ? p.C : H, !last};
    }
    i -= L;
    if (i < L) return {p.trunk_w[i], p.trunk_b[i], H, i == 0 ? DC : H, H, true};
    i -= L;
    switch (i) {
      case 0: return {p.slot_w, p.slot_b, p.NS, H, p.NS, false};
      case 1: return {p.head_w, p.head_b, p.head_ld, H + p.F, p.HO, false};
      case 2: return {p.head_wt, nullptr, p.head_t_ld, p.HO, H, false};
      case 3: return {p.slot_wt, nullptr, H, p.NS, H, false};
      default: break;
    }
    i -= 4;
    if (i < L) {
      const int l = L - 1 - i;
      return {p.trunk_wt[l], nullptr, l == 0 ? DC : H, H, l == 0 ? p.D : H, false};
    }
    const int l = L - 1 - (i - L);
    return {p.cat_wt[l], nullptr, l == 0 ? p.D : H, l == L - 1 ? p.C : H, l == 0 ? p.D : H, false};
  }
};

// K2p's products: the forward, K3p's first 2L + 2.
struct K2pProducts {
  const MnleParams& p;
  __device__ int count() const { return 2 * p.n_layers + 2; }
  __device__ TileProduct operator()(int i) const { return K3pProducts{p}(i); }
};

// Writes kf of the tile's rows k-major into kf_s (F x TILE_ROWS, zeros past
// the last row).
__device__ __forceinline__ void load_tile_features(const float* __restrict__ kf, float* kf_s, int row0, int N,
                                                   int F) {
  for (int idx = threadIdx.x; idx < TILE_ROWS * F; idx += TILE_THREADS) {
    const int r = idx / F, f = idx % F, row = row0 + r;
    kf_s[f * TILE_ROWS + r] = row < N ? kf[(size_t)row * F + f] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// K2p: the forward products through two hidden buffers, then a warp per row.
// ---------------------------------------------------------------------------

size_t fwd_smem_bytes(const MnleParams& p) {
  return sizeof(float) * ((size_t)TILE_STAGES * TILE_WBUF +
                          (size_t)TILE_ROWS * (p.D + p.C + 2 * p.H + p.F + p.C + p.NS + p.HO));
}

__global__ void __launch_bounds__(TILE_THREADS, FWD_BLOCKS_PER_SM) mnle_pulse_fwd_kernel(
    const __grid_constant__ MnleParams p, const float* __restrict__ phi, const float* __restrict__ oh,
    const float* __restrict__ ctx, const float* __restrict__ kf, const float* __restrict__ kv,
    float* __restrict__ out, int N) {
  extern __shared__ float4 smem4[];
  constexpr int R = TILE_ROWS;
  const int DC = p.D + p.C, H = p.H, L = p.n_layers;
  // Every array is k-major: element (k, r) at a[k * R + r]. The hidden
  // layers go to hid[0] and hid[1] in turn, the trunk's last to hid[0],
  // which kf_s follows: [emb; kf] is one (H + F) x R operand.
  float* ws = reinterpret_cast<float*>(smem4);  // TILE_STAGES x TILE_WBUF weight staging
  float* x0 = ws + TILE_STAGES * TILE_WBUF;     // DC x R: [ctx | onehot]
  float* kf_s = x0 + DC * R + H * R;            // F x R
  float* hid[2] = {x0 + DC * R, kf_s + p.F * R};
  float* logits = hid[1] + H * R;  // C x R
  float* slot = logits + p.C * R;  // NS x R
  float* sp = slot + p.NS * R;     // HO x R
  const int row0 = blockIdx.x * R;
  WeightStream<K2pProducts> ws_stream(K2pProducts{p}, ws);  // starts loading the first products' weights
  load_tile_rows(ctx, p.D, oh, p.C, x0, row0, N);
  load_tile_features(kf, kf_s, row0, N, p.F);

  const float* in = x0;
  for (int l = 0; l < L; ++l) {
    float* o = l == L - 1 ? logits : hid[l % 2];
    tile_dense(ws_stream, in, o, nullptr, false);
    in = o;
  }
  in = x0;
  for (int l = 0; l < L; ++l) {
    float* o = hid[(L - 1 - l) % 2];
    tile_dense(ws_stream, in, o, nullptr, false);
    in = o;
  }
  tile_dense(ws_stream, hid[0], slot, nullptr, false);
  tile_dense(ws_stream, hid[0], sp, nullptr, false);  // [emb; kf]
  __syncthreads();

  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += TILE_THREADS / 32) {
    const int row = row0 + r;
    if (row >= N) continue;
    PulseState s;
    const float v =
        warp_pulse_row_logp(logits + r, x0 + p.D * R + r, slot + r, sp + r, p, phi[row], kv[row], s, lane);
    if (lane == 0) out[row] = v;
  }
}

// ---------------------------------------------------------------------------
// K3p: the same forward keeping every activation, the row's value, then the
// backward.
// ---------------------------------------------------------------------------

size_t bwd_smem_bytes(const MnleParams& p) {
  return sizeof(float) * ((size_t)TILE_STAGES * TILE_WBUF +
                          (size_t)TILE_ROWS * (p.D + p.C + (2 * p.n_layers - 1) * p.H + 2 * p.F + p.C + p.NS +
                                               p.HO + 2 * p.H + p.D));
}

__global__ void __launch_bounds__(TILE_THREADS, 2) mnle_pulse_bwd_kernel(
    const __grid_constant__ MnleParams p, const float* __restrict__ phi, const float* __restrict__ oh,
    const float* __restrict__ ctx, const float* __restrict__ kf, const float* __restrict__ kv,
    const float* __restrict__ g, float* __restrict__ out, float* __restrict__ dphi, float* __restrict__ dctx,
    float* __restrict__ dkf, int N) {
  extern __shared__ float4 smem4[];
  constexpr int R = TILE_ROWS;
  const int DC = p.D + p.C, H = p.H, L = p.n_layers, S = 3 * p.K + 1;
  // Every array is k-major: element (k, r) at a[k * R + r].
  float* ws = reinterpret_cast<float*>(smem4);   // TILE_STAGES x TILE_WBUF weight staging
  float* x0 = ws + TILE_STAGES * TILE_WBUF;      // DC x R: [ctx | onehot]
  float* cat_act = x0 + DC * R;                  // (L-1) x H x R
  float* trunk_act = cat_act + (L - 1) * H * R;  // L x H x R, then ...
  float* kf_s = trunk_act + L * H * R;           // ... F x R: [emb; kf] is one (H + F) x R operand
  float* logits = kf_s + p.F * R;                // C x R
  float* slot = logits + p.C * R;                // NS x R
  float* sp = slot + p.NS * R;                   // HO x R
  float* gbuf[2] = {sp + p.HO * R, sp + p.HO * R + H * R};
  float* dx0 = gbuf[1] + H * R;                  // D x R
  float* dkf_s = dx0 + p.D * R;                  // F x R
  float* emb = trunk_act + (L - 1) * H * R;
  const int row0 = blockIdx.x * R;
  WeightStream<K3pProducts> ws_stream(K3pProducts{p}, ws);  // starts loading the first products' weights
  load_tile_rows(ctx, p.D, oh, p.C, x0, row0, N);
  load_tile_features(kf, kf_s, row0, N, p.F);

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
  tile_dense(ws_stream, emb, slot, nullptr, false);
  tile_dense(ws_stream, emb, sp, nullptr, false);  // [emb; kf]
  __syncthreads();

  // Per row, one warp: the value (as K2p writes it), then d logits (in
  // place), d slot logits (in place), the flow backward (d head output in
  // place, dphi to global memory) and d kf. Lane i holds bin i of each
  // spline, and lane j keeps transform j's bin, input and rotation between
  // the forward and the backward; the chain over the transforms stays
  // serial. Censored rows take the branch that zeroes their slot and spline
  // gradients.
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += TILE_THREADS / 32) {
    const int row = row0 + r;
    const float* ohr = x0 + p.D * R + r;
    float* spr = sp + r;
    PulseState s;
    if (row < N) {
      const float lp = warp_pulse_row_logp(logits + r, ohr, slot + r, spr, p, phi[row], kv[row], s, lane);
      if (lane == 0) out[row] = lp;
    }
    __syncwarp();  // every lane has read the slot logits the backward overwrites
    const float gr = row < N ? g[row] : 0.0f;
    if (lane == 0) cat_grad_strided(logits + r, ohr, R, p.C, gr);
    const float keep = keep_factor(ohr, p);
    float dz = 0.0f;
    if (keep > 0.0f && row < N) {
      const float gm = gr * keep;
      warp_slot_grad(slot + r, R, p.NS, kv[row], gm, s, lane);
      // Uniform base: the last z carries no gradient; each log-det gets gm.
      for (int i = p.T - 1; i >= 0; --i) {
        const Bin b = shfl_bin(s.mine, i);
        const float x = __shfl_sync(kFull, s.mine_x, i), rot = __shfl_sync(kFull, s.mine_rot, i);
        dz = warp_circular_bwd(spr + i * S * R, R, p, b, rot, x, dz, gm, lane);
      }
      __syncwarp();  // every lane's d sp written
      warp_dkf(spr, R, p, dkf_s + r, lane);
    } else {
      for (int j = lane; j < p.NS; j += 32) slot[j * R + r] = 0.0f;
      for (int j = lane; j < p.HO; j += 32) spr[j * R] = 0.0f;
      if (lane < p.F) dkf_s[lane * R + r] = 0.0f;
    }
    if (lane == 0 && row < N) dphi[row] = dz;
  }

  // d emb = d sp . head_w[:H]^T + d slot . slot_w^T, masked by the ReLU.
  tile_dense(ws_stream, sp, gbuf[0], emb, false);
  tile_dense(ws_stream, slot, gbuf[0], emb, true);

  // Trunk backward down to d ctx.
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
  for (int idx = threadIdx.x; idx < R * p.F; idx += TILE_THREADS) {
    const int r = idx / p.F, f = idx % p.F;
    if (row0 + r < N) dkf[(size_t)(row0 + r) * p.F + f] = dkf_s[f * R + r];
  }
}

// One bin per lane of a warp; kf's columns in registers (warp_dkf); the
// padded head copies.
bool params_ok(const MnleParams* p) {
  return p->T <= MAX_TRANSFORMS && p->n_layers >= 1 && p->n_layers <= MAX_LAYERS && p->K >= 1 && p->K <= 32 &&
         p->NS >= 1 && p->F >= 1 && p->F <= kMaxF && p->HO == p->T * (3 * p->K + 1) && p->head_ld >= p->HO &&
         p->head_ld % 4 == 0 && p->head_t_ld >= p->H + p->F;
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
  const int blocks = (N + TILE_ROWS - 1) / TILE_ROWS;
  mnle_pulse_fwd_kernel<<<blocks, TILE_THREADS, smem, (cudaStream_t)stream>>>(*p, phi, oh, ctx, kf, kv, out, N);
  return (int)cudaGetLastError();
}

int sdm_mnle_pulse_bwd(const MnleParams* p, const float* phi, const float* oh, const float* ctx,
                       const float* kf, const float* kv, const float* g, float* out, float* dphi, float* dctx,
                       float* dkf, int N, void* stream) {
  if (N <= 0) return 0;
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(*p);
  cudaError_t err = cudaFuncSetAttribute(mnle_pulse_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + TILE_ROWS - 1) / TILE_ROWS;
  mnle_pulse_bwd_kernel<<<blocks, TILE_THREADS, smem, (cudaStream_t)stream>>>(*p, phi, oh, ctx, kf, kv, g, out,
                                                                              dphi, dctx, dkf, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
