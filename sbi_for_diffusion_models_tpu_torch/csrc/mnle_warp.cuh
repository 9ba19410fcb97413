// Warp-level helpers shared by the fused MNLE kernels (K2/K3 in
// mnle_logprob.cu, K2p/K3p in mnle_pulse.cu), whose per-row phase runs one
// warp per row, lane i on bin i: the max and the double sums by butterfly
// shuffles, the knots by an inclusive double scan, a bin broadcast from one
// lane, and the categorical log-softmax and its VJP on a row of the tile.
//
// The softmax normalizers and the running sums behind the spline knots are
// taken in double: a spline's knots are sums of K softmax terms, a float32
// running sum rounds at the size of the whole sum at every term, and in a
// narrow bin that rounding is a visible share of the bin's width. The plain
// version's softmax and cumsum reduce as trees and round less; with double
// sums the kernels are closer to the float64 evaluation than the plain
// float32 version is. The order of the double sums is the one the kernels'
// float64 row checks were measured with: change it here and all four
// kernels change.

#pragma once

#include "mnle_common.cuh"
#include "mnle_tile.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Butterfly sum: every lane adds the same pair at every level, so every
// lane ends with the same bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_inclusive_scan(double v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ Bin shfl_bin(const Bin& b, int src) {
  Bin o;
  o.k = __shfl_sync(kFull, b.k, src);
  o.xk = __shfl_sync(kFull, b.xk, src);
  o.xk1 = __shfl_sync(kFull, b.xk1, src);
  o.yk = __shfl_sync(kFull, b.yk, src);
  o.yk1 = __shfl_sync(kFull, b.yk1, src);
  o.dk = __shfl_sync(kFull, b.dk, src);
  o.dk1 = __shfl_sync(kFull, b.dk1, src);
  return o;
}

// 1 - onehot[censored] of one row of the tile (the row's one-hot at
// ohr[j * TILE_ROWS]), or 1 when the model does not censor.
__device__ __forceinline__ float keep_factor(const float* ohr, const MnleParams& p) {
  return p.censored_col >= 0 ? 1.0f - ohr[p.censored_col * TILE_ROWS] : 1.0f;
}

// Categorical log-prob of one row from its C logits and one-hot, which lie
// `ld` apart (one thread).
__device__ float cat_logprob_strided(const float* lg, const float* ohr, int ld, int C) {
  float mx = -INFINITY;
  for (int j = 0; j < C; ++j) mx = fmaxf(mx, lg[j * ld]);
  float se = 0.0f;
  for (int j = 0; j < C; ++j) se += expf(lg[j * ld] - mx);
  const float lse = logf(se);
  float lp = 0.0f;
  for (int j = 0; j < C; ++j) lp += (lg[j * ld] - mx - lse) * ohr[j * ld];
  return lp;
}

// The cotangent gr of one row's categorical log-prob pulled back to its
// logits, in place: d logit_j = gr (oh_j - softmax_j sum(oh)); the row's
// logits and one-hot lie `ld` apart.
__device__ void cat_grad_strided(float* lg, const float* ohr, int ld, int C, float gr) {
  float mx = -INFINITY;
  for (int j = 0; j < C; ++j) mx = fmaxf(mx, lg[j * ld]);
  float se = 0.0f, soh = 0.0f;
  for (int j = 0; j < C; ++j) {
    se += expf(lg[j * ld] - mx);
    soh += ohr[j * ld];
  }
  for (int j = 0; j < C; ++j) lg[j * ld] = gr * ohr[j * ld] - (expf(lg[j * ld] - mx) / se) * gr * soh;
}

}  // namespace
