// Shared by the fused MNLE kernels (K2/K3 in mnle_logprob.cu, K2p/K3p in
// mnle_pulse.cu): the parameter struct and the scalar helpers. The tile
// product is in mnle_tile.cuh, the warp helpers of the per-row phase in
// mnle_warp.cuh.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define MAX_LAYERS 4
#define MAX_TRANSFORMS 16

struct MnleParams {
  const float* cat_w[MAX_LAYERS];    // (in, out)
  const float* cat_wt[MAX_LAYERS];   // (out, in)
  const float* cat_b[MAX_LAYERS];
  const float* trunk_w[MAX_LAYERS];
  const float* trunk_wt[MAX_LAYERS];
  const float* trunk_b[MAX_LAYERS];
  const float* head_w;   // (H + F, HO), leading dimension head_ld
  const float* head_wt;  // (HO, H + F), leading dimension head_t_ld
  const float* head_b;
  int D, C, H, n_layers, T, K, HO, cond_affine, censored_col;
  float tail_bound, min_w, min_h, min_d, scale_w, scale_h;
  // Pulse rep only (K2p/K3p): the slot head (H, NS) and the width F of the
  // flow-head features appended to the trunk output.
  const float* slot_w;
  const float* slot_wt;
  const float* slot_b;
  int NS, F;
  // The head's leading dimensions. For the pulse rep both copies are padded
  // with zero columns to a multiple of 4 floats, so the tile product stages
  // their rows by 16-byte copies (head_ld = 732 and head_t_ld = 132 at the
  // pulse model's widths); the other reps keep HO and H.
  int head_ld, head_t_ld;
};

namespace {

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// One spline bin: its index, knots and knot derivatives.
struct Bin {
  int k;
  float xk, xk1, yk, yk1, dk, dk1;
};

}  // namespace
