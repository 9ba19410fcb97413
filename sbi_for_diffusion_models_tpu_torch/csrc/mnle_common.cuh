// Shared by the fused MNLE kernels (K2/K3 in mnle_logprob.cu, K2p/K3p in
// mnle_pulse.cu): the parameter struct, the tile product and the per-row
// helpers. A block of THREADS threads owns a tile of ROWS rows; the tile's
// activations live in shared memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define MAX_LAYERS 4
#define MAX_TRANSFORMS 16
#define ROWS 16
#define THREADS 128
#define SUM_BLOCK 32

struct MnleParams {
  const float* cat_w[MAX_LAYERS];    // (in, out)
  const float* cat_wt[MAX_LAYERS];   // (out, in)
  const float* cat_b[MAX_LAYERS];
  const float* trunk_w[MAX_LAYERS];
  const float* trunk_wt[MAX_LAYERS];
  const float* trunk_b[MAX_LAYERS];
  const float* head_w;   // (H + F, HO)
  const float* head_wt;  // (HO, H + F)
  const float* head_b;
  int D, C, H, n_layers, T, K, HO, cond_affine, censored_col;
  float tail_bound, min_w, min_h, min_d, scale_w, scale_h;
  // Pulse rep only (K2p/K3p): the slot head (H, NS) and the width F of the
  // flow-head features appended to the trunk output.
  const float* slot_w;
  const float* slot_wt;
  const float* slot_b;
  int NS, F;
  // K3p's copy of head_w with leading dimension head_ld, and head_wt's
  // leading dimension head_t_ld. For the pulse rep both are padded with
  // zero columns to a multiple of 4 floats, so the tile product stages
  // their rows by 16-byte copies; K2p reads head_w (leading dimension HO),
  // K3 head_wt of the other reps (leading dimension H).
  const float* head_w_pad;
  int head_ld, head_t_ld;
};

namespace {

// out[r, j] (+)= act(sum_k in[r, k] * W[k, j] + b[j]) for r < ROWS, j < out_w.
// W is row-major with leading dimension w_ld; `mask` (optional) multiplies
// each output by (mask[r, j] > 0), the ReLU derivative; `accumulate` adds
// into out. Ends with __syncthreads().
__device__ void dense(const float* in, int in_ld, int in_w, const float* __restrict__ W, int w_ld,
                      const float* __restrict__ b, float* out, int out_ld, int out_w, bool relu,
                      const float* mask, int mask_ld, bool accumulate) {
  for (int j = threadIdx.x; j < out_w; j += blockDim.x) {
    float acc[ROWS];
    const float bj = b != nullptr ? __ldg(b + j) : 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = bj;
    const float* wcol = W + j;
    // Blocked summation: a partial sum per SUM_BLOCK inputs, added to acc.
    // One running sum over all 128 inputs rounds about four times worse.
    for (int k0 = 0; k0 < in_w; k0 += SUM_BLOCK) {
      const int k1 = min(k0 + SUM_BLOCK, in_w);
      float part[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) part[r] = 0.0f;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float w = __ldg(wcol + (size_t)k * w_ld);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) part[r] = fmaf(in[r * in_ld + k], w, part[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] += part[r];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float v = relu ? fmaxf(acc[r], 0.0f) : acc[r];
      if (mask != nullptr && !(mask[r * mask_ld + j] > 0.0f)) v = 0.0f;
      if (accumulate) v += out[r * out_ld + j];
      out[r * out_ld + j] = v;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

struct SoftmaxStats {
  float max_w, sum_w, max_h, sum_h;
};

// The normalizers are summed in double: a spline's knots are sums of K
// softmax terms, a float32 running sum rounds at the size of the whole sum
// at every term, and in a narrow bin that rounding is a visible share of the
// bin's width. The plain version's softmax and cumsum reduce as trees and
// round less; with double sums here (and in the knot walks) the kernels are
// closer to the float64 evaluation than the plain float32 version is.
__device__ __forceinline__ SoftmaxStats softmax_stats(const float* P, int K) {
  SoftmaxStats s{-INFINITY, 0.0f, -INFINITY, 0.0f};
  for (int i = 0; i < K; ++i) {
    s.max_w = fmaxf(s.max_w, P[i]);
    s.max_h = fmaxf(s.max_h, P[K + i]);
  }
  double sum_w = 0.0, sum_h = 0.0;
  for (int i = 0; i < K; ++i) {
    sum_w += (double)expf(P[i] - s.max_w);
    sum_h += (double)expf(P[K + i] - s.max_h);
  }
  s.sum_w = (float)sum_w;
  s.sum_h = (float)sum_h;
  return s;
}

// One spline bin: its index, knots and knot derivatives.
struct Bin {
  int k;
  float xk, xk1, yk, yk1, dk, dk1;
};

// Loads [ctx | onehot] for the tile into x0 (zeros past the last row).
__device__ void load_rows(const float* __restrict__ ctx, const float* __restrict__ oh, float* x0,
                          int row0, int N, const MnleParams& p) {
  const int DC = p.D + p.C;
  for (int idx = threadIdx.x; idx < ROWS * DC; idx += blockDim.x) {
    const int r = idx / DC, k = idx % DC, row = row0 + r;
    float v = 0.0f;
    if (row < N) v = k < p.D ? ctx[(size_t)row * p.D + k] : oh[(size_t)row * p.C + (k - p.D)];
    x0[idx] = v;
  }
  __syncthreads();
}

// Categorical log-prob of one row from its logits (C values) and one-hot.
__device__ float cat_logprob(const float* logits, const float* ohr, int C) {
  float mx = -INFINITY;
  for (int j = 0; j < C; ++j) mx = fmaxf(mx, logits[j]);
  float se = 0.0f;
  for (int j = 0; j < C; ++j) se += expf(logits[j] - mx);
  const float lse = logf(se);
  float lp = 0.0f;
  for (int j = 0; j < C; ++j) lp += (logits[j] - mx - lse) * ohr[j];
  return lp;
}

}  // namespace
