// Shared by the kernels that run a thread a chain and follow the plain path's float32 arithmetic bit for bit
// (nuts_leaf.cu, udensity.cu): their launch shape, one rounding per PyTorch operation, and a sum over a row in
// the order PyTorch's CUDA reduction takes it.

#pragma once

#include <cuda_runtime.h>

namespace {

// A thread a chain: one block of C threads rounded up to a warp, or blocks of MAX_THREADS.
constexpr int MAX_THREADS = 256;

inline dim3 blocks_for(int C, int* threads) {
  const int t = ((C + 31) / 32) * 32;
  *threads = t < 32 ? 32 : t < MAX_THREADS ? t : MAX_THREADS;
  const int blocks = (C + *threads - 1) / *threads;
  return dim3(blocks < 1 ? 1 : blocks);
}

// A product, sum or difference rounded once, as one PyTorch operation rounds it: never contracted into an FMA.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// sum(term(0), ..., term(D - 1)) in the order of PyTorch's CUDA reduction over a contiguous last dimension
// (ATen's Reduce.cuh: a thread reduction, then block_x_reduce), for a reduction of 16 outputs or more.
//
// Below VEC_MIN_D elements (thread_reduce_impl): W = min(2^floor(log2 D), 32) lanes; lane t adds elements
// t, t + W, t + 2W, ... into four accumulators in turn (element t + (i + 4k) W into accumulator i), starting
// from 0, then adds the four in order. From VEC_MIN_D elements on (input_vectorized_thread_reduce_impl), ATen
// loads four elements at a time from 16-byte boundaries, W = 32 lanes: where the row starts `shift` elements
// past a boundary (1 to 3), its first 4 - shift elements are the head, element e going to lane e + shift;
// lane t then adds the vectors t, t + W, ... of the rest, element i of a vector into accumulator i; the last
// (rest mod 4) elements go to lanes 0, 1, 2 (accumulator 0); the four accumulators are added in order.
// Either way, for offsets W/2, W/4, ..., 1, lane t then adds lane t + offset (the warp shuffle down).
// Reduce.cuh takes that W wherever D <= 32, or the reduction has 16 outputs or more; the kernel takes it
// always, so that a chain's sums do not depend on how many chains the launch holds. It splits a row over
// warps only from about 8,192 elements, which the kernel does not follow. W is a template argument, so that
// the lanes unroll into registers.
constexpr int VEC_MIN_D = 128;  // Reduce.cuh's setReduceConfig: vectorize_input from 128 inputs an output

template <int W>
__device__ __forceinline__ float lane_tree(float* lane) {
#pragma unroll
  for (int off = W >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int t = 0; t < off; ++t) lane[t] = add(lane[t], lane[t + off]);
  }
  return lane[0];
}

template <int W, class Term>
__device__ __forceinline__ float torch_order_sum_w(int D, Term term) {
  float lane[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int idx = t;
    while (idx + 3 * W < D) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = add(acc[i], term(idx + i * W));
      idx += 4 * W;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (idx < D) acc[i] = add(acc[i], term(idx));
      idx += W;
    }
    lane[t] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
  return lane_tree<W>(lane);
}

template <class Term>
__device__ __forceinline__ float torch_order_sum_vec(int D, int shift, Term term) {
  constexpr int W = 32;
  const int head = shift > 0 ? 4 - shift : 0;
  const int end = D - head;  // the elements after the head, from a 16-byte boundary
  const int tail = end - end % 4;
  float lane[W];
#pragma unroll
  for (int t = 0; t < W; ++t) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (shift > 0 && t >= shift && t < 4) acc[0] = add(acc[0], term(t - shift));
    for (int v = t; 4 * v + 3 < end; v += W) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = add(acc[i], term(head + 4 * v + i));
    }
    if (tail + t < end) acc[0] = add(acc[0], term(head + tail + t));
    lane[t] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
  return lane_tree<W>(lane);
}

// row: the index of the sum's row in the plain path's (rows, D) summand, a fresh tensor whose start lies on a
// 16-byte boundary, so that row r starts (r * D) mod 4 elements past one.
template <class Term>
__device__ __forceinline__ float torch_order_sum(int D, long long row, Term term) {
  if (D >= VEC_MIN_D) return torch_order_sum_vec(D, (int)((row * D) & 3), term);
  if (D >= 32) return torch_order_sum_w<32>(D, term);
  if (D >= 16) return torch_order_sum_w<16>(D, term);
  if (D >= 8) return torch_order_sum_w<8>(D, term);
  if (D >= 4) return torch_order_sum_w<4>(D, term);
  if (D >= 2) return torch_order_sum_w<2>(D, term);
  return torch_order_sum_w<1>(D, term);
}

}  // namespace
