// Register-tiled FP32 tile product for the fused MNLE kernels (K2 and K3 in
// mnle_logprob.cu, K2p and K3p in mnle_pulse.cu). A block of TILE_THREADS
// threads owns a tile of TILE_ROWS rows; the tile's activations live in
// shared memory k-major: element (k, r) at a[k * TILE_ROWS + r], so one
// 16-byte load gives four rows of one input k.
//
// out[(j, r)] (+)= act(b[j] + sum_k in[(k, r)] W[k, j]) for the tile's rows.
// W is row-major in global memory with leading dimension w_ld. A kernel
// lists its products (weights, bias, ReLU) in the order it runs them (a
// WeightStream); their chunks of TILE_KC inputs x up to TILE_NC columns are
// staged in shared memory by cp.async, double-buffered, the next chunk in
// flight across product boundaries (the next product's first chunk loads
// while this one computes, and while the code between two products runs).
// Each block reads each weight once, 16 bytes a thread where the rows are
// 16-byte aligned, 4 otherwise. In a chunk of TILE_NC columns each thread
// computes a micro-tile of 4 rows of one column in registers, a warp all
// the tile's rows of 16 columns, so that its activations and its weights of
// one k are one shared-memory wavefront each; a narrower chunk (the
// categorical logits, the d ctx products, the head's last columns) spreads
// its TILE_ROWS x cols outputs over all threads, consecutive threads on
// consecutive rows, so no more than a warp idles. All arithmetic is FP32,
// no tensor cores (the JAX kernel computes at Precision.HIGHEST).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_THREADS 256
// Rows of a tile. At 8 rows K3 takes 89,856 B of shared memory at the
// flagship's widths, so two blocks fit on an SM; 16-row tiles were slower
// on the H100 at 1,200 and at 115,200 rows (ROADMAP.md, open questions).
#define TILE_ROWS 8
// Blocks an SM the forward kernels K2 and K2p are built for (their
// __launch_bounds__): with two hidden buffers instead of every activation
// they take 66,656 B and 69,888 B of shared memory at the flagship's and
// the pulse model's widths, so three fit, at 80 registers a thread or fewer.
#define FWD_BLOCKS_PER_SM 3
#define TILE_KC 32
#define TILE_NC 128
#define TILE_WBUF (TILE_KC * TILE_NC)  // floats in one staging buffer
// Staging buffers: double-buffered. Deeper rings (3 or 6 buffers) were no
// faster in K3 on the H100: its products are bound by
// shared-memory loads and instruction issue, not by the weights' latency.
#define TILE_STAGES 2

namespace {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One product: W (in_w, out_w) row-major with leading dimension w_ld, its
// bias b (out_w, or nullptr) and whether a ReLU follows.
struct TileProduct {
  const float* W;
  const float* b;
  int w_ld, in_w, out_w;
  bool relu;
};

// Whether the chunk of inputs [k0, k0 + TILE_KC) is a column chunk's last:
// the producer and the consumer of the stream walk the chunks by this rule.
__device__ __forceinline__ bool last_k_chunk(int k0, int in_w) { return k0 + TILE_KC >= in_w; }

// The weights of a kernel's products in the order it runs them. `List` is
// a functor: list(i) -> TileProduct for i < list.count(), each with in_w > 0
// and out_w > 0. Chunk g of the stream lives in buffer g % TILE_STAGES of
// `ws` (TILE_STAGES x TILE_WBUF floats). Every thread of the block holds the
// same copy and calls every member.
template <class List>
struct WeightStream {
  List list;
  float* ws;
  int ip = 0;                // the product being staged ...
  TileProduct P;             // ... its weights
  bool vec = false;          // ... whether its rows take 16-byte copies
  int k0 = 0, j0 = 0;        // ... and its next chunk
  int issued = 0, consumed = 0, current = 0;  // chunks staged, chunks used, the product being computed

  __device__ WeightStream(const List& l, float* w) : list(l), ws(w) {
    load_product();
    for (int s = 0; s < TILE_STAGES - 1; ++s) issue();
  }

  __device__ void load_product() {
    if (ip >= list.count()) return;
    P = list(ip);
    vec = P.w_ld % 4 == 0 && ((uintptr_t)P.W & 15) == 0;
  }

  // Stage the next chunk of the stream (an empty group past its end):
  // W[k0 + kk, j0 + c] into buffer[kk * TILE_NC + c], a warp per row of
  // the chunk. With 16-byte copies a ragged last column chunk is copied up
  // to the next multiple of 4 columns where the row of W holds them (the
  // extra columns are never read).
  __device__ void issue() {
    if (ip < list.count()) {
      float* buf = ws + (issued % TILE_STAGES) * TILE_WBUF;
      const float* src = P.W + (size_t)k0 * P.w_ld + j0;
      const int kc = min(TILE_KC, P.in_w - k0), cols = min(TILE_NC, P.out_w - j0);
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      const int cols4 = (cols + 3) / 4;
      if (vec && kc == TILE_KC && cols == TILE_NC) {
#pragma unroll
        for (int m = 0; m < TILE_KC / (TILE_THREADS / 32); ++m) {
          const int kk = warp + m * (TILE_THREADS / 32);
          cp_async16(buf + kk * TILE_NC + 4 * lane, src + (size_t)kk * P.w_ld + 4 * lane);
        }
      } else if (vec && j0 + 4 * cols4 <= P.w_ld) {
        for (int kk = warp; kk < kc; kk += TILE_THREADS / 32)
          for (int c = lane; c < cols4; c += 32)
            cp_async16(buf + kk * TILE_NC + 4 * c, src + (size_t)kk * P.w_ld + 4 * c);
      } else {
        for (int kk = warp; kk < kc; kk += TILE_THREADS / 32)
          for (int c = lane; c < cols; c += 32) cp_async4(buf + kk * TILE_NC + c, src + (size_t)kk * P.w_ld + c);
      }
      if (!last_k_chunk(k0, P.in_w)) {
        k0 += TILE_KC;
      } else if (j0 + TILE_NC < P.out_w) {
        k0 = 0;
        j0 += TILE_NC;
      } else {
        k0 = j0 = 0;
        ++ip;
        load_product();
      }
    }
    cp_async_commit();
    ++issued;
  }

  // The next chunk's buffer, once every thread can read it: waits for its
  // copy and for every thread to be done with the buffer it refills.
  __device__ const float* next() {
    cp_async_wait<TILE_STAGES - 2>();
    __syncthreads();
    issue();
    return ws + (consumed++ % TILE_STAGES) * TILE_WBUF;
  }
};

// act(acc) with the optional ReLU mask (the output is 0 where mask <= 0)
// and accumulation (the output is added to what out holds), for
// out[col * TILE_ROWS + r].
__device__ __forceinline__ float epilogue(float acc, bool relu, const float* mask, const float* out, int col, int r,
                                          bool accumulate) {
  float v = relu ? fmaxf(acc, 0.0f) : acc;
  if (mask != nullptr && !(mask[col * TILE_ROWS + r] > 0.0f)) v = 0.0f;
  if (accumulate) v += out[col * TILE_ROWS + r];
  return v;
}

// The stream's next product (see the header), with its bias and ReLU, on
// inputs `in` into `out`, with the ReLU mask `mask` (optional) and the
// accumulation of `epilogue`; every array k-major with stride TILE_ROWS.
// The inputs must be written before the call; the outputs are visible to
// other threads after the next __syncthreads().
//
// The summation order is fixed, so every kernel that runs a product gets
// the same bits from it (K3's forward recompute and K2's forward, K3p's and
// K2p's): per output, k ascending, fmaf into a partial sum of TILE_KC = 32
// terms, each partial added to the bias-initialised accumulator. (One
// running sum over all 128 inputs of a hidden layer rounds about four times
// worse.)
template <class Stream>
__device__ void tile_dense(Stream& s, const float* in, float* out, const float* mask, bool accumulate) {
  constexpr int R = TILE_ROWS;
  constexpr int NOUT = R * TILE_NC / TILE_THREADS;  // outputs per thread: 4
  constexpr int CGW = 32 / (R / 4);                  // a warp: both 4-row groups of CGW columns
  static_assert(R == 8 && NOUT == 4, "the micro-tile is 4 rows of one column, two row groups a warp");
  const TileProduct P = s.list(s.current++);
  const int tid = threadIdx.x;
  for (int j0 = 0; j0 < P.out_w; j0 += TILE_NC) {
    const int cols = min(TILE_NC, P.out_w - j0);
    float acc[NOUT];
    if (cols == TILE_NC) {
      // Micro-tile: rows 4 rg .. 4 rg + 3 of column j0 + c. A warp's loads
      // of one k: 4 R bytes of activations and 4 CGW of weights, each one
      // shared-memory wavefront.
      const int rg = (tid & 31) / CGW, c = (tid >> 5) * CGW + (tid & 31) % CGW;
      const float bj = P.b != nullptr ? __ldg(P.b + j0 + c) : 0.0f;
#pragma unroll
      for (int i = 0; i < NOUT; ++i) acc[i] = bj;
      for (int k0 = 0;; k0 += TILE_KC) {
        const float* w = s.next() + c;
        const float* a_ptr = in + k0 * R + 4 * rg;
        const int kc = min(TILE_KC, P.in_w - k0);
        float part[NOUT];
#pragma unroll
        for (int i = 0; i < NOUT; ++i) part[i] = 0.0f;
        auto step = [&](int kk) {
          const float4 a = *reinterpret_cast<const float4*>(a_ptr + kk * R);
          const float wk = w[kk * TILE_NC];
          part[0] = fmaf(a.x, wk, part[0]);
          part[1] = fmaf(a.y, wk, part[1]);
          part[2] = fmaf(a.z, wk, part[2]);
          part[3] = fmaf(a.w, wk, part[3]);
        };
        if (kc == TILE_KC) {
#pragma unroll
          for (int kk = 0; kk < TILE_KC; ++kk) step(kk);
        } else {
          for (int kk = 0; kk < kc; ++kk) step(kk);
        }
#pragma unroll
        for (int i = 0; i < NOUT; ++i) acc[i] += part[i];
        if (last_k_chunk(k0, P.in_w)) break;
      }
      const int col = j0 + c;
      float v[NOUT];
#pragma unroll
      for (int i = 0; i < NOUT; ++i) v[i] = epilogue(acc[i], P.relu, mask, out, col, 4 * rg + i, accumulate);
      *reinterpret_cast<float4*>(out + col * R + 4 * rg) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      // A narrower chunk (the categorical logits, the d ctx products, the
      // head's last columns): output o = tid + TILE_THREADS m is row o % R
      // (the same row for every m) of column j0 + o / R, so no more than a
      // warp idles.
      const int r = tid % R, n_out = R * cols;
#pragma unroll
      for (int m = 0; m < NOUT; ++m) {
        const int o = tid + TILE_THREADS * m;
        acc[m] = (o < n_out && P.b != nullptr) ? __ldg(P.b + j0 + o / R) : 0.0f;
      }
      for (int k0 = 0;; k0 += TILE_KC) {
        const float* w = s.next();
        const int kc = min(TILE_KC, P.in_w - k0);
        float part[NOUT];
#pragma unroll
        for (int m = 0; m < NOUT; ++m) part[m] = 0.0f;
#pragma unroll 4
        for (int kk = 0; kk < kc; ++kk) {
          const float a = in[(k0 + kk) * R + r];
#pragma unroll
          for (int m = 0; m < NOUT; ++m) {
            const int o = tid + TILE_THREADS * m;
            if (o < n_out) part[m] = fmaf(a, w[kk * TILE_NC + o / R], part[m]);
          }
        }
#pragma unroll
        for (int m = 0; m < NOUT; ++m) acc[m] += part[m];
        if (last_k_chunk(k0, P.in_w)) break;
      }
#pragma unroll
      for (int m = 0; m < NOUT; ++m) {
        const int o = tid + TILE_THREADS * m;
        if (o < n_out) {
          const int col = j0 + o / R;
          out[col * R + r] = epilogue(acc[m], P.relu, mask, out, col, r, accumulate);
        }
      }
    }
  }
}

// Loads [ctx | onehot] of the tile's rows k-major into x0 ((D + C) x
// TILE_ROWS, zeros past the last row); visible to other threads after the
// next __syncthreads().
__device__ __forceinline__ void load_tile_rows(const float* __restrict__ ctx, int D, const float* __restrict__ oh,
                                               int C, float* x0, int row0, int N) {
  const int DC = D + C;
  for (int idx = threadIdx.x; idx < TILE_ROWS * DC; idx += TILE_THREADS) {
    const int r = idx / DC, k = idx % DC, row = row0 + r;
    float v = 0.0f;
    if (row < N) v = k < D ? ctx[(size_t)row * D + k] : oh[(size_t)row * C + (k - D)];
    x0[k * TILE_ROWS + r] = v;
  }
}

}  // namespace
