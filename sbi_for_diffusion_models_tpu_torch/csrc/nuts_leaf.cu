// The NUTS leaf kernel: the body of one leaf of inference/nuts.py's _build_subtree in one launch.
//
// A port-only kernel: the JAX package has no Pallas counterpart. There the leaf body is part of the
// while_loop that XLA compiles into one program; in the port it ran as some 45 to 50 eager PyTorch
// operations on (C, D) and (C,) tensors a leaf, each a launch of a few microseconds on the card and
// tens of microseconds of Python and dispatch on the host, while the card waited. A serving transition
// runs hundreds of leaves, so that host time was most of a potential call's.
//
// What it computes, after the leaf's potential call, for every chain c (C chains, D dimensions):
//   p_new = p_half + half_e * g_new;
//   delta = (0.5 * sum(p_new * p_new * inv_mass) - logp_new) - H0, NaN -> +inf;
//   new_log_w = logaddexp(log_w, -delta); take = live & (log(u) < -delta - new_log_w);
//   at an even leaf, the checkpoint store (p_new into r_ckpts[store_slot], rho into
//   rsum_ckpts[store_slot]); at an odd leaf, the U-turn test against slots idx_min..idx_max;
//   the updates of edge, prop, rho, log_w, sum_accept, n_leaves, turning, diverging and live (each
//   chain's edge, rho and sums move only while it is live); the next leaf's half step p_half and
//   position u_next from the updated edge; and any(live) into a byte of pinned host memory, which the
//   sampler reads one leaf late. Before a subtree's first leaf the sampler computes p_half and u_next with
//   the plain path's two torch.addcmul calls.
//
// The arithmetic is the plain path's, in its order and its rounding: every product and sum is
// __fmul_rn / __fadd_rn / __fsub_rn (no contraction into an FMA), an addcmul is rounded once (one FMA), as
// PyTorch's CUDA addcmul rounds a + b * c, logf, expf and log1pf are
// the math library's (no fast-math intrinsics), and a sum over D is taken in the order PyTorch's CUDA
// reduction takes it over a contiguous last dimension (torch_order_sum), its four-wide loads from D = 128 on
// included. Nothing of one chain depends on another
// chain, so a run split over ranks by rows gives each chain the bits of the unsharded run.
//
// What bounds it: the launch and one chain's chain of dependent operations. It moves about 150 bytes a
// chain and dimension; at C = 2,304 chains and D = 5 that is under 2 MB, a fraction of a microsecond of the
// card's bandwidth. So it is a thread a chain, in blocks of up to MAX_THREADS: a chain's work is a few
// hundred dependent operations, which one block looping over 2,304 chains would run three deep a thread.
// any(live) is or-ed over the blocks in two ints of device memory (SdmNutsLeafState.any_live), which the
// last block to finish reads into the flag and sets back to 0 for the next launch.

#include <cuda_runtime.h>
#include <math.h>

// One subtree's state, (C, ...) row-major float32 unless said; the kernel updates it in place.
struct SdmNutsLeafState {
  float* edge;                // (C, 3D + 1): [u | p | g | logp] of the subtree's far end
  float* prop;                // (C, 2D + 1): [u | g | logp] of the multinomial proposal
  float* rho;                 // (C, D): the momentum sum
  float* log_w;               // (C,)
  float* sum_accept;          // (C,)
  long long* n_leaves;        // (C,) int64
  unsigned char* turning;     // (C,) bool
  unsigned char* diverging;   // (C,) bool
  unsigned char* live;        // (C,) bool
  float* r_ckpts;             // (C, S, D)
  float* rsum_ckpts;          // (C, S, D)
  float* p_half;              // (C, D): this leaf's half step in, the next leaf's out
  const float* half_e;        // (C,): 0.5 * eps * direction
  const float* e_im;          // (C, D): eps * direction * inv_mass
  const float* inv_mass;      // (C, D)
  const float* H0;            // (C,)
  unsigned char* flag;        // two bytes of pinned host memory, as the device addresses them
  unsigned int* any_live;     // two ints of device memory, 0 between launches: the blocks' or, blocks done
  int C, D, S;
};

namespace {

constexpr int MAX_THREADS = 256;
constexpr float MAX_DELTA_ENERGY = 1000.0f;  // inference/nuts.py's _MAX_DELTA_ENERGY


__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.addcmul(a, b, c) with value 1, rounded as PyTorch's CUDA kernel rounds it.
__device__ __forceinline__ float addcmul(float a, float b, float c) { return __fmaf_rn(b, c, a); }

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

// torch.logaddexp's float32 CUDA kernel.
__device__ __forceinline__ float log_add_exp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return add(m, log1pf(expf(-fabsf(sub(a, b)))));
}

// The next leaf's half step and position from chain c's edge: p_half = p + half_e * g, u = u + e_im * p_half.
__device__ __forceinline__ void half_step(const SdmNutsLeafState& st, int c, float* u_next) {
  const int D = st.D;
  const float he = st.half_e[c];
  const float* e = st.edge + (long long)c * (3 * D + 1);
  const float* eim = st.e_im + (long long)c * D;
  float* ph = st.p_half + (long long)c * D;
  float* un = u_next + (long long)c * D;
  for (int d = 0; d < D; ++d) {
    const float p = addcmul(e[D + d], he, e[2 * D + d]);
    ph[d] = p;
    un[d] = addcmul(e[d], eim[d], p);
  }
}

// store_slot >= 0 at an even leaf (the checkpoint slot), else -1; idx_min..idx_max the slots of the U-turn
// test at an odd leaf (idx_min = -1 at an even one); flag_slot the byte of st.flag that takes any(live).
// Thread c of the grid takes chains c, c + the grid's threads, ...
__global__ void __launch_bounds__(MAX_THREADS) nuts_leaf_kernel(SdmNutsLeafState st, const float* u_new,
                                                                const float* logp_new, const float* g_new,
                                                                const float* uni, float* u_next, int store_slot,
                                                                int idx_min, int idx_max, int flag_slot) {
  const int D = st.D, S = st.S;
  int any_live = 0;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < st.C; c += gridDim.x * blockDim.x) {
    const long long cd = (long long)c * D;
    const float he = st.half_e[c];
    const float* im = st.inv_mass + cd;
    const float* gn = g_new + cd;
    const float* un = u_new + cd;
    float* ph = st.p_half + cd;
    float* rho = st.rho + cd;
    const auto p_new = [&](int d) { return addcmul(ph[d], he, gn[d]); };

    // Energy error, leaf weight and the multinomial take.
    // The plain path sums (C, D) for the energy and (C, k, D) for the k slots of the U-turn tests.
    const float kinetic = mul(0.5f, torch_order_sum(D, c, [&](int d) {
      const float p = p_new(d);
      return mul(mul(p, p), im[d]);
    }));
    float delta = sub(sub(kinetic, logp_new[c]), st.H0[c]);
    if (isnan(delta)) delta = INFINITY;  // nan_to_num(nan=inf, posinf=inf, neginf=-inf)
    const float leaf_log_w = -delta;
    const float new_log_w = log_add_exp(st.log_w[c], leaf_log_w);
    const bool live = st.live[c] != 0;
    const bool take = live && logf(uni[c]) < sub(leaf_log_w, new_log_w);

    // U-turn tests of the aligned segments that end at this (odd) leaf.
    bool leaf_turning = false;
    const int k = idx_max - idx_min + 1;
    for (int s = idx_min; s >= 0 && s <= idx_max; ++s) {
      const long long row = (long long)c * k + (s - idx_min);
      const float* rck = st.r_ckpts + ((long long)c * S + s) * D;
      const float* rsk = st.rsum_ckpts + ((long long)c * S + s) * D;
      const auto rho_seg = [&](int d) { return sub(add(rho[d], p_new(d)), rsk[d]); };
      const float a = torch_order_sum(D, row, [&](int d) { return mul(mul(rck[d], im[d]), rho_seg(d)); });
      const float b = torch_order_sum(D, row, [&](int d) { return mul(mul(p_new(d), im[d]), rho_seg(d)); });
      leaf_turning = leaf_turning || a <= 0.0f || b <= 0.0f;
    }

    // The state, then the next leaf's half step from the updated edge.
    const int E = 3 * D + 1, P = 2 * D + 1;
    float* edge = st.edge + (long long)c * E;
    float* prop = st.prop + (long long)c * P;
    float* r_store = store_slot >= 0 ? st.r_ckpts + ((long long)c * S + store_slot) * D : nullptr;
    float* rsum_store = store_slot >= 0 ? st.rsum_ckpts + ((long long)c * S + store_slot) * D : nullptr;
    for (int d = 0; d < D; ++d) {
      const float p = p_new(d);
      const float r = rho[d];
      if (live) {
        if (r_store != nullptr) {
          r_store[d] = p;
          rsum_store[d] = r;
        }
        edge[d] = un[d];
        edge[D + d] = p;
        edge[2 * D + d] = gn[d];
        rho[d] = add(r, p);
      }
      if (take) {
        prop[d] = un[d];
        prop[D + d] = gn[d];
      }
    }
    if (live) {
      edge[3 * D] = logp_new[c];
      st.log_w[c] = new_log_w;
    }
    if (take) prop[2 * D] = logp_new[c];
    st.sum_accept[c] = add(st.sum_accept[c], live ? fminf(expf(-delta), 1.0f) : 0.0f);
    st.n_leaves[c] += live ? 1 : 0;
    const bool turning = st.turning[c] != 0 || (live && leaf_turning);
    const bool diverging = st.diverging[c] != 0 || (live && delta > MAX_DELTA_ENERGY);
    const bool still = live && !(turning || diverging);
    st.turning[c] = turning;
    st.diverging[c] = diverging;
    st.live[c] = still;
    any_live |= still;
    half_step(st, c, u_next);
  }
  any_live = __syncthreads_or(any_live);
  if (threadIdx.x == 0) {
    if (any_live) atomicOr(&st.any_live[0], 1u);
    __threadfence();
    if (atomicAdd(&st.any_live[1], 1u) == gridDim.x - 1) {  // the last block: every other block's or is in
      st.flag[flag_slot] = atomicExch(&st.any_live[0], 0u) ? 1 : 0;
      st.any_live[1] = 0;
      __threadfence_system();
    }
  }
}

// A thread a chain: one block of C threads rounded up to a warp, or blocks of MAX_THREADS.
dim3 blocks_for(int C, int* threads) {
  const int t = ((C + 31) / 32) * 32;
  *threads = t < 32 ? 32 : t < MAX_THREADS ? t : MAX_THREADS;
  const int blocks = (C + *threads - 1) / *threads;
  return dim3(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

const char* sdm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The device's address of pinned host memory (the sampler's flag bytes), into *dev.
int sdm_host_device_pointer(void* host, void** dev) { return (int)cudaHostGetDevicePointer(dev, host, 0); }

// Leaf n's body after its potential call. st: one subtree's state (SdmNutsLeafState above, every pointer on the
// current device); u_new, g_new (C, D), logp_new, uni (C,) float32 on the device; u_next (C, D) takes the next
// leaf's position. The slots are as nuts_leaf_kernel takes them.
int sdm_nuts_leaf(const SdmNutsLeafState* st, const float* u_new, const float* logp_new, const float* g_new,
                  const float* uni, float* u_next, int store_slot, int idx_min, int idx_max, int flag_slot,
                  void* stream) {
  if (store_slot >= st->S || idx_max >= st->S || flag_slot < 0 || flag_slot > 1) return (int)cudaErrorInvalidValue;
  int threads;
  const dim3 grid = blocks_for(st->C, &threads);
  nuts_leaf_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(*st, u_new, logp_new, g_new, uni, u_next, store_slot,
                                                                idx_min, idx_max, flag_slot);
  return (int)cudaGetLastError();
}

}  // extern "C"
