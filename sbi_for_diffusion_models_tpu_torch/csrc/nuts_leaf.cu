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
// reduction takes it over a contiguous last dimension (torch_order_sum, torch_order.cuh), its four-wide loads from D = 128 on
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

#include "torch_order.cuh"

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

constexpr float MAX_DELTA_ENERGY = 1000.0f;  // inference/nuts.py's _MAX_DELTA_ENERGY

// torch.addcmul(a, b, c) with value 1, rounded as PyTorch's CUDA kernel rounds it.
__device__ __forceinline__ float addcmul(float a, float b, float c) { return __fmaf_rn(b, c, a); }

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
