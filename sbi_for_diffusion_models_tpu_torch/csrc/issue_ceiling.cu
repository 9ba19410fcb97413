// K4: the issue-ceiling microkernel, one thread per element.
//
// Replaces the Pallas TPU kernel of benchmarks/roofline.py (`kernel`, built by
// vpu_ceiling) and computes what it computes: every element of x runs a serial
// chain of K operations, K / 8 turns of an 8-operation body, and the result is
// written to out. Two bodies:
//   fma:             x = x * c + d, eight times (c = 1.0000001f, d = 1e-7f);
//   transcendental:  x = exp(x * 1e-3); x = log(x + 1.5); x = sqrt(x * x + 0.25);
//                    x = sin(x); x = x * 1.0001 + 1e-6; x = max(x, -10);
//                    x = min(x, 10); x = x + 1e-6.
// The kernel exists to be timed: (K_hi - K_lo) operations per element over the
// time difference of two chain lengths is the rate at which the card issues
// dependent FP32 work, the achievable ceiling the other kernels' demand is
// stated against (roofline.py in the package).
//
// What bounds it on the card: operations. An element is read once and written
// once (8 bytes) and runs up to 131,072 dependent operations in a register.
// The TPU kernel walks a grid of (1, R, 128) tiles held in VMEM; here the
// element lives in one register of one thread for the whole chain. One thread
// per element, not several elements per thread: the chain of one element is
// serial by data dependence (4 cycles between dependent FMAs), and what hides
// that latency is other warps. 2,097,152 elements in blocks of 256 threads
// keep 64 warps resident on every SM, 16 for each of its four schedulers,
// four times what the FMA latency needs, so more independent chains per thread
// would add registers and nothing else. A small test shape does not fill the
// card: only the full shape is timed.
//
// What is issued: the fma body is eight fmaf calls, one FFMA each. The chain
// length is a kernel argument, so the compiler cannot fold the chain, and
// without fast math it may not reassociate it. The loop over turns is unrolled
// four times, which spreads the loop's counter and branch over 32 chained
// operations; the chain itself is unchanged. The transcendental body calls the
// accurate expf, logf, sqrtf and sinf (no --use_fast_math, no __expf-style
// intrinsics), and its products and sums are written with __fmul_rn/__fadd_rn
// so that none is contracted: the plain PyTorch version rounds each on its
// own. The fma body does contract, on purpose (an FMA rounds once where the
// plain version rounds twice), so over K steps it drifts from the plain
// version by up to one ulp a step; the checks hold it to a float64 evaluation
// with a tolerance that grows with K. This file is not built with
// --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int KIND_FMA = 0;
constexpr int KIND_TRANSCENDENTAL = 1;
constexpr int THREADS = 256;

__device__ __forceinline__ float body8_fma(float x) {
  const float c = 1.0000001f, d = 1e-7f;
#pragma unroll
  for (int i = 0; i < 8; ++i) x = fmaf(x, c, d);
  return x;
}

__device__ __forceinline__ float body8_transcendental(float x) {
  x = expf(__fmul_rn(x, 1e-3f));
  x = logf(__fadd_rn(x, 1.5f));
  x = sqrtf(__fadd_rn(__fmul_rn(x, x), 0.25f));
  x = sinf(x);
  x = __fadd_rn(__fmul_rn(x, 1.0001f), 1e-6f);
  x = fmaxf(x, -10.0f);
  x = fminf(x, 10.0f);
  x = __fadd_rn(x, 1e-6f);
  return x;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS) issue_ceiling_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long n, int turns) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 4
  for (int t = 0; t < turns; ++t) {
    v = KIND == KIND_FMA ? body8_fma(v) : body8_transcendental(v);
  }
  out[i] = v;
}

}  // namespace

extern "C" {

const char* sdm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// x, out: n float32 values, contiguous, on the current device (out may be x).
// turns = K / 8 turns of the 8-operation body; kind 0 = fma, 1 = transcendental.
int sdm_issue_ceiling(const float* x, float* out, long long n, int turns, int kind, void* stream) {
  if (n <= 0) return 0;
  if (kind != KIND_FMA && kind != KIND_TRANSCENDENTAL) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == KIND_FMA) {
    issue_ceiling_kernel<KIND_FMA><<<(unsigned)blocks, THREADS, 0, s>>>(x, out, n, turns);
  } else {
    issue_ceiling_kernel<KIND_TRANSCENDENTAL><<<(unsigned)blocks, THREADS, 0, s>>>(x, out, n, turns);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
