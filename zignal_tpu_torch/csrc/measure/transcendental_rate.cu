// Throughput of the f32 transcendentals the port's kernels call, for the
// bounds of K1, K3 and K3p in chip_smoke.py. Measurement only: the package
// neither builds nor calls it; `python3 chip_smoke.py --ops` does.
//
// Each thread runs kChains independent chains of kIters steps,
// v = f(v) * 0.5 + 0.25, on values that stay in [0.25, 0.75] (positive and
// normal, as the kernels' roots and gamma curves mostly see them), and the
// grid fills every SM several times over, so the calls issue back to back
// and the time is the function's issue cost, not its latency. A call's cost
// is the time of f's loop less that of the same loop with f the identity,
// over the calls.
//
// f: 0 the identity, 1 cbrtf (the cube root of K1's Oklab epilogue, K3 and
// K3p), 2 powf with a runtime exponent (K3's output gamma and K3p), 3
// sign(x) * powf(|x|, e) (the cube root of the plain version and of K3's
// first design, for comparison). IEEE forms: the file is built without fast
// math, as the kernels are.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;
constexpr int kIters = 256;

template <int F>
__global__ void __launch_bounds__(kThreads)
rate_kernel(const float* __restrict__ x, float* __restrict__ y, float e) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float v[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) v[c] = x[(i * kChains + c) & 4095];
  for (int t = 0; t < kIters; ++t) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      float f = v[c];
      if constexpr (F == 1) f = cbrtf(f);
      if constexpr (F == 2) f = powf(f, e);
      if constexpr (F == 3) f = copysignf(powf(fabsf(f), e), f);
      v[c] = fmaf(f, 0.5f, 0.25f);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += v[c];
  y[i] = s;
}

}  // namespace

extern "C" {

// Calls of f a launch: blocks * kThreads * kChains * kIters.
long long zt_rate_calls(int blocks) {
  return (long long)blocks * kThreads * kChains * kIters;
}

// x: 4096 f32 values in [0.25, 0.75]; y: blocks * kThreads f32. Returns a
// cudaError_t.
int zt_rate(int f, const void* x, void* y, float e, int blocks,
            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float*>(x);
  auto* out = static_cast<float*>(y);
  switch (f) {
    case 0:
      rate_kernel<0><<<blocks, kThreads, 0, s>>>(in, out, e);
      break;
    case 1:
      rate_kernel<1><<<blocks, kThreads, 0, s>>>(in, out, e);
      break;
    case 2:
      rate_kernel<2><<<blocks, kThreads, 0, s>>>(in, out, e);
      break;
    case 3:
      rate_kernel<3><<<blocks, kThreads, 0, s>>>(in, out, e);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
