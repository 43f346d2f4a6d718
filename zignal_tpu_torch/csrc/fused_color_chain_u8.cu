// The fused u8 colour chain (BASELINE config 2) and its transcendental
// probe, for sm_90a.
//
// K3 replaces the TPU kernel zignal_tpu/ops/pallas_color.py:
// fused_color_chain_u8 (math `_chain_planar_u8` with the exact profile). It
// computes u8 / 255 -> color.convert_chain over rgb, xyz, lab, lch, oklab,
// oklch and xyb -> clip(round(f * 255)), with linear RGB carried across rgb
// junctions and cylindrical spaces held as their cartesian shadow. None of
// the TPU machinery carries over: no planar split (threads read the
// interleaved [B, H, W, 3] bytes), no exp/log + Newton roots (the card's
// powf is IEEE), no lane-multiple gate (any B, H, W >= 1).
//
// What bounds it on this card: compute, not HBM. On the bench chain
// (rgb, lab, rgb, oklch, rgb, xyb, rgb) a pixel costs 6 powf, 9 cube roots
// (each a powf) and ~100 multiply-adds, against an HBM floor of 6 B/px (3 read, 3 written):
// 25 MB and 7.5 us at B=4 of 1024^2 at 3.35 TB/s. The design keeps the f32
// chain values in registers: one thread per pixel in a grid-stride loop,
// reading 3 bytes and writing 3 (or 12 bytes of f32 when quantize == 0).
//
// The chain: the host walks convert_chain's state machine and passes at most
// kMaxSteps step codes by value (ops/color_chain.py:compile_chain). Every
// thread runs the same steps, so warps do not diverge on them.
//
// Exactness: the arithmetic is the plain version's (ops/color_chain.py:
// fused_color_chain_u8_reference) as PyTorch runs it on the card, op for op,
// because the chain is ill-conditioned where a channel is dark: a linear
// value near 0 is a difference of matrix terms near 1, and the gamma curve
// then multiplies its error by 12.92, so a one-ulp change in a root moves
// the f32 output by up to ~5e-5 (PERF.md). So:
// - powf, IEEE (no fast math), with the f32 exponents PyTorch passes;
// - the cube root as the plain version takes it, sign(x) * powf(|x|, 1/3f);
// - a division by a constant is a multiplication by its reciprocal 1 / c
//   rounded to f32, which is how PyTorch divides a CUDA tensor by a Python
//   scalar;
// - cubes as (c*c)*c, the 3x3 mixes in _mix3's order, every multiply and add
//   written as __fmul_rn/__fadd_rn so that nvcc's default contraction into
//   FMAs does not move the result;
// - the quantization rounds half to even (rintf), as torch.round does.
// The matrices and scalars come from the host, rounded to f32 as the plain
// version rounds them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSteps = 64;

enum Step : int {
  GAMMA_TO_LINEAR = 0,
  LINEAR_TO_GAMMA,
  LIN_TO_XYZ,
  LIN_TO_LAB,
  LIN_TO_OKLAB,
  LIN_TO_XYB,
  XYZ_TO_LIN,
  LAB_TO_LIN,
  OKLAB_TO_LIN,
  XYB_TO_LIN,
  SHADOW,
  XYZ_TO_LAB,
  LAB_TO_XYZ,
  XYZ_TO_OKLAB,
  OKLAB_TO_XYZ,
  XYZ_TO_XYB,
  XYB_TO_XYZ,
};

enum Matrix : int {
  RGB2XYZ = 0,
  XYZ2RGB,
  RGB2OKLMS,
  OKLMS2LAB,
  OKLAB2LMS,
  OKLMS2RGB,
  LINRGB2XYBMIX,
  XYBMIX2LINRGB,
  XYZ2OKLMS,
  OKLMS2XYZ,
  kMatrices,
};

// INV_x is the reciprocal 1 / x rounded to f32 (see Exactness above)
enum Scalar : int {
  SRGB_GAMMA_THRESHOLD = 0,
  SRGB_GAMMA_OFFSET,
  SRGB_GAMMA_SCALE,
  INV_SRGB_GAMMA_SCALE,
  SRGB_LINEAR_SLOPE,
  INV_SRGB_LINEAR_SLOPE,
  SRGB_GAMMA_EXPONENT,
  SRGB_INV_GAMMA_EXPONENT,
  SRGB_LINEAR_THRESHOLD,
  D65_X,
  D65_Y,
  D65_Z,
  INV_D65_X,
  INV_D65_Y,
  INV_D65_Z,
  LAB_EPSILON,
  LAB_KAPPA_DIV_116,
  INV_LAB_KAPPA_DIV_116,
  LAB_DELTA,
  XYB_BIAS,
  XYB_CBRT_BIAS_ENCODE,
  XYB_CBRT_BIAS_DECODE,
  ONE_THIRD,
  INV_255,
  INV_100,
  INV_116,
  INV_500,
  INV_200,
  kScalars,
};

// Passed by value: it lives in the kernel's parameter space, which every
// thread reads at the same address.
struct ChainParams {
  int n_steps;
  int step[kMaxSteps];
  float m[kMatrices][9];  // (in, out), row-major
  float k[kScalars];
};

// -- the helpers K3 and K3p share ---------------------------------------------

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float pow_(float x, float p) { return powf(x, p); }
// torch.sign(x) * x.abs().pow(1/3): the real cube root
__device__ __forceinline__ float cbrt_(float x, const float* k) {
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return mul(sign, pow_(fabsf(x), k[ONE_THIRD]));
}
__device__ __forceinline__ float cube(float x) { return mul(mul(x, x), x); }
__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// out[j] = v0 * m[0][j] + v1 * m[1][j] + v2 * m[2][j], left to right
__device__ __forceinline__ void mix3(float v[3], const float* m) {
  float o[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    o[j] = add(add(mul(v[0], m[j]), mul(v[1], m[3 + j])), mul(v[2], m[6 + j]));
  v[0] = o[0];
  v[1] = o[1];
  v[2] = o[2];
}

__device__ __forceinline__ void scale3(float v[3], float s) {
  v[0] = mul(v[0], s);
  v[1] = mul(v[1], s);
  v[2] = mul(v[2], s);
}

__device__ __forceinline__ void clip3(float v[3]) {
  v[0] = clip01(v[0]);
  v[1] = clip01(v[1]);
  v[2] = clip01(v[2]);
}

__device__ __forceinline__ float gamma_to_linear(float c, const float* k) {
  return c > k[SRGB_GAMMA_THRESHOLD]
             ? pow_(mul(add(c, k[SRGB_GAMMA_OFFSET]), k[INV_SRGB_GAMMA_SCALE]),
                    k[SRGB_GAMMA_EXPONENT])
             : mul(c, k[INV_SRGB_LINEAR_SLOPE]);
}

__device__ __forceinline__ float linear_to_gamma(float c, const float* k) {
  const float c_safe = fmaxf(c, 0.0f);
  return c > k[SRGB_LINEAR_THRESHOLD]
             ? sub(mul(k[SRGB_GAMMA_SCALE],
                       pow_(c_safe, k[SRGB_INV_GAMMA_EXPONENT])),
                   k[SRGB_GAMMA_OFFSET])
             : mul(c, k[SRGB_LINEAR_SLOPE]);
}

__device__ __forceinline__ float lab_f(float t, const float* k) {
  return t > k[LAB_EPSILON] ? cbrt_(t, k)
                            : add(mul(k[LAB_KAPPA_DIV_116], t), k[LAB_DELTA]);
}

__device__ __forceinline__ void xyz_to_lab(float v[3], const float* k) {
  const float fx = lab_f(mul(v[0], k[INV_D65_X]), k);
  const float fy = lab_f(mul(v[1], k[INV_D65_Y]), k);
  const float fz = lab_f(mul(v[2], k[INV_D65_Z]), k);
  v[0] = fmaxf(sub(mul(116.0f, fy), 16.0f), 0.0f);
  v[1] = mul(500.0f, sub(fx, fy));
  v[2] = mul(200.0f, sub(fy, fz));
}

__device__ __forceinline__ float lab_unf(float f, const float* k) {
  const float f3 = cube(f);
  return f3 > k[LAB_EPSILON]
             ? f3
             : mul(sub(f, k[LAB_DELTA]), k[INV_LAB_KAPPA_DIV_116]);
}

__device__ __forceinline__ void lab_to_xyz(float v[3], const float* k) {
  const float fy = mul(add(v[0], 16.0f), k[INV_116]);
  const float fx = add(mul(v[1], k[INV_500]), fy);
  const float fz = sub(fy, mul(v[2], k[INV_200]));
  v[0] = mul(lab_unf(fx, k), k[D65_X]);
  v[1] = mul(lab_unf(fy, k), k[D65_Y]);
  v[2] = mul(lab_unf(fz, k), k[D65_Z]);
}

// lms -> cbrt -> Oklab (the second half of rgb_to_oklab_fused/xyz_to_oklab)
__device__ __forceinline__ void oklms_to_oklab(float v[3],
                                               const ChainParams& p) {
  v[0] = cbrt_(v[0], p.k);
  v[1] = cbrt_(v[1], p.k);
  v[2] = cbrt_(v[2], p.k);
  mix3(v, p.m[OKLMS2LAB]);
}

__device__ __forceinline__ void linrgb_to_xyb(float v[3],
                                              const ChainParams& p) {
  mix3(v, p.m[LINRGB2XYBMIX]);
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    d[c] = sub(cbrt_(fmaxf(add(v[c], p.k[XYB_BIAS]), 0.0f), p.k),
               p.k[XYB_CBRT_BIAS_ENCODE]);
  v[0] = mul(0.5f, sub(d[0], d[1]));
  v[1] = mul(0.5f, add(d[0], d[1]));
  v[2] = d[2];
}

__device__ __forceinline__ void xyb_to_linrgb(float v[3],
                                              const ChainParams& p) {
  const float dec = p.k[XYB_CBRT_BIAS_DECODE], bias = p.k[XYB_BIAS];
  const float x = v[0], y = v[1], b = v[2];
  v[0] = sub(cube(add(add(y, x), dec)), bias);
  v[1] = sub(cube(add(sub(y, x), dec)), bias);
  v[2] = sub(cube(add(b, dec)), bias);
  mix3(v, p.m[XYBMIX2LINRGB]);
}

__device__ __forceinline__ void run_step(int step, float v[3],
                                         const ChainParams& p) {
  const float* k = p.k;
  switch (step) {
    case GAMMA_TO_LINEAR:
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = gamma_to_linear(v[c], k);
      break;
    case LINEAR_TO_GAMMA:
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = clip01(linear_to_gamma(v[c], k));
      break;
    case LIN_TO_XYZ:
      mix3(v, p.m[RGB2XYZ]);
      scale3(v, 100.0f);
      break;
    case LIN_TO_LAB:
      mix3(v, p.m[RGB2XYZ]);
      scale3(v, 100.0f);
      xyz_to_lab(v, k);
      break;
    case LIN_TO_OKLAB:
      mix3(v, p.m[RGB2OKLMS]);
      oklms_to_oklab(v, p);
      break;
    case LIN_TO_XYB:
      linrgb_to_xyb(v, p);
      break;
    case XYZ_TO_LIN:
      scale3(v, k[INV_100]);
      mix3(v, p.m[XYZ2RGB]);
      clip3(v);
      break;
    case LAB_TO_LIN:
      lab_to_xyz(v, k);
      scale3(v, k[INV_100]);
      mix3(v, p.m[XYZ2RGB]);
      clip3(v);
      break;
    case OKLAB_TO_LIN:
      mix3(v, p.m[OKLAB2LMS]);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = cube(v[c]);
      mix3(v, p.m[OKLMS2RGB]);
      clip3(v);
      break;
    case XYB_TO_LIN:
      xyb_to_linrgb(v, p);
      clip3(v);
      break;
    case SHADOW:  // entering lch/oklch: the cartesian values stay as they are
      break;
    case XYZ_TO_LAB:
      xyz_to_lab(v, k);
      break;
    case LAB_TO_XYZ:
      lab_to_xyz(v, k);
      break;
    case XYZ_TO_OKLAB:
      scale3(v, k[INV_100]);
      mix3(v, p.m[XYZ2OKLMS]);
      oklms_to_oklab(v, p);
      break;
    case OKLAB_TO_XYZ:
      mix3(v, p.m[OKLAB2LMS]);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = cube(v[c]);
      mix3(v, p.m[OKLMS2XYZ]);
      scale3(v, 100.0f);
      break;
    case XYZ_TO_XYB:
      mix3(v, p.m[XYZ2RGB]);
      scale3(v, k[INV_100]);
      linrgb_to_xyb(v, p);
      break;
    case XYB_TO_XYZ:
      xyb_to_linrgb(v, p);
      mix3(v, p.m[RGB2XYZ]);
      scale3(v, 100.0f);
      break;
    default:  // the host validates the codes; an unknown one poisons the pixel
      v[0] = v[1] = v[2] = __int_as_float(0x7fc00000);
      break;
  }
}

// K3: one thread per pixel, grid-stride over the B * H * W pixels.
template <bool QUANTIZE>
__global__ void __launch_bounds__(kThreads)
color_chain_kernel(const uint8_t* __restrict__ src, void* __restrict__ dst,
                   long long n, const ChainParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint8_t* s = src + 3 * i;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = mul((float)s[c], p.k[INV_255]);
    for (int t = 0; t < p.n_steps; ++t) run_step(p.step[t], v, p);
    if constexpr (QUANTIZE) {
      uint8_t* d = static_cast<uint8_t*>(dst) + 3 * i;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        d[c] = (uint8_t)fminf(fmaxf(rintf(mul(v[c], 255.0f)), 0.0f), 255.0f);
    } else {
      float* d = static_cast<float*>(dst) + 3 * i;
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = v[c];
    }
  }
}

// K3p: where(x > 0.5, cbrt(x) + x^2.4, x^(1/2.4) + x^3) through K3's
// helpers, so it checks the card's transcendentals exactly as K3 runs them.
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ x, float* __restrict__ y, long long n,
             const ChainParams p) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float v = x[i];
    y[i] = v > 0.5f ? add(cbrt_(v, p.k), pow_(v, p.k[SRGB_GAMMA_EXPONENT]))
                    : add(pow_(v, p.k[SRGB_INV_GAMMA_EXPONENT]), cube(v));
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < (1LL << 20) ? b : (1LL << 20));
}

}  // namespace

extern "C" {

int zt_color_chain_params_bytes() { return (int)sizeof(ChainParams); }

// Returns a cudaError_t: 0 when the launch was accepted. The caller checks
// dtype, shape and contiguity, allocates dst and compiles the chain.
int zt_fused_color_chain_u8(const void* src, void* dst, const void* params,
                            long long n, int quantize, void* stream) {
  ChainParams p;
  memcpy(&p, params, sizeof(p));
  if (p.n_steps < 0 || p.n_steps > kMaxSteps) return cudaErrorInvalidValue;
  if (n < 1) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  if (quantize)
    color_chain_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(in, dst, n, p);
  else
    color_chain_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(in, dst, n,
                                                                 p);
  return cudaGetLastError();
}

int zt_transcendentals_probe(const void* x, void* y, const void* params,
                             long long n, void* stream) {
  ChainParams p;
  memcpy(&p, params, sizeof(p));
  if (n < 1) return cudaSuccess;
  probe_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(
                                                 stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, p);
  return cudaGetLastError();
}

}  // extern "C"
