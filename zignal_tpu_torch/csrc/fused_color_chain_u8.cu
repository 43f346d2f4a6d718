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
// What bounds it on this card: its transcendentals, not HBM (6 B a pixel,
// 25 MB and 7.5 us at B=4 of 1024^2 at 3.35 TB/s). On the bench chain (rgb,
// lab, rgb, oklch, rgb, xyb, rgb) a pixel takes 9 cube roots, 3 channels of
// gamma in and out and 238 f32 ops of mixes, scalings, compares and clips.
// With every SM busy a powf costs ~166 f32 ops of issue time and a cbrtf
// ~50 (chip_smoke.py --ops). In the first design (one thread a pixel, every
// root a powf) a root cost ~230 and a channel's gamma ~420 (chip_smoke.py
// --times, chains of growing length; PERF.md). So this design:
// - takes the input gamma from a 256-entry f32 table in shared memory: the
//   first step of every supported chain acts on u8 / 255, so it has 256
//   values, which the wrapper computes once a device with the plain
//   version's own ops (bit-identical by construction); a chain that does
//   not start with it takes the computed path;
// - takes the cube roots with the card's cbrtf (1 ulp) instead of
//   sign(x) * powf(|x|, 1/3), for a fraction of a powf;
// - keeps the output gamma as IEEE powf;
// - runs kPix = 4 pixels a thread, so each thread has 4 independent root
//   chains to interleave and reads its 12 bytes as three 32-bit words (and
//   writes them back the same way) where the batch is 4-byte aligned.
//
// The chain: the host walks convert_chain's state machine and passes at most
// kMaxSteps step codes in the kernel's parameters (ops/color_chain.py:
// compile_chain). Every thread runs the same steps, so warps do not diverge
// on them, and each step runs on the thread's 4 pixels in turn.
//
// Exactness: the arithmetic is the plain version's (ops/color_chain.py:
// fused_color_chain_u8_reference) as PyTorch runs it on the card, op for op,
// but for the cube root. The chain is ill-conditioned where a channel is
// dark: a linear value near 0 is a difference of matrix terms near 1, and
// the gamma curve then multiplies its error by 12.92, so a one-ulp change in
// a root moves the f32 output by up to ~1e-4 (9.24e-5 over all 2^24 RGB
// triples of the six chains chip_smoke.py checks): that is the kernel's
// stated f32 bound against the plain version (CHAIN_UNIT in
// tests/test_torch_kernels.py and chip_smoke.py), and every u8 output stays
// equal to the plain version's. Otherwise:
// - powf, IEEE (no fast math), with the f32 exponents PyTorch passes;
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

constexpr int kThreads = 256;  // also the gamma table's length
constexpr int kMaxSteps = 64;
constexpr int kPix = 4;  // pixels a thread of K3

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
// the real cube root: the card's cbrtf (1 ulp), not the plain version's
// sign(x) * pow(|x|, f32(1/3)), which costs as much as a powf
__device__ __forceinline__ float cbrt_(float x) { return cbrtf(x); }
__device__ __forceinline__ float cube(float x) { return mul(mul(x, x), x); }
__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}
// clip(round(f * 255)) as u8, rounding half to even as torch.round does
__device__ __forceinline__ uint8_t quantize(float f) {
  return (uint8_t)fminf(fmaxf(rintf(mul(f, 255.0f)), 0.0f), 255.0f);
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
  return t > k[LAB_EPSILON] ? cbrt_(t)
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
  v[0] = cbrt_(v[0]);
  v[1] = cbrt_(v[1]);
  v[2] = cbrt_(v[2]);
  mix3(v, p.m[OKLMS2LAB]);
}

__device__ __forceinline__ void linrgb_to_xyb(float v[3],
                                              const ChainParams& p) {
  mix3(v, p.m[LINRGB2XYBMIX]);
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    d[c] = sub(cbrt_(fmaxf(add(v[c], p.k[XYB_BIAS]), 0.0f)),
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

// One step of the chain on P pixels: each case runs the step on every
// pixel, so a thread's P chains are independent work to interleave.
template <int P>
__device__ __forceinline__ void run_step(int step, float (&vs)[P][3],
                                         const ChainParams& p) {
  const float* k = p.k;
  switch (step) {
    case GAMMA_TO_LINEAR:
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int c = 0; c < 3; ++c) vs[q][c] = gamma_to_linear(vs[q][c], k);
      break;
    case LINEAR_TO_GAMMA:
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          vs[q][c] = clip01(linear_to_gamma(vs[q][c], k));
      break;
    case LIN_TO_XYZ:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        mix3(v, p.m[RGB2XYZ]);
        scale3(v, 100.0f);
      }
      break;
    case LIN_TO_LAB:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        mix3(v, p.m[RGB2XYZ]);
        scale3(v, 100.0f);
        xyz_to_lab(v, k);
      }
      break;
    case LIN_TO_OKLAB:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        mix3(v, p.m[RGB2OKLMS]);
        oklms_to_oklab(v, p);
      }
      break;
    case LIN_TO_XYB:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        linrgb_to_xyb(v, p);
      }
      break;
    case XYZ_TO_LIN:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        scale3(v, k[INV_100]);
        mix3(v, p.m[XYZ2RGB]);
        clip3(v);
      }
      break;
    case LAB_TO_LIN:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        lab_to_xyz(v, k);
        scale3(v, k[INV_100]);
        mix3(v, p.m[XYZ2RGB]);
        clip3(v);
      }
      break;
    case OKLAB_TO_LIN:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        mix3(v, p.m[OKLAB2LMS]);
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = cube(v[c]);
        mix3(v, p.m[OKLMS2RGB]);
        clip3(v);
      }
      break;
    case XYB_TO_LIN:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        xyb_to_linrgb(v, p);
        clip3(v);
      }
      break;
    case SHADOW:  // entering lch/oklch: the cartesian values stay as they are
      break;
    case XYZ_TO_LAB:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        xyz_to_lab(v, k);
      }
      break;
    case LAB_TO_XYZ:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        lab_to_xyz(v, k);
      }
      break;
    case XYZ_TO_OKLAB:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        scale3(v, k[INV_100]);
        mix3(v, p.m[XYZ2OKLMS]);
        oklms_to_oklab(v, p);
      }
      break;
    case OKLAB_TO_XYZ:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        mix3(v, p.m[OKLAB2LMS]);
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = cube(v[c]);
        mix3(v, p.m[OKLMS2XYZ]);
        scale3(v, 100.0f);
      }
      break;
    case XYZ_TO_XYB:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        mix3(v, p.m[XYZ2RGB]);
        scale3(v, k[INV_100]);
        linrgb_to_xyb(v, p);
      }
      break;
    case XYB_TO_XYZ:
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float* v = vs[q];
        xyb_to_linrgb(v, p);
        mix3(v, p.m[RGB2XYZ]);
        scale3(v, 100.0f);
      }
      break;
    default:  // the host validates the codes; an unknown one poisons the pixel
#pragma unroll
      for (int q = 0; q < P; ++q)
        vs[q][0] = vs[q][1] = vs[q][2] = __int_as_float(0x7fc00000);
      break;
  }
}

// Loads pixel q of a group from 3 bytes at s, through the gamma table when
// the chain's first step is the input gamma (LUT), else as u8 / 255.
template <bool LUT>
__device__ __forceinline__ void load_px(const uint8_t* s, float v[3],
                                        const float* lut,
                                        const ChainParams& p) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = LUT ? lut[s[c]] : mul((float)s[c], p.k[INV_255]);
}

template <bool QUANTIZE>
__device__ __forceinline__ void store_px(void* dst, long long i,
                                         const float v[3]) {
  if constexpr (QUANTIZE) {
    uint8_t* d = static_cast<uint8_t*>(dst) + 3 * i;
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = quantize(v[c]);
  } else {
    float* d = static_cast<float*>(dst) + 3 * i;
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = v[c];
  }
}

// K3: kPix pixels a thread, grid-stride over the groups of kPix pixels of
// the B * H * W; the last n % kPix pixels go one at a time. With `vec`
// (src 4-byte and dst 16-byte aligned) a group's 12 bytes are read as
// three 32-bit words and written back the same way (or as three float4).
template <bool QUANTIZE, bool LUT>
__global__ void __launch_bounds__(kThreads)
color_chain_kernel(const uint8_t* __restrict__ src, void* __restrict__ dst,
                   const float* __restrict__ lut_g, long long n, int vec,
                   const __grid_constant__ ChainParams p) {
  __shared__ float lut[256];
  if constexpr (LUT) {
    lut[threadIdx.x] = lut_g[threadIdx.x];
    __syncthreads();
  }
  const int first = LUT ? 1 : 0;  // the table took the first step
  const long long groups = n / kPix;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < groups; g += stride) {
    union {
      uint32_t w[3];
      uint8_t b[12];
    } in;
    const uint8_t* s = src + 12 * g;
    if (vec) {
      const uint32_t* s4 = reinterpret_cast<const uint32_t*>(s);
      in.w[0] = s4[0];
      in.w[1] = s4[1];
      in.w[2] = s4[2];
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) in.b[j] = s[j];
    }
    float v[kPix][3];
#pragma unroll
    for (int q = 0; q < kPix; ++q) load_px<LUT>(in.b + 3 * q, v[q], lut, p);
    for (int t = first; t < p.n_steps; ++t) run_step<kPix>(p.step[t], v, p);
    if constexpr (QUANTIZE) {
      union {
        uint32_t w[3];
        uint8_t b[12];
      } out;
#pragma unroll
      for (int q = 0; q < kPix; ++q)
#pragma unroll
        for (int c = 0; c < 3; ++c) out.b[3 * q + c] = quantize(v[q][c]);
      uint8_t* d = static_cast<uint8_t*>(dst) + 12 * g;
      if (vec) {
        uint32_t* d4 = reinterpret_cast<uint32_t*>(d);
        d4[0] = out.w[0];
        d4[1] = out.w[1];
        d4[2] = out.w[2];
      } else {
#pragma unroll
        for (int j = 0; j < 12; ++j) d[j] = out.b[j];
      }
    } else {
      float* d = static_cast<float*>(dst) + 12 * g;
      if (vec) {
        float4* d4 = reinterpret_cast<float4*>(d);
        d4[0] = make_float4(v[0][0], v[0][1], v[0][2], v[1][0]);
        d4[1] = make_float4(v[1][1], v[1][2], v[2][0], v[2][1]);
        d4[2] = make_float4(v[2][2], v[3][0], v[3][1], v[3][2]);
      } else {
#pragma unroll
        for (int q = 0; q < kPix; ++q)
#pragma unroll
          for (int c = 0; c < 3; ++c) d[3 * q + c] = v[q][c];
      }
    }
  }
  // the tail: one thread a pixel
  const long long tail = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (tail < n - groups * kPix) {
    const long long i = groups * kPix + tail;
    float v[1][3];
    load_px<LUT>(src + 3 * i, v[0], lut, p);
    for (int t = first; t < p.n_steps; ++t) run_step<1>(p.step[t], v, p);
    store_px<QUANTIZE>(dst, i, v[0]);
  }
}

// K3p: where(x > 0.5, cbrt(x) + x^2.4, x^(1/2.4) + x^3) through K3's
// helpers, so it checks the card's transcendentals exactly as K3 runs them.
// It replaces zignal_tpu/ops/pallas_color.py: mosaic_transcendentals_ok.
//
// What bounds it: a value costs one powf (~166 f32 ops of issue time) and,
// above 0.5, a cbrtf (~50), against 8 bytes moved, so the transcendentals
// bound it, and at 1M values (~3 us of work) a launch that is not one full
// wave leaves SMs idle behind its last blocks. So a thread takes kProbe = 4
// values, four independent powf chains for the scheduler to interleave,
// read (and written, where y allows it) as one float4: the first values up
// to x's 16-byte boundary (the head, at most 3) and the last whole group's
// remainder (the tail, at most 3) go one a thread. The grid is one resident
// wave, SMs x the blocks a SM holds, looping over the groups beyond it.
// Both branches take one powf, so the exponent is selected and the powf
// runs on every lane; the sum is the same either way round (IEEE addition
// commutes).
constexpr int kProbe = 4;

// e_hi, e_lo: the exponents 2.4 and 1 / 2.4 as ChainParams holds them
__device__ __forceinline__ float probe_value(float v, float e_hi, float e_lo) {
  const bool hi = v > 0.5f;
  const float pw = pow_(v, hi ? e_hi : e_lo);
  return add(hi ? cbrt_(v) : cube(v), pw);
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ x, float* __restrict__ y, long long n,
             int head, int vec_y, const __grid_constant__ ChainParams p) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long groups = (n - head) / kProbe;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  const float e_hi = p.k[SRGB_GAMMA_EXPONENT];
  const float e_lo = p.k[SRGB_INV_GAMMA_EXPONENT];
  for (long long g = tid; g < groups; g += stride) {
    const float4 v = x4[g];
    const float4 r = make_float4(
        probe_value(v.x, e_hi, e_lo), probe_value(v.y, e_hi, e_lo),
        probe_value(v.z, e_hi, e_lo), probe_value(v.w, e_hi, e_lo));
    float* d = y + head + kProbe * g;
    if (vec_y) {
      *reinterpret_cast<float4*>(d) = r;
    } else {
      d[0] = r.x;
      d[1] = r.y;
      d[2] = r.z;
      d[3] = r.w;
    }
  }
  const long long tail = n - head - kProbe * groups;
  if (tid < head + tail) {
    const long long i = tid < head ? tid : tid + kProbe * groups;
    y[i] = probe_value(x[i], e_hi, e_lo);
  }
}

// the blocks of one resident wave of probe_kernel on the current device
cudaError_t probe_wave(unsigned* blocks) {
  static unsigned cached[64];  // by device ordinal; 0 until asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, probe_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = (unsigned)(sms * (per_sm < 1 ? 1 : per_sm));
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : (b < (1LL << 20) ? b : (1LL << 20)));
}

template <bool QUANTIZE>
int launch_chain(const uint8_t* src, void* dst, const float* lut,
                 long long n, int vec, const ChainParams& p,
                 cudaStream_t s) {
  const unsigned blocks = blocks_for(n / kPix);
  if (lut)
    color_chain_kernel<QUANTIZE, true><<<blocks, kThreads, 0, s>>>(
        src, dst, lut, n, vec, p);
  else
    color_chain_kernel<QUANTIZE, false><<<blocks, kThreads, 0, s>>>(
        src, dst, lut, n, vec, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int zt_color_chain_params_bytes() { return (int)sizeof(ChainParams); }

// Returns a cudaError_t: 0 when the launch was accepted. The caller checks
// dtype, shape and contiguity, allocates dst and compiles the chain. lut:
// the 256 f32 values of the chain's first step, the input gamma, on the
// bytes 0..255 (the wrapper computes them with the plain version's ops),
// or null when the chain does not start with it; vec: src is 4-byte and
// dst 16-byte aligned.
int zt_fused_color_chain_u8(const void* src, void* dst, const void* lut,
                            const void* params, long long n, int quantize,
                            int vec, void* stream) {
  ChainParams p;
  memcpy(&p, params, sizeof(p));
  if (p.n_steps < 0 || p.n_steps > kMaxSteps) return cudaErrorInvalidValue;
  if (lut && (p.n_steps < 1 || p.step[0] != GAMMA_TO_LINEAR))
    return cudaErrorInvalidValue;
  if (n < 1) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  const auto* table = static_cast<const float*>(lut);
  if (quantize) return launch_chain<true>(in, dst, table, n, vec, p, s);
  return launch_chain<false>(in, dst, table, n, vec, p, s);
}

int zt_transcendentals_probe(const void* x, void* y, const void* params,
                             long long n, void* stream) {
  ChainParams p;
  memcpy(&p, params, sizeof(p));
  if (n < 1) return cudaSuccess;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  if (xa % 4 || ya % 4) return cudaErrorMisalignedAddress;
  long long head = (long long)((16 - xa % 16) % 16 / 4);
  if (head > n) head = n;
  const int vec_y = (ya + 4 * head) % 16 == 0;
  const long long groups = (n - head) / kProbe;
  // one wave at most, and no more blocks than the groups (and the head and
  // tail values, at most 6) need
  const long long need = blocks_for(groups > 6 ? groups : 6);
  unsigned wave = 0;
  const cudaError_t err = probe_wave(&wave);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(need < wave ? need : wave);
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, (int)head,
      vec_y, p);
  return cudaGetLastError();
}

}  // extern "C"
