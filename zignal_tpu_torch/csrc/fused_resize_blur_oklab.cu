// Fused bilinear u8 resize -> 8.8 Gaussian blur -> optional sRGB->Oklab,
// for sm_90a.
//
// Replaces the TPU kernel zignal_tpu/ops/pallas_pipeline.py:
// fused_resize_blur_oklab. It computes what that kernel computes, not what
// its blocks do: the TPU version splits values into base-256 digits and runs
// bf16 banded matmuls only to get exact integers from the MXU; here the
// int32 ALUs are exact, so each stage is a plain gather-and-MAC.
//
// What should bound it on this card: memory. Per output pixel at the 4:1 pixel
// ratio of the main path (1024^2 -> 512^2, RGB) it reads 12 B of u8 input
// (3 B per source pixel) and writes 12 B of f32 Oklab, against roughly 100
// integer MACs and one powf/cbrtf per channel. The design keeps every
// intermediate out of device memory: one block owns one output tile of one
// image, resizes the tile plus a blur halo of r = ceil(3 sigma) into shared
// memory (recomputing the halo costs (T+2r)^2 / T^2 resize work, 1.9x at
// T=32, r=6), runs the width pass into int32 shared memory, then the height
// pass and the epilogue, and writes the tile once. Measured on an H100 SXM
// (700 W) at B=16: 0.18 ms, 16.7 % of the HBM roofline, while the resize
// stage alone reaches 55 %: the shared-memory blur passes, not HBM, are the
// limit of this first version (PERF.md).
//
// Exactness (bit-identical to the JAX package in every u8 stage):
// - resize: taps (256-f, f) per axis, sum <= 255 * 256 * 256 < 2^31, then a
//   truncating >> 16 (the sum is never negative);
// - blur: taps round(k * 256) >= 0 summing to at most 257, width pass
//   <= 255 * 257, height pass <= 255 * 257 * 257 ~= 1.7e7 < 2^31, then
//   (acc + 32768) >> 16 (divClampU8 for a non-negative accumulator);
// - borders: the host tables hold MIRROR-resolved positions for the whole
//   halo (ops/tables.py:halo_axis_table), so edge tiles and axes shorter than
//   the radius need no logic here.
// The Oklab epilogue is IEEE f32 (no fast math: powf and cbrtf, not __powf).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Bilinear u8 resize of one pixel, all C channels.
template <int C>
__device__ __forceinline__ void resize_px(const uint8_t* __restrict__ img,
                                          int W, const int* __restrict__ ty,
                                          int ny, int py,
                                          const int* __restrict__ tx, int nx,
                                          int px, int q[C]) {
  const int ya = ty[py], yb = ty[ny + py], fy = ty[2 * ny + py];
  const int xa = tx[px], xb = tx[nx + px], fx = tx[2 * nx + px];
  const uint8_t* ra = img + (size_t)ya * W * C;
  const uint8_t* rb = img + (size_t)yb * W * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int top = ra[xa * C + c] * (256 - fx) + ra[xb * C + c] * fx;
    const int bot = rb[xa * C + c] * (256 - fx) + rb[xb * C + c] * fx;
    q[c] = min((top * (256 - fy) + bot * fy) >> 16, 255);
  }
}

__device__ __forceinline__ float srgb_to_linear(int q) {
  const float c = (float)q / 255.0f;
  return c > 0.04045f ? powf((c + 0.055f) / 1.055f, 2.4f) : c / 12.92f;
}

// mix holds the two 3x3 matrices as (in, out), row-major: _RGB2OKLMS then
// _OKLMS2LAB (color/_array.py).
__device__ __forceinline__ void mix3(const float* __restrict__ m,
                                     const float in[3], float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = in[0] * m[j] + in[1] * m[3 + j] + in[2] * m[6 + j];
}

template <int C, bool OKLAB>
__device__ __forceinline__ void store_px(void* __restrict__ dst, size_t pix,
                                         const int q[C],
                                         const float* __restrict__ mix) {
  if constexpr (OKLAB) {
    static_assert(C == 3, "the Oklab epilogue needs RGB");
    float lin[3], lms[3], lab[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) lin[c] = srgb_to_linear(q[c]);
    mix3(mix, lin, lms);
#pragma unroll
    for (int c = 0; c < 3; ++c) lms[c] = cbrtf(lms[c]);
    mix3(mix + 9, lms, lab);
    float* d = static_cast<float*>(dst) + pix * 3;
    d[0] = lab[0];
    d[1] = lab[1];
    d[2] = lab[2];
  } else {
    uint8_t* d = static_cast<uint8_t*>(dst) + pix * C;
#pragma unroll
    for (int c = 0; c < C; ++c) d[c] = (uint8_t)q[c];
  }
}

// One block: one tile x tile output tile of image blockIdx.z.
// ty/tx: int32 [3, n + 2r] halo tables (a, b, f); taps: int32 [2r + 1].
template <int C, bool BLUR, bool OKLAB>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint8_t* __restrict__ src, void* __restrict__ dst,
             const int* __restrict__ ty, const int* __restrict__ tx,
             const int* __restrict__ taps, const float* __restrict__ mix,
             int H, int W, int OH, int OW, int r, int tile) {
  const int ty0 = blockIdx.y * tile, tx0 = blockIdx.x * tile;
  const int th = min(tile, OH - ty0), tw = min(tile, OW - tx0);
  const int ny = OH + 2 * r, nx = OW + 2 * r;
  const uint8_t* img = src + (size_t)blockIdx.z * H * W * C;
  const size_t out0 = (size_t)blockIdx.z * OH * OW;

  if constexpr (!BLUR) {
    for (int i = threadIdx.x; i < th * tw; i += kThreads) {
      const int y = ty0 + i / tw, x = tx0 + i % tw;
      int q[C];
      resize_px<C>(img, W, ty, ny, y, tx, nx, x, q);
      store_px<C, OKLAB>(dst, out0 + (size_t)y * OW + x, q, mix);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const int hh = th + 2 * r, hw = tw + 2 * r, k = 2 * r + 1;
  const int side = tile + 2 * r;
  uint8_t* res = smem;                                      // [hh][hw][C]
  int* tmp = reinterpret_cast<int*>(smem + ((side * side * C + 15) & ~15));
                                                            // [hh][tw][C]

  // 1. resize the tile and its halo; halo position (hy, hx) is table
  //    column (ty0 + hy, tx0 + hx)
  for (int i = threadIdx.x; i < hh * hw; i += kThreads) {
    int q[C];
    resize_px<C>(img, W, ty, ny, ty0 + i / hw, tx, nx, tx0 + i % hw, q);
#pragma unroll
    for (int c = 0; c < C; ++c) res[i * C + c] = (uint8_t)q[c];
  }
  __syncthreads();

  // 2. width pass over every halo row
  for (int i = threadIdx.x; i < hh * tw; i += kThreads) {
    const uint8_t* row = res + ((i / tw) * hw + i % tw) * C;
    int acc[C] = {};
    for (int t = 0; t < k; ++t) {
      const int w = taps[t];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * row[t * C + c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) tmp[i * C + c] = acc[c];
  }
  __syncthreads();

  // 3. height pass, divClampU8 by 256^2, epilogue
  for (int i = threadIdx.x; i < th * tw; i += kThreads) {
    const int y = i / tw, x = i % tw;
    const int* col = tmp + i * C;
    int acc[C] = {};
    for (int t = 0; t < k; ++t) {
      const int w = taps[t];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * col[t * tw * C + c];
    }
    int q[C];
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = min((acc[c] + 32768) >> 16, 255);
    store_px<C, OKLAB>(dst, out0 + (size_t)(ty0 + y) * OW + tx0 + x, q, mix);
  }
}

template <int C, bool BLUR, bool OKLAB>
int launch(const void* src, void* dst, const void* ty, const void* tx,
           const void* taps, const void* mix, int B, int H, int W, int OH,
           int OW, int r, int tile, int smem, cudaStream_t stream) {
  auto kernel = fused_kernel<C, BLUR, OKLAB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((OW + tile - 1) / tile, (OH + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(src), dst, static_cast<const int*>(ty),
      static_cast<const int*>(tx), static_cast<const int*>(taps),
      static_cast<const float*>(mix), H, W, OH, OW, r, tile);
  return cudaGetLastError();
}

template <int C>
int dispatch(bool blur, const void* src, void* dst,
             const void* ty, const void* tx, const void* taps,
             const void* mix, int B, int H, int W, int OH, int OW, int r,
             int tile, int smem, cudaStream_t s) {
  if (blur)
    return launch<C, true, false>(src, dst, ty, tx, taps, mix, B, H, W, OH,
                                  OW, r, tile, smem, s);
  return launch<C, false, false>(src, dst, ty, tx, taps, mix, B, H, W, OH,
                                 OW, r, tile, smem, s);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. The caller checks
// shapes, dtypes and contiguity, allocates dst and picks tile and smem.
int zt_fused_resize_blur_oklab(const void* src, void* dst, const void* ty,
                               const void* tx, const void* taps,
                               const void* mix, int B, int H, int W, int C,
                               int OH, int OW, int r, int tile, int smem,
                               int oklab, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool blur = r > 0;
  if (oklab) {
    if (C != 3) return cudaErrorInvalidValue;
    if (blur)
      return launch<3, true, true>(src, dst, ty, tx, taps, mix, B, H, W, OH,
                                   OW, r, tile, smem, s);
    return launch<3, false, true>(src, dst, ty, tx, taps, mix, B, H, W, OH,
                                  OW, r, tile, smem, s);
  }
  switch (C) {
    case 1:
      return dispatch<1>(blur, src, dst, ty, tx, taps, mix, B, H, W,
                         OH, OW, r, tile, smem, s);
    case 3:
      return dispatch<3>(blur, src, dst, ty, tx, taps, mix, B, H, W,
                         OH, OW, r, tile, smem, s);
    case 4:
      return dispatch<4>(blur, src, dst, ty, tx, taps, mix, B, H, W,
                         OH, OW, r, tile, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* zt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
