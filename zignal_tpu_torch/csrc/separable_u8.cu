// Separable u8 convolution over banded integer matrices, for sm_90a:
// out = divClampU8(My . (x . Mx^T), 256^2), per image and channel.
//
// Replaces the TPU kernel zignal_tpu/ops/pallas_conv.py:pallas_separable_u8.
// It computes what that kernel computes, not what its blocks do: the TPU
// version splits the pass-1 values into base-256 digits so that bf16 MXU
// products stay exact (_combine_plan); here the int32 ALUs are exact, so
// each pass is a plain gather-and-MAC over compact tap tables.
//
// What should bound it on this card: the HBM floor is B*(H*W + OH*OW)*C
// bytes (6 B a pixel for RGB in and out, 100.7 MB at B=16 of 1024^2, 0.030
// ms at 3.35 TB/s). Against that it does byte-wide gathers into shared
// memory, re-reads the halo of each tile (a 32-px tile of a 13-tap
// Gaussian stages 44^2 source pixels for 32^2 outputs, 1.9x), and about
// 2 * 13 * 1.2 integer MACs per output value. The design keeps the int32
// pass-1 result out of device memory: one block owns one output tile of
// one image, stages the source rows x columns the tile reads, runs the
// column pass into int32 shared memory, then the row pass and the epilogue,
// and writes the tile once.
//
// The host tables (ops/tables.py:band_to_taps, tile_sources) turn each
// dense band into per-output (local index, weight) taps and, per tile, the
// sorted list of source positions they read. A list and not a span: a WRAP
// tile at an edge reads both ends of the axis. Taps of weight 0 pad every
// row to the same count and read position 0 of the list.
//
// Exactness: |pass 1| <= 255 * max_row sum|Mx|, |pass 2| <= that times
// max_row sum|My|; the wrapper raises unless that plus 2^15 is below 2^31.
// divClampU8 rounds half away from zero and clamps to [0, 255], so a
// negative accumulator gives 0 and a non-negative one (acc + 2^15) >> 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One block: one tile x tile output tile of image blockIdx.z.
// ysrc [tiles_y, sy] / xsrc [tiles_x, sx]: source rows / columns per tile;
// yidx, yw [OH, ky] / xidx, xw [OW, kx]: taps as positions in those lists.
template <int C>
__global__ void __launch_bounds__(kThreads)
separable_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 const int* __restrict__ ysrc, const int* __restrict__ yidx,
                 const int* __restrict__ yw, const int* __restrict__ xsrc,
                 const int* __restrict__ xidx, const int* __restrict__ xw,
                 int H, int W, int OH, int OW, int sy, int ky, int sx,
                 int kx, int tile) {
  const int oy0 = blockIdx.y * tile, ox0 = blockIdx.x * tile;
  const int th = min(tile, OH - oy0), tw = min(tile, OW - ox0);
  const uint8_t* img = src + (size_t)blockIdx.z * H * W * C;
  uint8_t* out = dst + (size_t)blockIdx.z * OH * OW * C;
  const int* rows = ysrc + (size_t)blockIdx.y * sy;
  const int* cols = xsrc + (size_t)blockIdx.x * sx;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* in = smem;                                        // [sy][sx][C]
  int* tmp = reinterpret_cast<int*>(smem + ((sy * sx * C + 15) & ~15));
                                                             // [sy][tw][C]

  // 1. stage the source rows x columns that the tile reads
  for (int i = threadIdx.x; i < sy * sx; i += kThreads) {
    const uint8_t* p = img + ((size_t)rows[i / sx] * W + cols[i % sx]) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) in[i * C + c] = p[c];
  }
  __syncthreads();

  // 2. column pass (contract W) over every staged row
  for (int i = threadIdx.x; i < sy * tw; i += kThreads) {
    const uint8_t* row = in + (i / tw) * sx * C;
    const size_t t0 = (size_t)(ox0 + i % tw) * kx;
    int acc[C] = {};
    for (int k = 0; k < kx; ++k) {
      const int w = xw[t0 + k];
      const uint8_t* px = row + xidx[t0 + k] * C;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * px[c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) tmp[i * C + c] = acc[c];
  }
  __syncthreads();

  // 3. row pass (contract H), divClampU8 by 256^2, u8 store
  for (int i = threadIdx.x; i < th * tw; i += kThreads) {
    const int oy = oy0 + i / tw, x = i % tw;
    const size_t t0 = (size_t)oy * ky;
    int acc[C] = {};
    for (int k = 0; k < ky; ++k) {
      const int w = yw[t0 + k];
      const int* t = tmp + (yidx[t0 + k] * tw + x) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * t[c];
    }
    uint8_t* o = out + ((size_t)oy * OW + ox0 + x) * C;
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[c] = acc[c] < 0 ? 0 : (uint8_t)min((acc[c] + 32768) >> 16, 255);
  }
}

template <int C>
int launch(const void* src, void* dst, const void* ysrc, const void* yidx,
           const void* yw, const void* xsrc, const void* xidx,
           const void* xw, int B, int H, int W, int OH, int OW, int sy,
           int ky, int sx, int kx, int tile, int smem,
           cudaStream_t stream) {
  auto kernel = separable_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((OW + tile - 1) / tile, (OH + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int*>(ysrc), static_cast<const int*>(yidx),
      static_cast<const int*>(yw), static_cast<const int*>(xsrc),
      static_cast<const int*>(xidx), static_cast<const int*>(xw), H, W, OH,
      OW, sy, ky, sx, kx, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. The caller checks
// shapes, dtypes, contiguity and the int32 bound, allocates dst and picks
// tile and smem.
int zt_separable_u8(const void* src, void* dst, const void* ysrc,
                    const void* yidx, const void* yw, const void* xsrc,
                    const void* xidx, const void* xw, int B, int H, int W,
                    int C, int OH, int OW, int sy, int ky, int sx, int kx,
                    int tile, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return launch<1>(src, dst, ysrc, yidx, yw, xsrc, xidx, xw, B, H, W, OH,
                       OW, sy, ky, sx, kx, tile, smem, s);
    case 2:
      return launch<2>(src, dst, ysrc, yidx, yw, xsrc, xidx, xw, B, H, W, OH,
                       OW, sy, ky, sx, kx, tile, smem, s);
    case 3:
      return launch<3>(src, dst, ysrc, yidx, yw, xsrc, xidx, xw, B, H, W, OH,
                       OW, sy, ky, sx, kx, tile, smem, s);
    case 4:
      return launch<4>(src, dst, ysrc, yidx, yw, xsrc, xidx, xw, B, H, W, OH,
                       OW, sy, ky, sx, kx, tile, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
