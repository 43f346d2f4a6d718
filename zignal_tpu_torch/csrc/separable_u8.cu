// Separable u8 convolution over banded integer matrices, for sm_90a:
// out = divClampU8(My . (x . Mx^T), 256^2), per image and channel.
//
// Replaces the TPU kernel zignal_tpu/ops/pallas_conv.py:pallas_separable_u8.
// It computes what that kernel computes, not what its blocks do: the TPU
// version splits the pass-1 values into base-256 digits so that bf16 MXU
// products stay exact (_combine_plan); here the int32 ALUs are exact.
//
// What bounds it on this card: the HBM floor is B*(H*W + OH*OW)*C bytes (6
// B a pixel for RGB in and out, 100.7 MB at B=16 of 1024^2, 0.030 ms at
// 3.35 TB/s); the MACs, 2 * 13 a value for a 13-tap Gaussian plus the rows
// of halo a tile's width pass recomputes, take 0.039 ms as f32 FMAs at 67
// TFLOP/s and twice that as int32 multiply-adds, which issue at half rate.
// Two kernels:
//
// conv_kernel: a convolution band, the same taps at consecutive offsets
// for every output (convolve_separable, gaussian_blur, the pyramid's blur).
// One block owns a th x tw output tile of one image (found in the 1-D grid
// with two divisions a block); the host's halo tables resolve the border
// of each axis, so every tile, edge or not, convolves a contiguous staged
// region with the same taps:
// - the taps are kernel parameters (constant bank); 7, 11 and 13 taps (sigma
//   1, 1.5, 2) are template arguments and fully unrolled; the row pitch of
//   the width pass's values is a constant (64 values a channel);
// - an interior tile stages its rows as 16-byte cp.async copies when the
//   image's rows are 16-byte aligned; edge tiles gather through the halo
//   tables (tile_staging.cuh);
// - the width pass computes 4 pixels x C values a thread from (K + 3) C
//   bytes in registers, in int32; the height pass 8 rows down a column of
//   values, in f32 FMAs where the host proved them exact (f32 = 1), else
//   int32; tw and th are powers of two, so threads map to work with shifts
//   and masks and no stage divides;
// - the height pass stores its bytes straight to the image, a warp's store
//   32 consecutive bytes of a row: a shared-memory tile written out in
//   16-byte stores costs one more barrier and measured slower.
//
// band_kernel: any other band (a resize band, a band of more taps than the
// parameters hold). The host tables (ops/tables.py:band_to_taps,
// tile_sources) turn each band into per-output (local index, weight) taps
// and, per tile, the sorted list of source positions they read; the block
// stages its tile's taps in shared memory once, gathers the source rows x
// columns, and runs both passes in int32.
//
// Channels: C in 1..4 is a template argument. An image of more channels
// runs in groups of at most 4 (one launch a group, each reading and writing
// its channels at the pixel stride C): conv_kernel with runtime taps,
// staged through the halo tables, or band_kernel.
//
// Exactness: |pass 1| <= 255 * max_row sum|Mx|, |pass 2| <= that times
// max_row sum|My|; the wrapper raises unless that plus 2^15 is below 2^31.
// f32 pass 2 is exact when that bound is below 2^24, or when both bands are
// non-negative: then partial sums rise monotonically, every one below 2^24
// is exact, and a sum that reaches 2^24 clips to 255 in both forms.
// divClampU8 rounds half away from zero and clamps to [0, 255], so a
// negative accumulator gives 0 and a non-negative one (acc + 2^15) >> 16.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tile_staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows a thread computes in the height pass
constexpr int kMaxTaps = 256;
constexpr int kTileW = 64;  // the widest conv tile, the pass-1 row pitch

// The wrapper's ops/separable_conv.py:_conv_params writes this layout.
struct ConvParams {
  int B, H, W, C;
  int kx, ky, ax, ay;  // tap counts; taps before the centre, per axis
  int th, tw;          // output tile, powers of two (tw >= 4, th >= 8)
  int tiles_x, tiles_y;  // tiles of an image
  int lg_g, lg_nch;    // log2 of the 4-pixel groups of a row, of 8-row chunks
  int sp;              // pitch of the staged rows, bytes (% 16 == 0)
  int vec_in;          // rows of src are 16-byte aligned
  int f32;             // the height pass in f32 is exact
  int off_t, smem;     // shared-memory layout, bytes
  int cs, c0;          // pixel stride of src and dst, first channel (C > 4)
  int xt[kMaxTaps], yt[kMaxTaps];
  float yf[kMaxTaps];
};

// The wrapper's ops/separable_conv.py:_band_params writes this layout.
struct BandParams {
  int B, H, W, C, OH, OW;
  int sy, ky, sx, kx;  // per tile: source rows, row taps, columns, col taps
  int tile;
  int off_tmp, off_xt, off_yt, smem;  // shared-memory layout, bytes
  int cs, c0;  // pixel stride of src and dst, first channel of this launch
};

template <bool F32>
struct Acc {
  using T = int;
};
template <>
struct Acc<true> {
  using T = float;
};

__device__ __forceinline__ uint8_t div_clamp_u8(int a) {
  return a < 0 ? 0 : (uint8_t)min((a + 32768) >> 16, 255);
}

// f32 accumulator: an integer below 2^24, or a sum that reached 2^24 and
// clips to 255. a * 2^-16 + 0.5 is exact below 2^24; clamped to [0, 255],
// adding 2^23 rounding down leaves floor() in the low byte.
__device__ __forceinline__ uint8_t div_clamp_u8(float a) {
  const float q = fminf(fmaxf(__fmaf_rn(a, 1.0f / 65536.0f, 0.5f), 0.0f),
                        255.0f);
  return (uint8_t)__float_as_uint(__fadd_rd(q, 8388608.0f));
}

// Width pass: 4 pixels x C values from the bytes s[0, (kx + 3) C).
template <int C, int K>
__device__ __forceinline__ void row_pass(const uint8_t* s,
                                         const ConvParams& p,
                                         int (&acc)[4 * C]) {
#pragma unroll
  for (int q = 0; q < 4 * C; ++q) acc[q] = 0;
  if constexpr (K > 0) {
    int x[(K + 3) * C];
#pragma unroll
    for (int i = 0; i < (K + 3) * C; ++i) x[i] = s[i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = p.xt[k];
#pragma unroll
      for (int q = 0; q < 4 * C; ++q) acc[q] += t * x[k * C + q];
    }
  } else {
    for (int k = 0; k < p.kx; ++k) {
      const int t = p.xt[k];
      const uint8_t* sk = s + k * C;
#pragma unroll
      for (int q = 0; q < 4 * C; ++q) acc[q] += t * sk[q];
    }
  }
}

template <bool F32>
__device__ __forceinline__ typename Acc<F32>::T ytap(const ConvParams& p,
                                                     int k) {
  if constexpr (F32)
    return p.yf[k];
  else
    return p.yt[k];
}

// Height pass: kRows outputs down the column q (pitch in values).
template <int K, bool F32>
__device__ __forceinline__ void col_pass(const typename Acc<F32>::T* q,
                                         int pitch, const ConvParams& p,
                                         typename Acc<F32>::T (&acc)[kRows]) {
  using T = typename Acc<F32>::T;
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0;
  if constexpr (K > 0) {
    T v[K + kRows - 1];
#pragma unroll
    for (int i = 0; i < K + kRows - 1; ++i) v[i] = q[i * pitch];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T t = ytap<F32>(p, k);
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] += t * v[j + k];
    }
  } else {
    for (int k = 0; k < p.ky; ++k) {
      const T t = ytap<F32>(p, k);
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] += t * q[(j + k) * pitch];
    }
  }
}

// Where a tile lies and what it stages: tile t of the tiles_x x tiles_y
// tiles of an image, images in order.
struct Tile {
  int z, y0, x0, th, tw, sh, sw, sy0, sx0, off;
  bool vec;  // interior, rows 16-byte aligned: staged with cp.async
};

template <int C, int K>
__device__ __forceinline__ Tile tile_at(int t, const ConvParams& p) {
  const int per = p.tiles_x * p.tiles_y;
  Tile g;
  g.z = t / per;  // once a block: the stages below never divide
  const int rem = t - g.z * per, by = rem / p.tiles_x;
  g.y0 = by * p.th;
  g.x0 = (rem - by * p.tiles_x) * p.tw;
  g.th = min(p.th, p.H - g.y0);
  g.tw = min(p.tw, p.W - g.x0);
  g.sh = g.th + (K > 0 ? K : p.ky) - 1;
  g.sw = g.tw + (K > 0 ? K : p.kx) - 1;
  g.sy0 = g.y0 - p.ay;
  g.sx0 = g.x0 - p.ax;
  g.vec = p.vec_in && g.sy0 >= 0 && g.sy0 + g.sh <= p.H && g.sx0 >= 0 &&
          g.sx0 + g.sw <= p.W;
  g.off = g.vec ? (g.sx0 * C) & 15 : 0;
  return g;
}

// An interior tile's rows as 16-byte chunks from the aligned chunk before
// its first byte: pixel j of row r lands at in[r * sp + off + j * C].
template <int C>
__device__ __forceinline__ void stage_async(const uint8_t* src, const Tile& g,
                                            const ConvParams& p, uint8_t* in) {
  const size_t pitch = (size_t)p.W * C;
  stage_rows_async<kWarps>(
      src + ((size_t)g.z * p.H + g.sy0) * pitch + ((g.sx0 * C) & ~15), pitch,
      g.sh, (g.off + g.sw * C + 15) >> 4, in, p.sp);
}

// Any other tile, through the halo tables: entry y0 + r is source row
// y0 - ay + r (-1 where a ZERO border reads 0). A warp gathers
// kStageRows rows at a time with all their loads in flight. A channel group
// (GROUP: C of the image's cs channels from c0) is staged as C channels.
template <int C, bool GROUP>
__device__ __forceinline__ void stage_gather(const uint8_t* src,
                                             const int* ty, const int* tx,
                                             const Tile& g,
                                             const ConvParams& p,
                                             uint8_t* in) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = GROUP ? p.cs : C;
  const uint8_t* img = src + (size_t)g.z * p.H * p.W * cs + (GROUP ? p.c0 : 0);
  for (int r0 = warp; r0 < g.sh; r0 += kWarps * kStageRows) {
    int gy[kStageRows];
    const uint8_t* rows[kStageRows];
#pragma unroll
    for (int i = 0; i < kStageRows; ++i) {
      gy[i] = ty[g.y0 + min(r0 + i * kWarps, g.sh - 1)];
      rows[i] = img + (size_t)max(gy[i], 0) * p.W * cs;
    }
    for (int j = lane; j < g.sw; j += 32) {
      const int gx = tx[g.x0 + j];
      uint8_t v[kStageRows][C];
#pragma unroll
      for (int i = 0; i < kStageRows; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) v[i][c] = rows[i][max(gx, 0) * cs + c];
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) {
        const int r = r0 + i * kWarps;
        if (r >= g.sh) continue;
#pragma unroll
        for (int c = 0; c < C; ++c)
          in[r * p.sp + j * C + c] = gy[i] < 0 || gx < 0 ? 0 : v[i][c];
      }
    }
  }
}

// One block: the output tile blockIdx.x, th x tw pixels of one image; with
// GROUP, channels c0 .. c0 + C of an image of cs channels.
template <int C, int K, bool F32, bool GROUP>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            const int* __restrict__ ty, const int* __restrict__ tx,
            const __grid_constant__ ConvParams p) {
  using T = typename Acc<F32>::T;
  // pitch of the pass-1 rows, values: a constant (tiles are at most kTileW
  // wide), so the height pass loads at immediate offsets
  constexpr int tp = kTileW * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* in = smem;  // [sh][sp]
  T* mid = reinterpret_cast<T*>(smem + p.off_t);  // [sh + kRows][tp]

  // 1. the source region; pixel j of row r at in[r * sp + off + j * C]
  const Tile cur = tile_at<C, K>(blockIdx.x, p);
  if (!GROUP && cur.vec) {
    stage_async<C>(src, cur, p, in);
    cp_async_commit();
    cp_async_wait_all();
  } else {
    stage_gather<C, GROUP>(src, ty, tx, cur, p, in);
  }
  __syncthreads();

  // width pass over every staged row: 4 pixels x C values a thread
  const int G = 1 << p.lg_g, ng = (cur.tw + 3) >> 2;
  for (int u = threadIdx.x; u < (cur.sh << p.lg_g); u += kThreads) {
    const int r = u >> p.lg_g, gi = u & (G - 1);
    if (gi >= ng) continue;
    int acc[4 * C];
    row_pass<C, K>(in + r * p.sp + cur.off + gi * 4 * C, p, acc);
    T* d = mid + r * tp + gi * 4 * C;
#pragma unroll
    for (int q = 0; q < 4 * C; q += 4) {
      if constexpr (F32)
        *reinterpret_cast<float4*>(d + q) =
            make_float4((float)acc[q], (float)acc[q + 1], (float)acc[q + 2],
                        (float)acc[q + 3]);
      else
        *reinterpret_cast<int4*>(d + q) =
            make_int4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
    }
  }
  __syncthreads();

  // height pass and divClampU8, stored to the image: a warp takes 8 rows x
  // 32 values, 32 consecutive bytes of a row a store
  const int nv = cur.tw * C, th = cur.th;
  const int cs = GROUP ? p.cs : C;
  const size_t pitch = (size_t)p.W * cs;
  uint8_t* out = dst + ((size_t)cur.z * p.H + cur.y0) * pitch +
                 (size_t)cur.x0 * cs + (GROUP ? p.c0 : 0);
  const int nchunk = 1 << p.lg_nch, ncb = (nv + 31) >> 5;
  for (int u = warp; u < (ncb << p.lg_nch); u += kWarps) {
    const int r0 = (u & (nchunk - 1)) * kRows;
    const int v = ((u >> p.lg_nch) << 5) + lane;
    if (r0 >= th || v >= nv) continue;
    T acc[kRows];
    col_pass<K, F32>(mid + r0 * tp + v, tp, p, acc);
    // value v is channel v % C of pixel v / C
    uint8_t* o = out + r0 * pitch + (GROUP ? (v / C) * cs + v % C : v);
    if (r0 + kRows <= th) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) o[j * pitch] = div_clamp_u8(acc[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (j < th - r0) o[j * pitch] = div_clamp_u8(acc[j]);
    }
  }
}

// One block: one tile x tile output tile of image blockIdx.z.
// ysrc [tiles_y, sy] / xsrc [tiles_x, sx]: source rows / columns per tile;
// yidx, yw [OH, ky] / xidx, xw [OW, kx]: taps as positions in those lists.
template <int C>
__global__ void __launch_bounds__(kThreads)
band_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            const int* __restrict__ ysrc, const int* __restrict__ yidx,
            const int* __restrict__ yw, const int* __restrict__ xsrc,
            const int* __restrict__ xidx, const int* __restrict__ xw,
            const __grid_constant__ BandParams p) {
  const int oy0 = blockIdx.y * p.tile, ox0 = blockIdx.x * p.tile;
  const int th = min(p.tile, p.OH - oy0), tw = min(p.tile, p.OW - ox0);
  const int sy = p.sy, sx = p.sx, kx = p.kx, ky = p.ky;
  const int tp = p.tile * C;  // pitch of the pass-1 rows, values
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = p.cs;  // C channels of cs from c0
  const uint8_t* img = src + (size_t)blockIdx.z * p.H * p.W * cs + p.c0;
  uint8_t* out = dst + (size_t)blockIdx.z * p.OH * p.OW * cs + p.c0;
  const int* rows = ysrc + (size_t)blockIdx.y * sy;
  const int* cols = xsrc + (size_t)blockIdx.x * sx;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* in = smem;                                      // [sy][sx * C]
  int* tmp = reinterpret_cast<int*>(smem + p.off_tmp);     // [sy][tp]
  int2* xt = reinterpret_cast<int2*>(smem + p.off_xt);     // [tw][kx]
  int2* yt = reinterpret_cast<int2*>(smem + p.off_yt);     // [th][ky]

  // 1. the tile's taps, as (offset in shared memory, weight), and the
  //    source rows x columns it reads
  for (int o = warp; o < tw; o += kWarps)
    for (int k = lane; k < kx; k += 32) {
      const size_t t = (size_t)(ox0 + o) * kx + k;
      xt[o * kx + k] = make_int2(xidx[t] * C, xw[t]);
    }
  for (int o = warp; o < th; o += kWarps)
    for (int k = lane; k < ky; k += 32) {
      const size_t t = (size_t)(oy0 + o) * ky + k;
      yt[o * ky + k] = make_int2(yidx[t] * tp, yw[t]);
    }
  for (int r = warp; r < sy; r += kWarps) {
    const uint8_t* srow = img + (size_t)rows[r] * p.W * cs;
    uint8_t* d = in + r * sx * C;
    for (int j = lane; j < sx; j += 32) {
      const uint8_t* s = srow + cols[j] * cs;
#pragma unroll
      for (int c = 0; c < C; ++c) d[j * C + c] = s[c];
    }
  }
  __syncthreads();

  // 2. column pass (contract W) over every staged row
  for (int r = warp; r < sy; r += kWarps) {
    const uint8_t* row = in + r * sx * C;
    for (int o = lane; o < tw; o += 32) {
      const int2* t = xt + o * kx;
      int acc[C] = {};
      for (int k = 0; k < kx; ++k) {
        const int2 tk = t[k];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += tk.y * row[tk.x + c];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) tmp[r * tp + o * C + c] = acc[c];
    }
  }
  __syncthreads();

  // 3. row pass (contract H), divClampU8 by 256^2, u8 store
  for (int r = warp; r < th; r += kWarps) {
    const int2* t = yt + r * ky;
    uint8_t* orow = out + ((size_t)(oy0 + r) * p.OW + ox0) * cs;
    for (int o = lane; o < tw; o += 32) {
      int acc[C] = {};
      for (int k = 0; k < ky; ++k) {
        const int2 tk = t[k];
        const int* s = tmp + tk.x + o * C;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += tk.y * s[c];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) orow[o * cs + c] = div_clamp_u8(acc[c]);
    }
  }
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int C, int K, bool F32, bool GROUP = false>
int launch_conv(const void* src, void* dst, const void* ty, const void* tx,
                const ConvParams& p, cudaStream_t stream) {
  auto kernel = conv_kernel<C, K, F32, GROUP>;
  int e = prepare(kernel, p.smem);
  if (e != cudaSuccess) return e;
  const long long grid = (long long)p.tiles_x * p.tiles_y * p.B;
  if (grid < 1 || grid > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, p.smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int*>(ty), static_cast<const int*>(tx), p);
  return cudaGetLastError();
}

template <int C, bool F32>
int conv_taps(const void* src, void* dst, const void* ty, const void* tx,
              const ConvParams& p, cudaStream_t s) {
  const int k = p.kx == p.ky ? p.kx : 0;
  switch (k) {
    case 7:
      return launch_conv<C, 7, F32>(src, dst, ty, tx, p, s);
    case 11:
      return launch_conv<C, 11, F32>(src, dst, ty, tx, p, s);
    case 13:
      return launch_conv<C, 13, F32>(src, dst, ty, tx, p, s);
    default:
      return launch_conv<C, 0, F32>(src, dst, ty, tx, p, s);
  }
}

template <int C>
int conv_form(const void* src, void* dst, const void* ty, const void* tx,
              const ConvParams& p, cudaStream_t s) {
  if (p.f32) return conv_taps<C, true>(src, dst, ty, tx, p, s);
  return conv_taps<C, false>(src, dst, ty, tx, p, s);
}

// C of an image's cs channels from c0: the runtime-tap kernel, staged
// through the halo tables
template <int C>
int conv_group(const void* src, void* dst, const void* ty, const void* tx,
               const ConvParams& p, cudaStream_t s) {
  if (p.f32) return launch_conv<C, 0, true, true>(src, dst, ty, tx, p, s);
  return launch_conv<C, 0, false, true>(src, dst, ty, tx, p, s);
}

template <int C>
int launch_band(const void* src, void* dst, const void* ysrc,
                const void* yidx, const void* yw, const void* xsrc,
                const void* xidx, const void* xw, const BandParams& p,
                cudaStream_t stream) {
  auto kernel = band_kernel<C>;
  const int e = prepare(kernel, p.smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.OW + p.tile - 1) / p.tile, (p.OH + p.tile - 1) / p.tile,
                  p.B);
  kernel<<<grid, kThreads, p.smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int*>(ysrc), static_cast<const int*>(yidx),
      static_cast<const int*>(yw), static_cast<const int*>(xsrc),
      static_cast<const int*>(xidx), static_cast<const int*>(xw), p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int zt_conv_params_bytes() { return (int)sizeof(ConvParams); }

int zt_band_params_bytes() { return (int)sizeof(BandParams); }

// Both return a cudaError_t: 0 when the launch was accepted. The caller
// checks shapes, dtypes, contiguity and the int32 bound, allocates dst,
// and fills params: the tile, the shared-memory layout, the alignment
// flags and, for conv, whether the f32 height pass is exact.
int zt_separable_conv_u8(const void* src, void* dst, const void* ty,
                         const void* tx, const void* params, void* stream) {
  ConvParams p;
  memcpy(&p, params, sizeof(p));
  if (p.kx < 1 || p.ky < 1 || p.kx > kMaxTaps || p.ky > kMaxTaps)
    return cudaErrorInvalidValue;
  if (p.C < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.C) {
    case 1:
      return conv_form<1>(src, dst, ty, tx, p, s);
    case 2:
      return conv_form<2>(src, dst, ty, tx, p, s);
    case 3:
      return conv_form<3>(src, dst, ty, tx, p, s);
    case 4:
      return conv_form<4>(src, dst, ty, tx, p, s);
  }
  // C > 4: one launch a group of at most 4 channels, pixel stride C
  for (int c0 = 0; c0 < p.C; c0 += 4) {
    ConvParams q = p;
    q.C = p.C - c0 < 4 ? p.C - c0 : 4;
    q.cs = p.C;
    q.c0 = c0;
    q.vec_in = 0;
    int e;
    switch (q.C) {
      case 1:
        e = conv_group<1>(src, dst, ty, tx, q, s);
        break;
      case 2:
        e = conv_group<2>(src, dst, ty, tx, q, s);
        break;
      case 3:
        e = conv_group<3>(src, dst, ty, tx, q, s);
        break;
      default:
        e = conv_group<4>(src, dst, ty, tx, q, s);
        break;
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

int zt_separable_u8(const void* src, void* dst, const void* ysrc,
                    const void* yidx, const void* yw, const void* xsrc,
                    const void* xidx, const void* xw, const void* params,
                    void* stream) {
  BandParams p;
  memcpy(&p, params, sizeof(p));
  if (p.C < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one launch a group of at most 4 channels, pixel stride C
  for (int c0 = 0; c0 < p.C; c0 += 4) {
    BandParams q = p;
    q.C = p.C - c0 < 4 ? p.C - c0 : 4;
    q.cs = p.C;
    q.c0 = c0;
    int e;
    switch (q.C) {
      case 1:
        e = launch_band<1>(src, dst, ysrc, yidx, yw, xsrc, xidx, xw, q, s);
        break;
      case 2:
        e = launch_band<2>(src, dst, ysrc, yidx, yw, xsrc, xidx, xw, q, s);
        break;
      case 3:
        e = launch_band<3>(src, dst, ysrc, yidx, yw, xsrc, xidx, xw, q, s);
        break;
      default:
        e = launch_band<4>(src, dst, ysrc, yidx, yw, xsrc, xidx, xw, q, s);
        break;
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // extern "C"
