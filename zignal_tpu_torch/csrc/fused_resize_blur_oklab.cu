// Fused bilinear u8 resize -> 8.8 Gaussian blur -> optional sRGB->Oklab,
// for sm_90a.
//
// Replaces the TPU kernel zignal_tpu/ops/pallas_pipeline.py:
// fused_resize_blur_oklab. It computes what that kernel computes, not what
// its blocks do: the TPU version splits values into base-256 digits and runs
// bf16 banded matmuls only to get exact integers from the MXU; here the
// int32 ALUs are exact, so each stage is a plain gather-and-MAC.
//
// What bounds it on this card: the HBM floor is 3 B a source pixel read and
// 12 B an Oklab pixel written (100.7 MB and 0.030 ms at B=16 of 1024^2 ->
// 512^2 at 3.35 TB/s); the work an output value is 4 resize and 2 * 13 blur
// multiply-adds plus the Oklab epilogue, on a tile that recomputes its blur
// halo. The first version (one value a thread, runtime divisions and taps
// from global memory in every stage, source bytes gathered from global)
// ran at 16.5 % of that floor. This design applies the methods of the K2
// and K4 redesigns:
// - one block owns a tw x th output tile of one image, found in the 1-D grid
//   with two divisions once; every stage walks its work in power-of-two
//   groups, so a thread's (row, column) is a shift and a mask;
// - the block stages its tile's resize tables, (a, b, f) for the hh halo
//   rows and hw halo columns, in shared memory once, an int4 each, as
//   offsets into the staged source;
// - it stages the source rows and columns its tile reads (the host's span
//   tables give their first row and column and their count) with 16-byte
//   cp.async copies (tile_staging.cuh), so the resize reads shared memory;
//   a plan whose spans do not fit a block (a strong downscale) gathers from
//   global memory instead, a pixel a thread (STAGED = false);
// - the resize makes 4 pixels x C a thread, a word a channel into a plane
//   a channel;
// - the width pass runs on dp4a: 4 u8 multiply-adds an instruction, each
//   output's window a funnel shift of the plane's words, the taps packed
//   as bytes in the kernel parameters (constant bank); 7, 11 and 13 taps
//   (sigma 1, 1.5, 2) are template arguments, fully unrolled; the height
//   pass makes 8 rows from k + 7 values in f32 (exact: see below);
// - the Oklab epilogue reads the sRGB -> linear curve from a 256-entry f32
//   table (its input is a u8), which the wrapper computes with the plain
//   version's own ops, then two 3x3 mixes around an IEEE cbrtf;
// - the height pass (u8) and the epilogue (Oklab) store straight to the
//   image, neighbouring threads on neighbouring bytes or pixels: a staged
//   output tile written in 16-byte stores measured slower;
// - the plain resize (no blur, no Oklab) is latency-bound, not issue-bound,
//   and runs without shared memory or a barrier: a pixel a thread, the
//   tables and the source read through the cache (staging measured slower).
// The tile is measured, not derived (chip_smoke.py --times sweeps
// ops/fused_pipeline.py:TILES); a grid of fewer than 4 blocks an SM takes a
// smaller tile. Measured, stage by stage (stages compiled out one at a
// time; PERF.md): the resize's arithmetic, the height pass, the output's
// stores, the cube roots and the staging of the span each take a fifth to
// a third of the time, and they overlap.
//
// Channels: C in {1, 3, 4} is a template argument. Any other C (no Oklab)
// runs in groups of at most 4 channels, one launch a group, each reading
// and writing its channels at the runtime pixel stride cs from channel c0,
// through the gathering (unstaged) kernels of the same C, which take cs = C
// and c0 = 0 for an image of C channels.
//
// Exactness (bit-identical to the JAX package in every u8 stage):
// - resize: taps (256-f, f) per axis, sum <= 255 * 256 * 256 < 2^31, then a
//   truncating >> 16 (the sum is never negative);
// - blur: taps round(k * 256) >= 0 summing to at most 257; the width pass
//   in int32 (<= 255 * 257; dp4a when every tap fits a byte, else int32
//   multiply-adds), the height pass in f32: the taps and values
//   are non-negative integers, so partial sums only rise, every one below
//   2^24 is exact and a sum that reaches 2^24 gives 255 either way; then
//   (acc + 32768) >> 16 (divClampU8 for a non-negative accumulator);
// - borders: the host tables hold MIRROR-resolved positions for the whole
//   halo (ops/tables.py:halo_axis_table), so edge tiles and axes shorter than
//   the radius need no logic here.
// The Oklab epilogue is IEEE f32 (no fast math: cbrtf, not an approximation).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tile_staging.cuh"

namespace {

constexpr int kThreads = 256;  // also the gamma table's length
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows a thread of the height pass computes
constexpr int kMaxTaps = 512;

// The wrapper's ops/fused_pipeline.py:_Plan writes this layout.
struct K1Params {
  int B, H, W, C;      // C: the channels this launch computes
  int cs, c0;          // pixel stride of src and dst, first channel
  int OH, OW, r, k;    // blur radius and taps (k = 2r + 1; r = 0: no blur)
  int tw, th, tiles_x, tiles_y;
  int nr;              // halo rows of a tile (the column tables follow)
  int lg_gr;           // log2 of the 4-pixel groups of a resized row (staged)
  int lg_pr;           // log2 of the pixels of a resized row (gathered)
  int lg_gw;           // log2 of the 4-pixel groups of a width-pass row
  int lg_nch;          // log2 of the 8-row chunks of the height pass
  int lg_px;           // log2 of the pixels of an output row
  int rp;              // pitch of a channel plane's resized rows, bytes
  int up;              // pitch of the u8 tile's rows (Oklab), bytes
  int mp;              // pitch of the width pass's rows, f32 values
  int sp;              // pitch of the staged source rows, bytes
  int oklab, staged, vec_in;
  int dp4a;            // every tap fits a byte: the width pass runs on dp4a
  int off_x, off_y, off_lut, smem;  // shared-memory layout, bytes
  int taps[kMaxTaps];
  uint32_t taps4[kMaxTaps / 4];  // the taps as bytes, 4 a word, 0-padded
  float mix[18];  // _RGB2OKLMS then _OKLMS2LAB, (in, out), row-major
};

// Width pass of one channel: 4 outputs from the plane row s (4-byte
// aligned), taps t .. t + k - 1 at bytes j .. j + k - 1 of output j.
// K taps run on dp4a: (K + 3) / 4 packed tap words, each output's window
// as funnel-shifted words of the row.
template <int K>
__device__ __forceinline__ void row_pass(const uint8_t* s, const K1Params& p,
                                         int (&acc)[4]) {
  if constexpr (K > 0) {
    constexpr int G = (K + 3) / 4;
    uint32_t w[G + 1];
#pragma unroll
    for (int m = 0; m <= G; ++m) w[m] = reinterpret_cast<const uint32_t*>(s)[m];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned a = 0;
#pragma unroll
      for (int m = 0; m < G; ++m)
        a = __dp4a(q ? __funnelshift_r(w[m], w[m + 1], 8 * q) : w[m],
                   p.taps4[m], a);
      acc[q] = (int)a;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = 0;
    for (int t = 0; t < p.k; ++t) {
      const int w = p.taps[t];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += w * s[t + q];
    }
  }
}

// Height pass: kRows outputs down the column q (pitch in values).
template <int K>
__device__ __forceinline__ void col_pass(const float* q, int pitch,
                                         const K1Params& p,
                                         float (&acc)[kRows]) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
  if constexpr (K > 0) {
    float v[K + kRows - 1];
#pragma unroll
    for (int i = 0; i < K + kRows - 1; ++i) v[i] = q[i * pitch];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const float w = (float)p.taps[t];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = __fmaf_rn(w, v[j + t], acc[j]);
    }
  } else {
    for (int t = 0; t < p.k; ++t) {
      const float w = (float)p.taps[t];
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        acc[j] = __fmaf_rn(w, q[(j + t) * pitch], acc[j]);
    }
  }
}

// An int in [0, 2^23) as f32, exactly: 2^23 + v, less 2^23.
__device__ __forceinline__ float exact_float(int v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.0f);
}

// (acc + 32768) >> 16 clamped to 255, for an f32 accumulator that is an
// integer below 2^24 or a sum that reached 2^24 (255 either way):
// acc * 2^-16 + 0.5 is exact; clamped to [0, 255], adding 2^23 rounding
// down leaves floor() in the low byte.
__device__ __forceinline__ uint8_t div_clamp_u8(float a) {
  const float q = fminf(__fmaf_rn(a, 1.0f / 65536.0f, 0.5f), 255.0f);
  return (uint8_t)__float_as_uint(__fadd_rd(q, 8388608.0f));
}

// out[j] = in . mix[:, j] (mix (in, out), row-major)
__device__ __forceinline__ void mix3(const float* m, const float in[3],
                                     float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = in[0] * m[j] + in[1] * m[3 + j] + in[2] * m[6 + j];
}

// One resized value: rows A and B, columns a and b (byte offsets).
__device__ __forceinline__ uint8_t lerp2(const uint8_t* A, const uint8_t* Bq,
                                         int a, int b, int wx1, int wy1) {
  const int wx0 = 256 - wx1, wy0 = 256 - wy1;
  const int top = A[a] * wx0 + A[b] * wx1;
  const int bot = Bq[a] * wx0 + Bq[b] * wx1;
  return (uint8_t)min((top * wy0 + bot * wy1) >> 16, 255);
}

// One block: the output tile blockIdx.x, tw x th pixels of one image (tiles
// of an image in row order, images in order).
// ty, tx: int32 [3, n + 2r] halo tables (a, b, f); sy, sx: int32 [2, tiles]
// (first source row or column a tile reads, their count); lut_g: the 256
// values of the sRGB -> linear curve (OKLAB).
//
// Shared memory: the tables (an int4 a halo row and column), region X (the
// staged source span; then the width pass's f32 rows, the gamma table after
// them) and region Y (the resized rows, a plane a channel when there is a
// blur; then the u8 tile, interleaved, that the Oklab epilogue reads).
template <int C, int K, bool OKLAB, bool STAGED>
__global__ void __launch_bounds__(kThreads)
resize_blur_kernel(const uint8_t* __restrict__ src, void* __restrict__ dst,
                   const int* __restrict__ ty, const int* __restrict__ tx,
                   const int* __restrict__ sy, const int* __restrict__ sx,
                   const float* __restrict__ lut_g,
                   const __grid_constant__ K1Params p) {
  constexpr bool BLUR = K >= 0;
  // the plain resize: straight from the gathered source to the image
  constexpr bool DIRECT = !BLUR && !OKLAB;
  static_assert(BLUR || !STAGED, "a plan without blur gathers");
  // pixel stride and first channel: a gathering launch may compute C of
  // an image's cs channels (a channel group); a staged one has cs = C
  const int cs = STAGED ? C : p.cs, c0 = STAGED ? 0 : p.c0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* rt = reinterpret_cast<int4*>(smem);
  int4* ct = rt + p.nr;
  uint8_t* xs = smem + p.off_x;
  uint8_t* ys = smem + p.off_y;
  float* lut = reinterpret_cast<float*>(xs + p.off_lut);

  // where the tile lies: two divisions, once
  const int per = p.tiles_x * p.tiles_y;
  const int z = blockIdx.x / per;
  const int rem = blockIdx.x - z * per, by = rem / p.tiles_x;
  const int bx = rem - by * p.tiles_x;
  const int y0 = by * p.th, x0 = bx * p.tw;
  const int th = min(p.th, p.OH - y0), tw = min(p.tw, p.OW - x0);
  const int r = p.r, hh = th + 2 * r, hw = tw + 2 * r;
  // resized columns: hw4 computed (4-pixel groups), nres read by the width
  // pass (its dp4a words reach past hw, where the taps are 0, so those
  // bytes need no value)
  const int hw4 = (hw + 3) & ~3;
  const int nres = ((tw + 3) & ~3) + ((p.k + 3) & ~3) + 4;
  const int pp = p.nr * p.rp;  // bytes of a channel plane
  const size_t ipitch = (size_t)p.W * cs;
  const uint8_t* img = src + (size_t)z * p.H * ipitch + c0;
  const int nty = p.OH + 2 * r, ntx = p.OW + 2 * r;

  if constexpr (DIRECT) {
    // the plain resize: a pixel a thread, neighbouring threads on
    // neighbouring pixels, the tables and the source read through the
    // cache, no shared memory and no barrier (latency-bound: staging
    // measured slower, PERF.md)
    const int np = 1 << p.lg_px;
    const size_t opitch = (size_t)p.OW * cs;
    uint8_t* out = static_cast<uint8_t*>(dst) +
                   (((size_t)z * p.OH + y0) * p.OW + x0) * cs + c0;
    for (int u = threadIdx.x; u < (th << p.lg_px); u += kThreads) {
      const int y = u >> p.lg_px, j = u & (np - 1);
      if (j >= tw) continue;
      const int wy1 = ty[2 * nty + y0 + y], wx1 = tx[2 * ntx + x0 + j];
      const uint8_t* A = img + ty[y0 + y] * ipitch;
      const uint8_t* Bq = img + ty[nty + y0 + y] * ipitch;
      const int a = tx[x0 + j] * cs, b = tx[ntx + x0 + j] * cs;
#pragma unroll
      for (int c = 0; c < C; ++c)
        out[y * opitch + j * cs + c] = lerp2(A, Bq, a + c, b + c, wx1, wy1);
    }
    return;
  }

  // 1. the source span, in flight while the tables are staged
  int ylo = 0, xlo = 0, soff = 0;
  if constexpr (STAGED) {
    ylo = sy[by];
    xlo = sx[bx];
    const int ny = sy[p.tiles_y + by], nx = sx[p.tiles_x + bx];
    if (p.vec_in) {
      soff = (xlo * cs) & 15;
      stage_rows_async<kWarps>(img + ylo * ipitch + ((xlo * cs) & ~15),
                               ipitch, ny, (soff + nx * cs + 15) >> 4, xs,
                               p.sp);
      cp_async_commit();
    } else {
      const int nb = nx * cs;
      for (int i = warp; i < ny; i += kWarps) {
        const uint8_t* s = img + (ylo + i) * ipitch + xlo * cs;
        for (int j = lane; j < nb; j += 32) xs[i * p.sp + j] = s[j];
      }
    }
  }
  for (int i = threadIdx.x; i < hh; i += kThreads) {
    const int a = ty[y0 + i], b = ty[nty + y0 + i];
    rt[i] = STAGED ? make_int4((a - ylo) * p.sp, (b - ylo) * p.sp,
                               ty[2 * nty + y0 + i], 0)
                   : make_int4(a * (int)ipitch, b * (int)ipitch,
                               ty[2 * nty + y0 + i], 0);
  }
  for (int i = threadIdx.x; i < hw4; i += kThreads) {
    const int e = x0 + min(i, hw - 1);  // columns past hw repeat the last
    const int a = tx[e], b = tx[ntx + e];
    ct[i] = STAGED ? make_int4((a - xlo) * cs + soff, (b - xlo) * cs + soff,
                               tx[2 * ntx + e], 0)
                   : make_int4(a * cs, b * cs, tx[2 * ntx + e], 0);
  }
  if constexpr (OKLAB && !BLUR) lut[threadIdx.x] = lut_g[threadIdx.x];
  if constexpr (STAGED) {
    if (p.vec_in) cp_async_wait_all();
  }
  __syncthreads();

  // 2. resize the tile and its halo. With a blur, into a plane a channel
  //    (row y of a plane is halo row y) for the width pass; without, into
  //    the interleaved u8 tile, or (DIRECT) straight to the image.
  if constexpr (STAGED) {
    // 4 pixels x C a thread from shared memory, a word a channel
    const int gr = 1 << p.lg_gr;
    for (int u = threadIdx.x; u < (hh << p.lg_gr); u += kThreads) {
      const int y = u >> p.lg_gr, j = (u & (gr - 1)) << 2;
      if (j >= hw4) continue;
      const int4 row = rt[y];
      const uint8_t* A = xs + row.x;
      const uint8_t* Bq = xs + row.y;
      uint32_t o[C];
#pragma unroll
      for (int c = 0; c < C; ++c) o[c] = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 col = ct[j + q];
#pragma unroll
        for (int c = 0; c < C; ++c)
          o[c] |= (uint32_t)lerp2(A, Bq, col.x + c, col.y + c, col.z, row.z)
                  << (8 * q);
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        *reinterpret_cast<uint32_t*>(ys + c * pp + y * p.rp + j) = o[c];
    }
  } else {
    // a pixel a thread from global memory, neighbouring threads on
    // neighbouring pixels
    const int np = 1 << p.lg_pr;
    for (int u = threadIdx.x; u < (hh << p.lg_pr); u += kThreads) {
      const int y = u >> p.lg_pr, j = u & (np - 1);
      if (j >= hw) continue;
      const int4 row = rt[y], col = ct[j];
      const uint8_t* A = img + row.x;
      const uint8_t* Bq = img + row.y;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint8_t v = lerp2(A, Bq, col.x + c, col.y + c, col.z, row.z);
        if constexpr (BLUR)
          ys[c * pp + y * p.rp + j] = v;
        else
          ys[y * p.up + j * C + c] = v;
      }
    }
  }
  __syncthreads();

  if constexpr (BLUR) {
    // 3. width pass over every halo row: 4 pixels x C values a thread,
    //    stored interleaved as f32
    float* mid = reinterpret_cast<float*>(xs);
    if constexpr (OKLAB) lut[threadIdx.x] = lut_g[threadIdx.x];
    const int gw = 1 << p.lg_gw, ng = (tw + 3) >> 2;
    for (int u = threadIdx.x; u < (hh << p.lg_gw); u += kThreads) {
      const int y = u >> p.lg_gw, g = u & (gw - 1);
      if (g >= ng) continue;
      float v[4 * C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        int acc[4];
        row_pass<K>(ys + c * pp + y * p.rp + 4 * g, p, acc);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q * C + c] = exact_float(acc[q]);
      }
      float* d = mid + y * p.mp + g * 4 * C;
#pragma unroll
      for (int q = 0; q < 4 * C; q += 4)
        *reinterpret_cast<float4*>(d + q) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    }
    __syncthreads();

    // 4. height pass and divClampU8: a warp takes 8 rows x 32 consecutive
    //    values, into the u8 tile for the epilogue or straight to the
    //    image, 32 consecutive bytes of a row a store (value v is channel
    //    v % C of pixel v / C)
    const int nv = tw * C, nch = 1 << p.lg_nch, ncb = (nv + 31) >> 5;
    const size_t opitch = (size_t)p.OW * cs;
    uint8_t* out = static_cast<uint8_t*>(dst) +
                   (((size_t)z * p.OH + y0) * p.OW + x0) * cs + c0;
    for (int u = warp; u < (ncb << p.lg_nch); u += kWarps) {
      const int r0 = (u & (nch - 1)) * kRows;
      const int v = ((u >> p.lg_nch) << 5) + lane;
      if (r0 >= th || v >= nv) continue;
      float acc[kRows];
      col_pass<K>(mid + r0 * p.mp + v, p.mp, p, acc);
      uint8_t* o = OKLAB ? ys + r0 * p.up + v
                         : out + r0 * opitch +
                               (cs == C ? v : (v / C) * cs + v % C);
      const size_t op = OKLAB ? p.up : opitch;
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < th) o[j * op] = div_clamp_u8(acc[j]);
    }
    if constexpr (!OKLAB) return;
    __syncthreads();
  }

  // 5. the Oklab epilogue: a pixel a thread, neighbouring threads on
  //    neighbouring pixels, stored straight to the image
  if constexpr (OKLAB) {
    static_assert(C == 3, "the Oklab epilogue needs RGB");
    const int np = 1 << p.lg_px;
    const size_t opitch = (size_t)p.OW * 3;
    float* out = static_cast<float*>(dst) +
                 (((size_t)z * p.OH + y0) * p.OW + x0) * 3;
    for (int u = threadIdx.x; u < (th << p.lg_px); u += kThreads) {
      const int y = u >> p.lg_px, j = u & (np - 1);
      if (j >= tw) continue;
      const uint8_t* s = ys + y * p.up + 3 * j;
      const float lin[3] = {lut[s[0]], lut[s[1]], lut[s[2]]};
      float lms[3], lab[3];
      mix3(p.mix, lin, lms);
#pragma unroll
      for (int c = 0; c < 3; ++c) lms[c] = cbrtf(lms[c]);
      mix3(p.mix + 9, lms, lab);
      float* d = out + y * opitch + 3 * j;
      d[0] = lab[0];
      d[1] = lab[1];
      d[2] = lab[2];
    }
  }
}

struct Args {
  const void *src, *ty, *tx, *sy, *sx, *lut;
  void* dst;
};

template <int C, int K, bool OKLAB, bool STAGED>
int launch(const Args& a, const K1Params& p, cudaStream_t stream) {
  auto kernel = resize_blur_kernel<C, K, OKLAB, STAGED>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  const long long grid = (long long)p.tiles_x * p.tiles_y * p.B;
  if (grid < 1 || grid > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, p.smem, stream>>>(
      static_cast<const uint8_t*>(a.src), a.dst,
      static_cast<const int*>(a.ty), static_cast<const int*>(a.tx),
      static_cast<const int*>(a.sy), static_cast<const int*>(a.sx),
      static_cast<const float*>(a.lut), p);
  return cudaGetLastError();
}

// The blur's taps: none, 7, 11 or 13 unrolled (staged plans), or any.
template <int C, bool OKLAB, bool STAGED>
int by_taps(const Args& a, const K1Params& p, cudaStream_t s) {
  if (p.r == 0) return launch<C, -1, OKLAB, false>(a, p, s);
  if constexpr (STAGED) {
    switch (p.dp4a ? p.k : 0) {
      case 7:
        return launch<C, 7, OKLAB, true>(a, p, s);
      case 11:
        return launch<C, 11, OKLAB, true>(a, p, s);
      case 13:
        return launch<C, 13, OKLAB, true>(a, p, s);
    }
  }
  return launch<C, 0, OKLAB, STAGED>(a, p, s);
}

template <int C, bool OKLAB>
int by_staging(const Args& a, const K1Params& p, cudaStream_t s) {
  if (p.staged) return by_taps<C, OKLAB, true>(a, p, s);
  return by_taps<C, OKLAB, false>(a, p, s);
}

}  // namespace

extern "C" {

int zt_resize_params_bytes() { return (int)sizeof(K1Params); }

// Returns a cudaError_t: 0 when the launch was accepted. The caller checks
// shapes, dtypes and contiguity, allocates dst, and fills params: the tile,
// the shared-memory layout, the alignment flags and the taps.
int zt_fused_resize_blur_oklab(const void* src, void* dst, const void* ty,
                               const void* tx, const void* sy,
                               const void* sx, const void* lut,
                               const void* params, void* stream) {
  K1Params p;
  memcpy(&p, params, sizeof(p));
  if (p.C < 1 || p.k > kMaxTaps || (p.oklab && (p.C != 3 || !lut)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{src, ty, tx, sy, sx, lut, dst};
  if (p.oklab) return by_staging<3, true>(a, p, s);
  switch (p.C) {
    case 1:
      return by_staging<1, false>(a, p, s);
    case 3:
      return by_staging<3, false>(a, p, s);
    case 4:
      return by_staging<4, false>(a, p, s);
  }
  // any other C: one launch a group of at most 4 channels, pixel stride C,
  // through the gathering kernels (the wrapper plans no staging for it)
  for (int c0 = 0; c0 < p.C; c0 += 4) {
    K1Params q = p;
    q.C = p.C - c0 < 4 ? p.C - c0 : 4;
    q.cs = p.C;
    q.c0 = c0;
    int e;
    switch (q.C) {
      case 1:
        e = by_taps<1, false, false>(a, q, s);
        break;
      case 2:
        e = by_taps<2, false, false>(a, q, s);
        break;
      case 3:
        e = by_taps<3, false, false>(a, q, s);
        break;
      default:
        e = by_taps<4, false, false>(a, q, s);
        break;
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

const char* zt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
