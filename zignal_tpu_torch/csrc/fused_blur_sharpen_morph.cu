// The config-3 filter chain on a u8 plane, for sm_90a: 8.8 Gaussian blur
// (MIRROR) -> sharpen over a clamped (2r+1)^2 window -> threshold (> thr ->
// 255, else 0) -> 3x3 dilate -> 3x3 erode (zero padding), one kernel.
//
// Replaces the TPU kernel zignal_tpu/ops/pallas_filter.py:
// fused_blur_sharpen_morph. It computes what that kernel computes, not what
// its blocks do: the TPU version carries base-256 digits through bf16 band
// dots and shifts the masks with lane rolls; here the int32 ALUs are exact.
//
// What bounds it on this card: the instructions it issues, not HBM. A
// pixel costs 2 B of HBM traffic (33.5 MB at B=16 of 1024^2, 0.010 ms at
// 3.35 TB/s) against 26 blur MACs, the box sums, the sharpen and 2 mask
// passes. Two kernels compute it, and the wrapper's plan picks one: the
// streamed kernel (further down: warps walk down column strips, so no row
// is computed twice and no block waits at a barrier) wherever its blur and
// sharpen fit its registers and a segment is more than its warm-up rows,
// else this tile kernel, which recomputes each tile's halo. The tile
// kernel keeps each stage at a few instructions an element:
// - one block owns a th x tw output tile of one plane (the wrapper picks
//   the tile by shared memory and grid size; the block finds its tile in
//   the 1-D grid with two divisions); every intermediate row has a pitch
//   of BW = 2^lg_bw elements, so threads map to (row, column) with a shift
//   and a mask, and no stage divides;
// - the taps are kernel parameters, in the constant bank; the tap counts
//   of sigma 1, 1.5 and 2 (7, 11, 13) are template arguments and fully
//   unrolled, the rest run a loop; the row pitch of the main tiles, 64, is
//   one too, so their shared-memory offsets are immediates;
// - an interior tile stages its input rows as 16-byte cp.async copies
//   when the plane's rows are 16-byte aligned; only edge tiles read the
//   MIRROR halo tables (tile_staging.cuh);
// - the blur width pass computes 4 adjacent columns a thread from kb + 3
//   bytes in registers; the height pass 8 rows down a column from kb + 7
//   values; the box sums run as running sums, 4 columns or 8 rows a thread;
// - masks are 0 or 255, so the 3x3 dilate and erode are byte-wise OR and
//   AND over 3 rows and 3 columns, 4 pixels a 32-bit word, one pass each.
//
// Regions around the tile origin (y0, x0), each as [start, end) rows and
// the same for columns, with h = 2 + rs and g = h + rb:
//   input    [y0 - g, y0 + th + g)   MIRROR-resolved
//   blurred  [y0 - h, y0 + th + h)   0 outside the image
//   mask     [y0 - 2, y0 + th + 2)   0 outside the image
//   dilated  [y0 - 1, y0 + th + 1)   0 outside the image
//   output   [y0, y0 + th)
// Blurred values outside the image are 0, so the box sum over the full
// window is the clamped-window sum; the box area is the product of the
// clamped window lengths, never a count of MIRROR halo values. The dilated
// region is set back to 0 outside the image before the erode, as the TPU
// kernel does (pallas_filter.py:178-186): the erode must see border zeros.
//
// Exactness (bit-identical to the JAX chain):
// - blur: taps round(k * 256) >= 0 summing to at most 257, so the width
//   pass is <= 255 * 257 and the height pass <= 255 * 257^2 < 2^31; then
//   (acc + 32768) >> 16, divClampU8 for a non-negative accumulator;
// - sharpen: JAX's own branch, chosen by the wrapper with JAX's bound rule.
//   The f32 form is 2b - s * f32(1/a), floor(v + 0.5), clip, with IEEE ops
//   that nvcc may not contract (__frcp_rn, __fmul_rn, ...): the JAX
//   program's area is a constant, and XLA turns its s / a into s times the
//   reciprocal, which differs from a true division at a few pixels in 10^4
//   (ops/integral.py). The int form is 2b - q - (2 rem > a) from q = s / a,
//   rem = s - q a;
// - threshold: (float)v > thr in f32, thr never rounded to an integer;
// - dilate and erode: max and min of values in {0, 255} are OR and AND.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tile_staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows a thread computes in a vertical pass
constexpr int kMaxTaps = 512;
constexpr int kLgBW = 6;  // log2 of the row pitch compiled as a constant
constexpr int kStreamTaps = 16;

// The wrapper's ops/filter_chain.py:_params writes this layout.
struct FilterParams {
  int B, H, W;
  int rb, rs, kb;      // blur radius, sharpen radius, blur taps (2 rb + 1)
  int th, tw;          // output tile rows and columns (tw % 4 == 0)
  int tiles_x, tiles_y;  // tiles of a plane
  int lg_bw;           // log2 of the pitch of every intermediate row
  int iws;             // pitch of the staged input rows, bytes (% 16 == 0)
  int vec_in;          // rows of src are 16-byte aligned
  int vec_out;         // rows of dst are 4-byte aligned
  int int_form;        // sharpen in integers (JAX's bound rule)
  int off_a, off_bl, off_m0, off_m1, smem;  // shared-memory layout, bytes
  int stream;          // 1: the streamed kernel, with the fields below
  int skb;             // its tap count: kb padded with zero taps
  int h4;              // blurred columns left of a strip's output, % 4 == 0
  int sw;              // output columns of a strip
  int strips;          // strips of a plane
  int seg, segs;       // output rows of a segment, segments of a strip
  float thr;
  float inv_full;      // f32(1) / f32((2 rs + 1)^2)
  int taps[kMaxTaps];
  int staps[kStreamTaps];  // the taps centred in skb, zeros around them
};

// The mask of one pixel: sharpen(b, s) > thr, for the blurred value b and
// the window sum s over an area of ay * ax pixels whose reciprocal is inv
// (ignored by the int form). The f32 form compares the clamped, floored
// f32 value itself: it is the integer the JAX program thresholds.
template <bool INT_FORM>
__device__ __forceinline__ bool over(int b, int s, float ay, float ax,
                                     float inv, float thr) {
  if constexpr (INT_FORM) {
    const int a = (int)__fmul_rn(ay, ax);
    const int q = s / a;
    const int rem = s - q * a;
    return (float)min(max(2 * b - q - (2 * rem > a ? 1 : 0), 0), 255) > thr;
  } else {
    const float mean = __fmul_rn((float)s, inv);
    const float v = __fsub_rn(__fmul_rn(2.0f, (float)b), mean);
    return fminf(fmaxf(floorf(__fadd_rn(v, 0.5f)), 0.0f), 255.0f) > thr;
  }
}

// Length of the window [i - r, i + r] clamped to [0, n), as f32.
__device__ __forceinline__ float extent(int i, int n, int r) {
  return (float)(min(i + r, n - 1) - max(i - r, 0) + 1);
}

// Blur width pass: 4 adjacent outputs from the bytes s[0, kb + 3).
template <int KB>
__device__ __forceinline__ int4 blur_row4(const uint8_t* s,
                                          const FilterParams& p) {
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if constexpr (KB > 0) {
    int x[KB + 3];
#pragma unroll
    for (int i = 0; i < KB + 3; ++i) x[i] = s[i];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int t = p.taps[k];
      a0 += t * x[k];
      a1 += t * x[k + 1];
      a2 += t * x[k + 2];
      a3 += t * x[k + 3];
    }
  } else {
    int x0 = s[0], x1 = s[1], x2 = s[2];
    for (int k = 0; k < p.kb; ++k) {
      const int x3 = s[k + 3], t = p.taps[k];
      a0 += t * x0;
      a1 += t * x1;
      a2 += t * x2;
      a3 += t * x3;
      x0 = x1;
      x1 = x2;
      x2 = x3;
    }
  }
  return make_int4(a0, a1, a2, a3);
}

// Blur height pass: kRows outputs down the column q (row pitch 2^lg).
template <int KB>
__device__ __forceinline__ void blur_col(const int* q, int lg,
                                         const FilterParams& p,
                                         int (&acc)[kRows]) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0;
  if constexpr (KB > 0) {
    int v[KB + kRows - 1];
#pragma unroll
    for (int i = 0; i < KB + kRows - 1; ++i) v[i] = q[i << lg];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int t = p.taps[k];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] += t * v[j + k];
    }
  } else {
    for (int k = 0; k < p.kb; ++k) {
      const int t = p.taps[k];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] += t * q[(j + k) << lg];
    }
  }
}

__device__ __forceinline__ uint32_t word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 4 pixels of a 3x3 OR (AND = false) or AND (AND = true) of 0/255 masks:
// the word at s and the 3 rows from it, each combined over the columns
// c, c + 1, c + 2 of its 4 pixels c.
template <bool AND>
__device__ __forceinline__ uint32_t rows3(const uint8_t* s, int pitch) {
  uint32_t w[3], n[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i] = word(s + i * pitch);
    n[i] = word(s + i * pitch + 4);
  }
  uint32_t v = AND ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t a = w[i], b = __funnelshift_r(w[i], n[i], 8),
                   c = __funnelshift_r(w[i], n[i], 16);
    v = AND ? (v & a & b & c) : (v | a | b | c);
  }
  return v;
}

// The tile t of the tiles_x x tiles_y tiles of a plane, planes in order,
// and how its input region is staged.
struct Tile {
  int z, y0, x0, th, tw;
  bool interior;  // the input region lies inside the plane
  bool vec;       // ... and its rows are 16-byte aligned: cp.async
  int off;        // column 0 of the input region at in[r * iws + off]
};

__device__ __forceinline__ Tile tile_at(int t, const FilterParams& p) {
  const int per = p.tiles_x * p.tiles_y;
  Tile g;
  g.z = t / per;  // once a block: the stages never divide
  const int rem = t - g.z * per, by = rem / p.tiles_x;
  g.y0 = by * p.th;
  g.x0 = (rem - by * p.tiles_x) * p.tw;
  g.th = min(p.th, p.H - g.y0);
  g.tw = min(p.tw, p.W - g.x0);
  const int gg = 2 + p.rs + p.rb;
  g.interior = g.y0 >= gg && g.y0 + g.th + gg <= p.H && g.x0 >= gg &&
               g.x0 + g.tw + gg <= p.W;
  g.vec = g.interior && p.vec_in;
  g.off = g.vec ? (g.x0 - gg) & 15 : 0;
  return g;
}

// An interior, aligned tile's input rows as cp.async copies.
__device__ __forceinline__ void stage_async(const uint8_t* src, const Tile& g,
                                            const FilterParams& p,
                                            uint8_t* in) {
  const int gg = 2 + p.rs + p.rb;
  stage_rows_async<kWarps>(
      src + ((size_t)g.z * p.H + g.y0 - gg) * p.W + ((g.x0 - gg) & ~15), p.W,
      g.th + 2 * gg, (g.off + g.tw + 2 * gg + 15) >> 4, in, p.iws);
}

// Any other tile's input rows: contiguous for an interior tile, through
// the halo tables at an edge (table entry y0 + r is input row y0 - g + r).
// A warp gathers kStageRows rows at a time with all their loads in flight.
__device__ __forceinline__ void stage_gather(const uint8_t* src,
                                             const int* ty, const int* tx,
                                             const Tile& g,
                                             const FilterParams& p,
                                             uint8_t* in) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gg = 2 + p.rs + p.rb, ih = g.th + 2 * gg, iw = g.tw + 2 * gg;
  const uint8_t* img = src + (size_t)g.z * p.H * p.W;
  for (int r0 = warp; r0 < ih; r0 += kWarps * kStageRows) {
    const uint8_t* rows[kStageRows];
#pragma unroll
    for (int i = 0; i < kStageRows; ++i) {
      const int r = min(r0 + i * kWarps, ih - 1);
      rows[i] = img + (size_t)(g.interior ? g.y0 - gg + r : ty[g.y0 + r]) *
                          p.W;
    }
    for (int c = lane; c < iw; c += 32) {
      const int gx = g.interior ? g.x0 - gg + c : tx[g.x0 + c];
      uint8_t v[kStageRows];
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) v[i] = rows[i][gx];
#pragma unroll
      for (int i = 0; i < kStageRows; ++i)
        if (r0 + i * kWarps < ih) in[(r0 + i * kWarps) * p.iws + c] = v[i];
    }
  }
}

// One block: the output tile blockIdx.x, th x tw pixels of one plane.
// ty/tx: int32 [n + 2g] MIRROR-resolved input positions of [-g, n + g).
template <int KB, int LG, bool INT_FORM>
__global__ void __launch_bounds__(kThreads)
filter_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
              const int* __restrict__ ty, const int* __restrict__ tx,
              const __grid_constant__ FilterParams p) {
  // LG > 0: rows of pitch 2^LG, a constant, so shared-memory offsets are
  // immediates
  const int H = p.H, W = p.W, rs = p.rs, lg = LG > 0 ? LG : p.lg_bw;
  const int BW = 1 << lg, lgG = lg - 2, G = BW >> 2;
  const int h = 2 + rs, g = h + p.rb, ks = 2 * rs + 1;
  const float full = (float)ks;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* in = smem;                                   // [ih][iws]
  int* A = reinterpret_cast<int*>(smem + p.off_a);      // [ih + 8][BW]
  uint8_t* bl = smem + p.off_bl;                        // [bh][BW]
  uint8_t* m0 = smem + p.off_m0;                        // [mh][BW]
  uint8_t* m1 = smem + p.off_m1;                        // [mh][BW]

  // 1. the input region; column j of row r at in[r * iws + off + j]
  const Tile cur = tile_at(blockIdx.x, p);
  if (cur.vec) {
    stage_async(src, cur, p, in);
    cp_async_commit();
    cp_async_wait_all();
  } else {
    stage_gather(src, ty, tx, cur, p, in);
  }
  __syncthreads();

  const int y0 = cur.y0, x0 = cur.x0, th = cur.th, tw = cur.tw;
  const int ih = th + 2 * g;                   // input region rows
  const int bh = th + 2 * h, bw = tw + 2 * h;  // blurred region
  const int mh = th + 4, mw = tw + 4;          // mask region
  const int dh = th + 2, dw = tw + 2;          // dilated region
  const int off = cur.off;
  uint8_t* out = dst + (size_t)cur.z * H * W;

  // 2. blur, width pass: every input row, the blurred region's columns
  for (int u = threadIdx.x; u < (ih << lgG); u += kThreads) {
    const int r = u >> lgG, c0 = (u & (G - 1)) << 2;
    if (c0 < bw)
      *reinterpret_cast<int4*>(A + (r << lg) + c0) =
          blur_row4<KB>(in + r * p.iws + off + c0, p);
  }
  __syncthreads();

  // 3. blur, height pass and divClampU8; 0 outside the image
  for (int u = threadIdx.x; u < (((bh + kRows - 1) / kRows) << lg);
       u += kThreads) {
    const int c = u & (BW - 1), r0 = (u >> lg) * kRows;
    if (c >= bw) continue;
    int acc[kRows];
    blur_col<KB>(A + (r0 << lg) + c, lg, p, acc);
    const int x = x0 - h + c;
    const bool col_in = x >= 0 && x < W;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + j, y = y0 - h + r;
      if (r < bh)
        bl[(r << lg) + c] = col_in && y >= 0 && y < H
                                ? (uint8_t)min((acc[j] + 32768) >> 16, 255)
                                : 0;
    }
  }
  __syncthreads();

  // 4. box sums, width pass (into A): mask column c sums blurred columns
  //    c .. c + 2rs, as a running sum over 4 columns
  for (int u = threadIdx.x; u < (bh << lgG); u += kThreads) {
    const int r = u >> lgG, c0 = (u & (G - 1)) << 2;
    if (c0 >= mw) continue;
    const uint8_t* s = bl + (r << lg) + c0;
    int a = 0;
    for (int j = 0; j < ks; ++j) a += s[j];
    int4 o;
    o.x = a;
    a += s[ks] - s[0];
    o.y = a;
    a += s[ks + 1] - s[1];
    o.z = a;
    a += s[ks + 2] - s[2];
    o.w = a;
    *reinterpret_cast<int4*>(A + (r << lg) + c0) = o;
  }
  __syncthreads();

  // 5. box sums, height pass as a running sum over 8 rows; sharpen;
  //    threshold; 0 outside the image. Away from the border the window is
  //    (2rs + 1)^2 and the host's f32(1) / f32(area) is __frcp_rn(area).
  for (int u = threadIdx.x; u < (((mh + kRows - 1) / kRows) << lg);
       u += kThreads) {
    const int c = u & (BW - 1), r0 = (u >> lg) * kRows;
    if (c >= mw) continue;
    const int* q = A + (r0 << lg) + c;
    const uint8_t* bp = bl + ((r0 + rs) << lg) + c + rs;
    // every load first: the stores below may not alias them
    int lo[kRows], hi[kRows], bv[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      lo[j] = q[j << lg];
      hi[j] = q[(j + ks) << lg];
      bv[j] = bp[j << lg];
    }
    int s = 0;
    for (int i = 0; i < ks; ++i) s += q[i << lg];
    const int x = x0 - 2 + c;
    const bool col_in = x >= 0 && x < W;
    const bool col_full = x >= rs && x + rs < W;
    const float ax = extent(x, W, rs);
    uint8_t* mp = m0 + (r0 << lg) + c;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = y0 - 2 + r0 + j;
      if (r0 + j < mh) {
        bool m = false;
        if (col_in && y >= 0 && y < H) {
          float ay = full, inv = p.inv_full;
          if (!(col_full && y >= rs && y + rs < H)) {
            ay = extent(y, H, rs);
            inv = __frcp_rn(__fmul_rn(ay, ax));
          }
          m = over<INT_FORM>(bv[j], s, ay, ax, inv, p.thr);
        }
        mp[j << lg] = m ? 255 : 0;
      }
      s += hi[j] - lo[j];
    }
  }
  __syncthreads();

  // 6. dilate: OR over 3 rows of the OR of 3 columns, 4 pixels a word;
  //    back to 0 outside the image before the erode
  const bool d_in = y0 >= 1 && y0 + th + 1 <= H && x0 >= 1 && x0 + tw + 1 <= W;
  for (int u = threadIdx.x; u < (dh << lgG);
       u += kThreads) {
    const int r = u >> lgG, c0 = (u & (G - 1)) << 2;
    if (c0 >= dw) continue;
    uint32_t v = rows3<false>(m0 + (r << lg) + c0, BW);
    if (!d_in) {
      const int y = y0 - 1 + r;
      uint32_t keep = 0;
      if (y >= 0 && y < H) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int x = x0 - 1 + c0 + j;
          if (x >= 0 && x < W) keep |= 0xFFu << (8 * j);
        }
      }
      v &= keep;
    }
    *reinterpret_cast<uint32_t*>(m1 + (r << lg) + c0) = v;
  }
  __syncthreads();

  // 7. erode: AND over 3 rows of the AND of 3 columns; u8 store, a word
  //    where the row allows
  for (int u = threadIdx.x; u < (th << lgG);
       u += kThreads) {
    const int r = u >> lgG, c0 = (u & (G - 1)) << 2;
    if (c0 >= tw) continue;
    const uint32_t v = rows3<true>(m1 + (r << lg) + c0, BW);
    uint8_t* o = out + (size_t)(y0 + r) * W + x0 + c0;
    if (p.vec_out && c0 + 4 <= tw) {
      *reinterpret_cast<uint32_t*>(o) = v;
    } else {
      for (int j = 0; j < 4 && c0 + j < tw; ++j) o[j] = (uint8_t)(v >> (8 * j));
    }
  }
}


template <int KB, int LG, bool INT_FORM>
int launch(const void* src, void* dst, const void* ty, const void* tx,
           const FilterParams& p, cudaStream_t stream) {
  auto kernel = filter_kernel<KB, LG, INT_FORM>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return e;
  }
  const long long grid = (long long)p.tiles_x * p.tiles_y * p.B;
  if (grid < 1 || grid > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid, kThreads, p.smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int*>(ty), static_cast<const int*>(tx), p);
  return cudaGetLastError();
}

template <int LG, bool INT_FORM>
int launch_taps(const void* src, void* dst, const void* ty, const void* tx,
                const FilterParams& p, cudaStream_t s) {
  switch (p.kb) {
    case 7:
      return launch<7, LG, INT_FORM>(src, dst, ty, tx, p, s);
    case 11:
      return launch<11, LG, INT_FORM>(src, dst, ty, tx, p, s);
    case 13:
      return launch<13, LG, INT_FORM>(src, dst, ty, tx, p, s);
    default:
      return launch<0, LG, INT_FORM>(src, dst, ty, tx, p, s);
  }
}

template <bool INT_FORM>
int launch_pitch(const void* src, void* dst, const void* ty, const void* tx,
                 const FilterParams& p, cudaStream_t s) {
  if (p.lg_bw == kLgBW)
    return launch_taps<kLgBW, INT_FORM>(src, dst, ty, tx, p, s);
  return launch_taps<0, INT_FORM>(src, dst, ty, tx, p, s);
}

// ---------------------------------------------------------------------------
// The streamed path: no tiles. A warp owns a column strip of one plane and
// walks down a segment of its rows, kBlock input rows an iteration, and carries
// every vertical window from row to row, so a row is computed once a
// segment, not once a tile that overlaps it:
// - lane l computes the blurred columns cb + 4 l .. cb + 4 l + 3, so a strip
//   computes 128 blurred columns; its output is the sw = 128 - 2 h4 columns
//   from x0 = cb + h4 (h4: h = rs + 2 rounded up to 4, so each output lane
//   stores one aligned word);
// - an iteration takes kBlock input rows: their copy into shared memory
//   was issued during the iteration before, and the next block's copy is
//   issued as soon as this one's width pass has read its rows: cp.async
//   where the strip's span of a row lies inside 16-byte aligned rows, else
//   each lane gathers its 5 bytes a row through the MIRROR table, all the
//   block's loads in flight before any store;
// - the blur width pass reads its lane's bytes as words and takes four taps
//   a __dp4a (taps <= 255); its columns travel two a word, each < 2^16 (the
//   taps sum to at most 257, 255 * 257 < 2^16);
// - the width-pass rows go to a per-lane ring of the last 32 in shared
//   memory (each lane reads only what it wrote, so it needs no barrier);
//   the height pass computes the block's kBlock blurred rows at once from
//   KB + kBlock - 1 of them;
// - the block's rows then run the box sums (two columns a word, each
//   < 2^16, with a running sum over rows), the sharpen, the threshold and
//   the 3x3 OR and AND, unrolled so that the rows interleave; what a row
//   needs of the block before (2 RS + 1 width sums, RS blurred rows, 2 rows
//   of the dilate's and the erode's) is carried in registers;
// - horizontal neighbours come from the next lanes (__shfl_*), merged with
//   __funnelshift; nothing waits for another warp (a block is one warp);
// - a segment starts 2 g input rows above its first output row (the only
//   vertical halo); those warm-up rows skip the stages whose window is not
//   full yet. Rows outside the plane are zeroed row by row (one test a
//   row), columns outside by a mask word.
// The arithmetic is the tile kernel's: the same integer sums, the same
// rounding, OR and AND, and the f32 form of over: the wrapper's plan keeps
// the int form on the tile kernel (at r <= 3 JAX's bound rule never takes
// it).

constexpr int kBlock = 4;                // input rows an iteration
constexpr int kRowBytes = 160;           // a ring row: >= 128 + 12 + 15
constexpr int kChunks = kRowBytes / 16;  // 16-byte copies a row
constexpr int kGather = kRowBytes / 32;  // bytes a lane gathers a row
constexpr int kARows = 32;               // width-pass rows kept
constexpr int kWCarry = 8;               // width sums carried: >= 2 RS + 1

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte i | byte i + 2 << 16 of the little-endian bytes of the words w, for
// i in [0, 4 NW - 2)
template <int NW>
__device__ __forceinline__ void byte_pairs(const uint32_t (&w)[NW],
                                           uint32_t (&e)[4 * NW - 2]) {
  uint32_t lo[NW], hi[NW];
#pragma unroll
  for (int m = 0; m < NW; ++m) {
    lo[m] = __byte_perm(w[m], 0, 0x4240);  // bytes 0 and 2
    hi[m] = __byte_perm(w[m], 0, 0x4341);  // bytes 1 and 3
  }
#pragma unroll
  for (int m = 0; m < NW; ++m) {
    e[4 * m] = lo[m];
    e[4 * m + 1] = hi[m];
    if (m + 1 < NW) {
      e[4 * m + 2] = __funnelshift_r(lo[m], lo[m + 1], 16);
      e[4 * m + 3] = __funnelshift_r(hi[m], hi[m + 1], 16);
    }
  }
}

template <int KB>
struct Stream {
  static constexpr int RB = KB / 2;
  // the byte of a lane's first word where its window starts: (-rb) & 3,
  // as cb is a multiple of 4 and the ring row starts 16-byte aligned
  static constexpr int A = (4 - RB % 4) % 4;
  // __dp4a a column of the width pass, and the words a lane reads a row
  static constexpr int NT = (KB + 3) / 4;
  static constexpr int NW = (A + 4 * NT + 2) / 4 + 1;
  // width-pass rows one height pass reads
  static constexpr int VR = KB + kBlock - 1;
};

// Blur width pass of a lane's 4 columns, A_j = sum_k t_k byte[a + j + k]
// of the bytes of its words w: four taps a __dp4a (tq[c]: taps 4c .. 4c +
// 3 as bytes, so each <= 255), returned as the pairs A_0 | A_2 << 16 and
// A_1 | A_3 << 16 (each A <= 255 * 257 < 2^16)
template <int KB>
__device__ __forceinline__ void blur_row_dp4a(
    const uint32_t (&w)[Stream<KB>::NW], const uint32_t (&tq)[Stream<KB>::NT],
    uint32_t& a02, uint32_t& a13) {
  using S = Stream<KB>;
  uint32_t a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = 0;
#pragma unroll
    for (int c = 0; c < S::NT; ++c) {
      const int b = S::A + j + 4 * c, q = b >> 2, sh = b & 3;
      a[j] = __dp4a(sh ? __funnelshift_r(w[q], w[q + 1], 8 * sh) : w[q],
                    tq[c], a[j]);
    }
  }
  a02 = __byte_perm(a[0], a[2], 0x5410);
  a13 = __byte_perm(a[1], a[3], 0x5410);
}

// One warp: the strip blockIdx.x % strips of segment (blockIdx.x / strips)
// % segs of plane blockIdx.x / (strips segs), for KB taps and sharpen
// radius RS.
// ty/tx: int32 [n + 2g] MIRROR-resolved input positions of [-g, n + g),
// g = 2 + RS + KB / 2.
template <int KB, int RS>
__global__ void __launch_bounds__(32, 16)
streamed_filter_kernel(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst,
                       const int* __restrict__ ty, const int* __restrict__ tx,
                       const __grid_constant__ FilterParams p) {
  using S = Stream<KB>;
  constexpr int RB = S::RB, NW = S::NW, NT = S::NT, VR = S::VR;
  __shared__ __align__(16) uint8_t ring[kBlock * kRowBytes];  // input
  __shared__ uint32_t a02r[kARows][32], a13r[kARows][32];      // width pass

  constexpr int g = 2 + RS + RB;
  constexpr float full = 2 * RS + 1;
  const int lane = threadIdx.x;
  const int H = p.H, W = p.W;

  // the warp's strip and segment; n iterations read input rows y0 - g + i
  const int per = p.strips * p.segs;
  const int z = blockIdx.x / per, rem = blockIdx.x - z * per;
  const int sy = rem / p.strips, sx = rem - sy * p.strips;
  const int x0 = sx * p.sw, cb = x0 - p.h4;
  const int y0 = sy * p.seg, y1 = min(y0 + p.seg, H);
  const int n = y1 - y0 + 2 * g;
  // ring byte q holds input column o + q; a lane's window starts at e + 4 l
  const int o = (cb - RB) & ~15, e = cb - RB - o;
  const bool vec = p.vec_in && o >= 0 && o + kRowBytes <= W;
  const uint8_t* img = src + (size_t)z * H * W;
  uint8_t* out = dst + (size_t)z * H * W;

  // the lane's columns: inside the plane, window extents, the reciprocal
  // of a full row's window area, the bytes it stores
  const int c0 = cb + 4 * lane;
  uint32_t colmask = 0;
  float ax[4], invc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + j;
    if (c >= 0 && c < W) colmask |= 0xFFu << (8 * j);
    ax[j] = extent(c, W, RS);
    invc[j] = c >= RS && c + RS < W ? p.inv_full
                                    : __frcp_rn(__fmul_rn(full, ax[j]));
  }
  const bool out_lane = c0 >= x0 && c0 < x0 + p.sw && c0 < W;
  const bool out_word = out_lane && p.vec_out && c0 + 4 <= W;

  // the gather's columns: ring bytes lane + 32 t, MIRROR-resolved
  int gcol[kGather];
  if (!vec) {
#pragma unroll
    for (int t = 0; t < kGather; ++t)
      gcol[t] = tx[min(max(o + lane + 32 * t + g, 0), W + 2 * g - 1)];
  }
  // input rows i0 .. i0 + kBlock - 1 (clamped to the last) into the ring,
  // row i0 + r at slot r: cp.async copies, or the gather's loads, all in
  // flight before any store
  auto stage = [&](int i0) {
    const uint8_t* rows[kBlock];
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      const int y = y0 - g + min(i0 + r, n - 1);
      rows[r] = img + (size_t)(y >= 0 && y < H ? y : ty[y + g]) * W;
    }
    if (vec) {
      if (lane < kChunks) {
#pragma unroll
        for (int r = 0; r < kBlock; ++r)
          cp_async16(ring + r * kRowBytes + 16 * lane, rows[r] + o + 16 * lane);
      }
      cp_async_commit();
    } else {
      uint8_t v[kBlock][kGather];
#pragma unroll
      for (int r = 0; r < kBlock; ++r)
#pragma unroll
        for (int t = 0; t < kGather; ++t) v[r][t] = rows[r][gcol[t]];
#pragma unroll
      for (int r = 0; r < kBlock; ++r)
#pragma unroll
        for (int t = 0; t < kGather; ++t)
          ring[r * kRowBytes + lane + 32 * t] = v[r][t];
    }
  };
  stage(0);
  uint32_t tq[NT];  // the taps as bytes, zeros past KB
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    tq[c] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * c + b < KB) tq[c] |= (uint32_t)p.staps[4 * c + b] << (8 * b);
  }

  // carried from block to block: the box sums over rows, the last 2 RS + 1
  // width sums, the last RS blurred rows, the last 2 rows of the dilate's
  // column ORs and of the erode's column ANDs
  uint32_t s02 = 0, s13 = 0, pw02[kWCarry] = {}, pw13[kWCarry] = {},
           pbl[kBlock] = {}, phm[2] = {}, phe[2] = {};

  for (int i0 = 0; i0 < n; i0 += kBlock) {
    // 1. blur width pass of input rows y0 - g + i, i in [i0, i0 + kBlock)
    if (vec) cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      const uint8_t* rowp = ring + r * kRowBytes + (e & ~3) + 4 * lane;
      uint32_t w[NW], a02, a13;
#pragma unroll
      for (int m = 0; m < NW; ++m)
        w[m] = *reinterpret_cast<const uint32_t*>(rowp + 4 * m);
      blur_row_dp4a<KB>(w, tq, a02, a13);
      a02r[(i0 + r) & (kARows - 1)][lane] = a02;
      a13r[(i0 + r) & (kARows - 1)][lane] = a13;
    }
    __syncwarp();
    if (i0 + kBlock < n) stage(i0 + kBlock);  // in flight during 2. and 3.

    // 2. blur height pass and divClampU8 of blurred rows y0 - g + i - RB,
    //    i in [i0, i0 + kBlock), from width-pass rows i0 - 2 RB .. i0 +
    //    kBlock - 1; 0 outside the image
    uint32_t blw[kBlock] = {};
    if (i0 + kBlock > 2 * RB) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // column j: the pair j & 1, half j >> 1
        int v[VR];
#pragma unroll
        for (int t = 0; t < VR; ++t) {
          const int row = (i0 - 2 * RB + t) & (kARows - 1);
          const uint32_t pr = (j & 1) ? a13r[row][lane] : a02r[row][lane];
          v[t] = (j >> 1) ? (int)(pr >> 16) : (int)(pr & 0xFFFF);
        }
#pragma unroll
        for (int r = 0; r < kBlock; ++r) {
          int acc = 32768;
#pragma unroll
          for (int k = 0; k < KB; ++k) acc += p.staps[k] * v[r + k];
          blw[r] |= (uint32_t)min(acc >> 16, 255) << (8 * j);
        }
      }
#pragma unroll
      for (int r = 0; r < kBlock; ++r) {
        const int br = y0 - g + i0 + r - RB;
        blw[r] = br >= 0 && br < H ? blw[r] & colmask : 0;
      }
    }

    // 3. each row of the block: box sums, sharpen, threshold, dilate,
    //    erode; a stage runs where its window is full
    uint32_t n02[kBlock], n13[kBlock], hm[kBlock], he[kBlock];
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      const int i = i0 + r;
      const int br = y0 - g + i - RB;  // the blurred row
      // box width sums of row br (two columns a word), 0 before the first
      n02[r] = n13[r] = 0;
      if (i >= 2 * RB) {
        const uint32_t w3[3] = {__shfl_up_sync(~0u, blw[r], 1), blw[r],
                                __shfl_down_sync(~0u, blw[r], 1)};
        uint32_t q[10];  // q[4 + d]: column d | column d + 2 << 16
        byte_pairs<3>(w3, q);
        n02[r] = q[4];
        n13[r] = q[5];
#pragma unroll
        for (int d = 1; d <= RS; ++d) {
          n02[r] += q[4 - d] + q[4 + d];
          n13[r] += q[5 - d] + q[5 + d];
        }
      }
      // the running sum over rows br - 2 RS .. br: each half stays in
      // [0, 2^16), so the word arithmetic is exact
      constexpr int back = 2 * RS + 1;
      s02 += n02[r] - (r >= back ? n02[r - back] : pw02[kWCarry + r - back]);
      s13 += n13[r] - (r >= back ? n13[r - back] : pw13[kWCarry + r - back]);

      // sharpen and threshold: mask row my = br - RS, 0 outside
      const int my = br - RS;
      uint32_t mw = 0;
      if (i >= 2 * g - 4 && my >= 0 && my < H) {
        const uint32_t bc = r >= RS ? blw[r - RS] : pbl[kBlock + r - RS];
        const int s[4] = {(int)(s02 & 0xFFFF), (int)(s13 & 0xFFFF),
                          (int)(s02 >> 16), (int)(s13 >> 16)};
        float ay = full, inv[4] = {invc[0], invc[1], invc[2], invc[3]};
        if (!(my >= RS && my + RS < H)) {  // a row near the top or bottom
          ay = extent(my, H, RS);
#pragma unroll
          for (int j = 0; j < 4; ++j) inv[j] = __frcp_rn(__fmul_rn(ay, ax[j]));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (over<false>((bc >> (8 * j)) & 0xFF, s[j], ay, ax[j], inv[j],
                          p.thr))
            mw |= 0xFFu << (8 * j);
        mw &= colmask;
      }
      // the OR of columns c - 1, c, c + 1 of mask row my
      hm[r] = mw | __funnelshift_l(__shfl_up_sync(~0u, mw, 1), mw, 8) |
              __funnelshift_r(mw, __shfl_down_sync(~0u, mw, 1), 8);

      // dilate: row my - 1, the OR of mask rows my - 2 .. my, back to 0
      // outside the image before the erode; the AND of its columns
      const int dy = my - 1;
      uint32_t d = 0;
      if (i >= 2 * g - 2 && dy >= 0 && dy < H)
        d = (hm[r] | (r >= 1 ? hm[r - 1] : phm[1]) |
             (r >= 2 ? hm[r - 2] : phm[r])) & colmask;
      he[r] = d & __funnelshift_l(__shfl_up_sync(~0u, d, 1), d, 8) &
              __funnelshift_r(d, __shfl_down_sync(~0u, d, 1), 8);

      // erode: output row my - 2, the AND of dilated rows my - 3 .. my - 1
      if (i >= 2 * g && i < n) {
        const uint32_t v = he[r] & (r >= 1 ? he[r - 1] : phe[1]) &
                           (r >= 2 ? he[r - 2] : phe[r]);
        uint8_t* op = out + (size_t)(my - 2) * W + c0;
        if (out_word) {
          *reinterpret_cast<uint32_t*>(op) = v;
        } else if (out_lane) {
          op[0] = (uint8_t)v;
          if (c0 + 1 < W) op[1] = (uint8_t)(v >> 8);
          if (c0 + 2 < W) op[2] = (uint8_t)(v >> 16);
          if (c0 + 3 < W) op[3] = (uint8_t)(v >> 24);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kWCarry; ++c) {
      pw02[c] = c + kBlock < kWCarry ? pw02[c + kBlock]
                                     : n02[c + kBlock - kWCarry];
      pw13[c] = c + kBlock < kWCarry ? pw13[c + kBlock]
                                     : n13[c + kBlock - kWCarry];
    }
#pragma unroll
    for (int r = 0; r < kBlock; ++r) pbl[r] = blw[r];
    phm[0] = hm[kBlock - 2];
    phm[1] = hm[kBlock - 1];
    phe[0] = he[kBlock - 2];
    phe[1] = he[kBlock - 1];
  }
  if (vec) cp_async_wait<0>();
}

template <int KB, int RS>
int launch_streamed(const void* src, void* dst, const void* ty,
                    const void* tx, const FilterParams& p,
                    cudaStream_t stream) {
  const long long grid = (long long)p.B * p.strips * p.segs;
  if (grid < 1 || grid > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  streamed_filter_kernel<KB, RS><<<(unsigned)grid, 32, 0, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int*>(ty), static_cast<const int*>(tx), p);
  return cudaGetLastError();
}

template <int RS>
int launch_stream_taps(const void* src, void* dst, const void* ty,
                       const void* tx, const FilterParams& p,
                       cudaStream_t s) {
  switch (p.skb) {
    case 7:
      return launch_streamed<7, RS>(src, dst, ty, tx, p, s);
    case 13:
      return launch_streamed<13, RS>(src, dst, ty, tx, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch_stream_radius(const void* src, void* dst, const void* ty,
                         const void* tx, const FilterParams& p,
                         cudaStream_t s) {
  switch (p.rs) {
    case 0:
      return launch_stream_taps<0>(src, dst, ty, tx, p, s);
    case 1:
      return launch_stream_taps<1>(src, dst, ty, tx, p, s);
    case 2:
      return launch_stream_taps<2>(src, dst, ty, tx, p, s);
    case 3:
      return launch_stream_taps<3>(src, dst, ty, tx, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int zt_filter_params_bytes() { return (int)sizeof(FilterParams); }

// Returns a cudaError_t: 0 when the launch was accepted. The caller checks
// shapes, dtypes and contiguity, allocates dst, and fills params: the tile,
// the shared-memory layout, the alignment flags and the sharpen form
// (int_form) by the JAX package's bound rule.
int zt_fused_blur_sharpen_morph(const void* src, void* dst, const void* ty,
                                const void* tx, const void* params,
                                void* stream) {
  FilterParams p;
  memcpy(&p, params, sizeof(p));
  if (p.kb < 1 || p.kb > kMaxTaps || p.lg_bw < 4) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.stream) {
    if (p.kb > p.skb) return cudaErrorInvalidValue;
    for (int k = 0; k < kStreamTaps; ++k)  // bytes of a __dp4a
      if (p.staps[k] < 0 || p.staps[k] > 255) return cudaErrorInvalidValue;
    if (p.int_form) return cudaErrorInvalidValue;  // the tile kernel's
    return launch_stream_radius(src, dst, ty, tx, p, s);
  }
  if (p.int_form) return launch_pitch<true>(src, dst, ty, tx, p, s);
  return launch_pitch<false>(src, dst, ty, tx, p, s);
}

}  // extern "C"
