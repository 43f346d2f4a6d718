// The config-3 filter chain on a u8 plane, for sm_90a: 8.8 Gaussian blur
// (MIRROR) -> sharpen over a clamped (2r+1)^2 window -> threshold (> thr ->
// 255, else 0) -> 3x3 dilate -> 3x3 erode (zero padding), one kernel.
//
// Replaces the TPU kernel zignal_tpu/ops/pallas_filter.py:
// fused_blur_sharpen_morph. It computes what that kernel computes, not what
// its blocks do: the TPU version carries base-256 digits through bf16 band
// dots and shifts the masks with lane rolls; here the int32 ALUs are exact.
//
// What bounds it on this card: the integer pipes and shared memory, not
// HBM. A pixel costs 2 B of HBM traffic (33.5 MB at B=16 of 1024^2, 0.010
// ms at 3.35 TB/s) against 26 blur MACs plus the halo the tile recomputes,
// the box sums, the sharpen and 2 mask passes. The design keeps each of
// those at a few instructions an element:
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
  float thr;
  float inv_full;      // f32(1) / f32((2 rs + 1)^2)
  int taps[kMaxTaps];
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
  if (p.int_form) return launch_pitch<true>(src, dst, ty, tx, p, s);
  return launch_pitch<false>(src, dst, ty, tx, p, s);
}

}  // extern "C"
