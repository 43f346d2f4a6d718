// ORB's detect stage over the atlas of pyramid levels, for sm_90a: each
// kept level's FAST-9 score, its non-maximum suppression and its Harris
// response, as one kernel, written straight into the candidates' level
// order (features/orb.py:_Atlas.candidates; the plain version is
// _Atlas.candidates_reference).
//
// It replaces no TPU kernel: the JAX package's FAST, NMS and Harris are
// jnp (zignal_tpu/features/fast.py fast_response_map and _nms_device,
// zignal_tpu/features/orb.py _harris_map_device). It was added because the
// port's plain route ran them as ~80 PyTorch kernels a request over
// gathered copies of the plane (FAST's 16 taps and the NMS's 68
// neighbours, each a shifted int32 plane): on an H100 that stage took 25 ms
// of a 40-ms orb_stereo request of 8 KITTI-size frames.
//
// What bounds it on this card: bytes. The atlas is read once (13.4 MB of u8
// at B=8 of 1348 x 1241) and the f32 candidates written once (46 MB), ~60
// MB, 18 us at 3.35 TB/s; FAST's 16 taps and the NMS's 68 compares a pixel
// are a few hundred integer operations, under that at the card's rate. So
// every byte of the atlas is read from device memory once a tile (1.75
// times with the halo) and every value the stage derives from it stays in
// shared memory:
// - a block owns kTileRows x kTileCols pixels of one plane and stages the
//   u8 tile with a 7-pixel halo (3 for FAST's ring, 4 more for the NMS,
//   which covers Harris's 4: a 7 x 7 window of central differences), a
//   warp reading 32 consecutive bytes of a row (the atlas's rows, 1241
//   bytes at KITTI size, are not 16-byte aligned);
// - FAST scores the tile and a 4-pixel halo into shared memory as u16 (at
//   most 16 * 255), the threshold and the 3-pixel interior of each pixel's
//   own level taken from the level table in the parameter struct;
// - the NMS reads the 68 neighbours at distance < 5 from there; a pixel
//   off the plane scores 0;
// - only a pixel the NMS keeps needs its Harris response (about one in a
//   hundred on noisy frames), so the kept pixels are listed in shared
//   memory and each is one thread's 7 x 7 window, with no thread of a
//   warp idle on a pixel that is not kept. The window sums are integers
//   (4 ix^2 = dx^2 with dx = a[x + 1] - a[x - 1]), below 2^22, so each
//   is the plain route's exact f32 box sum times 4;
// - a block whose tile holds no level's pixel (empty shelf space) returns
//   before it reads anything.
//
// Exactness: every score, mask and window sum is an integer, so they equal
// the plain route's. The response follows ops/fma.py: det = fma(ixx, iyy,
// -(ixy * ixy)) and resp = fma(-(0.04 * trace), trace, det), the products
// of two f32 values exact in f64 and each sum rounded once to f32; the f32
// products and the trace are __fmul_rn and __fadd_rn, so nvcc contracts
// none of them. The output equals the plain route's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kTileRows = 32, kTileCols = 64;
constexpr int kRing = 3;                     // FAST's circle radius
constexpr int kNear = 4;                     // the NMS's reach, Harris's
constexpr int kHalo = kRing + kNear;
constexpr int kSrcRows = kTileRows + 2 * kHalo;
constexpr int kSrcCols = kTileCols + 2 * kHalo;
constexpr int kSrcPitch = 80;
constexpr int kScoreRows = kTileRows + 2 * kNear;
constexpr int kScoreCols = kTileCols + 2 * kNear;
constexpr int kLevelShift = 11;  // a kept pixel's entry: level << 11 | pixel
static_assert(kTileRows * kTileCols <= (1 << kLevelShift), "tile index");
static_assert(kMaxLevels <= 32, "a level mask is one word");
static_assert(kSrcCols <= kSrcPitch, "staged row pitch");

// The wrapper's ops/orb_detect.py:_DetectPlan writes this layout: B planes
// of H x W u8 in, B rows of N f32 candidates out; each kept level's place
// in the plane, size, FAST threshold and first candidate.
struct DetectParams {
  int B, H, W, N;
  int levels;
  int tile_rows, tile_cols;  // the kernel's own, checked
  int row[kMaxLevels], col[kMaxLevels], height[kMaxLevels],
      width[kMaxLevels], thr[kMaxLevels], start[kMaxLevels];
};

// A level's rectangle, threshold and first candidate, in shared memory.
struct Level {
  int r, c, h, w, t, start;
};

// The level of `mask` whose rectangle, `inset` pixels in from each side,
// holds (y, x); -1 where none does (the rectangles are disjoint).
__device__ __forceinline__ int level_at(const Level* lv, unsigned mask,
                                        int y, int x, int inset) {
  for (; mask; mask &= mask - 1) {
    const int i = __ffs(mask) - 1;
    const Level& l = lv[i];
    if (y >= l.r + inset && y < l.r + l.h - inset && x >= l.c + inset &&
        x < l.c + l.w - inset)
      return i;
  }
  return -1;
}

// Does the 16-tap circular mask hold a run of 9 set taps? The mask doubled
// to 32 bits, then the runs of 2, 4, 8 and 9 (features/fast.py:_has_run).
__device__ __forceinline__ bool has_run9(unsigned m) {
  unsigned r = m | (m << 16);
  r &= r >> 1;
  r &= r >> 2;
  r &= r >> 4;
  r &= r >> 1;
  return r != 0;
}

// FAST-9 score of the staged pixel at p with threshold t: the sum of
// |tap - v| over the taps where it exceeds t, if a circular run of 9 taps
// lies all above min(v + t, 255) or all below max(v - t, 0); else 0.
__device__ __forceinline__ int fast_score(const uint8_t* p, int t) {
  // features/fast.py CIRCLE_OFFSETS, clockwise from 12 o'clock
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3,
                           -2, -1};
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1,
                           -2, -3};
  const int v = *p;
  const int hi = min(v + t, 255), lo = max(v - t, 0);
  unsigned bright = 0, dark = 0;
  int score = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int x = p[kDy[k] * kSrcPitch + kDx[k]];
    bright |= (unsigned)(x > hi) << k;
    dark |= (unsigned)(x < lo) << k;
    const int d = abs(x - v);
    score += d > t ? d : 0;
  }
  return has_run9(bright) || has_run9(dark) ? score : 0;
}

// Does no neighbour at distance < 5 score above s? s points into the
// score tile, at least kNear from its edges.
__device__ __forceinline__ bool nms_keeps(const unsigned short* s) {
  const int v = *s;
  int best = 0;
#pragma unroll
  for (int dy = -kNear; dy <= kNear; ++dy)
#pragma unroll
    for (int dx = -kNear; dx <= kNear; ++dx)
      if ((dx || dy) && dx * dx + dy * dy < 25)
        best = max(best, (int)s[dy * kScoreCols + dx]);
  return v >= best;
}

// Harris response of the staged pixel at p: 7 x 7 sums of the central
// differences' products, then the plain route's two f64-rounded FMAs.
__device__ __forceinline__ float harris(const uint8_t* p) {
  int sxx = 0, syy = 0, sxy = 0;
#pragma unroll
  for (int wy = -3; wy <= 3; ++wy)
#pragma unroll
    for (int wx = -3; wx <= 3; ++wx) {
      const uint8_t* q = p + wy * kSrcPitch + wx;
      const int dx = (int)q[1] - (int)q[-1];
      const int dy = (int)q[kSrcPitch] - (int)q[-kSrcPitch];
      sxx += dx * dx;
      syy += dy * dy;
      sxy += dx * dy;
    }
  // (dx / 2)^2 summed: exact, the sums below 2^24
  const float ixx = __fmul_rn((float)sxx, 0.25f);
  const float iyy = __fmul_rn((float)syy, 0.25f);
  const float ixy = __fmul_rn((float)sxy, 0.25f);
  const float det = __double2float_rn(
      __dadd_rn(__dmul_rn((double)ixx, (double)iyy),
                (double)(-__fmul_rn(ixy, ixy))));
  const float trace = __fadd_rn(ixx, iyy);
  const float kt = __fmul_rn(0.04f, trace);
  return __double2float_rn(
      __dadd_rn(__dmul_rn(-(double)kt, (double)trace), (double)det));
}

template <bool HARRIS>
__global__ void __launch_bounds__(kThreads)
detect_kernel(const uint8_t* __restrict__ src, float* __restrict__ dst,
              const DetectParams p) {
  __shared__ __align__(16) uint8_t tile[kSrcRows * kSrcPitch];
  __shared__ unsigned short score[kScoreRows * kScoreCols];
  __shared__ unsigned short kept[kTileRows * kTileCols];
  __shared__ Level lv[kMaxLevels];
  __shared__ unsigned tile_mask, halo_mask;
  __shared__ int n_kept;

  const int y0 = blockIdx.y * kTileRows, x0 = blockIdx.x * kTileCols;
  // the levels that meet the tile, and those that meet its NMS halo
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    bool in_tile = false, in_halo = false;
    if (i < p.levels) {
      const Level l{p.row[i], p.col[i], p.height[i], p.width[i], p.thr[i],
                    p.start[i]};
      lv[i] = l;
      in_tile = l.r < y0 + kTileRows && l.r + l.h > y0 &&
                l.c < x0 + kTileCols && l.c + l.w > x0;
      in_halo = l.r < y0 + kTileRows + kNear && l.r + l.h > y0 - kNear &&
                l.c < x0 + kTileCols + kNear && l.c + l.w > x0 - kNear;
    }
    const unsigned t = __ballot_sync(0xffffffffu, in_tile);
    const unsigned h = __ballot_sync(0xffffffffu, in_halo);
    if (i == 0) {
      tile_mask = t;
      halo_mask = h;
      n_kept = 0;
    }
  }
  __syncthreads();
  if (tile_mask == 0) return;  // empty shelf space: nothing to write

  // the u8 tile and its halo; off the plane reads 0
  const uint8_t* plane = src + (size_t)blockIdx.z * p.H * p.W;
  for (int i = threadIdx.x; i < kSrcRows * kSrcCols; i += kThreads) {
    const int r = i / kSrcCols, c = i - r * kSrcCols;
    const int y = y0 - kHalo + r, x = x0 - kHalo + c;
    uint8_t v = 0;
    if (y >= 0 && y < p.H && x >= 0 && x < p.W) v = plane[(size_t)y * p.W + x];
    tile[r * kSrcPitch + c] = v;
  }
  __syncthreads();

  // FAST over the tile and the NMS halo, on each level's 3-px interior
  const unsigned hmask = halo_mask;
  for (int i = threadIdx.x; i < kScoreRows * kScoreCols; i += kThreads) {
    const int r = i / kScoreCols, c = i - r * kScoreCols;
    const int l = level_at(lv, hmask, y0 - kNear + r, x0 - kNear + c, kRing);
    score[i] = l < 0 ? 0
                     : fast_score(tile + (r + kRing) * kSrcPitch + c + kRing,
                                  lv[l].t);
  }
  __syncthreads();

  // the NMS; each pixel of a level written, but the kept ones of a Harris
  // run, which are listed
  const unsigned tmask = tile_mask;
  float* out = dst + (size_t)blockIdx.z * p.N;
  for (int j = threadIdx.x; j < kTileRows * kTileCols; j += kThreads) {
    const int ty = j / kTileCols, tx = j % kTileCols;
    const int y = y0 + ty, x = x0 + tx;
    const int l = level_at(lv, tmask, y, x, 0);
    if (l < 0) continue;
    const unsigned short* s = score + (ty + kNear) * kScoreCols + tx + kNear;
    const Level& v = lv[l];
    float* o = out + v.start + (y - v.r) * v.w + (x - v.c);
    if (*s == 0 || !nms_keeps(s)) {
      *o = -__int_as_float(0x7f800000);
    } else if (!HARRIS) {
      *o = (float)*s;
    } else if (y >= v.r + kNear && y < v.r + v.h - kNear &&
               x >= v.c + kNear && x < v.c + v.w - kNear) {
      kept[atomicAdd(&n_kept, 1)] = (unsigned short)(l << kLevelShift | j);
    } else {
      *o = 0.0f;
    }
  }
  if (!HARRIS) return;
  __syncthreads();

  // Harris on the kept pixels, one a thread
  for (int i = threadIdx.x; i < n_kept; i += kThreads) {
    const int e = kept[i], l = e >> kLevelShift;
    const int j = e & ((1 << kLevelShift) - 1);
    const int ty = j / kTileCols, tx = j % kTileCols;
    const Level& v = lv[l];
    out[v.start + (y0 + ty - v.r) * v.w + (x0 + tx - v.c)] =
        harris(tile + (ty + kHalo) * kSrcPitch + tx + kHalo);
  }
}

}  // namespace

extern "C" {

int zt_orb_detect_params_bytes() { return (int)sizeof(DetectParams); }

// Returns a cudaError_t: 0 when the launch was accepted. The caller checks
// the plane (u8, [B, H, W], contiguous) and the level table (each level
// inside the plane, the levels disjoint, each level's candidates inside
// [0, N)) and allocates dst, f32 [B, N]. harris: the response is Harris's,
// else the FAST score.
int zt_orb_detect(const void* src, void* dst, int harris, const void* params,
                  void* stream) {
  DetectParams p;
  memcpy(&p, params, sizeof(p));
  const int tiles_x = (p.W + kTileCols - 1) / kTileCols;
  const int tiles_y = (p.H + kTileRows - 1) / kTileRows;
  if (p.tile_rows != kTileRows || p.tile_cols != kTileCols ||
      p.levels < 1 || p.levels > kMaxLevels || p.B < 0 || p.B > 65535 ||
      p.H < 0 || p.W < 0 || tiles_y > 65535)
    return cudaErrorInvalidValue;
  if (p.B == 0 || tiles_x == 0 || tiles_y == 0) return cudaSuccess;
  const dim3 grid(tiles_x, tiles_y, p.B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* out = static_cast<float*>(dst);
  if (harris)
    detect_kernel<true><<<grid, kThreads, 0, s>>>(in, out, p);
  else
    detect_kernel<false><<<grid, kThreads, 0, s>>>(in, out, p);
  return cudaGetLastError();
}

}  // extern "C"
