// ORB's describe stage over the atlas of pyramid levels, for sm_90a: each
// selected keypoint's intensity-centroid angle, its 256 rotated BRIEF
// bits and its row, as one kernel (features/orb.py:_Atlas.describe; the
// plain version is _Atlas.describe_reference).
//
// It replaces no TPU kernel: the JAX package's angle and BRIEF are jnp
// gathers (zignal_tpu/features/orb.py). It was added because the port's
// plain route ran them as ~120 PyTorch kernels a request over int64 index
// tensors of [B, K, 709] and [B, K, 256] and their f64 multiply-adds,
// some 3 GB of traffic: on an H100 that stage took 2.97 ms of a 16.2-ms
// orb_stereo request (8 KITTI-size frames, 1,999 keypoints each).
//
// What bounds it on this card: operations. A keypoint's work is 709 patch
// values times 5 and 256 pairs of rotated samples, ~7,900 operations, and
// its bytes are its window of the atlas (which the detect kernel has just
// left in L2), its inputs and its 53-byte outputs. So each keypoint reads
// its window once and everything else stays on chip:
// - one warp a keypoint, kWarps a block; a 1-D grid over (plane, group of
//   kWarps keypoints);
// - the warp stages the keypoint's window of radius R (the wrapper's
//   REACH, derived from the pattern: every rounded rotated sample lies
//   within R of the keypoint, and R covers the orientation patch) into
//   shared memory, a pixel off the keypoint's level stored as 0. The
//   plain angle reads such a pixel as 0, and a BRIEF sample off the level
//   loses its bit through `ok`, so one zero-filled window serves both;
// - the lanes sum m00, m10 and m01 over the circular patch as int32, which
//   is exact, and reduce them by shuffles;
// - each lane computes the angle, then takes pairs lane, lane + 32, ...,
//   lane + 224; each of the 8 ballots of the warp is one 32-bit word of
//   the descriptor, bit i of word q pair 32 q + i: the plain route's bytes
//   packed little first. Lanes 0-7 store the 8 words as one 32-byte row,
//   lanes 0-4 the row's five fields, lane 0 `valid`;
// - a sample that lies inside its level but outside the window (only at
//   coordinates past 2^19, where the f32 spacing moves the rounded sample)
//   is read from the plane, so the bits never depend on R.
//
// Exactness: the moments are integers. The angle follows _angles: each
// moment converted to f32, the f32 quotients by max(m00, 1e-6), atan2 in
// double rounded to f32, times f32(180 / pi); 0 where m00 < 0.001. BRIEF
// follows _brief and ops/fma.py: rad = angle * f32(pi / 180), cos and sin
// in double rounded to f32, each rotated coordinate fma(-sin, py, fma(cos,
// px, kx)) (fma(cos, py, fma(sin, px, ky))) with each product and sum in
// double and rounded to f32, then rounded half to even. Every f32 and f64
// operation is an intrinsic with its rounding named, so nvcc contracts
// none of them; double atan2, cos and sin are the CUDA math library's,
// which PyTorch's double ops call on the card too. The output equals the
// plain route's bit for bit on every row, valid or not.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;                  // keypoints a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPairs = 256;                // BRIEF's pairs
constexpr int kWords = kPairs / 32;        // a descriptor's 32-bit words
constexpr int kFields = 5;                 // features/orb.py KEYPOINT_FIELDS
// a row of the table, read as two int4: level, row, col, h, w; the first
// x and y a valid keypoint may take, the x and the y it must lie before
constexpr int kTableCols = 8;
static_assert(kPairs <= kThreads, "a thread stages one pair");
static_assert(kFields <= 32 && kWords <= 32, "a lane writes a field, a word");

// f32 constants of _angles and _brief, as numpy rounds them
constexpr float kDegrees = (float)(180.0 / 3.141592653589793);
constexpr float kRadians = (float)(3.141592653589793 / 180.0);

// The wrapper's ops/orb_describe.py:_DescribePlan writes this layout: B
// planes of H x W u8, K keypoints a plane; the staged window's radius,
// the orientation patch's radius, the kernel's warps a block (checked),
// and BRIEF's pairs (x1, y1, x2, y2).
struct DescribeParams {
  int B, H, W, K;
  int radius, half;
  int warps;
  int8_t pattern[kPairs][4];
};

// a * b + c with one rounding to f32: the product of two f32 values is
// exact in f64, the sum rounded to f64, then to f32 (ops/fma.py)
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__global__ void __launch_bounds__(kThreads)
describe_kernel(const uint8_t* __restrict__ src,
                const float* __restrict__ resp,
                const long long* __restrict__ idx,
                const int* __restrict__ table, float* __restrict__ rows,
                uint8_t* __restrict__ desc, uint8_t* __restrict__ valid,
                const DescribeParams p) {
  extern __shared__ uint8_t windows[];
  __shared__ char4 pairs[kPairs];
  if (threadIdx.x < kPairs) {
    const int8_t* q = p.pattern[threadIdx.x];
    pairs[threadIdx.x] = make_char4(q[0], q[1], q[2], q[3]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (p.K + kWarps - 1) / kWarps;
  const int b = blockIdx.x / groups;
  const int k = (blockIdx.x - b * groups) * kWarps + warp;
  if (k >= p.K) return;  // the whole warp: no block barrier follows

  const int4* t =
      reinterpret_cast<const int4*>(table + (size_t)k * kTableCols);
  const int4 t0 = t[0], t1 = t[1];
  const int level = t0.x, r0 = t0.y, c0 = t0.z, h = t0.w, w = t1.x;
  const size_t at = (size_t)b * p.K + k;
  const float score = resp[at];
  const long long i = idx[at];
  const int y = (int)(i / w), x = (int)(i - (long long)y * w);
  const uint8_t* plane = src + (size_t)b * p.H * p.W;

  // the window, 0 off the keypoint's level; a side over 32 wraps a lane's
  // next cell at most once, so the loop unrolls and its loads overlap
  const int R = p.radius, side = 2 * R + 1;
  uint8_t* win = windows + warp * side * side;
  int wy = lane / side, wx = lane % side;
#pragma unroll 4
  for (int j = lane; j < side * side; j += 32) {
    const int ly = y - R + wy, lx = x - R + wx;
    uint8_t v = 0;
    if (ly >= 0 && ly < h && lx >= 0 && lx < w)
      v = plane[(size_t)(r0 + ly) * p.W + c0 + lx];
    win[j] = v;
    const bool wrap = wx + 32 >= side;
    wx += wrap ? 32 - side : 32;
    wy += wrap;
  }
  __syncwarp();

  // the moments over the circular patch, exact in int32
  const uint8_t* centre = win + R * side + R;
  const int half = p.half, pd = 2 * half + 1;
  int m00 = 0, m10 = 0, m01 = 0;
  for (int j = lane, dy = lane / pd - half, dx = lane % pd - half;
       j < pd * pd; j += 32) {
    if (dx * dx + dy * dy <= half * half) {
      const int v = centre[dy * side + dx];
      m00 += v;
      m10 += v * dx;
      m01 += v * dy;
    }
    for (dx += 32; dx > half; dx -= pd) ++dy;
  }
  m00 = warp_sum(m00);
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);

  // the angle in degrees, as _angles rounds it
  const float f00 = (float)m00;
  const float safe = fmaxf(f00, 1e-6f);
  const float qy = __fdiv_rn((float)m01, safe), qx = __fdiv_rn((float)m10,
                                                                safe);
  float angle = __fmul_rn(
      __double2float_rn(atan2((double)qy, (double)qx)), kDegrees);
  if (f00 < 0.001f) angle = 0.0f;

  // BRIEF: pairs lane + 32 q, one ballot a word
  const float rad = __fmul_rn(angle, kRadians);
  const float ca = __double2float_rn(cos((double)rad));
  const float sa = __double2float_rn(sin((double)rad));
  const float kx = (float)x, ky = (float)y;
  auto pixel = [&](int ry, int rx) -> int {  // (ry, rx) on the level
    const int wy = ry - y + R, wx = rx - x + R;
    if ((unsigned)wy < (unsigned)side && (unsigned)wx < (unsigned)side)
      return win[wy * side + wx];
    return plane[(size_t)(r0 + ry) * p.W + c0 + rx];
  };
  unsigned word = 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const char4 pr = pairs[q * 32 + lane];
    const float x1 = pr.x, y1 = pr.y, x2 = pr.z, y2 = pr.w;
    const int rx1 = __float2int_rn(fma_f64(-sa, y1, fma_f64(ca, x1, kx)));
    const int ry1 = __float2int_rn(fma_f64(ca, y1, fma_f64(sa, x1, ky)));
    const int rx2 = __float2int_rn(fma_f64(-sa, y2, fma_f64(ca, x2, kx)));
    const int ry2 = __float2int_rn(fma_f64(ca, y2, fma_f64(sa, x2, ky)));
    const bool ok = rx1 >= 0 && rx1 < w && ry1 >= 0 && ry1 < h &&
                    rx2 >= 0 && rx2 < w && ry2 >= 0 && ry2 < h;
    const bool bit = ok && pixel(ry1, rx1) < pixel(ry2, rx2);
    const unsigned ballot = __ballot_sync(0xffffffffu, bit);
    if (lane == q) word = ballot;
  }
  if (lane < kWords)
    reinterpret_cast<unsigned*>(desc + at * (kWords * 4))[lane] = word;

  // the row: response, x, y, angle, level; and its validity
  if (lane < kFields)
    rows[at * kFields + lane] = lane == 0   ? score
                                : lane == 1 ? kx
                                : lane == 2 ? ky
                                : lane == 3 ? angle
                                            : (float)level;
  if (lane == 0)
    valid[at] = isfinite(score) && x >= t1.y && x < t1.z && y >= t1.y &&
                y < t1.w;
}

}  // namespace

extern "C" {

int zt_orb_describe_params_bytes() { return (int)sizeof(DescribeParams); }

// Returns a cudaError_t: 0 when the launch was accepted. The wrapper
// (ops/orb_describe.py) checks the plane (u8, [B, H, W], contiguous), resp
// (f32 [B, K]) and idx (int64 [B, K]), takes the row table (int32 [K, 8],
// as kTableCols says) only as a RowTable of this plane's H x W, whose rows
// were checked on the host when it was built (each level inside the
// plane), and allocates rows (f32 [B, K, 5]), desc (u8 [B, K, 32]) and
// valid (bool [B, K]). The kernel reads only pixels of a row's level, so
// an index off its level reads nothing outside the plane.
int zt_orb_describe(const void* src, const void* resp, const void* idx,
                    const void* table, void* rows, void* desc, void* valid,
                    const void* params, void* stream) {
  DescribeParams p;
  memcpy(&p, params, sizeof(p));
  if (p.warps != kWarps || p.half < 0 || p.radius < p.half ||
      2 * p.radius + 1 <= 32 || p.B < 0 || p.K < 0 || p.H < 0 || p.W < 0)
    return cudaErrorInvalidValue;
  if (p.B == 0 || p.K == 0) return cudaSuccess;
  const long long blocks =
      (long long)p.B * ((p.K + kWarps - 1) / kWarps);
  const int side = 2 * p.radius + 1;
  const size_t smem = (size_t)kWarps * side * side;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  describe_kernel<<<(unsigned)blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const float*>(resp),
      static_cast<const long long*>(idx), static_cast<const int*>(table),
      static_cast<float*>(rows), static_cast<uint8_t*>(desc),
      static_cast<uint8_t*>(valid), p);
  return cudaGetLastError();
}

}  // extern "C"
