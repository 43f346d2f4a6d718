// Canny's stencil stages for sm_90a, as one kernel: the Gaussian blur
// (MIRROR borders), the Sobel gradients (REPLICATE borders) and their
// magnitude, and the quantized non-maximum suppression, each output pixel
// from one shared-memory tile (ops/edges.py:canny is the plain version:
// ops/convolution.py convolve_separable and sobel_gradients,
// gradient_magnitude and edges._quantized_nms).
//
// It replaces no TPU kernel: the JAX package runs these stages as XLA's
// fused elementwise ops (zignal_tpu/ops/edges.py). It was added because
// the port's plain route runs them as ~300 PyTorch kernels a request,
// each multiply-add an f64 product, an f64 sum and a rounding: on an
// H100 a request of 8 KITTI-size frames spent 6.5 ms of host time
// issuing them, more than the card's own time for the whole request.
//
// Exactness: the plain route rounds as XLA's CPU backend contracts the
// JAX package's sums, each multiply-add ``fma(a, b, c)`` computed as the
// f64 product of two f32 values (exact), plus c in f64, rounded to f32
// (ops/fma.py). Here each is __dmul_rn, __dadd_rn and __double2float_rn,
// which nvcc never contracts, in the plain route's order:
// - a pass of the blur over taps k0, k1, ...: t = x[k1] * w1 (f32), then
//   t = fma(x[k0], w0, t), then t = fma(x[k], w, t) for each later tap;
//   the width pass first, then the height pass, each tap's source index
//   MIRROR-resolved, the taps those the wrapper keeps;
// - gx and gy: the nonzero Sobel taps in row-major order, the same way,
//   each source index clamped (REPLICATE);
// - the magnitude sqrt(fma(gx, gx, gy * gy)), __fsqrt_rn;
// - the NMS's products in f32 (__fmul_rn), a neighbour off the frame 0,
//   the frame's own pixels never kept.
// So the magnitude and the mask equal the plain route's bit for bit.
//
// What bounds it on this card: bytes. A frame is read once as f32 and
// the magnitude (f32) and the mask (u8) written once: 9 bytes a pixel, 34
// MB for 8 KITTI-size frames, 10 us at 3.35 TB/s; the 2 x 11 blur taps
// are 44 f64 operations a pixel, ~160 M for the request, ~5 us at the
// card's 34 TFLOP/s of f64. A block owns a 32 x 32 tile and stages its
// f32 input with a halo of the radius plus 2 (the blur's reach, Sobel's 1
// and the NMS's 1), then the width pass, the height pass, the gradients
// and the magnitude of the tile and a 1-pixel ring, and the mask, each in
// shared memory.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;        // output rows and columns of a block
constexpr int kMaxTaps = 33;     // a radius of at most 16
constexpr int kMaxRadius = kMaxTaps / 2;

struct FrontParams {
  int B, H, W;
  int nx, ny;                    // taps kept a pass (0: no blur)
  int radius;                    // half the taps of the blur
  int kx[kMaxTaps];              // kept taps' offsets, width pass
  int ky[kMaxTaps];              // height pass
  float wx[kMaxTaps];            // their weights
  float wy[kMaxTaps];
  float tan_k;                   // tan 22.5 degrees in f32
};

__device__ __forceinline__ int mirror(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m >= n ? period - m : m;
}

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// fma(a, b, c) as the plain route computes it
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b),
                                     (double)c));
}

__global__ void __launch_bounds__(kThreads)
front_kernel(const float* __restrict__ src, float* __restrict__ mag_out,
             uint8_t* __restrict__ mask_out, const FrontParams p) {
  extern __shared__ float smem[];
  const int H = p.H, W = p.W, R = p.radius;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int r1 = min(H - 1, r0 + kTile - 1), c1 = min(W - 1, c0 + kTile - 1);
  // the blurred region: the tile and 2 pixels, inside the frame
  const int br0 = max(0, r0 - 2), br1 = min(H - 1, r1 + 2);
  const int bc0 = max(0, c0 - 2), bc1 = min(W - 1, c1 + 2);
  // the width pass's rows and the input's columns
  const int tr0 = max(0, br0 - R), tr1 = min(H - 1, br1 + R);
  const int xc0 = max(0, bc0 - R), xc1 = min(W - 1, bc1 + R);
  const int nT = tr1 - tr0 + 1, nX = xc1 - xc0 + 1;
  const int nBr = br1 - br0 + 1, nBc = bc1 - bc0 + 1;
  // the gradients' region: the tile and 1 pixel, inside the frame
  const int gr0 = max(0, r0 - 1), gr1 = min(H - 1, r1 + 1);
  const int gc0 = max(0, c0 - 1), gc1 = min(W - 1, c1 + 1);
  const int nGr = gr1 - gr0 + 1, nGc = gc1 - gc0 + 1;
  const int stride_x = kTile + 4 + 2 * kMaxRadius;

  float* xs = smem;                                  // [nT][stride_x]
  float* temp = xs + stride_x * stride_x;            // [nT][kTile + 4]
  float* blur = temp + stride_x * (kTile + 4);       // [nBr][kTile + 4]
  float* gxs = blur + (kTile + 4) * (kTile + 4);     // [nGr][kTile + 2]
  float* gys = gxs + (kTile + 2) * (kTile + 2);
  float* mags = gys + (kTile + 2) * (kTile + 2);

  const long long plane = (long long)blockIdx.z * H * W;
  const float* in = src + plane;
  for (int i = threadIdx.x; i < nT * nX; i += kThreads) {
    const int r = i / nX, c = i % nX;
    xs[r * stride_x + c] = in[(long long)(tr0 + r) * W + xc0 + c];
  }
  __syncthreads();
  // the width pass: rows tr0..tr1, columns bc0..bc1
  for (int i = threadIdx.x; i < nT * nBc; i += kThreads) {
    const int r = i / nBc, c = i % nBc;
    const float* row = xs + r * stride_x;
    const int q = bc0 + c;
    float t;
    if (p.nx == 0) {
      t = row[q - xc0];
    } else if (p.nx == 1) {
      t = __fmul_rn(row[mirror(q + p.kx[0] - R, W) - xc0], p.wx[0]);
    } else {
      t = __fmul_rn(row[mirror(q + p.kx[1] - R, W) - xc0], p.wx[1]);
      t = fma_f64(row[mirror(q + p.kx[0] - R, W) - xc0], p.wx[0], t);
      for (int k = 2; k < p.nx; ++k)
        t = fma_f64(row[mirror(q + p.kx[k] - R, W) - xc0], p.wx[k], t);
    }
    temp[r * (kTile + 4) + c] = t;
  }
  __syncthreads();
  // the height pass: rows br0..br1
  for (int i = threadIdx.x; i < nBr * nBc; i += kThreads) {
    const int r = i / nBc, c = i % nBc;
    const int q = br0 + r;
    const float* col = temp + c;
    float t;
    if (p.ny == 0) {
      t = col[(q - tr0) * (kTile + 4)];
    } else if (p.ny == 1) {
      t = __fmul_rn(col[(mirror(q + p.ky[0] - R, H) - tr0) * (kTile + 4)],
                    p.wy[0]);
    } else {
      t = __fmul_rn(col[(mirror(q + p.ky[1] - R, H) - tr0) * (kTile + 4)],
                    p.wy[1]);
      t = fma_f64(col[(mirror(q + p.ky[0] - R, H) - tr0) * (kTile + 4)],
                  p.wy[0], t);
      for (int k = 2; k < p.ny; ++k)
        t = fma_f64(col[(mirror(q + p.ky[k] - R, H) - tr0) * (kTile + 4)],
                    p.wy[k], t);
    }
    blur[r * (kTile + 4) + c] = t;
  }
  __syncthreads();
  // Sobel and the magnitude over the tile and its ring
  for (int i = threadIdx.x; i < nGr * nGc; i += kThreads) {
    const int r = i / nGc, c = i % nGc;
    const int y = gr0 + r, x = gc0 + c;
    const int ya = clampi(y - 1, 0, H - 1) - br0, yb = y - br0,
              yc = clampi(y + 1, 0, H - 1) - br0;
    const int xa = clampi(x - 1, 0, W - 1) - bc0, xb = x - bc0,
              xc = clampi(x + 1, 0, W - 1) - bc0;
    const float* b = blur;
    const int s = kTile + 4;
    // gx: (0,0) -1, (0,2) 1, (1,0) -2, (1,2) 2, (2,0) -1, (2,2) 1
    float gx = __fmul_rn(b[ya * s + xc], 1.0f);
    gx = fma_f64(b[ya * s + xa], -1.0f, gx);
    gx = fma_f64(b[yb * s + xa], -2.0f, gx);
    gx = fma_f64(b[yb * s + xc], 2.0f, gx);
    gx = fma_f64(b[yc * s + xa], -1.0f, gx);
    gx = fma_f64(b[yc * s + xc], 1.0f, gx);
    // gy: (0,0) -1, (0,1) -2, (0,2) -1, (2,0) 1, (2,1) 2, (2,2) 1
    float gy = __fmul_rn(b[ya * s + xb], -2.0f);
    gy = fma_f64(b[ya * s + xa], -1.0f, gy);
    gy = fma_f64(b[ya * s + xc], -1.0f, gy);
    gy = fma_f64(b[yc * s + xa], 1.0f, gy);
    gy = fma_f64(b[yc * s + xb], 2.0f, gy);
    gy = fma_f64(b[yc * s + xc], 1.0f, gy);
    const int g = r * (kTile + 2) + c;
    gxs[g] = gx;
    gys[g] = gy;
    mags[g] = __fsqrt_rn(fma_f64(gx, gx, __fmul_rn(gy, gy)));
  }
  __syncthreads();
  // the NMS of the tile; the magnitude off the frame reads 0
  const int nr = r1 - r0 + 1, nc = c1 - c0 + 1;
  for (int i = threadIdx.x; i < nr * nc; i += kThreads) {
    const int y = r0 + i / nc, x = c0 + i % nc;
    const int g = (y - gr0) * (kTile + 2) + (x - gc0);
    const float gx = gxs[g], gy = gys[g], m = mags[g];
    auto at = [&](int dy, int dx) -> float {
      const int yy = y + dy, xx = x + dx;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) return 0.0f;
      return mags[(yy - gr0) * (kTile + 2) + (xx - gc0)];
    };
    const float ax = fabsf(gx), ay = fabsf(gy);
    const bool horiz = ay <= __fmul_rn(p.tan_k, ax);
    const bool vert = ax <= __fmul_rn(p.tan_k, ay);
    const bool diag45 = !horiz && !vert && __fmul_rn(gx, gy) > 0.0f;
    float n1, n2;
    if (horiz) {
      n1 = at(0, -1);
      n2 = at(0, 1);
    } else if (vert) {
      n1 = at(-1, 0);
      n2 = at(1, 0);
    } else if (diag45) {
      n1 = at(-1, 1);
      n2 = at(1, -1);
    } else {
      n1 = at(-1, -1);
      n2 = at(1, 1);
    }
    const bool inside = y >= 1 && y <= H - 2 && x >= 1 && x <= W - 2;
    const long long o = plane + (long long)y * W + x;
    mag_out[o] = m;
    mask_out[o] = (inside && m >= n1 && m >= n2) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int zt_canny_front_params_bytes() { return sizeof(FrontParams); }

// src: f32 [B, H, W]; mag: f32 and mask: u8 0/1, the same shape; params:
// a FrontParams packed by the wrapper. Returns a cudaError_t.
int zt_canny_front(const void* src, void* mag, void* mask,
                   const void* params, void* stream) {
  FrontParams p;
  memcpy(&p, params, sizeof(p));
  if (p.B < 0 || p.H < 1 || p.W < 1 || p.B > 65535 || p.radius < 0 ||
      p.radius > kMaxRadius || p.nx < 0 || p.nx > kMaxTaps || p.ny < 0 ||
      p.ny > kMaxTaps)
    return cudaErrorInvalidValue;
  if (p.B == 0) return cudaSuccess;
  // 47,344 bytes: under the 48 KiB a block takes without opting in
  const int stride_x = kTile + 4 + 2 * kMaxRadius;
  const size_t smem = sizeof(float) *
      (stride_x * stride_x + stride_x * (kTile + 4) +
       (kTile + 4) * (kTile + 4) + 3 * (kTile + 2) * (kTile + 2));
  const dim3 grid((p.W + kTile - 1) / kTile, (p.H + kTile - 1) / kTile, p.B);
  front_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(mag),
      static_cast<uint8_t*>(mask), p);
  return cudaGetLastError();
}

}  // extern "C"
