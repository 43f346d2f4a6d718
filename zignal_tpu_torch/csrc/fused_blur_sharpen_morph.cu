// The config-3 filter chain on a u8 plane, for sm_90a: 8.8 Gaussian blur
// (MIRROR) -> sharpen over a clamped (2r+1)^2 window -> threshold (> thr ->
// 255, else 0) -> 3x3 dilate -> 3x3 erode (zero padding), one kernel.
//
// Replaces the TPU kernel zignal_tpu/ops/pallas_filter.py:
// fused_blur_sharpen_morph. It computes what that kernel computes, not what
// its blocks do: the TPU version carries base-256 digits through bf16 band
// dots and shifts the masks with lane rolls; here the int32 ALUs are exact,
// so every stage is a plain loop over shared memory.
//
// What should bound it on this card: the integer pipes, not HBM. A pixel
// costs 2 B of HBM traffic (u8 in, u8 out: 33.5 MB at B=16 of 1024^2, 0.010
// ms at 3.35 TB/s) against about 40 integer MACs for the blur and the box
// sums plus 18 compares for the morphology, and the halo of every stage is
// recomputed by each tile (a 32-px tile at sigma 2, r 2 blurs a 40^2 region
// from 52^2 inputs). One block owns one 32x32 output tile of one plane and
// keeps every intermediate in shared memory: input region -> blur width
// pass (int32) -> blur height pass (u8) -> box width pass (int32) -> box
// height pass, sharpen, threshold (u8 mask) -> dilate (u8) -> erode -> one
// u8 store.
//
// Regions around the tile origin (y0, x0), each as [start, end) rows and
// the same for columns, with h = 2 + rs and g = h + rb:
//   input    [y0 - g, y0 + th + g)   through the MIRROR halo tables
//   blurred  [y0 - h, y0 + th + h)   0 outside the image
//   mask     [y0 - 2, y0 + th + 2)   0 outside the image
//   dilated  [y0 - 1, y0 + th + 1)   0 outside the image
//   output   [y0, y0 + th)
// Blurred values outside the image are 0, so the box sum over the full
// window is the clamped-window sum; the box area comes from the extents
// tables, never from MIRROR halo values. The dilated region is set back to
// 0 outside the image before the erode, as the TPU kernel does
// (pallas_filter.py:178-186): the erode must see border zeros there.
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
// - threshold: (float)v > thr in f32, thr never rounded to an integer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

template <bool INT_FORM>
__device__ __forceinline__ int sharpen(int b, int s, float ay, float ax) {
  const float area = __fmul_rn(ay, ax);
  if constexpr (INT_FORM) {
    const int a = (int)area;
    const int q = s / a;
    const int rem = s - q * a;
    return min(max(2 * b - q - (2 * rem > a ? 1 : 0), 0), 255);
  } else {
    const float mean = __fmul_rn((float)s, __frcp_rn(area));
    const float v = __fsub_rn(__fmul_rn(2.0f, (float)b), mean);
    return (int)fminf(fmaxf(floorf(__fadd_rn(v, 0.5f)), 0.0f), 255.0f);
  }
}

// One block: one tile x tile output tile of plane blockIdx.z.
// ty/tx: int32 [n + 2g] MIRROR-resolved input positions of [-g, n + g);
// ey/ex: f32 [n] clamped window lengths; taps: int32 [2rb + 1].
template <bool INT_FORM>
__global__ void __launch_bounds__(kThreads)
filter_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
              const int* __restrict__ ty, const int* __restrict__ tx,
              const float* __restrict__ ey, const float* __restrict__ ex,
              const int* __restrict__ taps, int H, int W, int rb, int rs,
              float thr, int tile) {
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int th = min(tile, H - y0), tw = min(tile, W - x0);
  const int h = 2 + rs, g = h + rb, kb = 2 * rb + 1, ks = 2 * rs + 1;
  const int ih = th + 2 * g, iw = tw + 2 * g;  // input region
  const int bh = th + 2 * h, bw = tw + 2 * h;  // blurred region
  const int mh = th + 4, mw = tw + 4;          // mask region
  const int dh = th + 2, dw = tw + 2;          // dilated region
  const uint8_t* img = src + (size_t)blockIdx.z * H * W;
  uint8_t* out = dst + (size_t)blockIdx.z * H * W;

  // shared memory, laid out for a full tile (ops/filter_chain.py:_smem)
  const int it = tile + 2 * g, bt = tile + 2 * h, mt = tile + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* in = smem;                                             // [ih][iw]
  int* tmp = reinterpret_cast<int*>(smem + ((it * it + 15) & ~15));
                                                                  // [ih][bw]
  uint8_t* bl = reinterpret_cast<uint8_t*>(tmp + it * bt);        // [bh][bw]
  int* boxw = reinterpret_cast<int*>(bl + ((bt * bt + 15) & ~15));
                                                                  // [bh][mw]
  uint8_t* mask = reinterpret_cast<uint8_t*>(boxw + bt * mt);     // [mh][mw]
  uint8_t* dil = mask + ((mt * mt + 15) & ~15);                   // [dh][dw]

  // 1. input region; table entry y0 + r is input row y0 - g + r
  for (int i = threadIdx.x; i < ih * iw; i += kThreads)
    in[i] = img[(size_t)ty[y0 + i / iw] * W + tx[x0 + i % iw]];
  __syncthreads();

  // 2. blur, width pass: every input row, the blurred region's columns
  for (int i = threadIdx.x; i < ih * bw; i += kThreads) {
    const uint8_t* row = in + (i / bw) * iw + i % bw;
    int acc = 0;
    for (int k = 0; k < kb; ++k) acc += taps[k] * row[k];
    tmp[i] = acc;
  }
  __syncthreads();

  // 3. blur, height pass and divClampU8; 0 outside the image
  for (int i = threadIdx.x; i < bh * bw; i += kThreads) {
    const int r = i / bw, c = i % bw;
    int v = 0;
    if (inside(y0 - h + r, x0 - h + c, H, W)) {
      int acc = 0;
      for (int k = 0; k < kb; ++k) acc += taps[k] * tmp[(r + k) * bw + c];
      v = min((acc + 32768) >> 16, 255);
    }
    bl[i] = (uint8_t)v;
  }
  __syncthreads();

  // 4. box sums, width pass: mask column c sums blurred columns c..c+2rs
  for (int i = threadIdx.x; i < bh * mw; i += kThreads) {
    const uint8_t* row = bl + (i / mw) * bw + i % mw;
    int s = 0;
    for (int k = 0; k < ks; ++k) s += row[k];
    boxw[i] = s;
  }
  __syncthreads();

  // 5. box sums, height pass; sharpen; threshold; 0 outside the image
  for (int i = threadIdx.x; i < mh * mw; i += kThreads) {
    const int r = i / mw, c = i % mw, y = y0 - 2 + r, x = x0 - 2 + c;
    uint8_t m = 0;
    if (inside(y, x, H, W)) {
      int s = 0;
      for (int k = 0; k < ks; ++k) s += boxw[(r + k) * mw + c];
      const int b = bl[(r + rs) * bw + c + rs];
      m = (float)sharpen<INT_FORM>(b, s, ey[y], ex[x]) > thr ? 255 : 0;
    }
    mask[i] = m;
  }
  __syncthreads();

  // 6. dilate, 3x3 max; back to 0 outside the image before the erode
  for (int i = threadIdx.x; i < dh * dw; i += kThreads) {
    const int r = i / dw, c = i % dw;
    int v = 0;
    if (inside(y0 - 1 + r, x0 - 1 + c, H, W)) {
      const uint8_t* p = mask + r * mw + c;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) v = max(v, (int)p[dy * mw + dx]);
    }
    dil[i] = (uint8_t)v;
  }
  __syncthreads();

  // 7. erode, 3x3 min, u8 store
  for (int i = threadIdx.x; i < th * tw; i += kThreads) {
    const int r = i / tw, c = i % tw;
    const uint8_t* p = dil + r * dw + c;
    int v = 255;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) v = min(v, (int)p[dy * dw + dx]);
    out[(size_t)(y0 + r) * W + x0 + c] = (uint8_t)v;
  }
}

template <bool INT_FORM>
int launch(const void* src, void* dst, const void* ty, const void* tx,
           const void* ey, const void* ex, const void* taps, int B, int H,
           int W, int rb, int rs, float thr, int tile, int smem,
           cudaStream_t stream) {
  auto kernel = filter_kernel<INT_FORM>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const int*>(ty), static_cast<const int*>(tx),
      static_cast<const float*>(ey), static_cast<const float*>(ex),
      static_cast<const int*>(taps), H, W, rb, rs, thr, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. The caller checks
// shapes, dtypes and contiguity, allocates dst, picks tile and smem, and
// picks the sharpen form (int_form) by the JAX package's bound rule.
int zt_fused_blur_sharpen_morph(const void* src, void* dst, const void* ty,
                                const void* tx, const void* ey,
                                const void* ex, const void* taps, int B,
                                int H, int W, int rb, int rs, float thr,
                                int int_form, int tile, int smem,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int_form)
    return launch<true>(src, dst, ty, tx, ey, ex, taps, B, H, W, rb, rs, thr,
                        tile, smem, s);
  return launch<false>(src, dst, ty, tx, ey, ex, taps, B, H, W, rb, rs, thr,
                       tile, smem, s);
}

}  // extern "C"
