// Staging a tile's source rows into shared memory, shared by K2
// (fused_blur_sharpen_morph.cu) and K4 (separable_u8.cu).
//
// A block that loads its tile one row per warp at a time waits one HBM
// round trip per row it owns, and these tiles have 40-90 rows. So an
// interior tile (its source region inside the image, rows 16-byte
// aligned) is copied with cp.async, every chunk in flight at once, and an
// edge tile gathers through the host's halo tables with each warp taking
// kStageRows rows at once, all their loads issued before it stores any.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kStageRows = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows x nch 16-byte chunks from src (row pitch `pitch` bytes, 16-byte
// aligned rows) to dst (row pitch `dpitch` bytes, 16-byte aligned), as
// cp.async copies of the calling block.
template <int kWarps>
__device__ __forceinline__ void stage_rows_async(const uint8_t* src,
                                                 size_t pitch, int rows,
                                                 int nch, uint8_t* dst,
                                                 int dpitch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps)
    for (int k = lane; k < nch; k += 32)
      cp_async16(dst + r * dpitch + 16 * k, src + r * pitch + 16 * k);
}
