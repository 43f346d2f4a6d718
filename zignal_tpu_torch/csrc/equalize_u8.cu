// Histogram equalization of u8 images [B, ..., C] with C = 1, 3 or 4, for
// sm_90a: two passes over the bytes and a table build between them.
//   hist_kernel    the [B, C, 256] int32 counts (binary.histogram256_batch)
//   tables_kernel  each (image, channel)'s u8 table from its counts, the
//                  upstream u32 arithmetic (enhancement.equalize_tables)
//   lut_kernel     out[..., c] = table[b, c, in[..., c]], a new contiguous
//                  batch laid out as the input
//                  (binary.lut_apply_u8_per_channel)
//
// It replaces no TPU kernel: the JAX package's equalize is plain jnp
// (zignal_tpu/ops/enhancement.py:74 equalize_from_hists and :102 equalize,
// over zignal_tpu/ops/binary.py:69 histogram256_multi and :104
// lut_apply_u8_per_channel). It was added because the port's plain route, an
// f32 histc of the bytes widened to bin centres and then a gather on an
// int64 index, was 91 % of the colorspace deployment's request on an H100:
// every stage widened each byte 4 to 8 times.
//
// What bounds it on this card: bytes, 3 a value (read by the histogram,
// read and written by the lookup), and a few integer ops a value. So both
// passes read the bytes as they are, 16 to a vector: a lane reads C 16-byte
// vectors a step, its warp 512 * C contiguous bytes (a chunk). A byte's
// channel then follows from its place in the chunk, with no division a
// byte: its "slot" k, its offset past the image's first 16-byte boundary
// modulo C, is fixed by its lane and its place in the vector, and its
// channel is (head + k) % C, where head is the image's bytes before that
// boundary. The unaligned head and the ragged tail go byte by byte.
// - The histogram counts into privatized counters in shared memory: each
//   lane owns a 16-bit counter for every (slot, value), two to a word at
//   word (k * 128 + v % 128) * 32 + lane. The lanes' words lie in 32
//   different banks, so the shared atomic add of every byte is one
//   conflict-free access, however peaked the histogram is. (One shared
//   histogram a warp serializes the lanes that meet on a bin: a camera
//   frame's grain spreads a warp over ~13 values, and on an H100 it took
//   0.083 ms on the colorspace frames against these counters' 0.080, but a
//   flat image puts all 32 on one word. Aggregating them first with
//   __match_any_sync took 1.37 ms.) The counters take 48 KB a warp at
//   C = 3, so a block is four warps and an SM holds one; each warp keeps
//   the next chunks' loads in flight while it counts the present ones. At
//   the end a warp sums its lanes' counters into the block's histogram, and
//   the block adds its nonzero bins into the global counts (zeroed first)
//   with atomics. A lane adds at most 16 to a counter a chunk; the grid
//   gives no warp more than kMaxChunks chunks, so no counter passes 65535.
// - The lookup stages the image's C x 256 table in shared memory, one u32
//   an entry, the slots' rows 11 banks apart, reads a vector and writes a
//   vector.
// Integer counts are exact in any order, so the counts, the tables and the
// bytes equal the plain version's (ops/binary.py, ops/enhancement.py) bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 16;             // bytes a lane reads at a time
constexpr int kMaxImages = 65535;     // gridDim.y
constexpr int kMaxChunks = 4095;      // a warp's chunks: 16 * 4095 < 2^16
constexpr int kRow = 256 + 11;        // words a row of a staged table
constexpr int kPrefetch = 4;          // chunks a warp loads ahead
constexpr int kLutThreads = 256;

// warps of a histogram block: its counters take 16 KB * C a warp, and
// 192 KB a block at most
template <int C>
__host__ __device__ constexpr int hist_warps() {
  return C == 1 ? 8 : (C == 3 ? 4 : 3);
}

// bytes of a histogram block's shared memory: the lanes' counters, then
// the block's bins
template <int C>
__host__ __device__ constexpr int hist_smem() {
  return (hist_warps<C>() * C * 128 * 32 + C * 256) * 4;
}

// One image of the launch (blockIdx.y) as the passes walk it: `head` bytes
// to the first 16-byte boundary, `chunks` chunks of 512 * C bytes, the tail
struct Span {
  long long offset;  // the image's first byte past the launch's first
  int head;
  long long chunks;
};

template <int C>
__device__ __forceinline__ Span span_of(const uint8_t* base, long long n) {
  Span s;
  s.offset = (long long)blockIdx.y * n;
  const int mis = (int)(reinterpret_cast<uintptr_t>(base + s.offset) & 15);
  s.head = (int)min((long long)((16 - mis) & 15), n);
  s.chunks = (n - s.head) / (512 * C);
  return s;
}

// slot of the byte at offset o of an image with `head` head bytes
template <int C>
__device__ __forceinline__ int slot_of(long long o, int head) {
  return (int)((o + 16 * C - head) % C);
}

// this block's chunks of the image, [c0, c1)
__device__ __forceinline__ void block_chunks(long long chunks, long long* c0,
                                             long long* c1) {
  *c0 = chunks * blockIdx.x / gridDim.x;
  *c1 = chunks * (blockIdx.x + 1) / gridDim.x;
}

// the lane's C vectors of chunk g; vec is its first vector of chunk 0
template <int C>
__device__ __forceinline__ void load_chunk(const uint4* vec, long long g,
                                           uint4 (&v)[C]) {
#pragma unroll
  for (int q = 0; q < C; ++q) v[q] = __ldcs(vec + g * 32 * C + q * 32);
}

template <int C>
__device__ __forceinline__ unsigned byte_of(const uint4 (&v)[C], int q,
                                            int j) {
  const uint4 w = v[q];
  const unsigned x = (j >> 2) == 0 ? w.x : (j >> 2) == 1 ? w.y
                     : (j >> 2) == 2 ? w.z : w.w;
  return (x >> (8 * (j & 3))) & 255;
}

template <int C>
__global__ void __launch_bounds__(32 * hist_warps<C>())
hist_kernel(const uint8_t* __restrict__ src, int* __restrict__ counts,
            long long n) {
  constexpr int W = hist_warps<C>();
  constexpr int kWords = C * 128 * 32;  // a warp's counters
  extern __shared__ unsigned smem[];
  unsigned* bins = smem + W * kWords;   // the block's [C slots][256]
  for (int i = threadIdx.x; i < W * kWords + C * 256; i += 32 * W) smem[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Span s = span_of<C>(src, n);
  const uint8_t* img = src + s.offset;
  unsigned* row[C];  // the lane's counters of each slot its bytes take
  const int rot = (lane * kLane) % C;
#pragma unroll
  for (int m = 0; m < C; ++m)
    row[m] = smem + warp * kWords + ((rot + m) % C) * 128 * 32 + lane;

  long long c0, c1;
  block_chunks(s.chunks, &c0, &c1);
  const uint4* vec = reinterpret_cast<const uint4*>(img + s.head) + lane;
  uint4 cur[kPrefetch][C], next[kPrefetch][C];
#pragma unroll
  for (int u = 0; u < kPrefetch; ++u) {
    const long long g = c0 + warp + u * W;
    if (g < c1) load_chunk<C>(vec, g, cur[u]);
  }
  for (long long g0 = c0 + warp; g0 < c1; g0 += kPrefetch * W) {
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const long long g = g0 + (kPrefetch + u) * W;
      if (g < c1) load_chunk<C>(vec, g, next[u]);
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      if (g0 + u * W >= c1) break;
#pragma unroll
      for (int q = 0; q < C; ++q)
#pragma unroll
        for (int j = 0; j < kLane; ++j) {
          const unsigned v = byte_of<C>(cur[u], q, j);
          atomicAdd(row[(q * 512 + j) % C] + ((v & 127) << 5),
                    (v & 128) ? 0x10000u : 1u);
        }
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u)
#pragma unroll
      for (int q = 0; q < C; ++q) cur[u][q] = next[u][q];
  }

  // the head and the tail, byte by byte, straight into the block's bins
  if (blockIdx.x == 0)
    for (int o = threadIdx.x; o < s.head; o += 32 * W)
      atomicAdd(&bins[slot_of<C>(o, s.head) * 256 + img[o]], 1u);
  if (blockIdx.x == gridDim.x - 1)
    for (long long o = s.head + s.chunks * 512 * C + threadIdx.x; o < n;
         o += 32 * W)
      atomicAdd(&bins[slot_of<C>(o, s.head) * 256 + img[o]], 1u);

  // the warp's lanes summed: a lane takes every 32nd word row and reads the
  // row's 32 words from the 32 banks in turn
  __syncwarp();
  const unsigned* mine = smem + warp * kWords;
  for (int r = lane; r < C * 128; r += 32) {
    unsigned lo = 0, hi = 0;
#pragma unroll 8
    for (int t = 0; t < 32; ++t) {
      const unsigned x = mine[r * 32 + ((t + lane) & 31)];
      lo += x & 0xFFFF;
      hi += x >> 16;
    }
    const int b = (r >> 7) * 256 + (r & 127);
    if (lo) atomicAdd(&bins[b], lo);
    if (hi) atomicAdd(&bins[b + 128], hi);
  }
  __syncthreads();
  int* out = counts + (long long)blockIdx.y * C * 256;
  for (int i = threadIdx.x; i < C * 256; i += 32 * W) {
    const unsigned x = bins[i];
    if (x) atomicAdd(&out[((s.head + (i >> 8)) % C) * 256 + (i & 255)],
                     (int)x);
  }
}

// One block an (image, channel): the reference's table from its 256
// counts (int64 where `wide`, else int32). cdf is their inclusive sum,
// cdf_min its first value above 0 (0 if none), denom = total - cdf_min;
// an entry is ((cdf - cdf_min) * 255 mod 2^32) / (max(denom, 1) mod 2^32),
// its low byte, where cdf >= cdf_min, else 0; the identity where denom is
// 0, and on the alpha channel of C = 4 where skip_alpha.
__global__ void __launch_bounds__(256)
tables_kernel(const void* __restrict__ hists, int wide,
              uint8_t* __restrict__ luts, int c, long long total,
              int skip_alpha) {
  __shared__ long long sums[8];
  __shared__ long long cdfs[256];
  __shared__ int first;
  const int v = threadIdx.x, lane = v & 31, warp = v >> 5;
  const long long i = (long long)blockIdx.x * 256 + v;
  long long cdf = wide ? static_cast<const long long*>(hists)[i]
                       : static_cast<const int*>(hists)[i];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long x = __shfl_up_sync(0xffffffffu, cdf, d);
    if (lane >= d) cdf += x;
  }
  if (lane == 31) sums[warp] = cdf;
  if (v == 0) first = 256;
  __syncthreads();
  for (int w = 0; w < warp; ++w) cdf += sums[w];
  cdfs[v] = cdf;
  if (cdf > 0) atomicMin(&first, v);
  __syncthreads();
  const long long cdf_min = first < 256 ? cdfs[first] : 0;
  const long long denom = total - cdf_min;
  unsigned entry;
  if (denom == 0 || (skip_alpha && c == 4 && blockIdx.x % c == 3)) {
    entry = v;
  } else if (cdf < cdf_min) {
    entry = 0;
  } else {
    const unsigned num = (unsigned)((cdf - cdf_min) * 255);
    const unsigned den = (unsigned)(denom > 1 ? denom : 1);
    entry = den ? num / den : 0;
  }
  luts[i] = (uint8_t)entry;
}

template <int C>
__global__ void __launch_bounds__(kLutThreads)
lut_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
           const uint8_t* __restrict__ luts, long long n) {
  __shared__ unsigned tab[C * kRow];  // [slot][value]
  const Span s = span_of<C>(src, n);
  const uint8_t* table = luts + (long long)blockIdx.y * C * 256;
  for (int i = threadIdx.x; i < C * 256; i += kLutThreads)
    tab[(i >> 8) * kRow + (i & 255)] =
        table[((s.head + (i >> 8)) % C) * 256 + (i & 255)];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int W = kLutThreads / 32;
  const uint8_t* img = src + s.offset;
  uint8_t* out = dst + s.offset;
  const unsigned* row[C];
  const int rot = (lane * kLane) % C;
#pragma unroll
  for (int m = 0; m < C; ++m) row[m] = tab + ((rot + m) % C) * kRow;

  long long c0, c1;
  block_chunks(s.chunks, &c0, &c1);
  const uint4* vin = reinterpret_cast<const uint4*>(img + s.head) + lane;
  uint4* vout = reinterpret_cast<uint4*>(out + s.head) + lane;
  for (long long g = c0 + warp; g < c1; g += W) {
    uint4 v[C];
    load_chunk<C>(vin, g, v);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = 4 * k + b;
          w[k] |= row[(q * 512 + j) % C][byte_of<C>(v, q, j)] << (8 * b);
        }
      }
      __stcs(vout + g * 32 * C + q * 32, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
  if (blockIdx.x == 0)
    for (int o = threadIdx.x; o < s.head; o += kLutThreads)
      out[o] = (uint8_t)tab[slot_of<C>(o, s.head) * kRow + img[o]];
  if (blockIdx.x == gridDim.x - 1)
    for (long long o = s.head + s.chunks * 512 * C + threadIdx.x; o < n;
         o += kLutThreads)
      out[o] = (uint8_t)tab[slot_of<C>(o, s.head) * kRow + img[o]];
}

// blocks of one resident wave of `kernel` on the current device, asked once
// a device (`cache`, by device ordinal); the kernel is first let take
// `smem` bytes of dynamic shared memory where that passes 48 KB
template <typename K>
cudaError_t wave_of(K kernel, int threads, int smem, unsigned* cache,
                    unsigned* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = (unsigned)(sms * per_sm);
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// blocks an image: one resident wave over the launch's images, no more than
// a chunk a warp needs, and at least enough that no warp takes more than
// `max_chunks`
long long blocks_an_image(unsigned wave, long long b, long long chunks,
                          int warps, long long max_chunks) {
  long long gx = ceil_div(wave, b < kMaxImages ? b : kMaxImages);
  const long long need = ceil_div(chunks, warps);
  if (gx > need) gx = need;
  const long long least = ceil_div(chunks, warps * max_chunks);
  if (gx < least) gx = least;
  return gx < 1 ? 1 : gx;
}

template <int C>
int launch_hist(const uint8_t* src, int* counts, long long b, long long n,
                cudaStream_t s) {
  constexpr int W = hist_warps<C>();
  static unsigned cache[64];
  unsigned wave = 0;
  cudaError_t err = wave_of(hist_kernel<C>, 32 * W, hist_smem<C>(), cache,
                            &wave);
  if (err != cudaSuccess) return err;
  const long long gx =
      blocks_an_image(wave, b, n / (512 * C), W, kMaxChunks);
  if (gx > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  for (long long b0 = 0; b0 < b; b0 += kMaxImages) {
    const long long nb = b - b0 < kMaxImages ? b - b0 : kMaxImages;
    hist_kernel<C><<<dim3((unsigned)gx, (unsigned)nb), 32 * W,
                     hist_smem<C>(), s>>>(src + b0 * n,
                                          counts + b0 * C * 256, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int C>
int launch_lut(const uint8_t* src, uint8_t* dst, const uint8_t* luts,
               long long b, long long n, cudaStream_t s) {
  static unsigned cache[64];
  unsigned wave = 0;
  cudaError_t err = wave_of(lut_kernel<C>, kLutThreads, 0, cache, &wave);
  if (err != cudaSuccess) return err;
  const long long gx = blocks_an_image(wave, b, n / (512 * C),
                                       kLutThreads / 32, 1LL << 40);
  if (gx > 0x7FFFFFFF) return cudaErrorInvalidConfiguration;
  for (long long b0 = 0; b0 < b; b0 += kMaxImages) {
    const long long nb = b - b0 < kMaxImages ? b - b0 : kMaxImages;
    lut_kernel<C><<<dim3((unsigned)gx, (unsigned)nb), kLutThreads, 0, s>>>(
        src + b0 * n, dst + b0 * n, luts + b0 * C * 256, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each returns a cudaError_t: 0 when the launch was accepted. The caller
// checks dtypes, shapes and contiguity and allocates the outputs. b images
// of n bytes each, one after the other, c channels a pixel.

// counts: int32 [b, c, 256], zeroed here, then counted into
int zt_histogram256_u8(const void* src, void* counts, long long b,
                       long long n, int c, void* stream) {
  if (b < 0 || n < 0 || n % c) return cudaErrorInvalidValue;
  if (c != 1 && c != 3 && c != 4) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, b * c * 256 * sizeof(int), s);
  if (err != cudaSuccess || n == 0) return err;
  const auto* in = static_cast<const uint8_t*>(src);
  auto* out = static_cast<int*>(counts);
  if (c == 1) return launch_hist<1>(in, out, b, n, s);
  if (c == 3) return launch_hist<3>(in, out, b, n, s);
  return launch_hist<4>(in, out, b, n, s);
}

// hists: [b, c, 256] counts, int64 where wide, else int32; luts: u8, same
// shape; total: an image's pixels
int zt_equalize_tables(const void* hists, int wide, void* luts, long long b,
                       int c, long long total, int skip_alpha, void* stream) {
  if (b < 0 || c < 1 || b * c > 0x7FFFFFFF) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  tables_kernel<<<(unsigned)(b * c), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      hists, wide, static_cast<uint8_t*>(luts), c, total, skip_alpha);
  return cudaGetLastError();
}

// luts: u8 [b, c, 256]; src and dst lie at the same offset from a 16-byte
// boundary
int zt_lut_apply_u8(const void* src, void* dst, const void* luts,
                    long long b, long long n, int c, void* stream) {
  if (b < 0 || n < 0 || n % c) return cudaErrorInvalidValue;
  if (c != 1 && c != 3 && c != 4) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(src) - reinterpret_cast<uintptr_t>(dst))
      % 16)
    return cudaErrorMisalignedAddress;
  if (b == 0 || n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(src);
  auto* out = static_cast<uint8_t*>(dst);
  const auto* t = static_cast<const uint8_t*>(luts);
  if (c == 1) return launch_lut<1>(in, out, t, b, n, s);
  if (c == 3) return launch_lut<3>(in, out, t, b, n, s);
  return launch_lut<4>(in, out, t, b, n, s);
}

}  // extern "C"
