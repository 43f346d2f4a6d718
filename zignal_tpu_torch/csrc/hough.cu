// The Hough transform of a batch of edge planes and its lines, for sm_90a,
// with no host wait (ops/hough.py: _vote and HoughTransform._kept are
// the plain versions).
//
// It replaces no TPU kernel: the JAX package votes with a scatter-add of
// XLA's and finds the lines on the host (zignal_tpu/ops/hough.py). It was
// added because the port's plain route needs the host twice a request,
// once for the length of the edge list and once for the length of the
// peak list, and runs the votes as ~100 elementwise PyTorch kernels over
// [thetas, edges] index tensors and the greedy suppression as ~320 small
// ones: on an H100 a request of 8 KITTI-size frames took ~8 ms of the
// card's time for the votes alone, and the two waits kept the card idle
// while the host issued the rest.
//
// Four kernels, each count and list on the card:
// 1. list: each pixel of a frame's size x size plane, read NEAREST from
//    the edge frame through the row and column tables, appends y << 16 | x
//    to its frame's edge list when it is an edge; one atomicAdd a warp for
//    the frame's count;
// 2. vote: a block owns T consecutive thetas of one frame and their
//    size x T bins in shared memory. Each T lanes take one edge of the
//    frame's list, the groups of a warp from parts of the list far apart,
//    a theta each (its cos and sin in registers): rho = x cos
//    + y sin in int32, the bin ((rho >> 1) + 2 offset) >> 16, one shared
//    atomicAdd of 1 where it lies in the accumulator. The block then writes
//    its bins into the accumulator's T columns with plain stores, so no
//    bin is zeroed first and none is written twice. The counts are exact
//    integers in any order;
// 3. peaks: each interior bin that reaches the threshold and each of its
//    8 neighbours is appended to its frame's candidate list as the key
//    score << 32 | rho << 16 | theta, one count a frame;
// 4. lines: a block a frame takes, max_lines times, the largest key among
//    the candidates no kept line suppresses, and keeps it. Suppression is
//    find_lines' test: |angle - kept angle| < angle_thr and |radius - kept
//    radius| < radius_thr, the angle c * (180 / even) - 90 and the radius
//    (r - even / 2) * sqrt 2 in f64 with __dmul_rn and __dadd_rn, as numpy
//    computes them. Taking the largest key that no kept line suppresses
//    keeps what the host's greedy pass over the sorted candidates keeps,
//    in its order: every larger key was kept or suppressed already.
//
// What bounds it on this card: the votes, one a theta of each edge pixel
// (~280 M for 8 KITTI-size frames at 3 % edges), each a few integer
// operations and a shared-memory atomic, and the accumulators' bytes (4 B
// a bin written by the votes, read by the peaks). The votes went to global
// atomics first, one an L2 transaction: 2.3 ms a request on an H100.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVoteThreads = 512;
constexpr int kLineThreads = 1024;
constexpr int kMaxLines = 256;
constexpr int kMaxVoteBytes = 227 * 1024;  // an sm_90 block's shared memory

struct HoughParams {
  int B, H, W;          // the edge frames
  int S;                // the accumulator's side
  int offset;           // hough.zig's 16.16 offset
  int threshold;
  int max_lines;
  int thetas;           // T, the thetas of a vote block: a power of two
  double angle_step;    // 180 / even
  double half_even;     // even / 2
  double sqrt2;
  double angle_thr, radius_thr;
};

__global__ void list_kernel(const uint8_t* __restrict__ edges,
                            const int* __restrict__ rows,
                            const int* __restrict__ cols, int* __restrict__ list,
                            int* __restrict__ counts, HoughParams p) {
  const int ss = p.S * p.S, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const uint8_t* frame = edges + (long long)b * p.H * p.W;
  for (int i0 = blockIdx.x * kThreads; i0 < ss; i0 += gridDim.x * kThreads) {
    const int i = i0 + threadIdx.x;
    const int y = i / p.S, x = i - y * p.S;
    const bool edge = i < ss && frame[(long long)rows[y] * p.W + cols[x]] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, edge);
    if (ballot == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(counts + b, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (edge)
      list[(long long)b * ss + base + __popc(ballot & ((1u << lane) - 1))] =
          y << 16 | x;
  }
}

__global__ void __launch_bounds__(kVoteThreads)
vote_kernel(const int* __restrict__ list, const int* __restrict__ counts,
            const int* __restrict__ cos_t, const int* __restrict__ sin_t,
            int* __restrict__ acc, HoughParams p) {
  extern __shared__ int bins[];  // [S][T]
  const int T = p.thetas, S = p.S, b = blockIdx.y;
  const int t0 = blockIdx.x * T, lt = threadIdx.x & (T - 1);
  const int t = t0 + lt;
  const bool live = t < S;
  const int ct = live ? cos_t[t] : 0, st = live ? sin_t[t] : 0;
  for (int i = threadIdx.x; i < S * T; i += kVoteThreads) bins[i] = 0;
  __syncthreads();
  const long long ss = (long long)S * S;
  const int* edges = list + b * ss;
  const int n = counts[b], off2 = p.offset << 1, top = S - 1;
  // the list in 32 / T parts, each of a warp's groups of T lanes in its
  // own: neighbours in the list are neighbouring pixels, whose votes mostly
  // fall in the same bins, and a warp's atomics on one address serialize
  const int groups = 32 / T, warps = kVoteThreads / 32;
  const int part = (n + groups - 1) / groups;
  const int lo = ((threadIdx.x & 31) / T) * part;
  const int hi = min(n, lo + part);
  for (int e = lo + (threadIdx.x >> 5); e < hi; e += warps) {
    const int v = __ldg(edges + e);
    const int xv = 2 * (v & 0xffff) - top, yv = 2 * (v >> 16) - top;
    const int r = (((xv * ct + yv * st) >> 1) + off2) >> 16;
    if (live && (unsigned)r < (unsigned)S) atomicAdd(bins + r * T + lt, 1);
  }
  __syncthreads();
  int* out = acc + b * ss + t0;
  for (int i = threadIdx.x; i < S * T; i += kVoteThreads) {
    const int r = i / T, c = i & (T - 1);
    if (t0 + c < S) out[(long long)r * S + c] = bins[i];
  }
}

__global__ void peaks_kernel(const int* __restrict__ acc,
                             long long* __restrict__ cand,
                             int* __restrict__ counts, HoughParams p) {
  const int S = p.S, inner = S - 2;
  const long long per = (long long)inner * inner;
  const long long n = (long long)p.B * per;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int b = (int)(i / per);
    const int rem = (int)(i - (long long)b * per);
    const int r = rem / inner + 1, c = rem % inner + 1;
    const int* a = acc + (long long)b * S * S;
    const int v = a[r * S + c];
    if (v < p.threshold) continue;
    bool peak = true;
    for (int dr = -1; dr <= 1 && peak; ++dr)
      for (int dc = -1; dc <= 1; ++dc)
        if ((dr || dc) && a[(r + dr) * S + c + dc] > v) {
          peak = false;
          break;
        }
    if (!peak) continue;
    const int k = atomicAdd(counts + b, 1);
    cand[(long long)b * per + k] =
        ((long long)v << 32) | ((long long)r << 16) | (long long)c;
  }
}

__device__ __forceinline__ double angle_of(long long key, const HoughParams& p) {
  const int c = (int)(key & 0xffff);
  return __dadd_rn(__dmul_rn((double)c, p.angle_step), -90.0);
}

__device__ __forceinline__ double radius_of(long long key,
                                            const HoughParams& p) {
  const int r = (int)((key >> 16) & 0xffff);
  return __dmul_rn(__dadd_rn((double)r, -p.half_even), p.sqrt2);
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long w = __shfl_down_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__global__ void __launch_bounds__(kLineThreads)
lines_kernel(const long long* __restrict__ cand_all,
             const int* __restrict__ counts, int* __restrict__ rows_out,
             uint8_t* __restrict__ valid_out, HoughParams p) {
  __shared__ double kept_a[kMaxLines], kept_r[kMaxLines];
  __shared__ long long partial[kLineThreads / 32];
  __shared__ long long chosen;
  const int b = blockIdx.x;
  const long long per = (long long)(p.S - 2) * (p.S - 2);
  const long long* cand = cand_all + (long long)b * per;
  const int n = counts[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long last = -1;  // the key kept last: every larger key is decided
  for (int j = 0; j < p.max_lines; ++j) {
    long long best = -1;
    for (int i = threadIdx.x; i < n; i += kLineThreads) {
      const long long key = cand[i];
      if (last >= 0 && key >= last) continue;
      const double a = angle_of(key, p), r = radius_of(key, p);
      bool near = false;
      for (int k = 0; k < j && !near; ++k)
        near = fabs(__dadd_rn(a, -kept_a[k])) < p.angle_thr &&
               fabs(__dadd_rn(r, -kept_r[k])) < p.radius_thr;
      if (!near && key > best) best = key;
    }
    best = warp_max(best);
    if (lane == 0) partial[warp] = best;
    __syncthreads();
    if (warp == 0) {
      long long v = lane < kLineThreads / 32 ? partial[lane] : -1;
      v = warp_max(v);
      if (lane == 0) {
        chosen = v;
        if (v >= 0) {
          kept_a[j] = angle_of(v, p);
          kept_r[j] = radius_of(v, p);
          int* row = rows_out + ((long long)b * p.max_lines + j) * 3;
          row[0] = (int)((v >> 16) & 0xffff);
          row[1] = (int)(v & 0xffff);
          row[2] = (int)(v >> 32);
          valid_out[(long long)b * p.max_lines + j] = 1;
        }
      }
    }
    __syncthreads();
    last = chosen;
    if (last < 0) break;
  }
}

}  // namespace

extern "C" {

int zt_hough_params_bytes() { return sizeof(HoughParams); }

// edges: u8 [B, H, W]; rows: int32 [S] and cols: int32 [S], the NEAREST
// source row and column of each accumulator row and column; cos_t, sin_t:
// int32 [S]; list: int32 scratch of B * S * S; counts: int32 scratch of B;
// acc: int32 [B, S, S], every bin written.
int zt_hough_vote(const void* edges, const void* rows, const void* cols,
                  const void* cos_t, const void* sin_t, void* list,
                  void* counts, void* acc, const void* params, void* stream) {
  HoughParams p;
  memcpy(&p, params, sizeof(p));
  const long long smem = (long long)p.S * p.thetas * sizeof(int);
  if (p.B < 0 || p.B > 65535 || p.H < 1 || p.W < 1 || p.S < 2 ||
      p.S > 65535 || (long long)p.B * p.S * p.S > 0x7FFFFFFF ||
      p.thetas < 1 || p.thetas > 32 || (p.thetas & (p.thetas - 1)) ||
      smem > kMaxVoteBytes)
    return cudaErrorInvalidValue;
  if (p.B == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, p.B * sizeof(int), s);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(vote_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int ss = p.S * p.S;
  const int blocks = (ss + kThreads - 1) / kThreads;
  list_kernel<<<dim3(blocks < 1024 ? blocks : 1024, p.B), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(edges), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<int*>(list),
      static_cast<int*>(counts), p);
  const dim3 grid((p.S + p.thetas - 1) / p.thetas, p.B);
  vote_kernel<<<grid, kVoteThreads, (size_t)smem, s>>>(
      static_cast<const int*>(list), static_cast<const int*>(counts),
      static_cast<const int*>(cos_t), static_cast<const int*>(sin_t),
      static_cast<int*>(acc), p);
  return cudaGetLastError();
}

// acc: int32 [B, S, S]; cand: int64 scratch of B * (S - 2)^2; counts:
// int32 scratch of B; rows: int32 [B, max_lines, 3] and valid: u8 [B,
// max_lines], zeroed here, then written.
int zt_hough_lines(const void* acc, void* cand, void* counts, void* rows,
                   void* valid, const void* params, void* stream) {
  HoughParams p;
  memcpy(&p, params, sizeof(p));
  if (p.B < 0 || p.S < 3 || p.S > 65535 || p.max_lines < 0 ||
      p.max_lines > kMaxLines)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.B == 0 || p.max_lines == 0) return cudaSuccess;
  cudaError_t err = cudaMemsetAsync(rows, 0,
                                    (size_t)p.B * p.max_lines * 3 * sizeof(int),
                                    s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(valid, 0, (size_t)p.B * p.max_lines, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counts, 0, (size_t)p.B * sizeof(int), s);
  if (err != cudaSuccess) return err;
  const long long n = (long long)p.B * (p.S - 2) * (p.S - 2);
  const long long blocks = (n + kThreads - 1) / kThreads;
  peaks_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), kThreads, 0, s>>>(
      static_cast<const int*>(acc), static_cast<long long*>(cand),
      static_cast<int*>(counts), p);
  lines_kernel<<<p.B, kLineThreads, 0, s>>>(
      static_cast<const long long*>(cand), static_cast<const int*>(counts),
      static_cast<int*>(rows), static_cast<uint8_t*>(valid), p);
  return cudaGetLastError();
}

}  // extern "C"
