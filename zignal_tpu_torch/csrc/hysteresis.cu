// Canny's hysteresis for sm_90a: the edges that the thresholds keep, as the
// connected components of the candidate pixels, in a fixed number of
// launches (ops/edges.py:_hysteresis is the plain version).
//
// It replaces no TPU kernel: the JAX package grows the strong edges by
// 3 x 3 dilations in a jax.lax.while_loop (zignal_tpu/ops/edges.py). It was
// added because the port's plain route grows them by whole-plane PyTorch
// ops with a host test of the fixpoint every few steps: the number of steps
// follows the longest chain of weak pixels, and each test makes the host
// wait for the card, so a batch of drive frames paid launches and waits
// that the frames, not the shapes, decide.
//
// The fixpoint is a property of the components. A member is a candidate
// pixel (the NMS keeps it) whose magnitude reaches ``low`` or ``high``; a
// strong pixel is one whose magnitude reaches ``high``. Growth from the
// strong pixels through the weak ones, 8-connected, ends at the members of
// every 8-connected component of members that holds a strong pixel: a
// member on a chain of members from a strong pixel joins one step after its
// predecessor on the chain, and growth never leaves the members. So:
// 1. init: each member its own label (its flat index), -1 elsewhere; each
//    root's flag cleared;
// 2. merge: each member joins its west, north-west, north and north-east
//    neighbours that are members, by the lock-free union of Playne and
//    Hawick (2018): a root is hung under the smaller root with atomicMin,
//    and a union that finds its root taken meanwhile goes on from the new
//    parent. Labels only fall, so no cycle forms; the components, and so
//    the result, do not depend on the order of the unions;
// 3. compress: each member's label becomes its root;
// 4. mark: each strong pixel flags its root;
// 5. out: a member whose root is flagged is 255, every other pixel 0.
//
// What bounds it on this card: bytes and launches. A pixel is read as a u8
// candidate and an f32 magnitude twice, its label written once and read
// four times, its flag and the output once: ~30 bytes a pixel, 110 MB for
// 8 KITTI-size frames, 33 us at 3.35 TB/s. Only members (a few in a
// hundred of the pixels) reach the unions. Labels are read past L1
// (__ldcg), where another SM's union may have left a stale line.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const int* labels, int x) {
  int parent = __ldcg(labels + x);
  while (parent != x) {
    x = parent;
    parent = __ldcg(labels + x);
  }
  return x;
}

__device__ void unite(int* labels, int a, int b) {
  a = find_root(labels, a);
  b = find_root(labels, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(labels + a, b);
    if (old == a) return;  // a was a root, now under b
    a = find_root(labels, old);
    b = find_root(labels, b);
  }
}

__device__ __forceinline__ bool member(const uint8_t* cand, const float* mag,
                                       int p, float low, float high) {
  const float m = mag[p];
  return cand[p] && (m >= low || m >= high);
}

__global__ void init_kernel(const uint8_t* cand, const float* mag,
                            int* labels, uint8_t* flags, int n, float low,
                            float high) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n;
       p += gridDim.x * kThreads) {
    labels[p] = member(cand, mag, p, low, high) ? p : -1;
    flags[p] = 0;
  }
}

__global__ void merge_kernel(int* labels, int h, int w, int n) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n;
       p += gridDim.x * kThreads) {
    if (__ldcg(labels + p) < 0) continue;  // members stay members
    const int x = p % w, y = (p / w) % h;
    if (x > 0 && __ldcg(labels + p - 1) >= 0) unite(labels, p, p - 1);
    if (y == 0) continue;
    const int q = p - w;
    if (x > 0 && __ldcg(labels + q - 1) >= 0) unite(labels, p, q - 1);
    if (__ldcg(labels + q) >= 0) unite(labels, p, q);
    if (x < w - 1 && __ldcg(labels + q + 1) >= 0) unite(labels, p, q + 1);
  }
}

__global__ void compress_kernel(int* labels, int n) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n;
       p += gridDim.x * kThreads) {
    if (__ldcg(labels + p) >= 0) labels[p] = find_root(labels, p);
  }
}

__global__ void mark_kernel(const uint8_t* cand, const float* mag,
                            const int* labels, uint8_t* flags, int n,
                            float high) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n;
       p += gridDim.x * kThreads) {
    if (cand[p] && mag[p] >= high) flags[labels[p]] = 1;
  }
}

__global__ void out_kernel(const int* labels, const uint8_t* flags,
                           uint8_t* out, int n) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n;
       p += gridDim.x * kThreads) {
    const int label = labels[p];
    out[p] = (label >= 0 && flags[label]) ? 255 : 0;
  }
}

}  // namespace

extern "C" {

// cand: u8 0/1 [b, h, w]; mag: f32 [b, h, w]; out: u8 0/255 [b, h, w];
// labels: int32 and flags: u8 scratch of b * h * w each; blocks: the
// grid of every pass. Returns a cudaError_t: 0 when all five launches
// were accepted.
int zt_hysteresis(const void* cand, const void* mag, void* out, void* labels,
                  void* flags, int b, int h, int w, float low, float high,
                  int blocks, void* stream) {
  if (b < 0 || h < 1 || w < 1 || blocks < 1) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * h * w;
  if (total > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const int n = static_cast<int>(total);
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(cand);
  const auto* m = static_cast<const float*>(mag);
  auto* l = static_cast<int*>(labels);
  auto* f = static_cast<uint8_t*>(flags);
  init_kernel<<<blocks, kThreads, 0, s>>>(c, m, l, f, n, low, high);
  merge_kernel<<<blocks, kThreads, 0, s>>>(l, h, w, n);
  compress_kernel<<<blocks, kThreads, 0, s>>>(l, n);
  mark_kernel<<<blocks, kThreads, 0, s>>>(c, m, l, f, n, high);
  out_kernel<<<blocks, kThreads, 0, s>>>(l, f, static_cast<uint8_t*>(out),
                                         n);
  return cudaGetLastError();
}

}  // extern "C"
