// Hand-written Hopper (sm_90a) kernels for the speckle filter
// (cv2.filterSpeckles), with a plain C interface loaded through ctypes
// (depthestimation_torch/ops/cuda_build.py). The wrapper, its plain
// version and its launch count live in depthestimation_torch/ops/filters.py.
//
// Replaces no TPU kernel: the JAX package computes the filter with plain
// XLA ops (depthestimation_tpu/ops/filters.py::filter_speckles), a min-label
// flood fill, a BFS distance field, parent pointers and a subtree count, all
// as shifted whole-map planes, because gathers and scatters are slow on a
// TPU. Run as plain torch on the card that is some 4,000 launches a call at
// window 50 and 7,000 at window 100, each over the whole 2-Mpixel map.
// Here the components are labelled directly by union-find (Playne & Hawick
// 2018, "A New Algorithm for Parallel Connected-Component Labelling on
// GPUs"; Allegretti, Bolelli & Grana 2020, block-based union-find), in four
// launches a call.
//
// Semantics, equal to the plain version bit for bit: pixels p and q that
// are 4-neighbours are joined when both differ from new_val and
// fabsf(d(p) - d(q)) <= max_diff, in float32; every component of at most
// max_size pixels is overwritten with new_val, every other pixel keeps d.
// The edge test is computed from d wherever it is needed: no mask is stored.
//
// Bound: bytes. The least traffic is d read once and out written once, 8
// bytes a pixel (16.6 MB at 1080x1920, ~5 us at 3.35 TB/s). The kernels
// move about 40 bytes a pixel: d twice, the int32 labels written, read and
// compressed, the sizes zeroed and gathered.
//
// 1. speckle_local_kernel: one block labels a 32x32 tile in shared memory.
//    A warp holds one row of the tile; the row's runs of joined pixels come
//    from one ballot (each pixel points at its run's first pixel), then
//    vertical edges are united with atomicMin union-find, once for each
//    stretch where two runs touch. The flattened label of a pixel is the
//    global index of its tile-local root (-1 where d == new_val); the size
//    array is zeroed on the way.
// 2. speckle_border_kernel: one thread a pixel pair across a tile seam
//    unites the two trees in global memory with atomicMin union-find,
//    skipping a pair whose union the pair before it along the seam already
//    implies.
// 3. speckle_count_kernel: every pixel finds its root and stores it (so
//    every label is then its root); a warp aggregates equal roots with
//    __match_any_sync and one lane adds the popcount, skipped once the root's
//    count is above max_size (the 1080p scenes have one component of about a
//    million pixels, whose root would otherwise take every warp's atomic).
//    A count stops only above max_size, so it is exact wherever it decides.
// 4. speckle_apply_kernel: out = (labelled && size[root] <= max_size) ?
//    new_val : d.
//
// No host sync, no allocation and no cooperative grid sync, so a CUDA graph
// captures and replays a call: the labels and sizes are scratch that the
// wrapper allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                 // tile side; a warp is one tile row
constexpr int kWarps = 8;                 // a block: 32 x 8 threads
constexpr int kRowsPerWarp = kTile / kWarps;
constexpr int kThreads = 256;             // 1-D kernels
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool joined(float a, float b, float new_val,
                                       float max_diff) {
  return a != new_val && b != new_val && fabsf(__fsub_rn(a, b)) <= max_diff;
}

// Roots of a union-find forest whose links always point to a smaller
// index. Reads go around L1 (volatile in shared memory, .cg in global), so
// a thread sees the links other threads' atomics made; a stale link is
// still an ancestor, since links only ever move to smaller indices.
__device__ __forceinline__ int find_shared(volatile const int* par, int x) {
  int p = par[x];
  while (p != x) {
    x = p;
    p = par[x];
  }
  return x;
}

__device__ __forceinline__ int find_global(const int* par, int x) {
  int p = __ldcg(par + x);
  while (p != x) {
    x = p;
    p = __ldcg(par + x);
  }
  return x;
}

// Unite the trees of a and b: the larger root is linked under the smaller.
// atomicMin returns the link it found; if that root had meanwhile been
// linked elsewhere, the link is now the smaller of the two, and the loop
// goes on to unite the tree it was linked to.
__device__ void unite_shared(int* par, int a, int b) {
  while (true) {
    a = find_shared(par, a);
    b = find_shared(par, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = old;
  }
}

__device__ void unite_global(int* par, int a, int b) {
  while (true) {
    a = find_global(par, a);
    b = find_global(par, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(kTile * kWarps)
speckle_local_kernel(const float* __restrict__ d, int* __restrict__ label,
                     int* __restrict__ size, int h, int w, float new_val,
                     float max_diff) {
  __shared__ int par[kTile * kTile];
  __shared__ float val[kTile * kTile];
  const int tx = threadIdx.x;
  const int x = blockIdx.x * kTile + tx;
  const int y0 = blockIdx.y * kTile;
  const unsigned below = (2u << tx) - 1u;  // lanes 0..tx

  // Rows as runs: a pixel points at the first pixel of its run.
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = threadIdx.y + k * kWarps;
    const int y = y0 + r;
    const bool in = y < h && x < w;
    const float v = in ? d[(size_t)y * w + x] : 0.f;
    const bool valid = in && v != new_val;
    const float left_v = __shfl_up_sync(kFull, v, 1);
    const bool left_valid = __shfl_up_sync(kFull, (int)valid, 1);
    const bool left = tx > 0 && valid && left_valid &&
                      fabsf(__fsub_rn(v, left_v)) <= max_diff;
    const unsigned starts = __ballot_sync(kFull, !left);
    const int start = 31 - __clz(starts & below);
    val[r * kTile + tx] = v;
    par[r * kTile + tx] = valid ? r * kTile + start : -1;
  }
  __syncthreads();

  // Vertical edges. A pixel whose left neighbour is joined to it, to the
  // pixel above that neighbour, and that pixel to the one above itself, is
  // already in the same tree as the pixel above it.
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = threadIdx.y + k * kWarps;
    const int i = r * kTile + tx;
    bool up = false, skip = false;
    if (r > 0 && par[i] >= 0 && par[i - kTile] >= 0) {
      const float v = val[i], vu = val[i - kTile];
      up = fabsf(__fsub_rn(v, vu)) <= max_diff;
      if (up && tx > 0 && par[i - 1] >= 0 && par[i - kTile - 1] >= 0)
        skip = fabsf(__fsub_rn(v, val[i - 1])) <= max_diff &&
               fabsf(__fsub_rn(vu, val[i - kTile - 1])) <= max_diff;
    }
    const bool left_up = __shfl_up_sync(kFull, (int)up, 1);
    if (up && !(skip && left_up)) unite_shared(par, i, i - kTile);
  }
  __syncthreads();

  // Flatten: the global index of the tile-local root.
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = threadIdx.y + k * kWarps;
    const int y = y0 + r;
    if (y >= h || x >= w) continue;
    const int i = r * kTile + tx;
    int lab = -1;
    if (par[i] >= 0) {
      const int root = find_shared(par, i);
      lab = (y0 + root / kTile) * w + blockIdx.x * kTile + root % kTile;
    }
    const size_t g = (size_t)y * w + x;
    label[g] = lab;
    size[g] = 0;
  }
}

// Pixel pairs across the tile seams: first the horizontal seams (a pixel
// of a tile's top row and the one above it), then the vertical ones (a
// pixel of a tile's left column and the one to its left).
__global__ void __launch_bounds__(kThreads)
speckle_border_kernel(const float* __restrict__ d, int* __restrict__ label,
                      int h, int w, long long n_rows, long long n_cols,
                      float new_val, float max_diff) {
  long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  int a, b, step;
  bool first;
  if (t < n_rows) {
    const int y = (int)(t / w + 1) * kTile, x = (int)(t % w);
    a = y * w + x;
    b = a - w;
    // The pair before along the seam: one pixel left. Where that crosses a
    // vertical seam the pair is always united, so that the skips below
    // never lean on each other around a tile corner.
    step = 1;
    first = x % kTile == 0;
  } else if (t < n_rows + n_cols) {
    t -= n_rows;
    const int x = (int)(t / h + 1) * kTile, y = (int)(t % h);
    a = y * w + x;
    b = a - 1;
    step = w;  // one row up
    first = y == 0;
  } else {
    return;
  }
  const float va = __ldg(d + a), vb = __ldg(d + b);
  if (!joined(va, vb, new_val, max_diff)) return;
  if (!first) {
    const float pa = __ldg(d + a - step), pb = __ldg(d + b - step);
    // a ~ a', b ~ b' and a' ~ b' are edges that other threads (or the local
    // pass) unite, so a and b end in one tree without this thread.
    if (joined(pa, pb, new_val, max_diff) && joined(va, pa, new_val, max_diff) &&
        joined(vb, pb, new_val, max_diff))
      return;
  }
  unite_global(label, a, b);
}

__global__ void __launch_bounds__(kThreads)
speckle_count_kernel(int* __restrict__ label, int* __restrict__ size, int n,
                     int max_size) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  int root = -1;
  if (i < n) {
    const int lab = label[i];
    if (lab >= 0) {
      root = lab;
      int p = label[root];
      while (p != root) {
        root = p;
        p = label[root];
      }
      if (root != lab) label[i] = root;
    }
  }
  const unsigned peers = __match_any_sync(kFull, root);
  if (root >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1 &&
      __ldcg(size + root) <= max_size)
    atomicAdd(size + root, __popc(peers));
}

__global__ void __launch_bounds__(kThreads)
speckle_apply_kernel(const float* __restrict__ d, const int* __restrict__ label,
                     const int* __restrict__ size, float* __restrict__ out, int n,
                     float new_val, int max_size) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int root = label[i];
  out[i] = root >= 0 && size[root] <= max_size ? new_val : d[i];
}

}  // namespace

extern "C" {

// The speckle filter of a contiguous (h, w) float32 map d into out, in
// four launches on stream; label and size are (h, w) int32 scratch.
// Returns the first launch error, else cudaGetLastError().
int speckle_filter(const float* d, float* out, int* label, int* size, int h,
                   int w, float new_val, float max_diff, int max_size,
                   cudaStream_t stream) {
  if (h < 1 || w < 1 || (long long)h * w > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n = h * w;
  const int tiles_x = (w + kTile - 1) / kTile, tiles_y = (h + kTile - 1) / kTile;
  if (tiles_y > 65535) return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)(tiles_y - 1) * w;
  const long long n_cols = (long long)(tiles_x - 1) * h;
  const long long seam_blocks = (n_rows + n_cols + kThreads - 1) / kThreads;
  const int pixel_blocks = (int)(((long long)n + kThreads - 1) / kThreads);

  speckle_local_kernel<<<dim3(tiles_x, tiles_y), dim3(kTile, kWarps), 0, stream>>>(
      d, label, size, h, w, new_val, max_diff);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // One block at least, so that every call makes the same four launches.
  speckle_border_kernel<<<(unsigned)(seam_blocks > 0 ? seam_blocks : 1), kThreads, 0,
                          stream>>>(d, label, h, w, n_rows, n_cols, new_val, max_diff);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  speckle_count_kernel<<<pixel_blocks, kThreads, 0, stream>>>(label, size, n, max_size);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  speckle_apply_kernel<<<pixel_blocks, kThreads, 0, stream>>>(d, label, size, out, n,
                                                              new_val, max_size);
  return (int)cudaGetLastError();
}

}  // extern "C"
