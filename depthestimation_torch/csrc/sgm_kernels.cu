// Hand-written Hopper (sm_90a) kernels for the SGM matcher's three hot
// stages, with a plain C interface loaded through ctypes
// (depthestimation_torch/ops/cuda_build.py). Wrappers, plain versions and
// launch counts live in depthestimation_torch/ops/cuda_sgm.py.
//
// All volumes are row-major (H, W, D) with D innermost and unpadded. Every
// launcher enqueues on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported at the call.
//
// Memory rate of one H100 SXM: 3.35 TB/s. One 1080x1920x128 int16 volume
// is 531 MB, so every pass over a volume costs at least ~0.16 ms; the
// arithmetic per element is a few integer operations, far below the
// card's rate, so all three kernels are bounded by bytes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Stands in for the out-of-range d-1 / d+1 neighbour and for the lanes
// past D; far above any aggregated cost, and kBig + P1 cannot overflow.
constexpr int kBig = 1 << 29;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// K1: cost volume with the fused block_size^2 SAD window, BT or census.
//
// Replaces depthestimation_tpu/ops/pallas_sgm.py::_cost_kernel (both
// routes). C[y, x, d] = sum over |dy|, |dx| <= r of pc(y', x', d), where
// the tap (y', x') is first clamped into the image and only then indexes
// the right image at clamp(x' - min_disp - d, 0, w - 1): the edge padding
// of costs._block_sum acts on the pixel-cost volume, which is what the TPU
// kernel's clamp_tap reproduces. The pixel cost pc is
//   BT:     min of the two half-sample envelope distances, from three
//           float32 planes per image (prefiltered value, envelope min and
//           max);
//   census: popcount(wl ^ wr) of one plane of packed census words per
//           image.
//
// Bound: the int16 output write (H*W*D*2 bytes) -- the input planes are
// ~1/10 of it. Design: one block per (row y, 64-column tile), one thread
// per disparity. The block stages the block_size input rows it needs
// (left: tile + 2r columns; right: tile + 2r + D - 1 columns, the span
// every (x, d) pair can reach) in shared memory, so each input value is
// read from device memory once per block. Each thread walks the tile's
// tap columns, keeps the last block_size column sums in a shared ring and
// writes one output per column; a warp's writes are 64 contiguous bytes.
//
// Summation order is costs._block_sum's: each column sum adds its rows
// top to bottom, and each window adds its column sums left to right
// (oldest ring slot first), both from 0. So the float32 result equals the
// plain version bit for bit on any input, not only on integer images
// where every partial sum is exact.
// ---------------------------------------------------------------------------

constexpr int kTileX = 64;

template <bool CENSUS>
struct PixelCost;

template <>
struct PixelCost<false> {
  using T = float;
  static constexpr int kPlanes = 3;
  // L and R point at plane 0 of the staged rows; planes are `lp` and `rp`
  // elements apart.
  __device__ static float at(const float* L, int lp, const float* R, int rp) {
    const float u = L[0], u0 = L[lp], u1 = L[2 * lp];
    const float v = R[0], v0 = R[rp], v1 = R[2 * rp];
    const float c0 = fmaxf(fmaxf(u - v1, v0 - u), 0.f);
    const float c1 = fmaxf(fmaxf(v - u1, u0 - v), 0.f);
    return fminf(c0, c1);
  }
};

template <>
struct PixelCost<true> {
  using T = uint32_t;
  static constexpr int kPlanes = 1;
  __device__ static float at(const uint32_t* L, int, const uint32_t* R, int) {
    return (float)__popc(L[0] ^ R[0]);
  }
};

template <bool CENSUS>
__global__ void cost_volume_kernel(
    const typename PixelCost<CENSUS>::T* __restrict__ l0,
    const typename PixelCost<CENSUS>::T* __restrict__ l1,
    const typename PixelCost<CENSUS>::T* __restrict__ l2,
    const typename PixelCost<CENSUS>::T* __restrict__ r0,
    const typename PixelCost<CENSUS>::T* __restrict__ r1,
    const typename PixelCost<CENSUS>::T* __restrict__ r2,
    int16_t* __restrict__ out, int h, int w, int D, int min_disp, int bs) {
  using PC = PixelCost<CENSUS>;
  using T = typename PC::T;
  constexpr int NP = PC::kPlanes;
  extern __shared__ float smem[];
  const int r = bs / 2;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTileX;
  const int lw = kTileX + 2 * r;
  const int rw = kTileX + 2 * r + D - 1;
  const int rbase = x0 - r - min_disp - (D - 1);
  T* L = reinterpret_cast<T*>(smem);  // [NP][bs][lw]
  T* R = L + NP * bs * lw;             // [NP][bs][rw]
  float* ring = reinterpret_cast<float*>(R + NP * bs * rw);  // [bs][blockDim.x]

  const T* lsrc[3] = {l0, l1, l2};
  const T* rsrc[3] = {r0, r1, r2};
  for (int i = threadIdx.x; i < NP * bs * lw; i += blockDim.x) {
    const int p = i / (bs * lw), k = (i / lw) % bs, j = i % lw;
    const int yy = clampi(y - r + k, 0, h - 1);
    L[i] = lsrc[p][yy * w + clampi(x0 - r + j, 0, w - 1)];
  }
  for (int i = threadIdx.x; i < NP * bs * rw; i += blockDim.x) {
    const int p = i / (bs * rw), k = (i / rw) % bs, j = i % rw;
    const int yy = clampi(y - r + k, 0, h - 1);
    R[i] = rsrc[p][yy * w + clampi(rbase + j, 0, w - 1)];
  }
  __syncthreads();

  const int d = threadIdx.x;
  if (d >= D) return;  // no barrier below
  const int taps = min(kTileX, w - x0) + 2 * r;
  for (int i = 0; i < taps; ++i) {
    const int xc = clampi(x0 - r + i, 0, w - 1);
    const int jr = xc - min_disp - d - rbase;
    float col = 0.f;
    for (int k = 0; k < bs; ++k)
      col += PC::at(L + k * lw + i, bs * lw, R + k * rw + jr, bs * rw);
    const int slot = i % bs;
    ring[slot * blockDim.x + d] = col;
    if (i >= 2 * r) {
      // Slot + 1 (mod bs) holds the oldest tap, i - 2r; slot the newest.
      float s = 0.f;
      for (int k = 0, j = slot; k < bs; ++k) {
        j = j + 1 == bs ? 0 : j + 1;
        s += ring[j * blockDim.x + d];
      }
      const int x = x0 + i - 2 * r;
      out[((size_t)y * w + x) * D + d] = (int16_t)(int)s;
    }
  }
}

// ---------------------------------------------------------------------------
// Shared by K2 and K3: one warp owns one scanline; lane l holds the K
// contiguous disparities [l*K, l*K + K), so a step's loads and stores are
// one contiguous D-long run per warp. Lanes with l*K >= D are idle and
// hold kBig (D is a multiple of 16 and K divides 16, so no lane straddles
// D).
// ---------------------------------------------------------------------------

template <typename T, int K>
struct alignas(sizeof(T) * K) Vec {
  T v[K];
};

template <int K, typename T>
__device__ __forceinline__ void load_vec(const T* p, int (&out)[K]) {
  const Vec<T, K> v = *reinterpret_cast<const Vec<T, K>*>(p);
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = static_cast<int>(v.v[k]);
}

template <int K, typename T>
__device__ __forceinline__ void store_vec(T* p, const int (&in)[K]) {
  Vec<T, K> v;
#pragma unroll
  for (int k = 0; k < K; ++k) v.v[k] = static_cast<T>(in[k]);
  *reinterpret_cast<Vec<T, K>*>(p) = v;
}

// One SGM recurrence step on the carry l (int32, in place):
//   L(d) = C(d) + min(L'(d), L'(d-1) + P1, L'(d+1) + P1, min L' + P2) - min L'
// min over D is one warp reduction; the d-1 / d+1 neighbours across lane
// boundaries are one shuffle each. Out-of-range neighbours read kBig, the
// counterpart of the big fill in ops/sgm.py and the TPU kernel's _BIG edge
// vectors.
template <int K>
__device__ __forceinline__ void sgm_step(int (&l)[K], const int (&c)[K],
                                         bool live, int lane, int p1,
                                         int p2) {
  int m = l[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = min(m, l[k]);
  m = __reduce_min_sync(kFull, m);
  int below = __shfl_up_sync(kFull, l[K - 1], 1);
  int above = __shfl_down_sync(kFull, l[0], 1);
  if (lane == 0) below = kBig;
  if (lane == 31) above = kBig;
  if (!live) return;
  int nl[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int dn = k == 0 ? below : l[k - 1];
    const int up = k == K - 1 ? above : l[k + 1];
    const int best = min(min(l[k], min(up, dn) + p1), m + p2);
    nl[k] = c[k] + best - m;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) l[k] = nl[k];
}

// ---------------------------------------------------------------------------
// K2: horizontal SGM scan.
//
// Replaces depthestimation_tpu/ops/pallas_sgm.py::_hscan_kernel. Forward
// (L->R) stores L as int16; backward (R->L) reads L and stores
// S_we = L + L_rl in OutT (the _acc_dtype rule). Zero carry at the row
// start = fresh path start, as in ops/sgm.py.
//
// Bound: bytes -- forward reads C and writes L (2 volumes), backward reads
// C and L and writes S_we (3 volumes). Design: one warp per row, the x
// loop sequential with the carry in registers and the next column's
// loads issued before the current step's arithmetic. Only H warps exist
// (1080 at 1080p, ~8 per SM of 64 slots), so the scan is bounded by load
// latency rather than by the memory rate; a deeper prefetch or more rows
// in flight per SM is later work.
// ---------------------------------------------------------------------------

template <int K, bool BACKWARD, typename OutT>
__global__ void hscan_kernel(const int16_t* __restrict__ cost,
                             const int16_t* __restrict__ lin,
                             OutT* __restrict__ out, int h, int w, int D,
                             int p1, int p2) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= h) return;  // warp-uniform
  const bool live = lane * K < D;
  const size_t base = (size_t)row * w * D + lane * K;

  int l[K], c[K], cn[K], a[K], an[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    l[k] = live ? 0 : kBig;
    c[k] = cn[k] = a[k] = an[k] = 0;
  }
  int x = BACKWARD ? w - 1 : 0;
  if (live) {
    load_vec<K>(cost + base + (size_t)x * D, c);
    if (BACKWARD) load_vec<K>(lin + base + (size_t)x * D, a);
  }
  for (int s = 0; s < w; ++s) {
    const int xn = BACKWARD ? x - 1 : x + 1;
    if (live && s + 1 < w) {
      load_vec<K>(cost + base + (size_t)xn * D, cn);
      if (BACKWARD) load_vec<K>(lin + base + (size_t)xn * D, an);
    }
    sgm_step<K>(l, c, live, lane, p1, p2);
    if (live) {
      if (BACKWARD) {
        int o[K];
#pragma unroll
        for (int k = 0; k < K; ++k) o[k] = a[k] + l[k];
        store_vec<K>(out + base + (size_t)x * D, o);
      } else {
        store_vec<K>(out + base + (size_t)x * D, l);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k] = cn[k];
      a[k] = an[k];
    }
    x = xn;
  }
}

// ---------------------------------------------------------------------------
// K3: one row-direction SGM sweep fused with a running sum,
// out = in + L_(dy, dx), for dy = +1 (downward) or -1 (upward) and
// dx in {-1, 0, 1}: the predecessor of (y, x) is (y - dy, x - dx), and a
// path restarts with a zero carry where that leaves the image, as in
// ops/sgm.py.
//
// Replaces depthestimation_tpu/ops/pallas_sgm.py::_rowsweep_kernel. The
// TPU kernel sweeps all of a pass's directions (dxs) in one launch; here
// the wrapper launches once per direction, each launch adding one L to
// the partial sum (stored int32 between launches, so nothing can wrap;
// the last launch stores the _final_dtype or _acc_dtype rule's type).
//
// Every pixel lies on exactly one line x - (dx/dy)*y = const, and the
// lines are independent scans. Design: one warp per line, walking it from
// its first pixel (on the first row in scan order, or on the entry
// column for a diagonal) with the carry in registers; each step reads D
// contiguous values per operand. A vertical pass has W lines, a diagonal
// one W + H - 1 of unequal length.
//
// Bound: bytes -- reads C and the partial sum, writes the new sum (3
// volumes per direction). Only W to W + H - 1 warps exist (1920 to 2999 at
// 1080p, ~15-23 per SM), so like K2 each launch is bounded by load latency
// rather than by the memory rate; raising the loads in flight is later
// work.
// ---------------------------------------------------------------------------

template <int K, typename InT, typename OutT>
__global__ void rowsweep_kernel(const int16_t* __restrict__ cost,
                                const InT* __restrict__ acc,
                                OutT* __restrict__ out, int h, int w, int D,
                                int dy, int dx, int p1, int p2) {
  const int line = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (line >= (dx == 0 ? w : w + h - 1)) return;  // warp-uniform
  const bool live = lane * K < D;

  // First pixel of the line (on the first row in scan order, or for a
  // diagonal's lines past w on the entry column) and its pixel count.
  // Selects, not branches: with branches here nvcc no longer proves the
  // warp converged in the loop, and serialises the two prefetch loads.
  const bool from_col = line >= w;
  const int j = line - w + 1;
  const int y = from_col ? (dy > 0 ? j : h - 1 - j) : (dy > 0 ? 0 : h - 1);
  const int x = from_col ? (dx > 0 ? 0 : w - 1) : line;
  const int rows_left = dy > 0 ? h - y : y + 1;
  const int cols_left = dx > 0 ? w - x : (dx < 0 ? x + 1 : rows_left);
  const int n = min(rows_left, cols_left);
  const ptrdiff_t step = ((ptrdiff_t)dy * w + dx) * D;
  ptrdiff_t p = ((ptrdiff_t)y * w + x) * D + lane * K;

  int l[K], c[K], a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    l[k] = live ? 0 : kBig;
    c[k] = a[k] = 0;
  }
  if (live) {
    load_vec<K>(cost + p, c);
    load_vec<K>(acc + p, a);
  }
  // The next pixel's operands stay packed until the step is done, so both
  // loads are in flight together while it runs.
  Vec<int16_t, K> cn = {};
  Vec<InT, K> an = {};
  for (int s = 0; s < n; ++s) {
    if (live && s + 1 < n) {
      cn = *reinterpret_cast<const Vec<int16_t, K>*>(cost + p + step);
      an = *reinterpret_cast<const Vec<InT, K>*>(acc + p + step);
    }
    sgm_step<K>(l, c, live, lane, p1, p2);
    if (live) {
      int o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = a[k] + l[k];
      store_vec<K>(out + p, o);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k] = cn.v[k];
      a[k] = an.v[k];
    }
    p += step;
  }
}

constexpr int kWarpsPerBlock = 4;

// Per-lane disparity count K for D (a multiple of 16, at most 256).
int lanes_k(int D) {
  if (D <= 32) return 1;
  if (D <= 64) return 2;
  if (D <= 128) return 4;
  if (D <= 256) return 8;
  return 0;
}

dim3 warp_grid(int lines) {
  const int per = kWarpsPerBlock;
  return dim3((lines + per - 1) / per);
}

template <int K>
void hscan_launch(const int16_t* cost, const int16_t* lin, void* out,
                  int out_int32, int backward, int h, int w, int D, int p1,
                  int p2, cudaStream_t stream) {
  const dim3 grid = warp_grid(h), block(32 * kWarpsPerBlock);
  if (!backward) {
    hscan_kernel<K, false, int16_t><<<grid, block, 0, stream>>>(
        cost, nullptr, static_cast<int16_t*>(out), h, w, D, p1, p2);
  } else if (out_int32) {
    hscan_kernel<K, true, int32_t><<<grid, block, 0, stream>>>(
        cost, lin, static_cast<int32_t*>(out), h, w, D, p1, p2);
  } else {
    hscan_kernel<K, true, int16_t><<<grid, block, 0, stream>>>(
        cost, lin, static_cast<int16_t*>(out), h, w, D, p1, p2);
  }
}

template <int K, typename InT>
void rowsweep_launch_in(const int16_t* cost, const void* acc, void* out,
                        int out_int32, int h, int w, int D, int dy, int dx,
                        int p1, int p2, cudaStream_t stream) {
  const dim3 grid = warp_grid(dx == 0 ? w : w + h - 1),
             block(32 * kWarpsPerBlock);
  const InT* a = static_cast<const InT*>(acc);
  if (out_int32) {
    rowsweep_kernel<K, InT, int32_t><<<grid, block, 0, stream>>>(
        cost, a, static_cast<int32_t*>(out), h, w, D, dy, dx, p1, p2);
  } else {
    rowsweep_kernel<K, InT, int16_t><<<grid, block, 0, stream>>>(
        cost, a, static_cast<int16_t*>(out), h, w, D, dy, dx, p1, p2);
  }
}

template <int K>
void rowsweep_launch(const int16_t* cost, const void* acc, int acc_int32,
                     void* out, int out_int32, int h, int w, int D, int dy,
                     int dx, int p1, int p2, cudaStream_t stream) {
  if (acc_int32) {
    rowsweep_launch_in<K, int32_t>(cost, acc, out, out_int32, h, w, D, dy,
                                   dx, p1, p2, stream);
  } else {
    rowsweep_launch_in<K, int16_t>(cost, acc, out, out_int32, h, w, D, dy,
                                   dx, p1, p2, stream);
  }
}

template <bool CENSUS>
int cost_volume_launch(const void* const* planes, int16_t* out, int h, int w,
                       int D, int min_disp, int bs, cudaStream_t stream) {
  using PC = PixelCost<CENSUS>;
  using T = typename PC::T;
  const int threads = (D + 31) / 32 * 32;
  const int r = bs / 2;
  const size_t smem =
      sizeof(T) * PC::kPlanes * bs * ((kTileX + 2 * r) + (kTileX + 2 * r + D - 1)) +
      sizeof(float) * bs * threads;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&cost_volume_kernel<CENSUS>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const T* p[6];
  for (int i = 0; i < 6; ++i) p[i] = static_cast<const T*>(planes[i]);
  const dim3 grid((w + kTileX - 1) / kTileX, h);
  cost_volume_kernel<CENSUS><<<grid, threads, smem, stream>>>(
      p[0], p[1], p[2], p[3], p[4], p[5], out, h, w, D, min_disp, bs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sgm_cost_volume(const float* pl, const float* pu0, const float* pu1,
                    const float* pr, const float* pv0, const float* pv1,
                    int16_t* out, int h, int w, int D, int min_disp, int bs,
                    cudaStream_t stream) {
  const void* planes[6] = {pl, pu0, pu1, pr, pv0, pv1};
  return cost_volume_launch<false>(planes, out, h, w, D, min_disp, bs, stream);
}

int sgm_census_cost_volume(const int32_t* cl, const int32_t* cr, int16_t* out,
                           int h, int w, int D, int min_disp, int bs,
                           cudaStream_t stream) {
  const void* planes[6] = {cl, nullptr, nullptr, cr, nullptr, nullptr};
  return cost_volume_launch<true>(planes, out, h, w, D, min_disp, bs, stream);
}

int sgm_hscan(const int16_t* cost, const int16_t* lin, void* out,
              int out_int32, int backward, int h, int w, int D, int p1, int p2,
              cudaStream_t stream) {
  switch (lanes_k(D)) {
    case 1: hscan_launch<1>(cost, lin, out, out_int32, backward, h, w, D, p1, p2, stream); break;
    case 2: hscan_launch<2>(cost, lin, out, out_int32, backward, h, w, D, p1, p2, stream); break;
    case 4: hscan_launch<4>(cost, lin, out, out_int32, backward, h, w, D, p1, p2, stream); break;
    case 8: hscan_launch<8>(cost, lin, out, out_int32, backward, h, w, D, p1, p2, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int sgm_rowsweep(const int16_t* cost, const void* acc, int acc_int32,
                 void* out, int out_int32, int h, int w, int D, int dy, int dx,
                 int p1, int p2, cudaStream_t stream) {
  if ((dy != 1 && dy != -1) || dx < -1 || dx > 1) return (int)cudaErrorInvalidValue;
  switch (lanes_k(D)) {
    case 1: rowsweep_launch<1>(cost, acc, acc_int32, out, out_int32, h, w, D, dy, dx, p1, p2, stream); break;
    case 2: rowsweep_launch<2>(cost, acc, acc_int32, out, out_int32, h, w, D, dy, dx, p1, p2, stream); break;
    case 4: rowsweep_launch<4>(cost, acc, acc_int32, out, out_int32, h, w, D, dy, dx, p1, p2, stream); break;
    case 8: rowsweep_launch<8>(cost, acc, acc_int32, out, out_int32, h, w, D, dy, dx, p1, p2, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
