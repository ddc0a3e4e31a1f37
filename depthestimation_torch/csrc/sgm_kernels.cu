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
// K1: BT cost volume with the fused block_size^2 SAD window.
//
// Replaces depthestimation_tpu/ops/pallas_sgm.py::_cost_kernel (BT route).
// C[y, x, d] = sum over |dy|, |dx| <= r of BT(y', x', d), where the tap
// (y', x') is first clamped into the image and only then indexes the right
// image at clamp(x' - min_disp - d, 0, w - 1): the edge padding of
// costs.bt_cost_volume's _block_sum acts on the pixel-cost volume, which
// is what the TPU kernel's clamp_tap reproduces.
//
// Bound: the int16 output write (H*W*D*2 bytes) -- the six float32 input
// planes are ~1/10 of it. Design: one block per (row y, 64-column tile),
// one thread per disparity. The block stages the block_size input rows it
// needs (left: tile + 2r columns; right: tile + 2r + D - 1 columns, the
// span every (x, d) pair can reach) in shared memory, so each input value
// is read from device memory once per block. Each thread walks the tile's
// tap columns, keeps the last block_size column sums in a shared ring and
// writes one output per column; a warp's writes are 64 contiguous bytes.
// Costs are small integers in float32, so every sum is exact.
// ---------------------------------------------------------------------------

constexpr int kTileX = 64;

__global__ void cost_volume_kernel(const float* __restrict__ pl,
                                   const float* __restrict__ pu0,
                                   const float* __restrict__ pu1,
                                   const float* __restrict__ pr,
                                   const float* __restrict__ pv0,
                                   const float* __restrict__ pv1,
                                   int16_t* __restrict__ out, int h, int w,
                                   int D, int min_disp, int bs) {
  extern __shared__ float smem[];
  const int r = bs / 2;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTileX;
  const int lw = kTileX + 2 * r;
  const int rw = kTileX + 2 * r + D - 1;
  const int rbase = x0 - r - min_disp - (D - 1);
  float* L = smem;                 // [3][bs][lw]: prefiltered, min, max
  float* R = L + 3 * bs * lw;      // [3][bs][rw]
  float* ring = R + 3 * bs * rw;   // [bs][blockDim.x]

  const float* lsrc[3] = {pl, pu0, pu1};
  const float* rsrc[3] = {pr, pv0, pv1};
  for (int i = threadIdx.x; i < 3 * bs * lw; i += blockDim.x) {
    const int p = i / (bs * lw), k = (i / lw) % bs, j = i % lw;
    const int yy = clampi(y - r + k, 0, h - 1);
    L[i] = lsrc[p][yy * w + clampi(x0 - r + j, 0, w - 1)];
  }
  for (int i = threadIdx.x; i < 3 * bs * rw; i += blockDim.x) {
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
    for (int k = 0; k < bs; ++k) {
      const float u = L[k * lw + i];
      const float u0 = L[(bs + k) * lw + i];
      const float u1 = L[(2 * bs + k) * lw + i];
      const float v = R[k * rw + jr];
      const float v0 = R[(bs + k) * rw + jr];
      const float v1 = R[(2 * bs + k) * rw + jr];
      const float c0 = fmaxf(fmaxf(u - v1, v0 - u), 0.f);
      const float c1 = fmaxf(fmaxf(v - u1, u0 - v), 0.f);
      col += fminf(c0, c1);
    }
    ring[(i % bs) * blockDim.x + d] = col;
    if (i >= 2 * r) {
      float s = 0.f;
      for (int k = 0; k < bs; ++k) s += ring[k * blockDim.x + d];
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
// K3: downward vertical sweep fused with the final sum S = S_we + L_down.
//
// Replaces depthestimation_tpu/ops/pallas_sgm.py::_rowsweep_kernel for
// dxs=[0], reverse=False (the sgbm_3way path). S is stored in OutT (the
// _final_dtype rule).
//
// Bound: bytes -- reads C and S_we, writes S (3 volumes). Design: one warp
// per column, the y loop sequential with the carry in registers; each
// step reads D contiguous values per operand, and neighbouring warps read
// neighbouring columns. Only W warps exist (1920 at 1080p, ~15 per SM),
// so like K2 it is bounded by load latency at this occupancy; raising
// the loads in flight is later work.
// ---------------------------------------------------------------------------

template <int K, typename AccT, typename OutT>
__global__ void rowsweep_kernel(const int16_t* __restrict__ cost,
                                const AccT* __restrict__ acc,
                                OutT* __restrict__ out, int h, int w, int D,
                                int p1, int p2) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (col >= w) return;  // warp-uniform
  const bool live = lane * K < D;
  const size_t base = (size_t)col * D + lane * K;
  const size_t pitch = (size_t)w * D;

  int l[K], c[K], cn[K], a[K], an[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    l[k] = live ? 0 : kBig;
    c[k] = cn[k] = a[k] = an[k] = 0;
  }
  if (live) {
    load_vec<K>(cost + base, c);
    load_vec<K>(acc + base, a);
  }
  for (int y = 0; y < h; ++y) {
    if (live && y + 1 < h) {
      load_vec<K>(cost + base + (y + 1) * pitch, cn);
      load_vec<K>(acc + base + (y + 1) * pitch, an);
    }
    sgm_step<K>(l, c, live, lane, p1, p2);
    if (live) {
      int o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = a[k] + l[k];
      store_vec<K>(out + base + y * pitch, o);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k] = cn[k];
      a[k] = an[k];
    }
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

template <int K, typename AccT>
void rowsweep_launch_acc(const int16_t* cost, const void* acc, void* out,
                         int out_int32, int h, int w, int D, int p1, int p2,
                         cudaStream_t stream) {
  const dim3 grid = warp_grid(w), block(32 * kWarpsPerBlock);
  const AccT* a = static_cast<const AccT*>(acc);
  if (out_int32) {
    rowsweep_kernel<K, AccT, int32_t><<<grid, block, 0, stream>>>(
        cost, a, static_cast<int32_t*>(out), h, w, D, p1, p2);
  } else {
    rowsweep_kernel<K, AccT, int16_t><<<grid, block, 0, stream>>>(
        cost, a, static_cast<int16_t*>(out), h, w, D, p1, p2);
  }
}

template <int K>
void rowsweep_launch(const int16_t* cost, const void* acc, int acc_int32,
                     void* out, int out_int32, int h, int w, int D, int p1,
                     int p2, cudaStream_t stream) {
  if (acc_int32) {
    rowsweep_launch_acc<K, int32_t>(cost, acc, out, out_int32, h, w, D, p1,
                                    p2, stream);
  } else {
    rowsweep_launch_acc<K, int16_t>(cost, acc, out, out_int32, h, w, D, p1,
                                    p2, stream);
  }
}

}  // namespace

extern "C" {

int sgm_cost_volume(const float* pl, const float* pu0, const float* pu1,
                    const float* pr, const float* pv0, const float* pv1,
                    int16_t* out, int h, int w, int D, int min_disp, int bs,
                    cudaStream_t stream) {
  const int threads = (D + 31) / 32 * 32;
  const int r = bs / 2;
  const size_t smem =
      sizeof(float) * (3 * bs * ((kTileX + 2 * r) + (kTileX + 2 * r + D - 1)) +
                       bs * threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cost_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((w + kTileX - 1) / kTileX, h);
  cost_volume_kernel<<<grid, threads, smem, stream>>>(
      pl, pu0, pu1, pr, pv0, pv1, out, h, w, D, min_disp, bs);
  return (int)cudaGetLastError();
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
                 void* out, int out_int32, int h, int w, int D, int p1, int p2,
                 cudaStream_t stream) {
  switch (lanes_k(D)) {
    case 1: rowsweep_launch<1>(cost, acc, acc_int32, out, out_int32, h, w, D, p1, p2, stream); break;
    case 2: rowsweep_launch<2>(cost, acc, acc_int32, out, out_int32, h, w, D, p1, p2, stream); break;
    case 4: rowsweep_launch<4>(cost, acc, acc_int32, out, out_int32, h, w, D, p1, p2, stream); break;
    case 8: rowsweep_launch<8>(cost, acc, acc_int32, out, out_int32, h, w, D, p1, p2, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
