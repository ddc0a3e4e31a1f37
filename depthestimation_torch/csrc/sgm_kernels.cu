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

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Stands in for the out-of-range d-1 / d+1 neighbour and for the lanes
// past D; far above any aggregated cost, and kBig + P1 cannot overflow.
constexpr int kBig = 1 << 29;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// K1: cost volume straight from the grayscale pair, with the prefilter and
// the census words fused in.
//
// Replaces depthestimation_tpu/ops/pallas_sgm.py::_cost_kernel (both
// routes) and the XLA ops that feed it there (the x-Sobel prefilter and
// its half-sample envelopes, or the census words). C[y, x, d] = sum over
// |dy|, |dx| <= r of pc(y', x', d), where the tap (y', x') is first
// clamped into the image and only then indexes the right image at
// clamp(x' - min_disp - d, 0, w - 1): the edge padding of costs._block_sum
// acts on the pixel-cost volume. The pixel cost pc is
//   BT:     min of the two half-sample envelope distances between the
//           prefiltered images (costs.xsobel_prefilter and
//           costs.half_sample_envelope);
//   census: popcount(wl ^ wr) of the packed radius-2 census words
//           (costs.census_transform).
//
// Bound: bytes. The int16 output is H*W*D*2 bytes (531 MB at
// 1080x1920x128: 0.163 ms at 3.35 TB/s); the two float32 images read are
// 1/32 of that. The arithmetic is one pixel cost (~10 operations) and
// 2*(block_size-1) adds per output, well under the card's rate if each
// pixel cost is evaluated about once.
//
// Design. A block covers 32 tap rows (32 - 2r output rows), 64 output
// columns and 64 disparities, as 8 warps of 8 disparities each.
//  - Staging, once per block: the prefiltered plane and its two envelopes
//    (or the census words) of both images, for the block's 32 tap rows and
//    the columns its taps reach, computed from the raw images (loads
//    through L1) into shared memory. No plane of the pair goes through
//    device memory, and no op runs before the launch.
//  - Main loop: lane l of every warp owns tap row l, and the warp walks the
//    tap columns left to right. At each column a thread evaluates the pixel
//    costs of its 8 disparities once. Disparity d0 + k matches right column
//    xc - min_disp - d0 - k, so one new right column enters per step and
//    the other seven slide along in registers.
//  - The column sum over block_size rows takes the rows above from the
//    lanes above (__shfl_up_sync), added top to bottom from the first.
//  - The window sum keeps block_size - 1 open partial sums per disparity in
//    registers: each new column sum completes the oldest window and is
//    added to every other, so each window adds its columns left to right
//    from the first. A tap column clamped at the image edge is fed as many
//    times as the taps it stands for.
//  - The output goes out through shared memory: each thread stages its 8
//    disparities of one (y, x) with one 16-byte store, and every 4 output
//    columns the block copies them out so that 8 threads write each
//    (y, x)'s 64 disparities as one whole 128-byte line (a warp, 4 lines
//    per instruction). Stored straight from the loop, a warp instruction
//    would write 16 bytes to each of 28 rows: half sectors, each its own
//    L2 request.
//
// Summation order is costs._block_sum's (rows, then columns, each from the
// first term), and the prefilter and envelopes round each operation on its
// own as torch does, so the result equals the plain version bit for bit on
// any input, not only on integer images where every partial sum is exact.
// ---------------------------------------------------------------------------

constexpr int kK1Rows = 32;   // tap rows of a block, one per lane
constexpr int kK1TileX = 64;  // output columns of a block
constexpr int kK1DispK = 8;   // disparities of a thread: one 16-byte store
constexpr int kK1Warps = 8;
constexpr int kK1DispBlock = kK1DispK * kK1Warps;
// Output staging: kK1Slots output columns of kK1Rows rows x 64 disparities
// (int16), each row padded to 72 so that a warp's 16-byte stores to 32
// rows fall in different banks.
constexpr int kK1Slots = 4;
constexpr int kK1OutPitch = kK1DispBlock + 8;
constexpr int kK1OutBytes = kK1Slots * kK1Rows * kK1OutPitch * 2;

// Shared-memory pitches, in 4-byte words, of one plane row: the columns a
// block's taps reach on the left and on the right image, one more on each
// side for the BT envelopes, rounded up to an odd count so that the 32
// lanes (32 rows, same column) hit 32 different banks.
template <int BS>
__host__ __device__ constexpr int k1_pitch_l() {
  return (kK1TileX + 2 * (BS / 2) + 2) | 1;
}
template <int BS>
__host__ __device__ constexpr int k1_pitch_r() {
  return (kK1TileX + 2 * (BS / 2) + kK1DispBlock + 1) | 1;
}

// costs.xsobel_prefilter at (y, x): edge-clamped taps, torch's association
// ((a - b) + 2 (c - d)) + (e - f), each operation rounded on its own.
__device__ __forceinline__ float k1_prefilter(const float* __restrict__ img,
                                              int y, int x, int h, int w,
                                              float cap) {
  const float* a = img + (size_t)max(y - 1, 0) * w;
  const float* b = img + (size_t)y * w;
  const float* c = img + (size_t)min(y + 1, h - 1) * w;
  const int xm = max(x - 1, 0), xp = min(x + 1, w - 1);
  const float dx = __fadd_rn(
      __fadd_rn(__fsub_rn(__ldg(a + xp), __ldg(a + xm)),
                __fmul_rn(2.f, __fsub_rn(__ldg(b + xp), __ldg(b + xm)))),
      __fsub_rn(__ldg(c + xp), __ldg(c + xm)));
  return __fadd_rn(fminf(fmaxf(dx, -cap), cap), cap);
}

// costs.census_transform at (y, x): bit k is set where the k-th neighbour
// of the edge-clamped 5x5 window (row-major, centre skipped) is below the
// centre.
__device__ __forceinline__ uint32_t k1_census(const float* __restrict__ img,
                                              int y, int x, int h, int w) {
  const float centre = __ldg(img + (size_t)y * w + x);
  uint32_t bits = 0;
  int bit = 0;
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
    const float* row = img + (size_t)clampi(y + dy, 0, h - 1) * w;
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      if (dy == 0 && dx == 0) continue;
      bits |= (uint32_t)(__ldg(row + clampi(x + dx, 0, w - 1)) < centre) << bit;
      ++bit;
    }
  }
  return bits;
}

// Low 16 bits of (int)s, i.e. (int16_t)(int)s, for 0 <= s < 2^23: adding
// 2^23 rounded down leaves floor(s) in the low mantissa bits (one add
// instead of a quarter-rate conversion).
__device__ __forceinline__ uint32_t k1_low16(float s) {
  return __float_as_uint(__fadd_rd(s, 8388608.f)) & 0xffffu;
}
__device__ __forceinline__ uint32_t k1_low16(int s) {
  return (uint32_t)s & 0xffffu;
}

template <typename Acc>
__device__ __forceinline__ void k1_store(int16_t* p, const Acc (&o)[kK1DispK]) {
  uint4 q;
  q.x = k1_low16(o[0]) | (k1_low16(o[1]) << 16);
  q.y = k1_low16(o[2]) | (k1_low16(o[3]) << 16);
  q.z = k1_low16(o[4]) | (k1_low16(o[5]) << 16);
  q.w = k1_low16(o[6]) | (k1_low16(o[7]) << 16);
  *reinterpret_cast<uint4*>(p) = q;
}

// Census sums are integers; BT sums are float32, as in the plain version.
template <int BS, bool CENSUS>
__global__ void __launch_bounds__(kK1Warps * 32, BS <= 9 ? 2 : 1)
cost_volume_kernel(const float* __restrict__ left,
                   const float* __restrict__ right, int16_t* __restrict__ out,
                   int h, int w, int D, int min_disp, float cap) {
  using Acc = typename std::conditional<CENSUS, int, float>::type;
  constexpr int R = BS / 2;
  constexpr int K = kK1DispK;
  constexpr int NP = CENSUS ? 1 : 3;  // planes per image
  constexpr int E = CENSUS ? 0 : 1;   // envelope neighbours
  constexpr int PL = k1_pitch_l<BS>(), PR = k1_pitch_r<BS>();
  constexpr int SL = kK1Rows * PL, SR = kK1Rows * PR;  // plane strides
  extern __shared__ float smem[];
  float* const lsh = smem;            // NP planes of kK1Rows x PL
  float* const rsh = smem + NP * SL;  // NP planes of kK1Rows x PR
  int16_t* const obuf = reinterpret_cast<int16_t*>(rsh + NP * SR);

  const int y0 = blockIdx.y * (kK1Rows - 2 * R);
  const int x0 = blockIdx.x * kK1TileX;
  const int dlo = blockIdx.z * kK1DispBlock;
  const int dhi = min(dlo + kK1DispBlock, D) - 1;
  const int xlast = min(x0 + kK1TileX, w) - 1;
  // Columns the clamped taps reach: [xs, xe] on the left image, [rs, re]
  // on the right; the planes start E columns further left, at lb and rb.
  const int xs = max(x0 - R, 0), xe = min(xlast + R, w - 1);
  const int rs = clampi(xs - min_disp - dhi, 0, w - 1);
  const int re = clampi(xe - min_disp - dlo, 0, w - 1);
  const int lb = max(xs - E, 0), rb = max(rs - E, 0);
  const int nl = min(xe + E, w - 1) - lb + 1, nr = min(re + E, w - 1) - rb + 1;

  // Stage 1: plane 0 (prefiltered values or census words) of both images
  // from the raw images, through L1; plane row k is tap row y0 - r + k,
  // clamped.
  for (int i = threadIdx.x; i < kK1Rows * (nl + nr); i += blockDim.x) {
    const bool rgt = i >= kK1Rows * nl;
    const int j = rgt ? i - kK1Rows * nl : i;
    const int n = rgt ? nr : nl;
    const int k = j / n, c = j - k * n;
    const int y = clampi(y0 - R + k, 0, h - 1);
    const float* img = rgt ? right : left;
    const int x = (rgt ? rb : lb) + c;
    float* dst = rgt ? rsh + k * PR + c : lsh + k * PL + c;
    if constexpr (CENSUS) {
      *dst = __uint_as_float(k1_census(img, y, x, h, w));
    } else {
      *dst = k1_prefilter(img, y, x, h, w, cap);
    }
  }
  __syncthreads();
  // Stage 2 (BT): planes 1 and 2, the envelope min and max, over [xs, xe]
  // and [rs, re]; the neighbours are clamped into the image.
  if constexpr (!CENSUS) {
    const int ml = xe - xs + 1, mr = re - rs + 1;
    for (int i = threadIdx.x; i < kK1Rows * (ml + mr); i += blockDim.x) {
      const bool rgt = i >= kK1Rows * ml;
      const int j = rgt ? i - kK1Rows * ml : i;
      const int n = rgt ? mr : ml;
      const int k = j / n;
      const int x = (rgt ? rs : xs) + (j - k * n);
      const int stride = rgt ? SR : SL;
      float* p = rgt ? rsh : lsh;
      const int o = rgt ? k * PR - rb : k * PL - lb;  // + image column
      const float v = p[o + x];
      const float hl = floorf(__fmul_rn(0.5f, __fadd_rn(v, p[o + max(x - 1, 0)])));
      const float hr = floorf(__fmul_rn(0.5f, __fadd_rn(v, p[o + min(x + 1, w - 1)])));
      p[stride + o + x] = fminf(v, fminf(hl, hr));
      p[2 * stride + o + x] = fmaxf(v, fmaxf(hl, hr));
    }
    __syncthreads();
  }

  // Every warp runs the loop, since the output goes out through barriers;
  // a warp past the last disparity repeats the last group, and its
  // results are not copied out.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = min(dlo + warp * K, dhi - K + 1);
  const int lo = lane * PL - lb, ro = lane * PR - rb;  // + image column

  // Right planes at clamp(xc - min_disp - d0 - k): what disparity d0 + k
  // matches at the current tap column xc. Moving to xc + 1 shifts them by
  // one and reads one new column.
  float wv[K], wlo[K], whi[K];
  auto load_right = [&](int k, int xc) {
    const int c = ro + clampi(xc - min_disp - d0 - k, 0, w - 1);
    wv[k] = rsh[c];
    if constexpr (!CENSUS) {
      wlo[k] = rsh[SR + c];
      whi[k] = rsh[2 * SR + c];
    }
  };
  auto shift_in = [&](int xc) {
#pragma unroll
    for (int k = K - 1; k > 0; --k) {
      wv[k] = wv[k - 1];
      if constexpr (!CENSUS) {
        wlo[k] = wlo[k - 1];
        whi[k] = whi[k - 1];
      }
    }
    load_right(0, xc);
  };
  // Column sums at tap column xc: the pixel costs of the 8 disparities,
  // added over the tap rows top to bottom, the upper ones from the lanes
  // above (lanes < 2r get their own values back and store nothing).
  Acc cs[K];
  auto column = [&](int xc) {
    Acc pc[K];
    if constexpr (CENSUS) {
      const uint32_t u = __float_as_uint(lsh[lo + xc]);
#pragma unroll
      for (int k = 0; k < K; ++k) pc[k] = __popc(u ^ __float_as_uint(wv[k]));
    } else {
      const float u = lsh[lo + xc], u0 = lsh[lo + SL + xc],
                  u1 = lsh[lo + 2 * SL + xc];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float c0 = fmaxf(fmaxf(u - whi[k], wlo[k] - u), 0.f);
        const float c1 = fmaxf(fmaxf(wv[k] - u1, u0 - wv[k]), 0.f);
        pc[k] = fminf(c0, c1);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Acc s = pc[k];
      if constexpr (BS > 1) {
        s = __shfl_up_sync(kFull, pc[k], 2 * R);
#pragma unroll
        for (int j = 2 * R - 1; j >= 1; --j) s += __shfl_up_sync(kFull, pc[k], j);
        s += pc[k];
      }
      cs[k] = s;
    }
  };
  // Copy out the staged output columns x - n + 1 .. x: each (column, row)
  // is 64 disparities, 128 contiguous bytes, written by 8 threads with one
  // 16-byte store each, so a warp writes 4 whole 128-byte lines.
  auto flush = [&](int x, int n) {
    __syncthreads();
    for (int i = threadIdx.x; i < n * kK1Rows * 8; i += blockDim.x) {
      const int q = i & 7, row = (i >> 3) & (kK1Rows - 1), slot = i >> 8;
      const int y = y0 + row - 2 * R, d = dlo + q * K;
      if (row >= 2 * R && y < h && d <= dhi) {
        const size_t at = ((size_t)y * w + (x - n + 1 + slot)) * D + d;
        *reinterpret_cast<uint4*>(out + at) = *reinterpret_cast<const uint4*>(
            obuf + (slot * kK1Rows + row) * kK1OutPitch + q * K);
      }
    }
    __syncthreads();
  };
  // open[j][k]: the window whose first tap column is j columns back. Each
  // column sum completes the oldest window, whose output column t - r is
  // staged, and is added to the others. Zeroed, because the first feeds
  // add into windows that are never stored: left uninitialised, that read
  // is undefined, and at block sizes 1 and 3 it cost the first columns.
  Acc open[BS > 1 ? BS - 1 : 1][K] = {};
  int t = x0 - R;  // tap column (before clamping) of the next column sum
  auto feed = [&]() {
    if (t >= x0 + R) {  // block-uniform
      const int x = t - R, slot = (x - x0) % kK1Slots;
      Acc o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = BS > 1 ? open[BS > 1 ? BS - 2 : 0][k] + cs[k] : cs[k];
      k1_store(obuf + (slot * kK1Rows + lane) * kK1OutPitch + warp * K, o);
      if (slot == kK1Slots - 1 || x == xlast) flush(x, slot + 1);
    }
#pragma unroll
    for (int j = BS - 2; j >= 1; --j) {
#pragma unroll
      for (int k = 0; k < K; ++k) open[j][k] = open[j - 1][k] + cs[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) open[0][k] = cs[k];
    ++t;
  };

  // A column clamped at the image edge stands for every tap beyond it: the
  // first is fed once more per tap left of column 0, the last once more
  // per tap right of column w - 1.
#pragma unroll
  for (int k = 0; k < K; ++k) load_right(k, xs);
  column(xs);
  for (int n = xs - (x0 - R); n >= 0; --n) feed();
  for (int xc = xs + 1; xc <= xe; ++xc) {
    shift_in(xc);
    column(xc);
    feed();
  }
  for (int n = xlast + R - xe; n > 0; --n) feed();
}

// ---------------------------------------------------------------------------
// Shared by K2 and K3: one warp owns one scanline; lane l holds the K
// contiguous disparities [l*K, l*K + K), so a step reads and writes one
// contiguous D-long run per operand. Lanes with l*K >= D are idle and hold
// kBig (D is a multiple of 16 and K divides 16, so no lane straddles D).
//
// Loads go through a ring of kRing stages per warp in shared memory, filled
// by 16-byte cp.async copies that all lanes issue: while the warp scans one
// stage, the next kRing - 1 are in flight. A stage is a fixed number of
// scan steps, 32/K columns for K2 and 16/K pixels for K3, i.e. 2 KB of
// int16 per operand at the largest D of that K (K2: 8 columns at D = 128).
// So a warp keeps ~6 KB of loads per operand in flight; the scan reads each
// step's K values a lane from shared memory. Stores go straight out, one contiguous run of
// D values per warp and step.
// ---------------------------------------------------------------------------

constexpr int kScanWarps = 4;  // scanlines (warps) per block
constexpr int kRing = 4;       // ring stages per warp

// Scan steps per ring stage: K2 32/K columns, K3 16/K pixels.
template <int K>
__host__ __device__ constexpr int hscan_stage() {
  return 32 / K;
}
template <int K>
__host__ __device__ constexpr int rowsweep_stage() {
  return 16 / K;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until the stage committed kRing - 1 groups ago has landed; the
// __syncwarp then makes every lane's copies visible to the whole warp.
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
  __syncwarp();
}

// The warp copies n bytes (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void warp_copy(void* dst, const void* src, int n,
                                          int lane) {
  for (int o = lane * 16; o < n; o += 32 * 16)
    cp_async16(static_cast<char*>(dst) + o, static_cast<const char*>(src) + o);
}

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
// C and L and writes S_we (3 volumes): 10 B a cell at int16, 2.65 GB at
// 1080x1920x128, 0.79 ms at 3.35 TB/s. Only H warps exist (1080 at 1080p,
// ~8 per SM), so a warp that waits a memory latency per step is latency-
// bound. Design: one warp per row, the x loop sequential with the carry in
// registers; a stage of the ring is 32/K contiguous columns of the row, one
// block of 32/K * D int16 per operand, so each warp keeps 3 stages of C (and
// in the backward scan of L) in flight while it scans the fourth.
// ---------------------------------------------------------------------------

template <int K, bool BACKWARD, typename OutT>
__global__ void __launch_bounds__(32 * kScanWarps)
hscan_kernel(const int16_t* __restrict__ cost, const int16_t* __restrict__ lin,
             OutT* __restrict__ out, int h, int w, int D, int p1, int p2) {
  constexpr int G = hscan_stage<K>();     // columns per stage
  constexpr int NOPS = BACKWARD ? 2 : 1;  // operands streamed: C (and L)
  extern __shared__ __align__(16) int16_t scan_ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kScanWarps + warp;
  if (row >= h) return;  // warp-uniform; the kernel has no block barrier
  const int sd = G * D;  // int16 per stage and operand
  int16_t* const cr = scan_ring + (size_t)warp * NOPS * kRing * sd;
  int16_t* const lr = cr + kRing * sd;
  const bool live = lane * K < D;
  const size_t base = (size_t)row * w * D;
  const int nst = (w + G - 1) / G;

  // Stage j holds scan steps j*G .. j*G + G - 1: columns [lo(j), hi(j)).
  auto lo = [&](int j) { return BACKWARD ? max(w - (j + 1) * G, 0) : j * G; };
  auto hi = [&](int j) { return BACKWARD ? w - j * G : min((j + 1) * G, w); };
  auto issue = [&](int j) {
    if (j < nst) {
      const int s = j % kRing, x0 = lo(j), n = (hi(j) - x0) * D * 2;
      warp_copy(cr + s * sd, cost + base + (size_t)x0 * D, n, lane);
      if (BACKWARD) warp_copy(lr + s * sd, lin + base + (size_t)x0 * D, n, lane);
    }
    cp_async_commit();  // empty past the row's end: keeps the group count
  };

  int l[K], c[K] = {}, a[K] = {};
#pragma unroll
  for (int k = 0; k < K; ++k) l[k] = live ? 0 : kBig;
  for (int j = 0; j < kRing - 1; ++j) issue(j);
  for (int j = 0; j < nst; ++j) {
    issue(j + kRing - 1);  // into the stage scanned at j - 1
    ring_wait();
    const int x0 = lo(j), n = hi(j) - x0;
    const int16_t* const cs = cr + (j % kRing) * sd + lane * K;
    const int16_t* const ls = lr + (j % kRing) * sd + lane * K;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (i >= n) break;  // warp-uniform
      const int o = BACKWARD ? n - 1 - i : i;
      if (live) {
        load_vec<K>(cs + o * D, c);
        if (BACKWARD) load_vec<K>(ls + o * D, a);
      }
      sgm_step<K>(l, c, live, lane, p1, p2);
      if (live) {
        OutT* const dst = out + base + (size_t)(x0 + o) * D + lane * K;
        if (BACKWARD) {
          int s[K];
#pragma unroll
          for (int k = 0; k < K; ++k) s[k] = a[k] + l[k];
          store_vec<K>(dst, s);
        } else {
          store_vec<K>(dst, l);
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
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
// TPU kernel sweeps all of a pass's directions (dxs) in one launch, its
// carries for a whole row in VMEM; here the wrapper launches once per
// direction, each launch adding one L to the partial sum, which it stores
// in the pass's out dtype (ops/cuda_sgm.rowsweep says why that is exact):
// 18 B a cell for a three-direction pass at int16, against the TPU's 6.
//
// Every pixel lies on exactly one line x - (dx/dy)*y = const, and the
// lines are independent scans. Design: one warp per line, walking it from
// its first pixel (on the first row in scan order, or on the entry column
// for a diagonal) with the carry in registers. A stage of the ring is 16/K
// consecutive pixels of the line, the D-long runs of C and of the partial
// sum at each (for a diagonal, (w +- 1) * D apart), so each warp keeps 3
// stages (~6 KB at D = 128, int16) in flight while it scans the fourth.
// A vertical pass has W lines, a diagonal one W + H - 1 of 1 to min(H, W)
// pixels.
//
// Bound: bytes -- reads C and the partial sum, writes the new sum (3
// volumes per direction: 6 B a cell at int16, 0.475 ms at 1080x1920x128),
// with 1920 to 2999 lines a launch, so the ring hides each warp's latency.
// ---------------------------------------------------------------------------

template <int K, typename InT, typename OutT>
__global__ void __launch_bounds__(32 * kScanWarps)
rowsweep_kernel(const int16_t* __restrict__ cost, const InT* __restrict__ acc,
                OutT* __restrict__ out, int h, int w, int D, int dy, int dx,
                int p1, int p2) {
  constexpr int G = rowsweep_stage<K>();  // pixels per stage
  extern __shared__ __align__(16) int16_t scan_ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int line = blockIdx.x * kScanWarps + warp;
  if (line >= (dx == 0 ? w : w + h - 1)) return;  // warp-uniform
  const bool live = lane * K < D;

  // First pixel of the line (on the first row in scan order, or for a
  // diagonal's lines past w on the entry column) and its pixel count.
  // Selects, not branches: with branches here nvcc no longer proves the
  // warp converged in the loop.
  const bool from_col = line >= w;
  const int e = line - w + 1;  // entry row, counted in scan order
  const int y = from_col ? (dy > 0 ? e : h - 1 - e) : (dy > 0 ? 0 : h - 1);
  const int x = from_col ? (dx > 0 ? 0 : w - 1) : line;
  const int rows_left = dy > 0 ? h - y : y + 1;
  const int cols_left = dx > 0 ? w - x : (dx < 0 ? x + 1 : rows_left);
  const int n = min(rows_left, cols_left);
  const ptrdiff_t step = ((ptrdiff_t)dy * w + dx) * D;
  const ptrdiff_t p0 = ((ptrdiff_t)y * w + x) * D;

  // A stage: G pixels of C (int16), then G pixels of the partial sum (InT).
  const int cb = D * 2, ab = D * (int)sizeof(InT);  // bytes per pixel
  const int sb = G * (cb + ab);                      // bytes per stage
  unsigned char* const ring =
      reinterpret_cast<unsigned char*>(scan_ring) + (size_t)warp * kRing * sb;
  auto issue = [&](int j) {
    unsigned char* const st = ring + (j % kRing) * sb;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = j * G + g;
      if (s < n) {  // warp-uniform
        const ptrdiff_t p = p0 + (ptrdiff_t)s * step;
        const char* const cp = reinterpret_cast<const char*>(cost + p);
        const char* const ap = reinterpret_cast<const char*>(acc + p);
        for (int o = lane * 16; o < cb + ab; o += 32 * 16) {
          if (o < cb) {
            cp_async16(st + g * cb + o, cp + o);
          } else {
            cp_async16(st + G * cb + g * ab + (o - cb), ap + (o - cb));
          }
        }
      }
    }
    cp_async_commit();  // empty past the line's end: keeps the group count
  };

  int l[K], c[K] = {}, a[K] = {};
#pragma unroll
  for (int k = 0; k < K; ++k) l[k] = live ? 0 : kBig;
  const int nst = (n + G - 1) / G;
  for (int j = 0; j < kRing - 1; ++j) issue(j);
  for (int j = 0; j < nst; ++j) {
    issue(j + kRing - 1);  // into the stage scanned at j - 1
    ring_wait();
    const unsigned char* const st = ring + (j % kRing) * sb;
    const int16_t* const cs = reinterpret_cast<const int16_t*>(st) + lane * K;
    const InT* const as = reinterpret_cast<const InT*>(st + G * cb) + lane * K;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = j * G + g;
      if (s >= n) break;  // warp-uniform
      if (live) {
        load_vec<K>(cs + g * D, c);
        load_vec<K>(as + g * D, a);
      }
      sgm_step<K>(l, c, live, lane, p1, p2);
      if (live) {
        int o[K];
#pragma unroll
        for (int k = 0; k < K; ++k) o[k] = a[k] + l[k];
        store_vec<K>(out + p0 + (ptrdiff_t)s * step + lane * K, o);
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
}

// ---------------------------------------------------------------------------
// K2 and K3 for D above 256 ("wide"; dispatched by ops/cuda_sgm.py through
// sgm_hscan_wide and sgm_rowsweep_wide): the scans, lines and outputs of
// hscan_kernel and rowsweep_kernel, for D a multiple of 16 up to the
// shared-memory ceiling below.
//
// Replaces depthestimation_tpu/ops/pallas_sgm.py::_hscan_kernel and
// ::_rowsweep_kernel where D > 256.
//
// Bound: bytes, as chip_smoke.kernel_work counts them at 3.35 TB/s: a K2
// call reads C and writes the sum, n * (2 + acc) bytes for n cells (2.03 ms
// at 1988x2964x288, int16); a K3 pass n * (2 + acc + out) (3.04 ms). The
// two launches of K2 move 10 B a cell (C twice, L out and back, the sum:
// 5.07 ms at that shape), a three-direction K3 pass 18 (9.12 ms).
//
// Design. The kernels above keep a line's carry in registers, at most 8
// disparities a lane, so one warp holds at most 256. An earlier wide
// version kept L' in a scratch row in device memory and read C and the
// sums straight from the volumes: each step wrote L, synced the warp, read
// L' back through L2 and waited a DRAM latency for its loads, about 1.66 us
// a step at 1988x2964x288. Here the carry never leaves the SM and every
// load comes through the ring, so a step waits on neither:
//  - 256 < D <= kLaneMax (512): K = 16 registers a lane (LaneCarry<16>),
//    the d +- 1 neighbours across lanes by shuffles as above (18 of the 32
//    lanes live at D = 288); a ring stage is 2 columns (K2) or 1 pixel
//    (K3), 1-3 KB an operand.
//  - D > kLaneMax: 8 disparities a lane in chunks of 256, the carry in the
//    warp's shared memory beside its ring (ChunkCarry); a stage is one
//    step. A block takes as many warps (at most kScanWarps) as their rings
//    and carries fit in kMaxBlockSmem; where one warp does not fit (D above
//    11,600 with int16 sums, 8,928 with int32 ones) the launch is refused,
//    and ops/cuda_sgm.wide_fits, which computes the same bytes, keeps such
//    configs off the kernels.
// The ring has kWideRing stages a warp, each filled by one bulk copy (TMA,
// cp.async.bulk) a run, C and L or the partial sum, that lane 0 issues on
// the stage's mbarrier. PERF.md section 6 has the turns that chose this
// design: bulk copies against 16-byte cp.async copies from every lane,
// ring depths of 3, 4, 6 and 8, and the registers against the chunked
// carry up to 512 (scripts/kernel_turns.py --wide --rings / --other).
// ---------------------------------------------------------------------------

constexpr int kWideRing = 3;  // ring stages per warp
// K of the wide kernels above kLaneMax disparities: the carry in shared
// memory, 8 disparities a lane in chunks of 256 (ChunkCarry).
constexpr int kChunked = 0;
constexpr int kLaneMax = 512;  // largest D whose carry stays in registers
// Shared memory a block can take on sm_90 (227 KB).
constexpr size_t kMaxBlockSmem = 232448;

// Scan steps per ring stage: K2 2 columns at K = 16, K3 1 pixel; one step
// for the chunked carry.
template <int K>
__host__ __device__ constexpr int hscan_wide_stage() {
  return K == kChunked ? 1 : hscan_stage<K>();
}
template <int K>
__host__ __device__ constexpr int rowsweep_wide_stage() {
  return K == kChunked ? 1 : rowsweep_stage<K>();
}

// The carry of a line in registers, as in the kernels above: lane l holds
// L' at [l*K, l*K + K), kBig past D.
template <int K>
struct LaneCarry {
  int l[K];
  int lane;
  bool live;

  __device__ __forceinline__ LaneCarry(int lane_, int D, int*)
      : lane(lane_), live(lane_ * K < D) {
#pragma unroll
    for (int k = 0; k < K; ++k) l[k] = live ? 0 : kBig;
  }

  // One scan step: C from the D-long run c (shared memory), the new L, or
  // with ADD the sum a + L, stored to the D-long run out.
  template <bool ADD, typename InT, typename OutT>
  __device__ __forceinline__ void step(const int16_t* c, const InT* a,
                                       OutT* out, int, int p1, int p2) {
    int cv[K], av[K];
    if (live) {
      load_vec<K>(c + lane * K, cv);
      if constexpr (ADD) load_vec<K>(a + lane * K, av);
    }
    sgm_step<K>(l, cv, live, lane, p1, p2);
    if (live) {
      if constexpr (ADD) {
        int s[K];
#pragma unroll
        for (int k = 0; k < K; ++k) s[k] = av[k] + l[k];
        store_vec<K>(out + lane * K, s);
      } else {
        store_vec<K>(out + lane * K, l);
      }
    }
  }
};

// Above kLaneMax: lane l takes [j*256 + 8l, j*256 + 8l + 8) of chunk j,
// and the warp's carry is two buffers of wide_cells(D) int32 in shared
// memory (the previous step's L' and this step's L), each with kWidePad
// kBig cells on both sides, so the d-1 and d+1 neighbours past either end
// read kBig; the neighbours across lanes and chunks are reads of L'. min
// over D of L' is the running min of the previous step's writes, one warp
// reduction a step, and a __syncwarp orders the step's writes and reads
// before the next step's.
constexpr int kWideK = 8;                // disparities of a lane a chunk
constexpr int kWideChunk = 32 * kWideK;  // disparities of a warp a chunk
constexpr int kWidePad = 8;              // kBig cells on each side of L'

// int32 cells of one carry buffer; a warp holds two.
__host__ __device__ constexpr int wide_cells(int D) {
  return D + 2 * kWidePad;
}

// The recurrence of sgm_step on the run [d0, d0 + 8): L' and its two
// outer neighbours from prev (padded), C from c, the new L into l.
__device__ __forceinline__ void wide_run(const int* prev, int d0,
                                         const int (&c)[kWideK], int m,
                                         int p1, int p2, int (&l)[kWideK]) {
  const int* const q = prev + kWidePad + d0;
  int lp[kWideK + 2];  // lp[k + 1] = L'(d0 + k), k = -1 .. 8
  const int4 v0 = *reinterpret_cast<const int4*>(q);
  const int4 v1 = *reinterpret_cast<const int4*>(q + 4);
  lp[0] = q[-1];
  lp[1] = v0.x; lp[2] = v0.y; lp[3] = v0.z; lp[4] = v0.w;
  lp[5] = v1.x; lp[6] = v1.y; lp[7] = v1.z; lp[8] = v1.w;
  lp[9] = q[kWideK];
#pragma unroll
  for (int k = 0; k < kWideK; ++k) {
    const int best = min(min(lp[k + 1], min(lp[k], lp[k + 2]) + p1), m + p2);
    l[k] = c[k] + best - m;
  }
}

// Writes the run's new L into next (padded) and returns its min.
__device__ __forceinline__ int wide_keep(int* next, int d0,
                                         const int (&l)[kWideK]) {
  int* const q = next + kWidePad + d0;
  *reinterpret_cast<int4*>(q) = make_int4(l[0], l[1], l[2], l[3]);
  *reinterpret_cast<int4*>(q + 4) = make_int4(l[4], l[5], l[6], l[7]);
  int m = l[0];
#pragma unroll
  for (int k = 1; k < kWideK; ++k) m = min(m, l[k]);
  return m;
}

struct ChunkCarry {
  int* buf;  // the warp's two carry buffers
  int lane, cells, par, m;

  // A fresh path: L' = 0 (and min L' = 0) between the kBig pads.
  __device__ __forceinline__ ChunkCarry(int lane_, int D, int* smem)
      : buf(smem), lane(lane_), cells(wide_cells(D)), par(0), m(0) {
    for (int i = lane; i < 2 * cells; i += 32) {
      const int j = i % cells;
      buf[i] = (j < kWidePad || j >= kWidePad + D) ? kBig : 0;
    }
    __syncwarp();
  }

  template <bool ADD, typename InT, typename OutT>
  __device__ __forceinline__ void step(const int16_t* c, const InT* a,
                                       OutT* out, int D, int p1, int p2) {
    const int* const prev = buf + par * cells;
    int* const next = buf + (par ^ 1) * cells;
    int mn = kBig;
    for (int d0 = lane * kWideK; d0 < D; d0 += kWideChunk) {
      int cv[kWideK], l[kWideK];
      load_vec<kWideK>(c + d0, cv);
      wide_run(prev, d0, cv, m, p1, p2, l);
      mn = min(mn, wide_keep(next, d0, l));
      if constexpr (ADD) {
        int av[kWideK], s[kWideK];
        load_vec<kWideK>(a + d0, av);
#pragma unroll
        for (int k = 0; k < kWideK; ++k) s[k] = av[k] + l[k];
        store_vec<kWideK>(out + d0, s);
      } else {
        store_vec<kWideK>(out + d0, l);
      }
    }
    m = __reduce_min_sync(kFull, mn);
    __syncwarp();  // this step's L is written before the next step reads it
    par ^= 1;
  }
};

template <int K>
using Carry =
    typename std::conditional<K == kChunked, ChunkCarry, LaneCarry<K>>::type;

// Bytes of shared memory a warp takes besides its ring: the chunked
// carry's two buffers, and an mbarrier a stage.
__host__ __device__ constexpr size_t carry_bytes(int K, int D) {
  return K == kChunked ? 2 * sizeof(int) * (size_t)wide_cells(D) : 0;
}
constexpr size_t kBarBytes = sizeof(uint64_t) * kWideRing;

// The bulk-copy ring: an mbarrier a stage, initialised once for one
// arrival (lane 0's, with the stage's bytes); the copies complete it.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Lane 0 arrives on the stage's barrier, which then waits for `bytes`.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// n bytes (a multiple of 16, both ends 16-byte aligned) in one copy.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(n), "r"(smem_u32(bar))
      : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Before the first stage is issued: the ring's barriers.
__device__ __forceinline__ void wide_ring_start(uint64_t* bars, int lane) {
  if (lane == 0) {
    for (int s = 0; s < kWideRing; ++s) bar_init(bars + s);
    bar_init_fence();
  }
  __syncwarp();
}

// Waits until stage j of the ring has landed and is visible to the warp.
__device__ __forceinline__ void wide_ring_ready(uint64_t* bars, int j) {
  bar_wait(bars + j % kWideRing, (j / kWideRing) & 1);
}

// The warp's shared memory behind the block's rings: a chunked carry's
// buffers first, then the ring's barriers.
struct WideSmem {
  int* carry;
  uint64_t* bars;

  __device__ __forceinline__ WideSmem(unsigned char* rings_end, int K, int D,
                                      int warps, int warp)
      : carry(reinterpret_cast<int*>(rings_end + warp * carry_bytes(K, D))),
        bars(reinterpret_cast<uint64_t*>(rings_end + warps * carry_bytes(K, D)) +
             warp * kWideRing) {}
};

// K2, wide: hscan_kernel's scan with a wide carry (K = 16 or kChunked) and
// kWideRing stages; a block has blockDim.x / 32 warps (scan_launch).
template <int K, bool BACKWARD, typename OutT>
__global__ void __launch_bounds__(32 * kScanWarps)
hscan_wide_kernel(const int16_t* __restrict__ cost,
                  const int16_t* __restrict__ lin, OutT* __restrict__ out,
                  int h, int w, int D, int p1, int p2) {
  constexpr int G = hscan_wide_stage<K>();  // columns per stage
  constexpr int R = kWideRing;
  constexpr int NOPS = BACKWARD ? 2 : 1;    // operands streamed: C (and L)
  extern __shared__ __align__(16) int16_t scan_ring[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + warp;
  if (row >= h) return;  // warp-uniform; the kernel has no block barrier
  const int sd = G * D;  // int16 per stage and operand
  int16_t* const cr = scan_ring + (size_t)warp * NOPS * R * sd;
  int16_t* const lr = cr + R * sd;
  const WideSmem sm(reinterpret_cast<unsigned char*>(scan_ring + (size_t)warps * NOPS * R * sd),
                    K, D, warps, warp);
  const size_t base = (size_t)row * w * D;
  const int nst = (w + G - 1) / G;

  // Stage j holds scan steps j*G .. j*G + G - 1: columns [lo(j), hi(j)).
  auto lo = [&](int j) { return BACKWARD ? max(w - (j + 1) * G, 0) : j * G; };
  auto hi = [&](int j) { return BACKWARD ? w - j * G : min((j + 1) * G, w); };
  auto issue = [&](int j) {
    if (j < nst) {
      const int s = j % R, x0 = lo(j), n = (hi(j) - x0) * D * 2;
      if (lane == 0) {
        bar_expect(sm.bars + s, NOPS * n);
        bulk_copy(cr + s * sd, cost + base + (size_t)x0 * D, n, sm.bars + s);
        if (BACKWARD) bulk_copy(lr + s * sd, lin + base + (size_t)x0 * D, n, sm.bars + s);
      }
    }
  };

  Carry<K> carry(lane, D, sm.carry);
  wide_ring_start(sm.bars, lane);
  for (int j = 0; j < R - 1; ++j) issue(j);
  for (int j = 0; j < nst; ++j) {
    issue(j + R - 1);  // into the stage scanned at j - 1
    wide_ring_ready(sm.bars, j);
    const int x0 = lo(j), n = hi(j) - x0;
    const int16_t* const cs = cr + (j % R) * sd;
    const int16_t* const ls = lr + (j % R) * sd;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (i >= n) break;  // warp-uniform
      const int o = BACKWARD ? n - 1 - i : i;
      carry.template step<BACKWARD>(cs + o * D, ls + o * D,
                                    out + base + (size_t)(x0 + o) * D, D, p1, p2);
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
}

// K3, wide: rowsweep_kernel's lines with a wide carry and kWideRing stages
// of one pixel each.
template <int K, typename InT, typename OutT>
__global__ void __launch_bounds__(32 * kScanWarps)
rowsweep_wide_kernel(const int16_t* __restrict__ cost,
                     const InT* __restrict__ acc, OutT* __restrict__ out,
                     int h, int w, int D, int dy, int dx, int p1, int p2) {
  constexpr int G = rowsweep_wide_stage<K>();  // pixels per stage
  constexpr int R = kWideRing;
  extern __shared__ __align__(16) int16_t scan_ring[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int line = blockIdx.x * warps + warp;
  if (line >= (dx == 0 ? w : w + h - 1)) return;  // warp-uniform
  // The line's first pixel and pixel count, as in rowsweep_kernel.
  const bool from_col = line >= w;
  const int e = line - w + 1;
  const int y = from_col ? (dy > 0 ? e : h - 1 - e) : (dy > 0 ? 0 : h - 1);
  const int x = from_col ? (dx > 0 ? 0 : w - 1) : line;
  const int rows_left = dy > 0 ? h - y : y + 1;
  const int cols_left = dx > 0 ? w - x : (dx < 0 ? x + 1 : rows_left);
  const int n = min(rows_left, cols_left);
  const ptrdiff_t stride = ((ptrdiff_t)dy * w + dx) * D;
  const ptrdiff_t p0 = ((ptrdiff_t)y * w + x) * D;

  // A stage: G pixels of C (int16), then G pixels of the partial sum (InT).
  const int cb = D * 2, ab = D * (int)sizeof(InT);  // bytes per pixel
  const int sb = G * (cb + ab);                      // bytes per stage
  unsigned char* const rings = reinterpret_cast<unsigned char*>(scan_ring);
  unsigned char* const ring = rings + (size_t)warp * R * sb;
  const WideSmem sm(rings + (size_t)warps * R * sb, K, D, warps, warp);
  auto issue = [&](int j) {
    unsigned char* const st = ring + (j % R) * sb;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = j * G + g;
      if (s < n) {  // warp-uniform
        const ptrdiff_t p = p0 + (ptrdiff_t)s * stride;
        if (lane == 0) {
          uint64_t* const bar = sm.bars + j % R;
          if (g == 0) bar_expect(bar, min(G, n - j * G) * (cb + ab));
          bulk_copy(st + g * cb, cost + p, cb, bar);
          bulk_copy(st + G * cb + g * ab, acc + p, ab, bar);
        }
      }
    }
  };

  Carry<K> carry(lane, D, sm.carry);
  const int nst = (n + G - 1) / G;
  wide_ring_start(sm.bars, lane);
  for (int j = 0; j < R - 1; ++j) issue(j);
  for (int j = 0; j < nst; ++j) {
    issue(j + R - 1);  // into the stage scanned at j - 1
    wide_ring_ready(sm.bars, j);
    const unsigned char* const st = ring + (j % R) * sb;
    const int16_t* const cs = reinterpret_cast<const int16_t*>(st);
    const InT* const as = reinterpret_cast<const InT*>(st + G * cb);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int s = j * G + g;
      if (s >= n) break;  // warp-uniform
      carry.template step<true>(cs + g * D, as + g * D,
                                out + p0 + (ptrdiff_t)s * stride, D, p1, p2);
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
}

// Per-lane disparity count K for D (a multiple of 16, at most 256).
int lanes_k(int D) {
  if (D % 16 != 0) return 0;
  if (D <= 32) return 1;
  if (D <= 64) return 2;
  if (D <= 128) return 4;
  if (D <= 256) return 8;
  return 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches a scan kernel with one warp per line and `warps` warps a block,
// each taking per_warp bytes of shared memory (above 48 KB a block only
// after raising the kernel's limit).
template <typename... Params, typename... Args>
int scan_launch(void (*kernel)(Params...), int lines, int warps,
                size_t per_warp, cudaStream_t stream, Args... args) {
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (lines + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int K>
int hscan_launch(const int16_t* cost, const int16_t* lin, void* out,
                 int out_int32, int backward, int h, int w, int D, int p1,
                 int p2, cudaStream_t stream) {
  const size_t stage = (size_t)hscan_stage<K>() * D * sizeof(int16_t);
  const size_t fwd = kRing * stage, bwd = 2 * fwd;
  if (!backward)
    return scan_launch(&hscan_kernel<K, false, int16_t>, h, kScanWarps, fwd,
                       stream, cost, lin, static_cast<int16_t*>(out), h, w, D,
                       p1, p2);
  if (out_int32)
    return scan_launch(&hscan_kernel<K, true, int32_t>, h, kScanWarps, bwd,
                       stream, cost, lin, static_cast<int32_t*>(out), h, w, D,
                       p1, p2);
  return scan_launch(&hscan_kernel<K, true, int16_t>, h, kScanWarps, bwd,
                     stream, cost, lin, static_cast<int16_t*>(out), h, w, D,
                     p1, p2);
}

template <int K, typename InT>
int rowsweep_launch_in(const int16_t* cost, const void* acc, void* out,
                       int out_int32, int h, int w, int D, int dy, int dx,
                       int p1, int p2, cudaStream_t stream) {
  const int lines = dx == 0 ? w : w + h - 1;
  const size_t per_warp =
      (size_t)kRing * rowsweep_stage<K>() * D * (2 + sizeof(InT));
  const InT* a = static_cast<const InT*>(acc);
  if (out_int32)
    return scan_launch(&rowsweep_kernel<K, InT, int32_t>, lines, kScanWarps,
                       per_warp, stream, cost, a, static_cast<int32_t*>(out),
                       h, w, D, dy, dx, p1, p2);
  return scan_launch(&rowsweep_kernel<K, InT, int16_t>, lines, kScanWarps,
                     per_warp, stream, cost, a, static_cast<int16_t*>(out), h,
                     w, D, dy, dx, p1, p2);
}

template <int K>
int rowsweep_launch(const int16_t* cost, const void* acc, int acc_int32,
                    void* out, int out_int32, int h, int w, int D, int dy,
                    int dx, int p1, int p2, cudaStream_t stream) {
  if (acc_int32)
    return rowsweep_launch_in<K, int32_t>(cost, acc, out, out_int32, h, w, D,
                                          dy, dx, p1, p2, stream);
  return rowsweep_launch_in<K, int16_t>(cost, acc, out, out_int32, h, w, D,
                                        dy, dx, p1, p2, stream);
}

// Warps a block of a wide kernel whose warps take per_warp bytes each:
// kScanWarps, or for the chunked carry as many as fit in a block (0: the
// launch is refused). ops/cuda_sgm.wide_fits computes the same per_warp.
int wide_warps(int K, size_t per_warp) {
  if (K != kChunked) return kScanWarps;
  const size_t fit = kMaxBlockSmem / per_warp;
  return fit < (size_t)kScanWarps ? (int)fit : kScanWarps;
}

template <int K>
int hscan_wide_launch(const int16_t* cost, const int16_t* lin, void* out,
                      int out_int32, int backward, int h, int w, int D,
                      int p1, int p2, cudaStream_t stream) {
  const size_t ring =
      (size_t)kWideRing * hscan_wide_stage<K>() * D * sizeof(int16_t);
  const size_t per_warp = (backward ? 2 : 1) * ring + carry_bytes(K, D) + kBarBytes;
  const int warps = wide_warps(K, per_warp);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  if (!backward)
    return scan_launch(&hscan_wide_kernel<K, false, int16_t>, h, warps,
                       per_warp, stream, cost, lin, static_cast<int16_t*>(out),
                       h, w, D, p1, p2);
  if (out_int32)
    return scan_launch(&hscan_wide_kernel<K, true, int32_t>, h, warps,
                       per_warp, stream, cost, lin, static_cast<int32_t*>(out),
                       h, w, D, p1, p2);
  return scan_launch(&hscan_wide_kernel<K, true, int16_t>, h, warps, per_warp,
                     stream, cost, lin, static_cast<int16_t*>(out), h, w, D,
                     p1, p2);
}

template <int K, typename InT>
int rowsweep_wide_launch_in(const int16_t* cost, const void* acc, void* out,
                            int out_int32, int h, int w, int D, int dy,
                            int dx, int p1, int p2, cudaStream_t stream) {
  const int lines = dx == 0 ? w : w + h - 1;
  const size_t per_warp = (size_t)kWideRing * rowsweep_wide_stage<K>() * D *
                              (2 + sizeof(InT)) +
                          carry_bytes(K, D) + kBarBytes;
  const int warps = wide_warps(K, per_warp);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  const InT* a = static_cast<const InT*>(acc);
  if (out_int32)
    return scan_launch(&rowsweep_wide_kernel<K, InT, int32_t>, lines, warps,
                       per_warp, stream, cost, a, static_cast<int32_t*>(out),
                       h, w, D, dy, dx, p1, p2);
  return scan_launch(&rowsweep_wide_kernel<K, InT, int16_t>, lines, warps,
                     per_warp, stream, cost, a, static_cast<int16_t*>(out), h,
                     w, D, dy, dx, p1, p2);
}

template <int K>
int rowsweep_wide_launch(const int16_t* cost, const void* acc, int acc_int32,
                         void* out, int out_int32, int h, int w, int D,
                         int dy, int dx, int p1, int p2, cudaStream_t stream) {
  if (acc_int32)
    return rowsweep_wide_launch_in<K, int32_t>(cost, acc, out, out_int32, h,
                                               w, D, dy, dx, p1, p2, stream);
  return rowsweep_wide_launch_in<K, int16_t>(cost, acc, out, out_int32, h, w,
                                             D, dy, dx, p1, p2, stream);
}

template <int BS, bool CENSUS>
int cost_volume_launch(const float* left, const float* right, int16_t* out,
                       int h, int w, int D, int min_disp, int cap,
                       cudaStream_t stream) {
  constexpr int rows_out = kK1Rows - 2 * (BS / 2);
  const size_t smem = sizeof(float) * (CENSUS ? 1 : 3) * kK1Rows *
                         (k1_pitch_l<BS>() + k1_pitch_r<BS>()) +
                     kK1OutBytes;
  const dim3 grid((w + kK1TileX - 1) / kK1TileX,
                  (h + rows_out - 1) / rows_out,
                  (D + kK1DispBlock - 1) / kK1DispBlock);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&cost_volume_kernel<BS, CENSUS>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cost_volume_kernel<BS, CENSUS><<<grid, kK1Warps * 32, smem, stream>>>(
      left, right, out, h, w, D, min_disp, (float)cap);
  return (int)cudaGetLastError();
}

// Takes D a multiple of 16 (64 a block on grid.z, so up to 65535 * 64),
// min_disp >= 0, an odd block_size up to 17 (the largest kernels_supported
// admits) and a 16-byte aligned out.
template <bool CENSUS>
int cost_volume_dispatch(const float* left, const float* right, int16_t* out,
                         int h, int w, int D, int min_disp, int bs, int cap,
                         cudaStream_t stream) {
  if (h < 1 || w < 1 || D < 16 || D % 16 != 0 || min_disp < 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (bs) {
#define K1_CASE(B) \
  case B:          \
    return cost_volume_launch<B, CENSUS>(left, right, out, h, w, D, min_disp, cap, stream);
    K1_CASE(1) K1_CASE(3) K1_CASE(5) K1_CASE(7) K1_CASE(9)
    K1_CASE(11) K1_CASE(13) K1_CASE(15) K1_CASE(17)
#undef K1_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K1 from the (h, w) float32 pair: BT with the x-Sobel prefilter clipped
// to +-cap, or census; out is (h, w, D) int16.
int sgm_cost_volume(const float* left, const float* right, int16_t* out,
                    int h, int w, int D, int min_disp, int bs, int cap,
                    cudaStream_t stream) {
  return cost_volume_dispatch<false>(left, right, out, h, w, D, min_disp, bs,
                                     cap, stream);
}

int sgm_census_cost_volume(const float* left, const float* right,
                           int16_t* out, int h, int w, int D, int min_disp,
                           int bs, cudaStream_t stream) {
  return cost_volume_dispatch<true>(left, right, out, h, w, D, min_disp, bs,
                                    0, stream);
}

int sgm_hscan(const int16_t* cost, const int16_t* lin, void* out,
              int out_int32, int backward, int h, int w, int D, int p1, int p2,
              cudaStream_t stream) {
  if (!aligned16(cost) || !aligned16(out) || (backward && !aligned16(lin)))
    return (int)cudaErrorInvalidValue;
  switch (lanes_k(D)) {
    case 1: return hscan_launch<1>(cost, lin, out, out_int32, backward, h, w, D, p1, p2, stream);
    case 2: return hscan_launch<2>(cost, lin, out, out_int32, backward, h, w, D, p1, p2, stream);
    case 4: return hscan_launch<4>(cost, lin, out, out_int32, backward, h, w, D, p1, p2, stream);
    case 8: return hscan_launch<8>(cost, lin, out, out_int32, backward, h, w, D, p1, p2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int sgm_rowsweep(const int16_t* cost, const void* acc, int acc_int32,
                 void* out, int out_int32, int h, int w, int D, int dy, int dx,
                 int p1, int p2, cudaStream_t stream) {
  if ((dy != 1 && dy != -1) || dx < -1 || dx > 1 || !aligned16(cost) ||
      !aligned16(acc) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  switch (lanes_k(D)) {
    case 1: return rowsweep_launch<1>(cost, acc, acc_int32, out, out_int32, h, w, D, dy, dx, p1, p2, stream);
    case 2: return rowsweep_launch<2>(cost, acc, acc_int32, out, out_int32, h, w, D, dy, dx, p1, p2, stream);
    case 4: return rowsweep_launch<4>(cost, acc, acc_int32, out, out_int32, h, w, D, dy, dx, p1, p2, stream);
    case 8: return rowsweep_launch<8>(cost, acc, acc_int32, out, out_int32, h, w, D, dy, dx, p1, p2, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The wide scans take D a multiple of 16 (refused past the shared-memory
// ceiling, wide_warps): K = 16 registers a lane up to kLaneMax, the chunked
// carry above.
int sgm_hscan_wide(const int16_t* cost, const int16_t* lin, void* out,
                   int out_int32, int backward, int h, int w, int D, int p1,
                   int p2, cudaStream_t stream) {
  if (D < 16 || D % 16 != 0 || !aligned16(cost) || !aligned16(out) ||
      (backward && !aligned16(lin)))
    return (int)cudaErrorInvalidValue;
  if (D <= kLaneMax)
    return hscan_wide_launch<16>(cost, lin, out, out_int32, backward, h, w, D,
                                 p1, p2, stream);
  return hscan_wide_launch<kChunked>(cost, lin, out, out_int32, backward, h,
                                     w, D, p1, p2, stream);
}

int sgm_rowsweep_wide(const int16_t* cost, const void* acc, int acc_int32,
                      void* out, int out_int32, int h, int w, int D, int dy,
                      int dx, int p1, int p2, cudaStream_t stream) {
  if ((dy != 1 && dy != -1) || dx < -1 || dx > 1 || D < 16 || D % 16 != 0 ||
      !aligned16(cost) || !aligned16(acc) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (D <= kLaneMax)
    return rowsweep_wide_launch<16>(cost, acc, acc_int32, out, out_int32, h,
                                    w, D, dy, dx, p1, p2, stream);
  return rowsweep_wide_launch<kChunked>(cost, acc, acc_int32, out, out_int32,
                                        h, w, D, dy, dx, p1, p2, stream);
}

}  // extern "C"
