// Hand-written Hopper (sm_90a) kernel for the WTA stage of the matcher, with
// a plain C interface loaded through ctypes
// (depthestimation_torch/ops/cuda_build.py). The wrapper, its plain version
// (wta_disparity_plain) and its launch count live in
// depthestimation_torch/ops/wta.py.
//
// Replaces no TPU kernel: the JAX package leaves the stage to XLA
// (depthestimation_tpu/ops/wta.py::wta_disparity, a packed-key argmin, masked
// minima over D, and the LR check as two shift loops of D steps over whole
// maps). Run as plain torch on the card that is some 1,480 launches a call at
// D = 128 and int32 copies of the whole volume. Here one launch selects,
// claims and checks.
//
// Semantics, equal to wta_disparity_plain bit for bit, all in int32 with
// wrap-around, as torch computes it:
// - key = S[d] << shift | d, shift = max(8, bits of D - 1); min_s = key >> shift
//   and d0 = key & (2^shift - 1) of the smallest key (ties to the smallest d);
// - cm, cp = S[d0 - 1], S[d0 + 1], the dtype's sentinel (int16 max, or 2^20
//   for int32) outside [0, D);
// - uniqueness (ratio > 0): invalid when min(sentinel, S[d] at |d - d0| > 1)
//   * (100 - ratio) < min_s * 100;
// - subpixel: d0 * 16 + ((cm - cp) * 16 + denom) / (2 * denom), C's
//   truncating division, denom = max(cm + cp - 2 min_s, 1), no correction at
//   d0 = 0 or D - 1; the map holds (min_disp * 16 + that) / 16 as float32;
// - LR check (max_diff >= 0): each uniqueness survivor x claims right pixel
//   xr = x - d0 - min_disp with its key; the smallest key wins (the plain
//   version's min over cost << shift | d0, which is the same key widened to
//   int64 above 256 disparities, so int32 keys compare alike; at shift 8 a
//   key at or above 2^29, the plain version's noclaim, claims nothing). A
//   survivor fails when |disp2(xr) - d0| > max_diff, disp2 = the winner's d0,
//   2^20 where nobody claimed, -2^20 where xr is outside the row;
// - invalid pixels hold min_disp - 1.
//
// Bound: bytes. S is read once (2 or 4 bytes a value) and the float32 map
// written once: 539 MB at 1080x1920x128 int16, 0.161 ms at 3.35 TB/s. Every
// step is row-local, so one block takes one row and keeps it in shared
// memory: the claims (W keys, int32 up to 256 disparities, int64 above) and
// the survivors' d0 (W int16), 11.5 KB at W = 1920.
// 1. Select: a warp takes 32 pixels at a time, one after another. Up to
//    384 disparities (d a multiple of 4, s aligned) a pixel's values are
//    one to three coalesced vector loads a lane (8 or 16 bytes each), held
//    in registers and issued ahead into a ring (three pixels ahead with one
//    vector a lane, one with more), with no test a value: a lane past d
//    takes no part as a whole, and the values next to d0 are a 4-bit mask.
//    Above that, or unaligned, the lanes loop over the values and the
//    uniqueness pass reads them again (from L1). The key minimum and the
//    masked competitor minimum are one warp-wide reduction each (redux);
//    lane p keeps pixel p's two minima. Then every lane finishes its own
//    pixel: cm and cp (two loads that hit L1), the uniqueness test and the
//    subpixel step; it writes the map (coalesced) and claims its right
//    pixel with a shared-memory atomicMin (claimants of one right pixel
//    have distinct d0, so the minimum is the loop's answer). A block of
//    four warps keeps at most 56 registers a thread, so that nine blocks fit
//    an SM and a 1080-row image runs in one wave.
// 2. Check (after __syncthreads): a survivor that fails is overwritten
//    with min_disp - 1; only those pixels are written twice.
//
// No host sync, no allocation and no grid sync, so a CUDA graph captures and
// replays a call.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // a block: one image row
constexpr int kThreads = 32 * kWarps;
// Blocks an SM holds where a lane holds a pixel's values (at most 56
// registers a thread): 1,188 rows at once on 132 SMs, so a 1080-row image
// runs in one wave.
constexpr int kMinBlocks = 9;
constexpr int kVec = 4;                   // values a lane loads at once
constexpr int kSpan = 32 * kVec;          // values a warp loads at once
constexpr int kBig = 1 << 20;             // ops/wta.py's _BIG
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxBlockSmem = 232448;  // sm_90: 227 KB a block

template <typename T>
struct Vec4;
template <>
struct Vec4<int16_t> {
  using type = short4;
};
template <>
struct Vec4<int32_t> {
  using type = int4;
};

// The claim of a right pixel: int32 keys up to shift 8, where a key at or
// above the plain version's noclaim (2^29) claims nothing; int64 above.
template <typename Key>
struct Claim;
template <>
struct Claim<int> {
  static constexpr int kNone = INT_MAX;
  static __device__ __forceinline__ bool ok(int key) { return key < (1 << 29); }
};
template <>
struct Claim<long long> {
  static constexpr long long kNone = LLONG_MAX;
  static __device__ __forceinline__ bool ok(int) { return true; }
};

// Values e..e+3 of a pixel's D values at p (zeros at and past d); vec: one
// aligned vector load.
template <typename T>
__device__ __forceinline__ typename Vec4<T>::type load4(const T* __restrict__ p,
                                                        int e, int d, bool vec) {
  using V = typename Vec4<T>::type;
  V q = {};
  if (e >= d) return q;
  if (vec) return __ldg(reinterpret_cast<const V*>(p + e));
  q.x = __ldg(p + e);
  if (e + 1 < d) q.y = __ldg(p + e + 1);
  if (e + 2 < d) q.z = __ldg(p + e + 2);
  if (e + 3 < d) q.w = __ldg(p + e + 3);
  return q;
}

template <typename V>
__device__ __forceinline__ void unpack(const V& q, int (&v)[kVec]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The values of a lane's vector (disparities e..e+3) that take no part,
// as a 4-bit mask: those at or past d.
__device__ __forceinline__ unsigned past_d(int e, int d) {
  const int n = d - e;
  return n >= kVec ? 0u : n <= 0 ? 15u : (15u << n) & 15u;
}

// The smallest of key and the keys S[dd] << shift | dd of v outside skip.
__device__ __forceinline__ int key_min4(int key, const int (&v)[kVec], int e, int shift,
                                        unsigned skip) {
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (!(skip & (1u << j)))
      key = min(key, (int)(((unsigned)v[j] << shift) | (unsigned)(e + j)));
  return key;
}

// The smallest of m and the values of v outside skip and not next to d0
// (d0 - 1 .. d0 + 1 are the lane's positions t - 2 .. t).
__device__ __forceinline__ int far_min4(int m, const int (&v)[kVec], int e, int d0,
                                        unsigned skip) {
  const unsigned t = (unsigned)(d0 + 1 - e);
  skip |= t < 6u ? (7u << t) >> 2 : 0u;
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (!(skip & (1u << j))) m = min(m, v[j]);
  return m;
}

__device__ __forceinline__ int warp_min(int v) { return __reduce_min_sync(kFull, v); }

// One block a row of s (h, w, d); out (h, w) float32. kHeld > 0: d at most
// kHeld * kSpan, a multiple of kVec, and s aligned for vector loads; a lane
// holds its kHeld vectors of a pixel. kHeld = 0: any d and alignment.
template <typename T, typename Key, int kHeld>
__global__ void __launch_bounds__(kThreads, kHeld > 0 ? kMinBlocks : 1)
wta_select_kernel(const T* __restrict__ s, float* __restrict__ out, int w, int d,
                  int shift_arg, int min_disp, int uniqueness_ratio, int max_diff,
                  float invalid, bool vec) {
  using V = typename Vec4<T>::type;
  // kHeld > 0: a ring of registers for the loads of the pixel being
  // selected and the next ones (three, or one above one vector a lane);
  // kHeld = 0: pixels a warp selects at once.
  constexpr int kRing = kHeld > 1 ? 2 : 4;
  constexpr int kH = kHeld > 0 ? kHeld : 1;
  constexpr int kPix = sizeof(T) == 2 ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  Key* claim = reinterpret_cast<Key*>(smem);
  int16_t* d0s = reinterpret_cast<int16_t*>(claim + w);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool lr = max_diff >= 0, unique_on = uniqueness_ratio > 0;
  const int shift = kHeld == 1 ? 8 : shift_arg;  // up to 128 disparities: 8
  const int low = (1 << shift) - 1;
  const int sent = sizeof(T) == 2 ? 32767 : kBig;
  const T* row = s + (size_t)blockIdx.x * w * d;
  float* out_row = out + (size_t)blockIdx.x * w;
  if (lr)
    for (int x = threadIdx.x; x < w; x += kThreads) claim[x] = Claim<Key>::kNone;
  __syncthreads();

  // Pixel x's values (x clamped into the row).
  auto pixel = [&](int x) { return row + (size_t)min(x, w - 1) * d; };
  const int e1 = lane * kVec;  // the lane's first value
  // kHeld > 0: the lane's vector c of pixel x, values e1 + c * kSpan on; a
  // lane past d there reads the pixel's first values and takes no part
  // (in_d[c]).
  bool in_d[kH];
  const T* lane_row[kH];
#pragma unroll
  for (int c = 0; c < kH; ++c) {
    in_d[c] = e1 + c * kSpan < d;
    lane_row[c] = row + (in_d[c] ? e1 + c * kSpan : 0);
  }
  auto values = [&](int x, int c) {
    return __ldg(reinterpret_cast<const V*>(lane_row[c] + min(x, w - 1) * d));
  };
  V ring[kRing][kH];
  if constexpr (kHeld > 0) {
#pragma unroll
    for (int j = 0; j + 1 < kRing; ++j) {
#pragma unroll
      for (int c = 0; c < kH; ++c) ring[j][c] = values(warp * 32 + j, c);
    }
  }

  for (int x0 = warp * 32; x0 < w; x0 += kThreads) {
    int my_key = 0, my_far = sent;  // lane p: pixel x0 + p's minima
    if constexpr (kHeld > 0) {
      // Pixel j's values sit in ring[j % kRing]; their loads went out
      // kRing - 1 pixels earlier (from the warp's previous 32 for the first).
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int ahead = j + kRing - 1;
#pragma unroll
        for (int c = 0; c < kH; ++c) {
          ring[ahead % kRing][c] =
              values(ahead < 32 ? x0 + ahead : x0 + kThreads + ahead - 32, c);
        }
        int v[kH][kVec];
        int lane_key = INT_MAX;
#pragma unroll
        for (int c = 0; c < kH; ++c) {
          unpack(ring[j % kRing][c], v[c]);
          if (in_d[c]) lane_key = key_min4(lane_key, v[c], e1 + c * kSpan, shift, 0u);
        }
        const int key = warp_min(lane_key);
        int far = sent;
        if (unique_on) {
#pragma unroll
          for (int c = 0; c < kH; ++c) {
            far = far_min4(far, v[c], e1 + c * kSpan, key & low, in_d[c] ? 0u : 15u);
          }
          far = warp_min(far);
        }
        if (lane == j) {
          my_key = key;
          my_far = far;
        }
      }
    } else {
      const int n = min(32, w - x0);
      for (int p = 0; p < n; p += kPix) {
        int key[kPix], far[kPix];
#pragma unroll
        for (int u = 0; u < kPix; ++u) key[u] = INT_MAX;
        for (int e = e1; e < d; e += kSpan) {
#pragma unroll
          for (int u = 0; u < kPix; ++u) {
            int v[kVec];
            unpack(load4(pixel(x0 + p + u), e, d, vec), v);
            key[u] = key_min4(key[u], v, e, shift, past_d(e, d));
          }
        }
#pragma unroll
        for (int u = 0; u < kPix; ++u) key[u] = warp_min(key[u]);
        if (unique_on) {
#pragma unroll
          for (int u = 0; u < kPix; ++u) far[u] = sent;
          for (int e = e1; e < d; e += kSpan) {
#pragma unroll
            for (int u = 0; u < kPix; ++u) {
              int v[kVec];
              unpack(load4(pixel(x0 + p + u), e, d, vec), v);
              far[u] = far_min4(far[u], v, e, key[u] & low, past_d(e, d));
            }
          }
#pragma unroll
          for (int u = 0; u < kPix; ++u) far[u] = warp_min(far[u]);
        }
#pragma unroll
        for (int u = 0; u < kPix; ++u)
          if (lane == p + u) {
            my_key = key[u];
            if (unique_on) my_far = far[u];
          }
      }
    }

    const int x = x0 + lane;
    if (x >= w) continue;
    const int min_s = my_key >> shift, d0 = my_key & low;
    const T* px = row + (size_t)x * d;
    const int cm = d0 > 0 ? (int)__ldg(px + d0 - 1) : sent;
    const int cp = d0 + 1 < d ? (int)__ldg(px + d0 + 1) : sent;
    const bool unique =
        !unique_on || (int)((unsigned)my_far * (unsigned)(100 - uniqueness_ratio)) >=
                          (int)((unsigned)min_s * 100u);
    int denom = (int)((unsigned)cm + (unsigned)cp - 2u * (unsigned)min_s);
    denom = max(denom, 1);
    int delta = (int)(((unsigned)cm - (unsigned)cp) * 16u + (unsigned)denom) /
                (int)(2u * (unsigned)denom);
    if (d0 == 0 || d0 == d - 1) delta = 0;
    const int fixed = (int)(((unsigned)min_disp + (unsigned)d0) * 16u + (unsigned)delta);
    out_row[x] = unique ? __int2float_rn(fixed) * 0.0625f : invalid;
    if (lr) {
      d0s[x] = unique ? (int16_t)d0 : (int16_t)-1;
      const long long xr = (long long)x - d0 - min_disp;
      if (unique && Claim<Key>::ok(my_key) && xr >= 0 && xr < w)
        atomicMin(claim + xr, (Key)my_key);
    }
  }
  if (!lr) return;
  __syncthreads();

  for (int x = threadIdx.x; x < w; x += kThreads) {
    const int d0 = d0s[x];
    if (d0 < 0) continue;
    const long long xr = (long long)x - d0 - min_disp;
    int dr = -kBig;
    if (xr >= 0 && xr < w) {
      const Key c = claim[xr];
      dr = c == Claim<Key>::kNone ? kBig : (int)(c & low);
    }
    if (abs(dr - d0) > max_diff) out_row[x] = invalid;
  }
}

template <typename T, typename Key, int kHeld>
int wta_launch(const T* s, float* out, int h, int w, int d, int shift, int min_disp,
               int uniqueness_ratio, int max_diff, float invalid, bool vec,
               cudaStream_t stream) {
  const auto kernel = &wta_select_kernel<T, Key, kHeld>;
  const size_t smem = max_diff >= 0 ? (size_t)w * (sizeof(Key) + sizeof(int16_t)) : 0;
  if (smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<h, kThreads, smem, stream>>>(s, out, w, d, shift, min_disp,
                                        uniqueness_ratio, max_diff, invalid, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int wta_dispatch(const T* s, float* out, int h, int w, int d, int min_disp,
                 int uniqueness_ratio, int max_diff, float invalid,
                 cudaStream_t stream) {
  int shift = 8;
  while ((1 << shift) < d) ++shift;
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(s) % (kVec * sizeof(T)) == 0;
  // Up to 256 disparities shift is 8 and the claims int32; above, int64.
  if (vec && d <= kSpan)
    return wta_launch<T, int, 1>(s, out, h, w, d, shift, min_disp, uniqueness_ratio,
                                 max_diff, invalid, vec, stream);
  if (vec && d <= 2 * kSpan)
    return wta_launch<T, int, 2>(s, out, h, w, d, shift, min_disp, uniqueness_ratio,
                                 max_diff, invalid, vec, stream);
  if (vec && d <= 3 * kSpan)
    return wta_launch<T, long long, 3>(s, out, h, w, d, shift, min_disp,
                                       uniqueness_ratio, max_diff, invalid, vec, stream);
  if (shift == 8)
    return wta_launch<T, int, 0>(s, out, h, w, d, shift, min_disp, uniqueness_ratio,
                                 max_diff, invalid, vec, stream);
  return wta_launch<T, long long, 0>(s, out, h, w, d, shift, min_disp, uniqueness_ratio,
                                     max_diff, invalid, vec, stream);
}

}  // namespace

extern "C" {

// The WTA stage of a contiguous (h, w, D) int16 or int32 (s_int32) volume s
// into the (h, w) float32 map out, in one launch on stream; max_diff < 0
// skips the LR check, uniqueness_ratio <= 0 the uniqueness test. Refused
// (cudaErrorInvalidValue) above 32,767 disparities or where the row's
// claims do not fit in a block's shared memory (w above 38,741 up to 256
// disparities, 23,244 above).
int wta_select(const void* s, int s_int32, float* out, int h, int w, int D,
               int min_disp, int uniqueness_ratio, int max_diff, float invalid,
               cudaStream_t stream) {
  if (h < 1 || w < 1 || D < 1 || D > 32767) return (int)cudaErrorInvalidValue;
  if (s_int32)
    return wta_dispatch(static_cast<const int32_t*>(s), out, h, w, D, min_disp,
                        uniqueness_ratio, max_diff, invalid, stream);
  return wta_dispatch(static_cast<const int16_t*>(s), out, h, w, D, min_disp,
                      uniqueness_ratio, max_diff, invalid, stream);
}

}  // extern "C"
