// Hand-written Hopper (sm_90a) kernel for the bilinear remap of
// rectification, with a plain C interface loaded through ctypes
// (depthestimation_torch/ops/cuda_build.py). The wrapper, its plain
// version and its launch count live in depthestimation_torch/ops/remap.py.
//
// Replaces depthestimation_tpu/ops/remap.py::_remap_band_kernel. The TPU
// kernel sums statically shifted planes over the maps' displacement band
// only because gathers are slow on a TPU; on Hopper a direct 4-tap gather
// is the natural form and covers every map, so there is no band and no
// wide-warp fallback.
//
// out[n, y, x] = bilinear sample of img[n] at (map_x, map_y)[n, y, x]; a
// tap outside the image reads 0 (cv2 BORDER_CONSTANT). The arithmetic is
// the banded kernel's association,
//   ((w00*v00 + w01*v01) + w10*v10) + w11*v11,  w00 = (1-fy)*(1-fx), ...
// with every multiply and add rounded on its own (__fmul_rn/__fadd_rn keep
// nvcc from contracting them to FMAs), so the result equals the plain
// PyTorch version bit for bit.
//
// Bound: bytes -- per output pixel two float32 map reads, one write and
// (through L1/L2, since neighbouring pixels share taps) about one image
// read: 16 bytes, ~66 MB for a 1080p pair, ~0.02 ms at 3.35 TB/s.
// Design: each thread does 4 consecutive output pixels of a row, with one
// 16-byte load from each map and one 16-byte store, so a warp moves 512
// contiguous bytes per operand. Blocks are 2-D tiles of 32x8 threads
// (128x8 pixels), so the taps of rows y and y+1 that a tile shares come
// from L1; 1920x1080 is 15x135 whole tiles. blockIdx.z is the image of the
// batch, so one launch rectifies both images of a pair. Where a row is not
// a whole number of 16-byte words (w % 4 != 0) or a map or the output is not
// 16-byte aligned, the same kernel runs its scalar form.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32, kThreadsY = 8, kPix = 4;

// The int of a float that holds a whole number of magnitude below 2^22:
// adding 1.5 * 2^23 leaves it in the low mantissa bits (one add instead of
// a quarter-rate conversion).
__device__ __forceinline__ int whole(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.f)) - 0x4B400000;
}

__device__ __forceinline__ float sample(const float* __restrict__ src,
                                        float mx, float my, int h, int w) {
  const float x0 = floorf(mx), y0 = floorf(my);
  const float fx = __fsub_rn(mx, x0), fy = __fsub_rn(my, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  // A tap reads 0 unless both its coordinates are inside the image.
  const float xl = (float)(w - 1), yl = (float)(h - 1);
  const bool in_x0 = x0 >= 0.f && x0 <= xl, in_x1 = x1 >= 0.f && x1 <= xl;
  const bool in_y0 = y0 >= 0.f && y0 <= yl, in_y1 = y1 >= 0.f && y1 <= yl;
  // Only dereferenced for an inside tap, where both whole() are exact.
  const float* p = src + (ptrdiff_t)whole(y0) * w + whole(x0);

  const float v00 = in_y0 && in_x0 ? __ldg(p) : 0.f;
  const float v01 = in_y0 && in_x1 ? __ldg(p + 1) : 0.f;
  const float v10 = in_y1 && in_x0 ? __ldg(p + w) : 0.f;
  const float v11 = in_y1 && in_x1 ? __ldg(p + w + 1) : 0.f;

  float o = __fadd_rn(__fmul_rn(__fmul_rn(gy, gx), v00),
                      __fmul_rn(__fmul_rn(gy, fx), v01));
  o = __fadd_rn(o, __fmul_rn(__fmul_rn(fy, gx), v10));
  return __fadd_rn(o, __fmul_rn(__fmul_rn(fy, fx), v11));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
remap_kernel(const float* __restrict__ img, const float* __restrict__ map_x,
             const float* __restrict__ map_y, float* __restrict__ out, int h,
             int w) {
  const int y = blockIdx.y * kThreadsY + threadIdx.y;
  const int x = (blockIdx.x * kThreadsX + threadIdx.x) * kPix;
  if (y >= h || x >= w) return;
  const size_t plane = (size_t)h * w;
  const float* src = img + blockIdx.z * plane;
  const size_t i = blockIdx.z * plane + (size_t)y * w + x;
  if (VEC) {
    // w % 4 == 0 and every base 16-byte aligned: all 4 pixels are in the
    // row and i is a multiple of 4.
    const float4 mx = __ldg(reinterpret_cast<const float4*>(map_x + i));
    const float4 my = __ldg(reinterpret_cast<const float4*>(map_y + i));
    float4 o;
    o.x = sample(src, mx.x, my.x, h, w);
    o.y = sample(src, mx.y, my.y, h, w);
    o.z = sample(src, mx.z, my.z, h, w);
    o.w = sample(src, mx.w, my.w, h, w);
    *reinterpret_cast<float4*>(out + i) = o;
  } else {
    const int n = min(kPix, w - x);
    for (int k = 0; k < n; ++k)
      out[i + k] = sample(src, __ldg(map_x + i + k), __ldg(map_y + i + k), h, w);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// n images of (h, w) float32, maps and output of the same shape, all
// contiguous. Returns cudaGetLastError().
int remap_bilinear(const float* img, const float* map_x, const float* map_y,
                   float* out, int n, int h, int w, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kThreadsX * kPix - 1) / (kThreadsX * kPix),
                  (h + kThreadsY - 1) / kThreadsY, n);
  if (n < 1 || n > 65535 || h < 1 || w < 1 || grid.y > 65535)
    return (int)cudaErrorInvalidValue;
  if (w % kPix == 0 && aligned16(map_x) && aligned16(map_y) && aligned16(out)) {
    remap_kernel<true><<<grid, block, 0, stream>>>(img, map_x, map_y, out, h, w);
  } else {
    remap_kernel<false><<<grid, block, 0, stream>>>(img, map_x, map_y, out, h, w);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
