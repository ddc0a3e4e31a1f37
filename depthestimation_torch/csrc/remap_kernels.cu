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
// read: 16 bytes, ~66 MB for a 1080p pair, ~0.02 ms at 3.35 TB/s. Design:
// one thread per output pixel, a block of 256 along a row, blockIdx.z the
// image of the batch, so one launch rectifies both images of a pair.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ img, float yf,
                                     float xf, int h, int w) {
  if (!(yf >= 0.f && yf <= (float)(h - 1) && xf >= 0.f && xf <= (float)(w - 1)))
    return 0.f;
  return __ldg(img + (size_t)(int)yf * w + (int)xf);
}

__global__ void remap_kernel(const float* __restrict__ img,
                             const float* __restrict__ map_x,
                             const float* __restrict__ map_y,
                             float* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const size_t plane = (size_t)h * w;
  const float* src = img + blockIdx.z * plane;
  const size_t i = blockIdx.z * plane + (size_t)blockIdx.y * w + x;

  const float mx = map_x[i], my = map_y[i];
  const float x0 = floorf(mx), y0 = floorf(my);
  const float fx = __fsub_rn(mx, x0), fy = __fsub_rn(my, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);

  const float v00 = tap(src, y0, x0, h, w);
  const float v01 = tap(src, y0, x1, h, w);
  const float v10 = tap(src, y1, x0, h, w);
  const float v11 = tap(src, y1, x1, h, w);

  float o = __fadd_rn(__fmul_rn(__fmul_rn(gy, gx), v00),
                      __fmul_rn(__fmul_rn(gy, fx), v01));
  o = __fadd_rn(o, __fmul_rn(__fmul_rn(fy, gx), v10));
  o = __fadd_rn(o, __fmul_rn(__fmul_rn(fy, fx), v11));
  out[i] = o;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// n images of (h, w) float32, maps and output of the same shape, all
// contiguous. Returns cudaGetLastError().
int remap_bilinear(const float* img, const float* map_x, const float* map_y,
                   float* out, int n, int h, int w, cudaStream_t stream) {
  if (n < 1 || n > 65535 || h < 1 || h > 65535 || w < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kThreads - 1) / kThreads, h, n);
  remap_kernel<<<grid, kThreads, 0, stream>>>(img, map_x, map_y, out, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
