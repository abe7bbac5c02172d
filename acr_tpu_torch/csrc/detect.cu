// The detector's two data-dependent kernels (ops/detect.py): greedy NMS and
// ROIAlignV2. Neither replaces a Pallas kernel: the JAX package has no
// detector. They exist so that ViTDet's proposals and cascade run on the
// card at fixed shapes with no host wait, inside the detect stage's CUDA
// graph; the same arithmetic in plain PyTorch is ops/detect.py's
// nms_plain and roi_align_plain.
//
// acr_nms: one block per segment (a level of the RPN, a class of the box
// head) over its n boxes, given in the order of decreasing score. The boxes
// and a "gone" flag per box sit in shared memory; the block walks the boxes
// in order, and a box still standing when its turn comes is kept and its
// threads strike every later box whose IoU with it exceeds the threshold
// (torchvision's nms: IoU = inter / (area_i + area_j - inter), areas
// (x2 - x1)(y2 - y1), "> threshold" suppresses). Invalid boxes start gone
// and suppress nothing. Bound: the walk is sequential, one barrier per kept
// box, so the kernel is bound by latency, not by its few bytes or its
// n(n-1)/2 IoUs at most.
//
// acr_roi_align: one thread per output (roi, channel, bin y, bin x), as
// torchvision's roi_align (aligned=True, sampling_ratio 0: an adaptive
// ceil(roi size / pooled) grid of samples per bin, averaged), each RoI
// reading the pyramid level the caller assigned to it. Bound: the output
// written once (R x C x P x P floats); the samples' reads mostly hit L2.
//
// Built with --fmad=false (ops/cuda_lib.py), so every product and sum is
// rounded on its own, in the order the plain versions write them.

#include <cuda_runtime.h>
#include <math.h>

extern "C" __global__ void acr_nms_kernel(const float* __restrict__ boxes,
                                          const unsigned char* __restrict__ valid,
                                          float thresh, int n,
                                          unsigned char* __restrict__ keep) {
  extern __shared__ float smem[];
  float* b = smem;                                         // n x 4
  unsigned char* gone = reinterpret_cast<unsigned char*>(smem + 4 * n);
  const size_t seg = blockIdx.x;
  const float* src = boxes + seg * (size_t)n * 4;
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) b[i] = src[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    gone[i] = valid[seg * n + i] ? 0 : 1;
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (gone[i]) continue;           // final since the last barrier: uniform
    const float ix1 = b[4 * i], iy1 = b[4 * i + 1];
    const float ix2 = b[4 * i + 2], iy2 = b[4 * i + 3];
    const float iarea = (ix2 - ix1) * (iy2 - iy1);
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
      if (gone[j]) continue;
      const float xx1 = fmaxf(ix1, b[4 * j]);
      const float yy1 = fmaxf(iy1, b[4 * j + 1]);
      const float xx2 = fminf(ix2, b[4 * j + 2]);
      const float yy2 = fminf(iy2, b[4 * j + 3]);
      const float w = fmaxf(0.f, xx2 - xx1);
      const float h = fmaxf(0.f, yy2 - yy1);
      const float inter = w * h;
      const float area = (b[4 * j + 2] - b[4 * j]) * (b[4 * j + 3] - b[4 * j + 1]);
      const float ovr = inter / (iarea + area - inter);
      if (ovr > thresh) gone[j] = 1;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    keep[seg * n + i] = gone[i] ? 0 : 1;
}

__device__ __forceinline__ float bilinear(const float* __restrict__ f, int height,
                                          int width, float y, float x) {
  if (y < -1.f || y > (float)height || x < -1.f || x > (float)width) return 0.f;
  if (y <= 0.f) y = 0.f;
  if (x <= 0.f) x = 0.f;
  int y_low = (int)y, x_low = (int)x, y_high, x_high;
  if (y_low >= height - 1) {
    y_high = y_low = height - 1;
    y = (float)y_low;
  } else {
    y_high = y_low + 1;
  }
  if (x_low >= width - 1) {
    x_high = x_low = width - 1;
    x = (float)x_low;
  } else {
    x_high = x_low + 1;
  }
  const float ly = y - (float)y_low, lx = x - (float)x_low;
  const float hy = 1.f - ly, hx = 1.f - lx;
  const float v1 = f[y_low * width + x_low], v2 = f[y_low * width + x_high];
  const float v3 = f[y_high * width + x_low], v4 = f[y_high * width + x_high];
  const float w1 = hy * hx, w2 = hy * lx, w3 = ly * hx, w4 = ly * lx;
  return w1 * v1 + w2 * v2 + w3 * v3 + w4 * v4;
}

// f0..f3: the levels (C, H >> l, W >> l) at strides base << l; rois (R, 4)
// x1 y1 x2 y2 in input pixels; level (R,) in 0..3; out (R, C, P, P).
extern "C" __global__ void acr_roi_align_kernel(
    const float* __restrict__ f0, const float* __restrict__ f1,
    const float* __restrict__ f2, const float* __restrict__ f3, int channels,
    int height, int width, float scale0, const float* __restrict__ rois,
    const int* __restrict__ level, int n_rois, int pooled,
    float* __restrict__ out) {
  const long long total = (long long)n_rois * channels * pooled * pooled;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int pw = idx % pooled;
    const int ph = (idx / pooled) % pooled;
    const int c = (idx / pooled / pooled) % channels;
    const int r = idx / pooled / pooled / channels;
    const int l = level[r];
    const float* f = l == 0 ? f0 : l == 1 ? f1 : l == 2 ? f2 : f3;
    const int h = height >> l, w = width >> l;
    const float scale = scale0 / (float)(1 << l);
    const float x1 = rois[4 * r] * scale - 0.5f;
    const float y1 = rois[4 * r + 1] * scale - 0.5f;
    const float x2 = rois[4 * r + 2] * scale - 0.5f;
    const float y2 = rois[4 * r + 3] * scale - 0.5f;
    const float roi_w = x2 - x1, roi_h = y2 - y1;
    const float bin_h = roi_h / (float)pooled, bin_w = roi_w / (float)pooled;
    const int grid_h = (int)ceilf(roi_h / (float)pooled);
    const int grid_w = (int)ceilf(roi_w / (float)pooled);
    const float count = (float)max(grid_h * grid_w, 1);
    const float* fc = f + (size_t)c * h * w;
    float acc = 0.f;
    for (int iy = 0; iy < grid_h; ++iy) {
      const float y = y1 + (float)ph * bin_h + ((float)iy + 0.5f) * bin_h / (float)grid_h;
      for (int ix = 0; ix < grid_w; ++ix) {
        const float x = x1 + (float)pw * bin_w + ((float)ix + 0.5f) * bin_w / (float)grid_w;
        acc += bilinear(fc, h, w, y, x);
      }
    }
    out[idx] = acc / count;
  }
}

extern "C" int acr_nms(const void* boxes, const void* valid, float thresh,
                       int segments, int n, void* keep, void* stream) {
  if (segments == 0 || n == 0) return 0;
  const size_t shared = (size_t)n * (4 * sizeof(float) + 1);
  if (shared > 48 * 1024) return (int)cudaErrorInvalidValue;
  acr_nms_kernel<<<segments, 256, shared, (cudaStream_t)stream>>>(
      (const float*)boxes, (const unsigned char*)valid, thresh, n,
      (unsigned char*)keep);
  return (int)cudaGetLastError();
}

extern "C" int acr_roi_align(const void* f0, const void* f1, const void* f2,
                             const void* f3, int channels, int height, int width,
                             float scale0, const void* rois, const void* level,
                             int n_rois, int pooled, void* out, void* stream) {
  const long long total = (long long)n_rois * channels * pooled * pooled;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  acr_roi_align_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)f0, (const float*)f1, (const float*)f2, (const float*)f3,
      channels, height, width, scale0, (const float*)rois, (const int*)level,
      n_rois, pooled, (float*)out);
  return (int)cudaGetLastError();
}
