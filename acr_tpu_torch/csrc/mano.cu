// Fused MANO blendshapes + linear blend skinning for Hopper (sm_90a), bound
// with ctypes.
//
// mano_fused_kernel replaces the Pallas kernel `_fused_kernel`
// (acr_tpu/ops/mano_kernel.py:88, launched by fused_blend_skin :117 from
// mano_forward_fused :161). Per hand b and vertex v it computes
//
//   p[c]  = sum_k coef[b, k] * basis[k, c, v]          c = x, y, z; k < 146
//   t[r]  = sum_j g_rows[12 b + r, j] * weights_t[j, v]    r < 12;  j < 16
//   out[b, v, i] = t[4i] p[0] + t[4i+1] p[1] + t[4i+2] p[2] + t[4i+3]
//
// coef is [1 | betas | pose map], basis the [template | shapedirs |
// posedirs] coordinate planes, g_rows the top three rows of the 16
// skinning transforms. The per-joint math (Rodrigues, forward kinematics)
// stays in PyTorch (acr_tpu_torch/ops/mano_kernel.py).
//
// The TPU kernel lays vertices on the 128-lane axis (778 padded to 896),
// pads the batch to the 8-row sublane tile and grids it in VMEM blocks of
// 64 hands, so that both products run on the MXU. None of that is carried
// over. Here one thread owns one vertex of kHands hands: a block of kBlock
// threads covers kBlock consecutive vertices, with the hands' coefficients
// and transform rows staged in shared memory, so each basis and weight
// value a thread loads from device memory (coalesced across the warp)
// serves kHands hands from registers. The sums run in fp32 on the CUDA
// cores in ascending k and j; they differ from a matmul's order by
// rounding only (about 1e-7 on vertex coordinates of 0.1 m). No TF32: its
// 10-bit mantissa would put errors of about 5e-5 on the vertices.
//
// What bounds it on this card: 2 B 778 (146 x 3 + 12 x 16) + 18 B 778
// operations, about 1.0 GFLOP at B = 1024 hands, or 15 us at 67 TFLOP/s,
// against 12.4 MB read and written once (basis 1.36 MB, output 9.6 MB),
// 3.7 us at 3.35 TB/s: compute-bound at scale. The library is built with
// --fmad=false for the rasterizer's exactness, so each term is a multiply
// and an add, which halves the usable fp32 rate. At the throughput path's
// 8 hands per call it is bound by the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kVerts = 778;
constexpr int kCoef = 146;      // 1 + 10 betas + 135 pose-map entries
constexpr int kJoints = 16;
constexpr int kRows = 12;       // rows of the 3x4 skinning transforms
constexpr int kHands = 4;       // hands per block
constexpr int kBlock = 128;     // vertices per block

__global__ void mano_fused_kernel(const float* __restrict__ coef,
                                  const float* __restrict__ g_rows,
                                  const float* __restrict__ basis,
                                  const float* __restrict__ weights_t,
                                  int batch, float* __restrict__ out) {
  __shared__ float s_coef[kHands][kCoef];
  __shared__ float s_g[kHands][kRows * kJoints];
  const int b0 = blockIdx.y * kHands;
  const int n_hands = min(kHands, batch - b0);
  for (int i = threadIdx.x; i < kHands * kCoef; i += blockDim.x) {
    const int h = i / kCoef;
    s_coef[h][i % kCoef] =
        h < n_hands ? coef[(long long)(b0 + h) * kCoef + i % kCoef] : 0.0f;
  }
  for (int i = threadIdx.x; i < kHands * kRows * kJoints; i += blockDim.x) {
    const int h = i / (kRows * kJoints);
    const int r = i % (kRows * kJoints);
    s_g[h][r] = h < n_hands
                    ? g_rows[(long long)(b0 + h) * kRows * kJoints + r]
                    : 0.0f;
  }
  __syncthreads();
  const int v = blockIdx.x * kBlock + threadIdx.x;
  if (v >= kVerts) return;

  float p[kHands][3];
#pragma unroll
  for (int h = 0; h < kHands; ++h) p[h][0] = p[h][1] = p[h][2] = 0.0f;
  for (int k = 0; k < kCoef; ++k) {
    const float bx = basis[(k * 3 + 0) * kVerts + v];
    const float by = basis[(k * 3 + 1) * kVerts + v];
    const float bz = basis[(k * 3 + 2) * kVerts + v];
#pragma unroll
    for (int h = 0; h < kHands; ++h) {
      const float c = s_coef[h][k];
      p[h][0] += c * bx;
      p[h][1] += c * by;
      p[h][2] += c * bz;
    }
  }
  float w[kJoints];
#pragma unroll
  for (int j = 0; j < kJoints; ++j) w[j] = weights_t[j * kVerts + v];

#pragma unroll
  for (int h = 0; h < kHands; ++h) {
    if (h < n_hands) {
      float t[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < kJoints; ++j)
          acc += s_g[h][r * kJoints + j] * w[j];
        t[r] = acc;
      }
      float* o = out + ((long long)(b0 + h) * kVerts + v) * 3;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        o[i] = t[4 * i] * p[h][0] + t[4 * i + 1] * p[h][1] +
               t[4 * i + 2] * p[h][2] + t[4 * i + 3];
    }
  }
}

}  // namespace

extern "C" {

// coef (B, 146), g_rows (B*12, 16), basis (146, 3, 778), weights_t
// (16, 778) -> out (B, 778, 3); all fp32, contiguous, on one device.
int acr_mano_fused(const float* coef, const float* g_rows, const float* basis,
                   const float* weights_t, int batch, float* out,
                   void* stream) {
  if (batch <= 0) return 0;
  const dim3 grid((kVerts + kBlock - 1) / kBlock,
                  (batch + kHands - 1) / kHands);
  mano_fused_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      coef, g_rows, basis, weights_t, batch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
