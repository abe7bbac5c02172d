// Fused MANO blendshapes + linear blend skinning for Hopper (sm_90a), bound
// with ctypes.
//
// mano_split_kernel replaces the Pallas kernel `_fused_kernel`
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
// over. What bounds the work on this card: 2 B 778 (146 x 3 + 12 x 16) +
// 18 B 778 fp32 operations, 1.0 GFLOP at B = 1024 hands or 15 us at
// 67 TFLOP/s, against 12.4 MB read and written once (3.7 us at 3.35 TB/s).
// The throughput path sends 8 hands per call, where the bound is the
// latency of the loads, not the arithmetic.
//
// So the kernel fights latency: a block of 8 hands and 32 vertices
// requests its whole basis slab (146 x 3 x 32 floats), coefficients,
// transform rows and weights at once with cp.async, then its 8 warps each
// walk 19 of the 146 coefficients (not 146 in series), keeping 8 hands x 3
// coordinates of accumulators per lane, and the partial sums are added in
// shared memory in ascending warp order, so the result is deterministic.
// The skinning product and the affine run as an epilogue from the
// transform rows in shared memory; the (B, 778, 3) output is written
// directly. The grid is (25, ceil(B / 8)), so it takes any batch, but it
// reads the 1.36 MB basis from L2 once per 8 hands: at hundreds of hands
// per call a tile of more hands per block would read it less often. No
// caller sends that many yet.
//
// Every product is written with __fmaf_rn: the library is compiled with
// --fmad=false for the rasterizer's bit exactness, which leaves explicit
// fused multiply-adds alone. Sums run in fp32 in another order than a
// matmul's; they differ by rounding only (about 1e-7 on vertex
// coordinates of 0.1 m). No tensor cores: TF32's 10-bit mantissa would
// put about 5e-5 on the vertices, and a 3xTF32 split (three mma products
// per term to recover fp32) does not pay at 1 GFLOP.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kVerts = 778;
constexpr int kCoef = 146;       // 1 + 10 betas + 135 pose-map entries
constexpr int kJoints = 16;
constexpr int kRows = 12;        // rows of the 3x4 skinning transforms
constexpr int kG = kRows * kJoints;  // transform floats per hand
constexpr int kHT = 8;           // hands per block (and per thread)
constexpr int kSplitVerts = 32;  // vertices per block, one per lane
constexpr int kSplitWarps = 8;   // the coefficient splits
constexpr int kSplitK = (kCoef + kSplitWarps - 1) / kSplitWarps;  // 19

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  // copies N bytes, or writes N zero bytes when !valid
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}

// Grid (ceil(778 / 32), ceil(B / 8)), 256 threads, dynamic shared memory
// kSplitFloats floats.
constexpr int kSplitBasis = kCoef * 3 * kSplitVerts;
constexpr int kSplitPitch = kHT + 4;  // coefficient rows, bank-spread
constexpr int kSplitFloats = kSplitBasis + kCoef * kSplitPitch + kHT * kG +
                             kJoints * kSplitVerts +
                             kSplitWarps * kHT * 3 * kSplitVerts;

__global__ void __launch_bounds__(kSplitWarps * 32)
    mano_split_kernel(const float* __restrict__ coef,
                      const float* __restrict__ g_rows,
                      const float* __restrict__ basis,
                      const float* __restrict__ weights_t, int batch,
                      float* __restrict__ out) {
  constexpr int kThreads = kSplitWarps * 32;
  extern __shared__ float4 smem4[];
  float* s_basis = reinterpret_cast<float*>(smem4);  // [146*3][32]
  float* s_coef = s_basis + kSplitBasis;             // [146][kSplitPitch]
  float* s_g = s_coef + kCoef * kSplitPitch;         // [8][kG]
  float* s_w = s_g + kHT * kG;                       // [16][32]
  float* s_part = s_w + kJoints * kSplitVerts;       // [warps][8][3][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kHT;
  const int v0 = blockIdx.x * kSplitVerts;

  // the block's whole slab is requested before any of it is used; hands
  // past the batch and vertices past 778 read as zero
  for (int i = threadIdx.x; i < kCoef * 3 * (kSplitVerts / 2); i += kThreads) {
    const int pair = i % (kSplitVerts / 2), row = i / (kSplitVerts / 2);
    const int v = v0 + 2 * pair;
    const bool valid = v < kVerts;
    cp_async<8>(s_basis + row * kSplitVerts + 2 * pair,
                valid ? basis + (long long)row * kVerts + v : basis, valid);
  }
  for (int i = threadIdx.x; i < kCoef * kHT; i += kThreads) {
    const int h = i / kCoef, k = i % kCoef;
    const bool valid = b0 + h < batch;
    cp_async<4>(s_coef + k * kSplitPitch + h,
                valid ? coef + (long long)(b0 + h) * kCoef + k : coef, valid);
  }
  for (int i = threadIdx.x; i < kHT * kG / 4; i += kThreads) {
    const bool valid = b0 + i / (kG / 4) < batch;
    cp_async<16>(s_g + 4 * i,
                 valid ? g_rows + (long long)b0 * kG + 4 * i : g_rows, valid);
  }
  for (int i = threadIdx.x; i < kJoints * (kSplitVerts / 2); i += kThreads) {
    const int pair = i % (kSplitVerts / 2), j = i / (kSplitVerts / 2);
    const int v = v0 + 2 * pair;
    const bool valid = v < kVerts;
    cp_async<8>(s_w + j * kSplitVerts + 2 * pair,
                valid ? weights_t + j * kVerts + v : weights_t, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // warp w: coefficients [19 w, 19 w + 19), one vertex per lane
  float acc[kHT][3];
#pragma unroll
  for (int h = 0; h < kHT; ++h) acc[h][0] = acc[h][1] = acc[h][2] = 0.0f;
  const int k1 = min(kCoef, (warp + 1) * kSplitK);
  for (int k = warp * kSplitK; k < k1; ++k) {
    const float bx = s_basis[(k * 3 + 0) * kSplitVerts + lane];
    const float by = s_basis[(k * 3 + 1) * kSplitVerts + lane];
    const float bz = s_basis[(k * 3 + 2) * kSplitVerts + lane];
    const float4* cp =
        reinterpret_cast<const float4*>(s_coef + k * kSplitPitch);
    const float4 c0 = cp[0], c1 = cp[1];
    const float c[kHT] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int h = 0; h < kHT; ++h) {
      acc[h][0] = __fmaf_rn(c[h], bx, acc[h][0]);
      acc[h][1] = __fmaf_rn(c[h], by, acc[h][1]);
      acc[h][2] = __fmaf_rn(c[h], bz, acc[h][2]);
    }
  }
#pragma unroll
  for (int h = 0; h < kHT; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s_part[((warp * kHT + h) * 3 + c) * kSplitVerts + lane] = acc[h][c];
  __syncthreads();

  // epilogue: one (hand, output coordinate, vertex) per item; a warp's
  // items share the hand and coordinate, so its transform rows broadcast
  for (int item = threadIdx.x; item < kHT * 3 * kSplitVerts; item += kThreads) {
    const int vl = item % kSplitVerts;
    const int i = (item / kSplitVerts) % 3, h = item / (3 * kSplitVerts);
    const int b = b0 + h, v = v0 + vl;
    if (b >= batch || v >= kVerts) continue;
    float p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sum = s_part[(h * 3 + c) * kSplitVerts + vl];
#pragma unroll
      for (int w = 1; w < kSplitWarps; ++w)
        sum += s_part[((w * kHT + h) * 3 + c) * kSplitVerts + vl];
      p[c] = sum;
    }
    const float* g = s_g + h * kG + 4 * i * kJoints;
    float t[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc_t = 0.0f;
#pragma unroll
      for (int j = 0; j < kJoints; ++j)
        acc_t = __fmaf_rn(g[q * kJoints + j], s_w[j * kSplitVerts + vl], acc_t);
      t[q] = acc_t;
    }
    out[((long long)b * kVerts + v) * 3 + i] =
        __fmaf_rn(t[2], p[2], __fmaf_rn(t[1], p[1], __fmaf_rn(t[0], p[0], t[3])));
  }
}

// Above 48 KB a kernel's dynamic shared memory must be allowed once per
// device; the flag holds one bit per device.
std::atomic<unsigned long long> smem_allowed{0};

cudaError_t allow_smem(int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (smem_allowed.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(mano_split_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) smem_allowed.fetch_or(bit);
  return err;
}

}  // namespace

extern "C" {

// coef (B, 146), g_rows (B*12, 16) 16-byte aligned, basis (146, 3, 778)
// and weights_t (16, 778) 8-byte aligned -> out (B, 778, 3); all fp32,
// contiguous, on the current device. Grid (25, ceil(B / 8)) of 256
// threads (ops/mano_kernel.py launch_shape). Returns the CUDA error of the
// launch.
int acr_mano_fused(const float* coef, const float* g_rows, const float* basis,
                   const float* weights_t, int batch, float* out,
                   void* stream) {
  if (batch <= 0) return 0;
  if ((batch + kHT - 1) / kHT > 65535) return (int)cudaErrorInvalidValue;
  constexpr int bytes = kSplitFloats * 4;
  cudaError_t err = allow_smem(bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((kVerts + kSplitVerts - 1) / kSplitVerts,
                  (batch + kHT - 1) / kHT);
  mano_split_kernel<<<grid, kSplitWarps * 32, bytes, (cudaStream_t)stream>>>(
      coef, g_rows, basis, weights_t, batch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
