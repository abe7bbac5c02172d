// Z-buffer rasterizer kernels for Hopper (sm_90a), bound with ctypes.
//
// raster_flat_kernel replaces the Pallas kernel `_raster_kernel`
// (acr_tpu/viz/raster_pallas.py:106, launched by rasterize_pallas) and
// raster_binned_kernel replaces `_raster_kernel_binned` (:193, launched
// by rasterize_pallas_binned); both fold in the winner's attribute pick,
// `_attr_pick_fold` (:66).
//
// What they compute, per pixel centre (x + 0.5, y + 0.5): the edge-
// function barycentrics of every face (or of the pixel tile's binned face
// list), the inside test w0, w1, w2 >= 0 with a non-degenerate face
// (inv != 0), the interpolated depth, and the minimum-depth winner. Faces
// are visited in ascending id order with a strict `<`, so a depth tie
// goes to the lowest face id, the rule the TPU kernels get from an
// in-chunk argmin plus a strict `<` across chunks. After the fold the
// winner's 16 attribute rows are read by index: the TPU kernels pick
// them with a one-hot matmul because TPU gathers are slow; here a direct
// load gives the same bits.
//
// Exactness: every operation of the edge math is an explicitly rounded
// intrinsic (__fmul_rn, __fsub_rn, __fadd_rn), and the file is compiled
// with --fmad=false as well, so no multiply-add is contracted and the
// bits equal the plain PyTorch version's (acr_tpu_torch/viz/raster_cuda.py),
// whose elementwise ops round each result. A contracted FMA could move a
// depth across a tie and change the winning face.
//
// What bounds them on this card: the flat kernel does about 20 fp32
// operations per face per pixel (3200 faces x 262144 pixels at 512 px,
// about 17 GFLOP without FMA), so it is bound by fp32 issue rate; the
// face rows it reads are the same for every thread of a block at each
// step, which the L1 cache serves as broadcasts. The binned kernel does
// the same work over a tile's live count only (a few hundred faces at
// most), so at 512 px it is bound by launch latency and by the tiles
// with the most faces. The design is the simple one: one thread per
// pixel, the running z-buffer, winner and barycentrics in registers,
// no shared-memory staging.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowTile = 8;    // rows per binned tile (ROW_TILE)
constexpr int kNAttr = 16;     // attribute rows per face (N_ATTR)
constexpr int kTriRows = 32;   // binned table rows: 0..8 triangle, 16..31 attrs
constexpr int kBlock = 128;    // threads per block, along x

// Edge-function barycentrics and depth of one face at one pixel centre,
// in the operation order of raster_pallas.py:150-161.
struct Hit {
  float w0, w1, depth;
  bool inside;
};

__device__ __forceinline__ Hit edge_test(float gx, float gy, float ax,
                                         float ay, float az, float bx,
                                         float by, float bz, float cx,
                                         float cy, float cz, float inv) {
  Hit h;
  h.w0 = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(cx, bx), __fsub_rn(gy, by)),
                             __fmul_rn(__fsub_rn(cy, by), __fsub_rn(gx, bx))),
                   inv);
  h.w1 = __fmul_rn(__fsub_rn(__fmul_rn(__fsub_rn(ax, cx), __fsub_rn(gy, cy)),
                             __fmul_rn(__fsub_rn(ay, cy), __fsub_rn(gx, cx))),
                   inv);
  const float w2 = __fsub_rn(__fsub_rn(1.0f, h.w0), h.w1);
  h.inside = h.w0 >= 0.0f && h.w1 >= 0.0f && w2 >= 0.0f && inv != 0.0f;
  h.depth = __fadd_rn(__fadd_rn(__fmul_rn(h.w0, az), __fmul_rn(h.w1, bz)),
                      __fmul_rn(w2, cz));
  return h;
}

// tri: (9, F) rows ax ay az bx by bz cx cy cz; inv: (F,); attrs: (16, F).
// Outputs (H, W) fid / b0 / b1 and (16, H, W) attribute planes.
__global__ void raster_flat_kernel(const float* __restrict__ tri,
                                   const float* __restrict__ inv,
                                   const float* __restrict__ attrs,
                                   int n_faces, int height, int width,
                                   int* __restrict__ fid_out,
                                   float* __restrict__ b0_out,
                                   float* __restrict__ b1_out,
                                   float* __restrict__ attr_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width || y >= height) return;
  const float gx = __fadd_rn((float)x, 0.5f);
  const float gy = __fadd_rn((float)y, 0.5f);
  const int F = n_faces;

  float zbuf = CUDART_INF_F;
  int best = -1;
  float bb0 = 0.0f, bb1 = 0.0f;
  for (int f = 0; f < F; ++f) {
    const float iv = inv[f];
    const Hit h = edge_test(gx, gy, tri[f], tri[F + f], tri[2 * F + f],
                            tri[3 * F + f], tri[4 * F + f], tri[5 * F + f],
                            tri[6 * F + f], tri[7 * F + f], tri[8 * F + f], iv);
    if (h.inside && h.depth < zbuf) {
      zbuf = h.depth;
      best = f;
      bb0 = h.w0;
      bb1 = h.w1;
    }
  }
  const long long hw = (long long)height * width;
  const long long p = (long long)y * width + x;
  fid_out[p] = best;
  b0_out[p] = bb0;
  b1_out[p] = bb1;
  for (int r = 0; r < kNAttr; ++r)
    attr_out[r * hw + p] = best >= 0 ? attrs[(long long)r * F + best] : 0.0f;
}

// counts: (T,) live slots per tile; tri_t: (T, 32, cap) rows 0..8 the
// triangle, 16..31 the attribute rows; inv_t, ids_t: (T, cap). Tiles are
// 8 rows x col_tile columns in row-major grid order. Slots past a tile's
// count are never visited (they hold inv = 0 and could not win).
__global__ void raster_binned_kernel(const int* __restrict__ counts,
                                     const float* __restrict__ tri_t,
                                     const float* __restrict__ inv_t,
                                     const int* __restrict__ ids_t, int cap,
                                     int height, int width, int col_tile,
                                     int* __restrict__ fid_out,
                                     float* __restrict__ b0_out,
                                     float* __restrict__ b1_out,
                                     float* __restrict__ attr_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width || y >= height) return;
  const int n_tx = width / col_tile;
  const int t = (y / kRowTile) * n_tx + x / col_tile;
  const float* rows = tri_t + (long long)t * kTriRows * cap;
  const float* inv = inv_t + (long long)t * cap;
  const int* ids = ids_t + (long long)t * cap;
  const int n = min(counts[t], cap);
  const float gx = __fadd_rn((float)x, 0.5f);
  const float gy = __fadd_rn((float)y, 0.5f);

  float zbuf = CUDART_INF_F;
  int slot = -1;
  float bb0 = 0.0f, bb1 = 0.0f;
  for (int s = 0; s < n; ++s) {
    const Hit h = edge_test(gx, gy, rows[s], rows[cap + s], rows[2 * cap + s],
                            rows[3 * cap + s], rows[4 * cap + s],
                            rows[5 * cap + s], rows[6 * cap + s],
                            rows[7 * cap + s], rows[8 * cap + s], inv[s]);
    if (h.inside && h.depth < zbuf) {
      zbuf = h.depth;
      slot = s;
      bb0 = h.w0;
      bb1 = h.w1;
    }
  }
  const long long hw = (long long)height * width;
  const long long p = (long long)y * width + x;
  fid_out[p] = slot >= 0 ? ids[slot] : -1;
  b0_out[p] = bb0;
  b1_out[p] = bb1;
  const float* attr_rows = rows + 16 * cap;
  for (int r = 0; r < kNAttr; ++r)
    attr_out[r * hw + p] = slot >= 0 ? attr_rows[r * cap + slot] : 0.0f;
}

}  // namespace

extern "C" {

int acr_raster_flat(const float* tri, const float* inv, const float* attrs,
                    int n_faces, int height, int width, int* fid, float* b0,
                    float* b1, float* attr_out, void* stream) {
  const dim3 grid((width + kBlock - 1) / kBlock, height);
  raster_flat_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      tri, inv, attrs, n_faces, height, width, fid, b0, b1, attr_out);
  return (int)cudaGetLastError();
}

int acr_raster_binned(const int* counts, const float* tri_t, const float* inv_t,
                      const int* ids_t, int cap, int height, int width,
                      int col_tile, int* fid, float* b0, float* b1,
                      float* attr_out, void* stream) {
  const dim3 grid((width + kBlock - 1) / kBlock, height);
  raster_binned_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      counts, tri_t, inv_t, ids_t, cap, height, width, col_tile, fid, b0, b1,
      attr_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
