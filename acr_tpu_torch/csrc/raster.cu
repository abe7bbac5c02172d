// Z-buffer rasterizer kernels for Hopper (sm_90a), bound with ctypes.
//
// raster_flat_kernel replaces the Pallas kernel `_raster_kernel`
// (acr_tpu/viz/raster_pallas.py:106, launched by rasterize_pallas),
// raster_binned_kernel replaces `_raster_kernel_binned` (:193, launched
// by rasterize_pallas_binned) and raster_banded_kernel replaces
// `_raster_kernel_banded` (:298, launched by rasterize_pallas_banded);
// all three fold in the winner's attribute pick, `_attr_pick_fold` (:66).
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
// What bounds them on this card: about 23 fp32 operations per face per
// pixel of the edge math, each a separate FADD or FMUL (one operation per
// lane per clock: no FMA). Brute force, the flat kernel's TPU original
// folds every face at every pixel (3200 faces x 262144 pixels at 512 px,
// about 19 GFLOP), yet on a frame of small hands a face's bbox covers a
// few pixels. So the flat kernel culls, per tile of 8 x 128 pixels, and
// folds only the faces whose bbox reaches the tile. Culled work is uneven:
// a tile over a small far hand keeps several hundred faces while most
// tiles keep none, and one block per tile would leave the densest tile's
// whole fold to one SM while the others idle. So a tile is a cluster of
// kFlatCluster blocks on neighbouring SMs that split its faces: block r
// takes the chunks r, r + 8, r + 16, ... of kFlatChunk faces, tests each
// face's bbox against the tile (one thread per face), compacts the
// survivors with a warp ballot and a prefix count, in ascending id order,
// into shared memory, and folds them over all the tile's pixels (4 per
// thread). Each block's fold is then the first minimum in ascending order
// over its faces, that is the least (depth, id); each block writes row r
// of its result into block r's shared memory (distributed shared memory),
// and after a cluster barrier block r merges row r over the eight blocks
// by the same order (merge_tile_row). That is the winner, barycentrics
// included, of one ascending fold over all faces. It is bound by the live
// (face, tile) pairs it folds and by reading each face's rows once per
// tile. The binned kernel folds a tile's prestaged list with the same
// block shape and the same merge; see raster_binned_kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kRowTile = 8;    // rows per binned tile (ROW_TILE)
constexpr int kNAttr = 16;     // attribute rows per face (N_ATTR)
constexpr int kTriRows = 32;   // table rows: 0..8 triangle, 16..31 attrs
constexpr int kRowInv = 9;     // face and band tables: inverse area
constexpr int kRowGid = 10;    // banded table: global face id as f32
constexpr int kRowAttr = 16;   // first attribute row of a table
constexpr int kFaceChunk = 128;  // slots per tilenc chunk (FACE_CHUNK)
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

// The flat and binned kernels' tile: kFlatRows x kFlatCols pixels, one
// cluster of kFlatCluster blocks of kFlatThreads threads, kFlatPx pixels
// per thread.
constexpr int kFlatRows = 8;
constexpr int kFlatCols = 128;
constexpr int kFlatCluster = 8;   // = kFlatRows: block r merges row r
constexpr int kFlatThreads = 256;
constexpr int kFlatPx = kFlatRows * kFlatCols / kFlatThreads;  // 4 rows
constexpr int kFlatChunk = 256;   // faces a block culls at a time

// Whether a face can win at a pixel centre of the rectangle [x0, x1] x
// [y0, y1]: the inclusive bbox test of the binned prestage (_tile_overlap
// in acr_tpu_torch/viz/raster_cuda.py, whose pixel centres lie 0.5 px
// inside the bounds), on a live face (inv != 0) whose six screen
// coordinates are not NaN. A face that fails it is inside no pixel centre
// of the tile (a NaN coordinate makes the edge test fail too), so
// dropping it changes no winner.
__device__ __forceinline__ bool face_reaches(float ax, float ay, float bx,
                                             float by, float cx, float cy,
                                             float inv, float x0, float x1,
                                             float y0, float y1) {
  if (inv == 0.0f || isnan(ax) || isnan(ay) || isnan(bx) || isnan(by) ||
      isnan(cx) || isnan(cy))
    return false;
  return fminf(fminf(ax, bx), cx) <= x1 && fmaxf(fmaxf(ax, bx), cx) >= x0 &&
         fminf(fminf(ay, by), cy) <= y1 && fmaxf(fmaxf(ay, by), cy) >= y0;
}

// A block's fold of the faces it staged, per thread kFlatPx pixels of one
// column: the depth buffer, the winner's ordering key (ascending with the
// face id; -1 for none) and its barycentrics.
struct Fold {
  float gx, gy[kFlatPx], zbuf[kFlatPx], b0[kFlatPx], b1[kFlatPx];
  int key[kFlatPx];
};

__device__ __forceinline__ void fold_init(Fold& f, int x0, int y0, int col,
                                          int row0) {
  f.gx = __fadd_rn((float)(x0 + col), 0.5f);
#pragma unroll
  for (int m = 0; m < kFlatPx; ++m) {
    f.gy[m] = __fadd_rn((float)(y0 + row0 + m), 0.5f);
    f.zbuf[m] = CUDART_INF_F;
    f.key[m] = -1;
    f.b0[m] = f.b1[m] = 0.0f;
  }
}

// Fold n staged faces, each (ax ay az bx) (by bz cx cy) (cz inv - -) and
// its key, in staging order with a strict `<`. With kWarpCull a warp folds
// only the faces whose bbox (box[s]: xmin xmax ymin ymax) reaches its
// pixels, inside [wx0, wx1] x [wy0, wy1]: its lanes test 32 faces at a
// time, one each, and a ballot lists the faces to fold, so a face the
// warp skips costs it nothing. The list is uniform over the warp, so no
// lane diverges, and a skipped face covers none of the warp's pixel
// centres.
template <bool kWarpCull>
__device__ __forceinline__ void fold_staged(Fold& f, const float4 (*face)[3],
                                            const int* key, const float4* box,
                                            int n, float wx0, float wx1,
                                            float wy0, float wy1) {
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < n; s0 += 32) {
    unsigned todo = n - s0 >= 32 ? 0xffffffffu : (1u << (n - s0)) - 1u;
    if (kWarpCull) {
      bool hit = false;
      if (s0 + lane < n) {
        const float4 b = box[s0 + lane];
        hit = b.x <= wx1 && b.y >= wx0 && b.z <= wy1 && b.w >= wy0;
      }
      todo = __ballot_sync(0xffffffffu, hit);
    }
    while (todo) {  // in ascending order
      const int s = s0 + __ffs(todo) - 1;
      todo &= todo - 1u;
      const float4 p = face[s][0], q = face[s][1], r = face[s][2];
#pragma unroll
      for (int m = 0; m < kFlatPx; ++m) {
        const Hit h = edge_test(f.gx, f.gy[m], p.x, p.y, p.z, p.w, q.x, q.y,
                                q.z, q.w, r.x, r.y);
        if (h.inside && h.depth < f.zbuf[m]) {
          f.zbuf[m] = h.depth;
          f.key[m] = key[s];
          f.b0[m] = h.w0;
          f.b1[m] = h.w1;
        }
      }
    }
  }
}

// Count the block's surviving faces (keep) and give each its place in
// ascending order: warps in order, lanes in order. Returns the number of
// survivors; *slot is the thread's place when it keeps its face.
__device__ __forceinline__ int compact(bool keep, int* s_warp_live,
                                       int* slot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned live = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_warp_live[warp] = __popc(live);
  __syncthreads();
  int base = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kFlatThreads / 32; ++w) {
    const int c = s_warp_live[w];
    base += w < warp ? c : 0;
    n += c;
  }
  *slot = base + __popc(live & ((1u << lane) - 1u));
  return n;
}

// The cluster's merge. Each block sends tile row r of its fold to block r
// (a block that drew nothing sends only that); after the cluster barrier,
// thread c < kFlatCols of block r takes the least (depth, key) of row r,
// column c over the blocks and calls emit(c, key, w0, w1). Every block
// must have arrived at the cluster barrier (barrier.cluster.arrive) when it
// started, before any block writes into another's shared memory.
template <typename Emit>
__device__ __forceinline__ void merge_tile_row(
    const Fold& f, int rank, int col, int row0, int4 (*s_row)[kFlatCols],
    int* s_drew, Emit emit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  bool any = false;
#pragma unroll
  for (int m = 0; m < kFlatPx; ++m) any |= f.key[m] >= 0;
  const int drew = __syncthreads_or(any);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (drew) {
#pragma unroll
    for (int m = 0; m < kFlatPx; ++m)
      cluster.map_shared_rank(&s_row[0][0], row0 + m)[rank * kFlatCols + col] =
          make_int4(__float_as_int(f.zbuf[m]), f.key[m],
                    __float_as_int(f.b0[m]), __float_as_int(f.b1[m]));
  }
  if (tid < kFlatCluster) *cluster.map_shared_rank(&s_drew[rank], tid) = drew;
  cluster.sync();

  if (tid >= kFlatCols) return;
  float z = 0.0f, w0 = 0.0f, w1 = 0.0f;
  int key = -1;
#pragma unroll
  for (int b = 0; b < kFlatCluster; ++b) {
    if (!s_drew[b]) continue;
    const int4 e = s_row[b][tid];
    const float ez = __int_as_float(e.x);
    if (e.y >= 0 && (key < 0 || ez < z || (ez == z && e.y < key))) {
      z = ez;
      key = e.y;
      w0 = __int_as_float(e.z);
      w1 = __int_as_float(e.w);
    }
  }
  emit(tid, key, w0, w1);
}

// tri: (9, F) rows ax ay az bx by bz cx cy cz; inv: (F,); attrs: (16, F).
// Outputs (H, W) fid / b0 / b1 and (16, H, W) attribute planes. Grid
// (kFlatCluster ceil(W / 128), ceil(H / 8)); the ragged edge is computed
// and masked at the store, since every block takes part in every barrier.
__global__ void __cluster_dims__(kFlatCluster, 1, 1)
    __launch_bounds__(kFlatThreads)
        raster_flat_kernel(const float* __restrict__ tri,
                           const float* __restrict__ inv,
                           const float* __restrict__ attrs, int n_faces,
                           int height, int width, int* __restrict__ fid_out,
                           float* __restrict__ b0_out,
                           float* __restrict__ b1_out,
                           float* __restrict__ attr_out) {
  // a surviving face: (ax ay az bx) (by bz cx cy) (cz inv - -), its id
  __shared__ float4 s_face[kFlatChunk][3];
  __shared__ int s_id[kFlatChunk];
  __shared__ int s_warp_live[kFlatThreads / 32];
  // tile row `rank` as each block folded it (the bits of depth, face id,
  // b0, b1), written by that block, and whether it drew any pixel at all
  __shared__ int4 s_row[kFlatCluster][kFlatCols];
  __shared__ int s_drew[kFlatCluster];
  // every block of the cluster must run before one writes into another's
  // shared memory: arrive now, wait just before the writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x;
  const int x0 = (blockIdx.x / kFlatCluster) * kFlatCols;
  const int y0 = blockIdx.y * kFlatRows;
  const float rx0 = (float)x0, rx1 = (float)(x0 + kFlatCols);
  const float ry0 = (float)y0, ry1 = (float)(y0 + kFlatRows);
  const int col = tid % kFlatCols, row0 = (tid / kFlatCols) * kFlatPx;
  const int F = n_faces;

  Fold fold;
  fold_init(fold, x0, y0, col, row0);
  for (int c0 = rank * kFlatChunk; c0 < F; c0 += kFlatCluster * kFlatChunk) {
    const int f = c0 + tid;
    float ax = 0.0f, ay = 0.0f, bx = 0.0f, by = 0.0f, cx = 0.0f, cy = 0.0f;
    float iv = 0.0f;
    bool keep = false;
    if (f < F) {
      ax = tri[f];
      ay = tri[F + f];
      bx = tri[3 * F + f];
      by = tri[4 * F + f];
      cx = tri[6 * F + f];
      cy = tri[7 * F + f];
      iv = inv[f];
      keep = face_reaches(ax, ay, bx, by, cx, cy, iv, rx0, rx1, ry0, ry1);
    }
    int s;
    const int n = compact(keep, s_warp_live, &s);
    if (keep) {
      s_face[s][0] = make_float4(ax, ay, tri[2 * F + f], bx);
      s_face[s][1] = make_float4(by, tri[5 * F + f], cx, cy);
      s_face[s][2] = make_float4(tri[8 * F + f], iv, 0.0f, 0.0f);
      s_id[s] = f;
    }
    __syncthreads();
    fold_staged<false>(fold, s_face, s_id, nullptr, n, 0.0f, 0.0f, 0.0f,
                       0.0f);
    __syncthreads();  // the next chunk overwrites the list
  }
  merge_tile_row(
      fold, rank, col, row0, s_row, s_drew,
      [&](int c, int id, float w0, float w1) {
        const int x = x0 + c, y = y0 + rank;
        if (x >= width || y >= height) return;
        const long long hw = (long long)height * width;
        const long long p = (long long)y * width + x;
        fid_out[p] = id;
        b0_out[p] = w0;
        b1_out[p] = w1;
        for (int r = 0; r < kNAttr; ++r)
          attr_out[r * hw + p] = id >= 0 ? attrs[(long long)r * F + id] : 0.0f;
      });
}

// The binned kernel (the render below 1024 px).
//
// counts: (T,) the live faces whose bbox reaches each tile, either clipped
// to cap or not; tri_t: (T, 32, cap) rows 0..8 the triangle, 16..31 the
// attribute rows; inv_t, ids_t: (T, cap), each tile's faces in ascending
// id order. Tiles are 8 rows x col_tile columns in row-major grid order,
// col_tile a multiple of 128 or the whole width. table: (32, n_faces), the
// full face table (rows 0..8 the triangle, 9 the inverse area, 16..31 the
// attributes), or null.
//
// Overflow: a tile whose count exceeds cap (only with a table) folds its
// cap kept slots, which are its lowest ids, and then the table's faces
// after the last kept id, culled against the block's pixels by
// face_reaches. The faces that can win at a pixel of the tile all reach
// it, so they are among these, visited in ascending id order: the winner
// equals the flat kernel's bit for bit. With clipped counts or no table
// the faces above cap drop, as in the TPU kernel.
//
// Design, for what bounds it on this card: the edge math of the live
// (face, pixel) pairs (23 FADD/FMUL each) and writing the 19 output planes.
// On a frame of small hands most tiles are empty while a few hold hundreds
// of tiny faces, whose fold no single SM should carry. So the kernel has
// the flat kernel's block shape: each 8 x 128 half of a tile is a cluster
// of 8 blocks on neighbouring SMs, and a tile's candidates (its kept
// slots, then its overflow faces) are split into 8 contiguous runs, one
// per block, so that the densest tile spreads over 16 SMs. A block stages
// its run in chunks of 256 into shared memory (coalesced loads: a slot
// run is contiguous along the slot axis of tri_t), culls it against its
// own 8 x 128 pixels, and compacts the survivors in order with their
// bboxes. Each warp (32 columns x 4 rows, 4 pixels of one column per
// thread) then folds only the survivors whose bbox reaches its pixels
// (fold_staged): a face of a few pixels touches one or two of a block's
// 8 warps, and a warp skips the others at no cost. The cluster merges rows
// by the least (depth, key) as the flat kernel does; the key is the
// candidate's place in the tile's ascending order, so the merge picks the
// ascending fold's winner. An empty tile writes the background and exits
// before any barrier (its count is uniform over the cluster). The winner's
// id and attribute rows are read by its key: from ids_t and tri_t for a
// slot, from the table for an overflow face. The launch bound keeps it at
// 64 registers, so 4 blocks fit on an SM: a frame of large hands has work
// in most of its 2048 blocks, and their number of waves sets its time.
__global__ void __cluster_dims__(kFlatCluster, 1, 1)
    __launch_bounds__(kFlatThreads, 4)
        raster_binned_kernel(const int* __restrict__ counts,
                             const float* __restrict__ tri_t,
                             const float* __restrict__ inv_t,
                             const int* __restrict__ ids_t, int cap,
                             const float* __restrict__ table, int n_faces,
                             int height, int width, int col_tile,
                             int* __restrict__ fid_out,
                             float* __restrict__ b0_out,
                             float* __restrict__ b1_out,
                             float* __restrict__ attr_out) {
  __shared__ float4 s_face[kFlatChunk][3];
  __shared__ float4 s_box[kFlatChunk];   // xmin xmax ymin ymax
  __shared__ int s_key[kFlatChunk];
  __shared__ int s_warp_live[kFlatThreads / 32];
  __shared__ int4 s_row[kFlatCluster][kFlatCols];
  __shared__ int s_drew[kFlatCluster];
  const int rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x;
  const int x0 = (blockIdx.x / kFlatCluster) * kFlatCols;
  const int y0 = blockIdx.y * kFlatRows;
  const int t = (y0 / kRowTile) * (width / col_tile) + x0 / col_tile;
  const int count = counts[t];
  const long long hw = (long long)height * width;
  const float* rows = tri_t + (long long)t * kTriRows * cap;
  const int* ids = ids_t + (long long)t * cap;
  const int n_kept = min(count, cap);
  // the overflow faces: the table's faces after the last kept id
  const int first = table != nullptr && count > cap ? ids[cap - 1] + 1
                                                    : n_faces;
  const int n_over = max(n_faces - first, 0);
  const long long F = n_faces;
  // the winner's id, barycentrics and attribute rows at pixel (x, y), by
  // its key: from ids_t and tri_t for a slot, the table for an overflow face
  auto write_px = [&](int x, int y, int key, float w0, float w1) {
    if (x >= width) return;
    const long long p = (long long)y * width + x;
    int id = -1;
    const float* attr = rows + kRowAttr * cap;
    long long stride = cap, j = key;
    if (key >= 0 && key < n_kept) {
      id = ids[key];
    } else if (key >= 0) {
      id = first + (key - n_kept);
      attr = table + kRowAttr * F;
      stride = F;
      j = id;
    }
    fid_out[p] = id;
    b0_out[p] = w0;
    b1_out[p] = w1;
    for (int r = 0; r < kNAttr; ++r)
      attr_out[r * hw + p] = id >= 0 ? attr[r * stride + j] : 0.0f;
  };
  if (count <= 0) {  // block r writes row r of the background
    if (tid < kFlatCols) write_px(x0 + tid, y0 + rank, -1, 0.0f, 0.0f);
    return;
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const float rx0 = (float)x0, rx1 = (float)(x0 + kFlatCols);
  const float ry0 = (float)y0, ry1 = (float)(y0 + kFlatRows);
  const int col = tid % kFlatCols, row0 = (tid / kFlatCols) * kFlatPx;
  // the warp's pixels: 32 columns of 4 rows
  const float wx0 = (float)(x0 + (col & ~31)), wy0 = (float)(y0 + row0);
  const float wx1 = wx0 + 32.0f, wy1 = wy0 + (float)kFlatPx;
  const float* tinv = inv_t + (long long)t * cap;

  Fold fold;
  fold_init(fold, x0, y0, col, row0);
  // stage the candidate keys [begin, end) in chunks, cull them against the
  // block's pixels and fold them
  auto fold_run = [&](int begin, int end) {
    for (int c0 = begin; c0 < end; c0 += kFlatChunk) {
      const int k = c0 + tid;
      // a slot's rows lie along tri_t's slot axis, a face's along the table
      float v[9] = {};  // ax ay az bx by bz cx cy cz
      float iv = 0.0f;
      bool keep = false;
      if (k < end) {
        const float* src = rows;
        long long stride = cap, j = k;
        if (k < n_kept) {
          iv = tinv[k];
        } else {
          src = table;
          stride = F;
          j = first + (k - n_kept);
          iv = table[kRowInv * F + j];
        }
#pragma unroll
        for (int r = 0; r < 9; ++r) v[r] = src[r * stride + j];
        keep = face_reaches(v[0], v[1], v[3], v[4], v[6], v[7], iv, rx0, rx1,
                            ry0, ry1);
      }
      int s;
      const int n = compact(keep, s_warp_live, &s);
      if (keep) {
        s_face[s][0] = make_float4(v[0], v[1], v[2], v[3]);
        s_face[s][1] = make_float4(v[4], v[5], v[6], v[7]);
        s_face[s][2] = make_float4(v[8], iv, 0.0f, 0.0f);
        s_box[s] = make_float4(fminf(fminf(v[0], v[3]), v[6]),
                               fmaxf(fmaxf(v[0], v[3]), v[6]),
                               fminf(fminf(v[1], v[4]), v[7]),
                               fmaxf(fmaxf(v[1], v[4]), v[7]));
        s_key[s] = k;
      }
      __syncthreads();
      fold_staged<true>(fold, s_face, s_key, s_box, n, wx0, wx1, wy0, wy1);
      __syncthreads();  // the next chunk overwrites the list
    }
  };
  // block r's runs of the candidate keys: a share of the slots, then a
  // share of the overflow faces (key n_kept + i is the face first + i)
  const int ps = (n_kept + kFlatCluster - 1) / kFlatCluster;
  const int pf = (n_over + kFlatCluster - 1) / kFlatCluster;
  fold_run(min(rank * ps, n_kept), min(rank * ps + ps, n_kept));
  fold_run(n_kept + min(rank * pf, n_over),
           n_kept + min(rank * pf + pf, n_over));
  merge_tile_row(fold, rank, col, row0, s_row, s_drew,
                 [&](int c, int key, float w0, float w1) {
                   write_px(x0 + c, y0 + rank, key, w0, w1);
                 });
}

// The banded kernel (the render at 1024 px and above).
//
// table: (n_bands, 32, band_cap), one face table per band of band_h rows:
// rows 0..8 the triangle, 9 the inverse area (0 for a dead column), 10 the
// global face id as f32 (exact below 2^24, which rasterize_banded checks),
// 16..31 the attribute rows. ids_t: (T, 1, cap) per 8 x col_tile tile, the
// ascending columns of its band's table whose bbox reaches the tile, then
// the sentinel band_cap. tilenc: (T,) the tile's live chunks of 128 slots.
//
// The TPU kernel rebuilt each chunk's face rows with a one-hot matmul over
// the band table (bounded by the prestage's fetchnc), because a TPU gather
// is slow. Here each slot's rows are read from the table at its column,
// directly: a thread visits only its tile's live slots, in ascending order
// (so ascending face id) with the strict `<` of the other kernels, and
// stops at the first sentinel; fetchnc has no use.
//
// What bounds it on this card: about 20 fp32 operations per live slot per
// pixel, and per slot one int and ten float loads that every thread of a
// warp shares (a warp lies in one tile, so the loop and its loads are
// warp-uniform and the L1 cache broadcasts them). The band table (8 bands
// x 32 rows x 2048 columns x 4 B = 2 MB at 2048 px) stays in L2. The
// busiest tiles set the time; most tiles of a frame are empty and cost one
// load of tilenc.
__global__ void raster_banded_kernel(const int* __restrict__ tilenc,
                                     const float* __restrict__ table,
                                     const int* __restrict__ ids_t,
                                     int band_cap, int cap, int band_h,
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
  const float* rows = table + (long long)(y / band_h) * kTriRows * band_cap;
  const int* ids = ids_t + (long long)t * cap;
  const int n = min(tilenc[t] * kFaceChunk, cap);
  const float gx = __fadd_rn((float)x, 0.5f);
  const float gy = __fadd_rn((float)y, 0.5f);
  const long long bc = band_cap;

  float zbuf = CUDART_INF_F;
  int col = -1;
  float bb0 = 0.0f, bb1 = 0.0f;
  for (int s = 0; s < n; ++s) {
    const int c = ids[s];
    if (c >= band_cap) break;  // the ascending list ends at its sentinel
    const Hit h = edge_test(gx, gy, rows[c], rows[bc + c], rows[2 * bc + c],
                            rows[3 * bc + c], rows[4 * bc + c],
                            rows[5 * bc + c], rows[6 * bc + c],
                            rows[7 * bc + c], rows[8 * bc + c],
                            rows[kRowInv * bc + c]);
    if (h.inside && h.depth < zbuf) {
      zbuf = h.depth;
      col = c;
      bb0 = h.w0;
      bb1 = h.w1;
    }
  }
  const long long hw = (long long)height * width;
  const long long p = (long long)y * width + x;
  fid_out[p] = col >= 0 ? (int)rows[kRowGid * bc + col] : -1;
  b0_out[p] = bb0;
  b1_out[p] = bb1;
  const float* attr_rows = rows + kRowAttr * bc;
  for (int r = 0; r < kNAttr; ++r)
    attr_out[r * hw + p] = col >= 0 ? attr_rows[r * bc + col] : 0.0f;
}

}  // namespace

extern "C" {

int acr_raster_flat(const float* tri, const float* inv, const float* attrs,
                    int n_faces, int height, int width, int* fid, float* b0,
                    float* b1, float* attr_out, void* stream) {
  const dim3 grid((width + kFlatCols - 1) / kFlatCols * kFlatCluster,
                  (height + kFlatRows - 1) / kFlatRows);
  raster_flat_kernel<<<grid, kFlatThreads, 0, (cudaStream_t)stream>>>(
      tri, inv, attrs, n_faces, height, width, fid, b0, b1, attr_out);
  return (int)cudaGetLastError();
}

// height a multiple of 8; width a multiple of col_tile, which is a
// multiple of 128 or the whole width (the wrapper checks both)
int acr_raster_binned(const int* counts, const float* tri_t, const float* inv_t,
                      const int* ids_t, int cap, const float* table,
                      int n_faces, int height, int width, int col_tile,
                      int* fid, float* b0, float* b1, float* attr_out,
                      void* stream) {
  const dim3 grid((width + kFlatCols - 1) / kFlatCols * kFlatCluster,
                  height / kFlatRows);
  raster_binned_kernel<<<grid, kFlatThreads, 0, (cudaStream_t)stream>>>(
      counts, tri_t, inv_t, ids_t, cap, table, n_faces, height, width,
      col_tile, fid, b0, b1, attr_out);
  return (int)cudaGetLastError();
}

int acr_raster_banded(const int* tilenc, const float* table, const int* ids_t,
                      int band_cap, int cap, int band_h, int height, int width,
                      int col_tile, int* fid, float* b0, float* b1,
                      float* attr_out, void* stream) {
  const dim3 grid((width + kBlock - 1) / kBlock, height);
  raster_banded_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      tilenc, table, ids_t, band_cap, cap, band_h, height, width, col_tile,
      fid, b0, b1, attr_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
