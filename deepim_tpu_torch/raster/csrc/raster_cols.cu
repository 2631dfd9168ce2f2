// Cols raster kernel.
//
// Replaces the TPU kernel deepim_tpu/raster/raster_pallas.py
// §_raster_kernel_cols (grid (sample, 128-px column), 8-face blocks over the
// column's 8x128 sub-tiles).  Same function: each pixel walks its 8x128
// sub-tile's sorted face range, then its column's global list, and keeps the
// strict-'>' nearest face.  Binned by raster_cuda.py §bin_faces_packed
// (column-major tile ids: t = column * n_subs + sub-tile row).  It renders
// every headline crop (assets of 1,024 faces and more) and the dense scenes
// and target depths of synthetic_occlusion_batch.
//
// What bounds it on the card: bytes (outputs, 16 bytes a pixel, and 48 + 36
// bytes a listed / winning face).  Storing a frame's pixels with no list at
// all takes 0.200 ms at B=128, 480x640 (H100, 700 W: 106 % of the bound),
// so everything above that is the lists.  The first port walked a
// sub-tile's range and then, after a second chain of dependent loads, the
// column's global list, and evaluated every staged face at all 1,024
// pixels, 96 bytes a face staged: 0.34 ms on the headline's crops, 0.36-0.60
// on dense full frames.  The design now:
//
// - The shared walk, raster_common.cuh §culled_walk: per-warp cull by each
//   plane's largest corner value, winner ids, 48 bytes a face through
//   cp.async double buffering.  A warp owns a quarter of a sub-tile's width
//   and all 8 of its rows (a 32x8 rectangle, 8 rows a thread).
// - One block of 128 threads a sub-tile, eight resident an SM.  It reads its
//   range's two ends and the global range's two ends up front (one round
//   trip), then walks range and global list as one sequence of rounds, so
//   the global list's first round is in flight while the range is walked.
// - Warps past the right edge (the last column of a width that is no
//   multiple of 128) cull and walk nothing, but stage with the rest and
//   reach every barrier.
//
// Measured and dropped (same card, B=128): a block that owns 2 or 4
// sub-tiles of a column (their ranges are one contiguous stretch of
// face_ids) and stages the column's global list once for all of them was
// slower than one block a sub-tile in every case, by 3-40 % (many small
// blocks hide each other's load chains; a wide block's warps wait at its
// barriers while one sub-tile's faces are walked); 32x4 rectangles (256
// threads) were 7-11 % faster on sparse full frames and 4-12 % slower on
// crops, dense ones too; a third pipeline stage for the ids gained 0-4 %
// here and cost the sorted kernel 7 %.  On dense full frames the walk
// itself (staging and cull alone: 0.23-0.26 ms) is what is left.
//
// It walks exact ranges (none of the TPU kernel's SMEM id windows, DMA
// rounds, 8-face block padding or tail re-evaluations), writes (H, W)
// directly with edge masks, launches on the caller's stream and allocates
// nothing.

#include "raster_common.cuh"

namespace {

constexpr int kSubH = 8;
constexpr int kColW = 128;
constexpr int kWarps = kColW / deepim::kWarpW;  // 4, side by side
constexpr int kThreads = 32 * kWarps;           // 128
constexpr int kMinBlocks = 8;  // resident blocks an SM: at most 64 registers
static_assert(kSubH == deepim::kRows, "a warp owns all rows of its sub-tile");

__global__ void __launch_bounds__(kThreads, kMinBlocks)
raster_cols_kernel(const float4* __restrict__ params, const int* __restrict__ face_ids,
                   const int* __restrict__ starts, const int* __restrict__ glob_col,
                   float* __restrict__ rgb, float* __restrict__ depth, int F, int H,
                   int W, int n_ids, int n_glob, int n_subs, int n_cols) {
  __shared__ deepim::Stage stage;
  const int b = blockIdx.y;
  const int t = blockIdx.x;  // column-major sub-tile id
  const int xi = t / n_subs;
  const deepim::WarpRect w = deepim::warp_rect(
      xi * kColW + (threadIdx.x >> 5) * deepim::kWarpW, (t % n_subs) * kSubH,
      threadIdx.x & 31, H, W);

  const float4* p = params + (size_t)b * F * deepim::kParamVecs;
  // The sub-tile's range and the column's global range, glob_col row
  // [gstarts (n_cols+1) | ids ...]: all four ends read up front.
  const int* st = starts + (size_t)b * (n_subs * n_cols + 1);
  const int* g = glob_col + (size_t)b * n_glob;
  const int lo = st[t], hi = st[t + 1], gs = g[xi], ge = g[xi + 1];
  float zbuf[deepim::kRows] = {};
  int win[deepim::kRows] = {};
  deepim::culled_walk<kThreads>(p, face_ids + (size_t)b * n_ids + lo, hi - lo,
                                g + n_cols + 1 + gs, ge - gs, stage, w, zbuf, win);
  deepim::shade_store(p, zbuf, win, w, rgb, depth, b, H, W);
}

}  // namespace

extern "C" int deepim_raster_cols(const void* params, const void* face_ids,
                                  const void* starts, const void* glob_col, void* rgb,
                                  void* depth, int B, int F, int H, int W, int n_ids,
                                  int n_glob, void* stream) {
  const int n_subs = (H + kSubH - 1) / kSubH;
  const int n_cols = (W + kColW - 1) / kColW;
  if (B > 0 && H > 0 && W > 0) {
    const dim3 grid(n_subs * n_cols, B);
    raster_cols_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(params), static_cast<const int*>(face_ids),
        static_cast<const int*>(starts), static_cast<const int*>(glob_col),
        static_cast<float*>(rgb), static_cast<float*>(depth), F, H, W, n_ids, n_glob,
        n_subs, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* deepim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
