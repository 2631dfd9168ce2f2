// Top-k raster kernel.
//
// Replaces the TPU kernel deepim_tpu/raster/raster_pallas.py §_raster_kernel
// (grid (sample, 32x256 tile); each step DMAs its tile's row
// [count | ids ...] of a per-tile face list, capped at max_faces_per_tile,
// into SMEM and walks ids[0:count]).  Same function: each pixel walks its
// tile's list lists[t, 0:counts[t]] in order and keeps the strict-'>'
// nearest face.  Binned by raster_cuda.py §bin_faces_topk (row-major tile
// ids, first K incident faces in ascending id; the rest are dropped, as in
// the reference).  It carries binning="topk" of render_batch,
// render_batch_tri and render_batch_textured.
//
// What bounds it on the card: bytes (outputs, 16 bytes a pixel, and 48 + 36
// bytes a listed / winning face).  A crowded tile lists up to K faces
// however few of them reach a given pixel, so a walk of the whole list at
// all 8,192 pixels of the tile took 3-17 times the bound.  The kernel is now
// the sorted kernel's launch on a capped list: the shared walk,
// raster_common.cuh §culled_walk (per-warp cull by each plane's largest
// corner value, winner ids, cp.async double buffering), over
// lists[row*K : row*K + counts[row]] and no second list; blocks of 256
// threads own a 32x64 quarter of a tile, four an SM, each warp a 32x8
// rectangle, and a quarter past the image's right edge returns at once.
// Which faces a tile drops is the binning's; nothing of it changes here.
//
// The count and ids come straight from the two binned arrays (no fused row,
// no DMA); it writes (H, W) with edge masks, launches on the caller's stream
// and allocates nothing.

#include "raster_common.cuh"

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 256;
constexpr int kQuarterW = 64;                        // block width; 4 blocks a tile
constexpr int kWarpsX = kQuarterW / deepim::kWarpW;  // 2
constexpr int kWarpsY = kTileH / deepim::kRows;      // 4
constexpr int kThreads = 32 * kWarpsX * kWarpsY;     // 256
constexpr int kMinBlocks = 4;  // resident blocks an SM: at most 64 registers

__global__ void __launch_bounds__(kThreads, kMinBlocks)
raster_topk_kernel(const float4* __restrict__ params, const int* __restrict__ lists,
                   const int* __restrict__ counts, float* __restrict__ rgb,
                   float* __restrict__ depth, int F, int H, int W, int K, int n_tx,
                   int n_tiles) {
  __shared__ deepim::Stage stage;
  const int b = blockIdx.y;
  const int t = blockIdx.x / 4;  // row-major tile id
  const int x0 = (t % n_tx) * kTileW + (blockIdx.x % 4) * kQuarterW;
  if (x0 >= W) return;  // the whole block: before any barrier
  const int warp = threadIdx.x >> 5;
  const deepim::WarpRect w = deepim::warp_rect(
      x0 + (warp % kWarpsX) * deepim::kWarpW,
      (t / n_tx) * kTileH + (warp / kWarpsX) * deepim::kRows, threadIdx.x & 31, H, W);

  const float4* p = params + (size_t)b * F * deepim::kParamVecs;
  const size_t row = (size_t)b * n_tiles + t;
  float zbuf[deepim::kRows] = {};
  int win[deepim::kRows] = {};
  deepim::culled_walk<kThreads>(p, lists + row * K, __ldg(counts + row), nullptr, 0, stage,
                                w, zbuf, win);
  deepim::shade_store(p, zbuf, win, w, rgb, depth, b, H, W);
}

}  // namespace

extern "C" int deepim_raster_topk(const void* params, const void* lists,
                                  const void* counts, void* rgb, void* depth, int B,
                                  int F, int H, int W, int K, void* stream) {
  const int n_ty = (H + kTileH - 1) / kTileH;
  const int n_tx = (W + kTileW - 1) / kTileW;
  if (B > 0 && H > 0 && W > 0) {
    const dim3 grid(4 * n_ty * n_tx, B);
    raster_topk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(params), static_cast<const int*>(lists),
        static_cast<const int*>(counts), static_cast<float*>(rgb),
        static_cast<float*>(depth), F, H, W, K, n_tx, n_ty * n_tx);
  }
  return static_cast<int>(cudaGetLastError());
}
