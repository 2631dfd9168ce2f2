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
// What bounds it on the card: ALU, as for the other two kernels: four plane
// evaluations per face and pixel (colour planes only on a win), plus 96
// bytes of params per listed face, which the block stages once in shared
// memory (raster_common.cuh §walk) and every thread reads by broadcast.
// Every tile walks its whole capped list, so a crowded tile costs up to K
// faces however few of them cover its pixels.
//
// Design: the sorted kernel's shape (one block per (sample, 32x256 tile),
// 256x4 threads, 8 rows per thread), walking the tile's list instead of a
// sorted range.  The count and ids come straight from the two binned arrays
// (no fused row, no DMA); it writes (H, W) with edge masks, launches on the
// caller's stream and allocates nothing.

#include "raster_common.cuh"

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 256;
constexpr int kThreadsY = 4;
constexpr int kRowsPerThread = kTileH / kThreadsY;

__global__ void __launch_bounds__(kTileW * kThreadsY)
raster_topk_kernel(const float4* __restrict__ params, const int* __restrict__ lists,
                   const int* __restrict__ counts, float* __restrict__ rgb,
                   float* __restrict__ depth, int F, int H, int W, int K, int n_tx,
                   int n_tiles) {
  __shared__ float4 stage[deepim::kStage * deepim::kParamVecs];
  const int b = blockIdx.y;
  const int t = blockIdx.x;  // row-major tile id
  const int x = (t % n_tx) * kTileW + threadIdx.x;
  const int row0 = (t / n_tx) * kTileH + threadIdx.y;
  const float px = (float)x + 0.5f;

  deepim::Pixels<kRowsPerThread> acc = {};
  const size_t row = (size_t)b * n_tiles + t;
  deepim::walk(params + (size_t)b * F * deepim::kParamVecs, lists + row * K, 0,
               __ldg(counts + row), stage, px, row0, kThreadsY, acc);
  deepim::store(acc, rgb, depth, b, H, W, x, row0, kThreadsY);
}

}  // namespace

extern "C" int deepim_raster_topk(const void* params, const void* lists,
                                  const void* counts, void* rgb, void* depth, int B,
                                  int F, int H, int W, int K, void* stream) {
  const int n_ty = (H + kTileH - 1) / kTileH;
  const int n_tx = (W + kTileW - 1) / kTileW;
  if (B > 0 && H > 0 && W > 0) {
    const dim3 grid(n_ty * n_tx, B);
    const dim3 block(kTileW, kThreadsY);
    raster_topk_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(params), static_cast<const int*>(lists),
        static_cast<const int*>(counts), static_cast<float*>(rgb),
        static_cast<float*>(depth), F, H, W, K, n_tx, n_ty * n_tx);
  }
  return static_cast<int>(cudaGetLastError());
}
