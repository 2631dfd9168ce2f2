// Sorted raster kernel.
//
// Replaces the TPU kernel deepim_tpu/raster/raster_pallas.py
// §_raster_kernel_sorted (grid (sample, 32x256 tile), face by face through
// the tile's sorted range, then a global list of at most 128 faces).  Same
// function: each pixel walks its tile's range vals[starts[t]:starts[t+1]],
// then glob[1 : 1+glob[0]], and keeps the strict-'>' nearest face.  Binned
// by raster_cuda.py §bin_faces_sorted (row-major tile ids).  In the refine
// loop it renders crops of fewer than 1,024 faces and the cols path's
// lossless fallback (spans covering the whole tile grid).
//
// What bounds it on the card: ALU, as for the cols kernel: four plane
// evaluations per face and pixel (colour planes only on a win), plus 96
// bytes of params per face, which the block stages once in shared memory
// (raster_common.cuh §walk) and every thread reads by broadcast.
//
// Design: one block per (sample, 32x256 tile), 256x4 threads, 8 rows per
// thread, so each staged face serves 8192 pixels.  It walks exact ranges
// (none of the TPU kernel's SMEM id windows or DMA chunks), writes (H, W)
// with edge masks, launches on the caller's stream and allocates nothing.

#include "raster_common.cuh"

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 256;
constexpr int kThreadsY = 4;
constexpr int kRowsPerThread = kTileH / kThreadsY;

__global__ void __launch_bounds__(kTileW * kThreadsY)
raster_sorted_kernel(const float4* __restrict__ params, const int* __restrict__ vals,
                     const int* __restrict__ starts, const int* __restrict__ glob,
                     float* __restrict__ rgb, float* __restrict__ depth, int F, int H,
                     int W, int n_ids, int n_glob, int n_tx, int n_tiles) {
  __shared__ float4 stage[deepim::kStage * deepim::kParamVecs];
  const int b = blockIdx.y;
  const int t = blockIdx.x;  // row-major tile id
  const int x = (t % n_tx) * kTileW + threadIdx.x;
  const int row0 = (t / n_tx) * kTileH + threadIdx.y;
  const float px = (float)x + 0.5f;

  deepim::Pixels<kRowsPerThread> acc = {};
  const float4* p = params + (size_t)b * F * deepim::kParamVecs;
  const int* st = starts + (size_t)b * (n_tiles + 1);
  deepim::walk(p, vals + (size_t)b * n_ids, st[t], st[t + 1], stage, px, row0,
               kThreadsY, acc);
  // glob row: [count | ids ...]
  const int* g = glob + (size_t)b * n_glob;
  deepim::walk(p, g + 1, 0, g[0], stage, px, row0, kThreadsY, acc);
  deepim::store(acc, rgb, depth, b, H, W, x, row0, kThreadsY);
}

}  // namespace

extern "C" int deepim_raster_sorted(const void* params, const void* vals,
                                    const void* starts, const void* glob, void* rgb,
                                    void* depth, int B, int F, int H, int W, int n_ids,
                                    int n_glob, void* stream) {
  const int n_ty = (H + kTileH - 1) / kTileH;
  const int n_tx = (W + kTileW - 1) / kTileW;
  if (B > 0 && H > 0 && W > 0) {
    const dim3 grid(n_ty * n_tx, B);
    const dim3 block(kTileW, kThreadsY);
    raster_sorted_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(params), static_cast<const int*>(vals),
        static_cast<const int*>(starts), static_cast<const int*>(glob),
        static_cast<float*>(rgb), static_cast<float*>(depth), F, H, W, n_ids, n_glob,
        n_tx, n_ty * n_tx);
  }
  return static_cast<int>(cudaGetLastError());
}
