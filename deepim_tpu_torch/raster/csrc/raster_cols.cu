// Cols raster kernel.
//
// Replaces the TPU kernel deepim_tpu/raster/raster_pallas.py
// §_raster_kernel_cols (grid (sample, 128-px column), 8-face blocks over the
// column's 8x128 sub-tiles).  Same function: each pixel walks its 8x128
// sub-tile's sorted face range, then its column's global list, and keeps the
// strict-'>' nearest face.  Binned by raster_cuda.py §bin_faces_packed
// (column-major tile ids: t = column * n_subs + sub-tile row).
//
// What bounds it on the card: ALU.  Per face and pixel it evaluates four
// planes (3 barycentric + inverse depth; the 3 colour planes only when the
// face wins), ~20 float ops, plus the face's 96 bytes of params.  The params
// are read once per block through shared memory (raster_common.cuh §walk),
// so a pixel's cost is its list length times those plane evaluations; the
// design keeps the inner loop free of global loads and of per-pixel branches
// other than the coverage/depth test.
//
// Design: one block per (sample, 8x128 sub-tile), 128x2 threads, 4 rows per
// thread (one pixel column), so each face's params are read from shared
// memory once per 4 pixels.  It walks exact ranges: none of the TPU kernel's
// SMEM id windows, DMA rounds, 8-face block padding or tail re-evaluations,
// and it writes (H, W) directly with edge masks (no padding to 8/128).
// It launches on the caller's stream and allocates nothing.

#include "raster_common.cuh"

namespace {

constexpr int kSubH = 8;
constexpr int kColW = 128;
constexpr int kRowsPerThread = 4;
constexpr int kThreadsY = kSubH / kRowsPerThread;

__global__ void __launch_bounds__(kColW * kThreadsY)
raster_cols_kernel(const float4* __restrict__ params, const int* __restrict__ face_ids,
                   const int* __restrict__ starts, const int* __restrict__ glob_col,
                   float* __restrict__ rgb, float* __restrict__ depth, int F, int H,
                   int W, int n_ids, int n_glob, int n_subs, int n_cols) {
  __shared__ float4 stage[deepim::kStage * deepim::kParamVecs];
  const int b = blockIdx.y;
  const int t = blockIdx.x;  // column-major sub-tile id
  const int xi = t / n_subs;
  const int x = xi * kColW + threadIdx.x;
  const int row0 = (t % n_subs) * kSubH + threadIdx.y;
  const float px = (float)x + 0.5f;

  deepim::Pixels<kRowsPerThread> acc = {};
  const float4* p = params + (size_t)b * F * deepim::kParamVecs;
  const int* st = starts + (size_t)b * (n_subs * n_cols + 1);
  deepim::walk(p, face_ids + (size_t)b * n_ids, st[t], st[t + 1], stage, px, row0,
               kThreadsY, acc);
  // glob_col row: [gstarts (n_cols+1) | ids ... ]
  const int* g = glob_col + (size_t)b * n_glob;
  deepim::walk(p, g + n_cols + 1, g[xi], g[xi + 1], stage, px, row0, kThreadsY, acc);
  deepim::store(acc, rgb, depth, b, H, W, x, row0, kThreadsY);
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
    const dim3 block(kColW, kThreadsY);
    raster_cols_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
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
