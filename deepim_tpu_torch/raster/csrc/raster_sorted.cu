// Sorted raster kernel.
//
// Replaces the TPU kernel deepim_tpu/raster/raster_pallas.py
// §_raster_kernel_sorted (grid (sample, 32x256 tile), face by face through
// the tile's sorted range, then a global list of at most 128 faces).  Same
// function: each pixel walks its tile's range vals[starts[t]:starts[t+1]],
// then glob[1 : 1+glob[0]], and keeps the strict-'>' nearest face.  Binned
// by raster_cuda.py §bin_faces_sorted (row-major tile ids).  It renders the
// crops of assets under 1,024 faces (and the coarse level of larger ones),
// the scene of synthetic_occlusion_batch, and the cols path's lossless
// fallback (spans covering the whole tile grid).
//
// What bounds it on the card: bytes (outputs, 16 bytes a pixel, and 48 + 36
// bytes a listed / winning face).  Its walk is the one all three kernels
// share, raster_common.cuh §culled_walk (per-warp cull by each plane's
// largest corner value, winner ids, cp.async double buffering), over the
// tile's range followed by the global list as one sequence of rounds.
//
// Its own part is the block shape: small blocks, four per SM.  256 threads
// own a 32x64 quarter of a tile, each warp a 32x8 rectangle; the four
// quarters walk the same range (the repeated param reads hit L2), and a
// quarter past the image's right edge returns at once.
//
// It writes (H, W) with edge masks, launches on the caller's stream and
// allocates nothing.

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
raster_sorted_kernel(const float4* __restrict__ params, const int* __restrict__ vals,
                     const int* __restrict__ starts, const int* __restrict__ glob,
                     float* __restrict__ rgb, float* __restrict__ depth, int F, int H,
                     int W, int n_ids, int n_glob, int n_tx, int n_tiles) {
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
  const int* st = starts + (size_t)b * (n_tiles + 1);
  const int n1 = st[t + 1] - st[t];
  const int* g = glob + (size_t)b * n_glob;  // [count | ids ...]
  float zbuf[deepim::kRows] = {};
  int win[deepim::kRows] = {};
  deepim::culled_walk<kThreads>(p, vals + (size_t)b * n_ids + st[t], n1, g + 1, g[0],
                                stage, w, zbuf, win);
  deepim::shade_store(p, zbuf, win, w, rgb, depth, b, H, W);
}

}  // namespace

extern "C" int deepim_raster_sorted(const void* params, const void* vals,
                                    const void* starts, const void* glob, void* rgb,
                                    void* depth, int B, int F, int H, int W, int n_ids,
                                    int n_glob, void* stream) {
  const int n_ty = (H + kTileH - 1) / kTileH;
  const int n_tx = (W + kTileW - 1) / kTileW;
  if (B > 0 && H > 0 && W > 0) {
    const dim3 grid(4 * n_ty * n_tx, B);
    raster_sorted_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(params), static_cast<const int*>(vals),
        static_cast<const int*>(starts), static_cast<const int*>(glob),
        static_cast<float*>(rgb), static_cast<float*>(depth), F, H, W, n_ids, n_glob,
        n_tx, n_ty * n_tx);
  }
  return static_cast<int>(cudaGetLastError());
}
