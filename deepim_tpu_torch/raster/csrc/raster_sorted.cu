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
// What bounds it on the card: bytes.  The outputs (16 bytes a pixel) and
// the params (96 bytes a face) are the least it must move; the plane work
// it must do (16 float ops per pixel centre inside a listed face's bbox)
// is an order of magnitude below that.  A tile-wide walk evaluates every
// listed face at all 8,192 pixels of its tile, most of them far from the
// face, so the design spends its effort on not doing that:
//
// 1. Per-warp cull.  Each warp owns a 32x8 rectangle of pixels.  After a
//    round of faces lands in shared memory, each lane tests faces lane,
//    lane+32, ... against the rectangle (clipped to the image), and
//    __ballot_sync gathers a mask that the warp walks in ascending order.
//    The test evaluates each of the face's four planes, with the same
//    rounded operations as the walk, at the rectangle's corner where the
//    plane is largest: a rounded a*x + b*y + c is monotone in x and in y,
//    so that corner bounds the plane over every pixel of the rectangle.  A
//    face is skipped only if some barycentric is negative, or the inverse
//    depth is not positive, at every pixel, so it covers or wins none of
//    them, and the strict '>' resolves exactly as a full walk would.  (The
//    face bbox is no such bound: under rounding a sliver can cover pixels
//    well outside it; tests/test_torch_raster.py pins both facts.)  A warp
//    wholly outside the image skips every face.
// 2. Small blocks, four per SM: 256 threads own a 32x64 quarter of a
//    tile, 8 rows a thread; the four quarters walk the same range (the
//    repeated param reads hit L2), and a quarter past the image's right
//    edge returns at once.  To fit 64 registers with no spill, the walk
//    keeps each pixel's inverse depth and winning face id only; the
//    winner's three colour planes are read once per covered pixel at the
//    end (from L2) and evaluated with the same rounded operations.
// 3. Pipelined staging: two shared buffers of 128 faces (the 48 bytes of
//    coverage and depth planes a face, and its id); cp.async fills round
//    r+1 (the dependent ids -> params gather) while round r is culled and
//    walked.  The tile range and the global list are one sequence of
//    rounds.
//
// It writes (H, W) with edge masks, launches on the caller's stream and
// allocates nothing.

#include "raster_common.cuh"

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 256;
constexpr int kQuarterW = 64;                 // block width; 4 blocks a tile
constexpr int kWarpW = 32;                    // a warp's rectangle: 32 x kRows
constexpr int kRows = 8;                      // rows a thread owns
constexpr int kWarpsX = kQuarterW / kWarpW;   // 2
constexpr int kWarpsY = kTileH / kRows;       // 4
constexpr int kThreads = 32 * kWarpsX * kWarpsY;  // 256
constexpr int kWalkVecs = 3;  // float4 of the coverage and depth planes a face
constexpr int kStageVecs = deepim::kStage * kWalkVecs;
constexpr int kMinBlocks = 4;  // resident blocks an SM: at most 64 registers

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The largest value the rounded plane takes over pixel centres [xl, xh] x
// [yl, yh]: monotone in each coordinate, so it is at one corner.
__device__ __forceinline__ float plane_max(float a, float b, float c, float xl,
                                           float xh, float yl, float yh) {
  return deepim::plane(a, b, c, a >= 0.f ? xh : xl, b >= 0.f ? yh : yl);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
raster_sorted_kernel(const float4* __restrict__ params, const int* __restrict__ vals,
                     const int* __restrict__ starts, const int* __restrict__ glob,
                     float* __restrict__ rgb, float* __restrict__ depth, int F, int H,
                     int W, int n_ids, int n_glob, int n_tx, int n_tiles) {
  __shared__ float4 stage[2][kStageVecs];   // planes of 128 faces, two rounds
  __shared__ int stage_id[2][deepim::kStage];  // and their face ids
  const int b = blockIdx.y;
  const int t = blockIdx.x / 4;  // row-major tile id
  const int x0 = (t % n_tx) * kTileW + (blockIdx.x % 4) * kQuarterW;
  if (x0 >= W) return;  // the whole block: before any barrier
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int xl = x0 + (warp % kWarpsX) * kWarpW;
  const int yl = (t / n_tx) * kTileH + (warp / kWarpsX) * kRows;
  const int x = xl + lane;
  const float px = (float)x + 0.5f;
  // The warp's rectangle of pixel centres, clipped to the image.
  const bool live = xl < W && yl < H;
  const float cxl = (float)xl + 0.5f, cxh = (float)min(xl + kWarpW - 1, W - 1) + 0.5f;
  const float cyl = (float)yl + 0.5f, cyh = (float)min(yl + kRows - 1, H - 1) + 0.5f;

  const float4* p = params + (size_t)b * F * deepim::kParamVecs;
  const int* st = starts + (size_t)b * (n_tiles + 1);
  const int* ids1 = vals + (size_t)b * n_ids + st[t];
  const int n1 = st[t + 1] - st[t];
  const int* g = glob + (size_t)b * n_glob;  // [count | ids ...]
  const int total = n1 + g[0];
  const int rounds = (total + deepim::kStage - 1) / deepim::kStage;

  // Round r (faces r*128 ... of the tile range ++ the global list) into
  // buffer r & 1: each face's three coverage/depth float4 by cp.async, and
  // its id.
  auto fetch = [&](int r) {
    const int c = r * deepim::kStage;
    const int n = min(deepim::kStage, total - c);
    for (int i = tid; i < n * kWalkVecs; i += kThreads) {
      const int j = i / kWalkVecs;
      const int f = __ldg(c + j < n1 ? ids1 + c + j : g + 1 + (c + j - n1));
      cp_async16(&stage[r & 1][i], p + (size_t)f * deepim::kParamVecs + i % kWalkVecs);
      if (i % kWalkVecs == 0) stage_id[r & 1][j] = f;
    }
    cp_async_commit();
  };

  // Per row: the winning inverse depth and face; colours at the end.
  float zbuf[kRows] = {};
  int win[kRows] = {};
  if (rounds > 0) fetch(0);
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds) {
      fetch(r + 1);
      cp_async_wait<1>();  // round r has landed (this thread's copies)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and every thread's
    const int n = min(deepim::kStage, total - r * deepim::kStage);
    const float4* sb = stage[r & 1];
    for (int q = 0; live && q * 32 < n; ++q) {
      const int j = q * 32 + lane;
      bool hit = false;
      if (j < n) {
        const float4 p0 = sb[j * kWalkVecs], p1 = sb[j * kWalkVecs + 1],
                     p2 = sb[j * kWalkVecs + 2];
        hit = plane_max(p0.x, p0.y, p0.z, cxl, cxh, cyl, cyh) >= 0.f &&
              plane_max(p0.w, p1.x, p1.y, cxl, cxh, cyl, cyh) >= 0.f &&
              plane_max(p1.z, p1.w, p2.x, cxl, cxh, cyl, cyh) >= 0.f &&
              plane_max(p2.y, p2.z, p2.w, cxl, cxh, cyl, cyh) > 0.f;
      }
      for (unsigned m = __ballot_sync(0xffffffffu, hit); m; m &= m - 1) {
        const int jj = q * 32 + __ffs(m) - 1;
        const float4 p0 = sb[jj * kWalkVecs], p1 = sb[jj * kWalkVecs + 1],
                     p2 = sb[jj * kWalkVecs + 2];
        const int f = stage_id[r & 1][jj];
        // a*x rounds the same for every row: take it once.
        const float ax0 = __fmul_rn(p0.x, px), ax1 = __fmul_rn(p0.w, px);
        const float ax2 = __fmul_rn(p1.z, px), axz = __fmul_rn(p2.y, px);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float py = (float)(yl + k) + 0.5f;
          const float l0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(p0.y, py)), p0.z);
          const float l1 = __fadd_rn(__fadd_rn(ax1, __fmul_rn(p1.x, py)), p1.y);
          const float l2 = __fadd_rn(__fadd_rn(ax2, __fmul_rn(p1.w, py)), p2.x);
          const float iz = __fadd_rn(__fadd_rn(axz, __fmul_rn(p2.z, py)), p2.w);
          if (l0 >= 0.f && l1 >= 0.f && l2 >= 0.f && iz > zbuf[k]) {
            zbuf[k] = iz;
            win[k] = f;
          }
        }
      }
    }
    __syncthreads();  // buffer r & 1 is free for round r + 2
  }
  // The winners' colour planes, read once per covered pixel (L2).
  deepim::Pixels<kRows> acc = {};
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    acc.z[k] = zbuf[k];
    if (zbuf[k] > 0.f) {
      const float py = (float)(yl + k) + 0.5f;
      const float4* q = p + (size_t)win[k] * deepim::kParamVecs;
      const float4 p3 = __ldg(q + 3), p4 = __ldg(q + 4), p5 = __ldg(q + 5);
      acc.r[k] = deepim::plane(p3.x, p3.y, p3.z, px, py);
      acc.g[k] = deepim::plane(p3.w, p4.x, p4.y, px, py);
      acc.b[k] = deepim::plane(p4.z, p4.w, p5.x, px, py);
    }
  }
  deepim::store(acc, rgb, depth, b, H, W, x, yl, 1);
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
