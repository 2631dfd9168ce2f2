// Device code shared by the three raster kernels (raster_cols.cu,
// raster_sorted.cu, raster_topk.cu): the culled, pipelined walk that all
// three run, each over its own face lists.  Together they replace the TPU
// kernels of deepim_tpu/raster/raster_pallas.py (§_raster_kernel_cols,
// §_raster_kernel_sorted, §_raster_kernel).
//
// Face parameter layout, 24 floats per face, as packed by raster_cuda.py
// §_plane_pack:
//   [A0 B0 C0 | A1 B1 C1 | A2 B2 C2 | az bz cz | ar br cr | ag bg cg | ab bb cb | 0 0 0]
// Each triple is a screen-space plane a*x + b*y + c: three barycentrics, the
// inverse depth, and three perspective-correct colour numerators.
//
// What bounds the kernels on the card: bytes.  The outputs (16 bytes a
// pixel), the coverage and depth planes of each listed face (48 bytes) and
// the colour planes of each winning face (36 bytes) are the least a call
// must move; its plane work (16 float ops per pixel centre inside a listed
// face's bbox) is an order of magnitude below that.  A walk that evaluates
// every listed face at every pixel of its tile does far more plane work
// than that, most of it far from the face, and a walk that waits for each
// round of its lists before it starts on it leaves the memory system idle.
// So the walk spends its effort on neither:
//
// 1. Per-warp cull.  Each warp owns a 32x8 rectangle of pixels, 8 rows a
//    thread.  After a round of faces lands in shared memory, each lane
//    tests faces lane, lane+32, ... against the rectangle (clipped to the
//    image), and __ballot_sync gathers a mask that the warp walks in
//    ascending list order.  The test evaluates each of the face's four
//    planes, with the same rounded operations as the walk, at the
//    rectangle's corner where the plane is largest: a rounded a*x + b*y + c
//    is monotone in x and in y, so that corner bounds the plane over every
//    pixel of the rectangle.  A face is skipped only if some barycentric is
//    negative, or the inverse depth is not positive, at every pixel, so it
//    covers or wins none of them, and the strict '>' resolves exactly as a
//    full walk would.  (The face bbox is no such bound: under rounding a
//    sliver can cover pixels well outside it; tests/test_torch_raster.py
//    pins both facts.)  A warp wholly outside the image skips every face.
//    (Culling and walking in four 8x8 units a warp, each unit's lanes on
//    that unit's own next hit, gained 8 % on the top-k kernel's crowded
//    tiles and cost the sorted and cols kernels 4-10 %, with 28 bytes of
//    spill, on an H100 at 700 W: dropped.)
// 2. Winner ids.  The walk keeps each pixel's inverse depth and winning
//    face id only (64 registers, no spill); the winner's three colour
//    planes are read once per covered pixel at the end (from L2) and
//    evaluated with the same rounded operations.
// 3. Pipelined staging.  Two shared buffers of 128 faces (the 48 bytes of
//    coverage and depth planes a face, and its id); cp.async fills round
//    r+1 (the dependent ids -> params gather) while round r is culled and
//    walked.  A first id range and a second one (a tile's range and a global
//    list) are one sequence of rounds, so the second is in flight while the
//    first is walked.  A round's ids are read at the head of its fetch; a
//    third stage that brought them in a round earlier (cp.async of 4 bytes
//    into a ring of three id buffers) gained 0-4 % on the cols kernel's
//    long lists and cost the sorted kernel 7 % on crops (16 bytes of
//    spill) on an H100 at 700 W, so there is none.
//
// cp.async or a bulk copy (TMA)?  The staging is a gather of 48-byte rows
// through an id list, not a tile: the tensor-map form of TMA has no row
// gather on this card, and its plain bulk form (cp.async.bulk, one 48-byte
// copy a face, completion on an mbarrier) would still be started by a thread
// that has just loaded the face's id, so the dependent ids -> params chain,
// stays as long.  A round is 384 copies of 16 bytes over the block's 128 or
// 256 threads, at most three a thread; there is no address arithmetic or
// register pressure for a bulk copy to take away.  cp.async (16 bytes a
// thread, .cg: L2 only, the rows are read once a block) serves it; a bulk
// copy was not measured.  Tensor cores have no work here: four fp32 planes
// a pixel, whose rounding order is fixed by the plain version.
#pragma once

#include <cuda_runtime.h>

namespace deepim {

constexpr int kParamVecs = 6;  // 24 floats = 6 float4 per face
constexpr int kWalkVecs = 3;   // of which the coverage and depth planes
constexpr int kStage = 128;    // faces staged in shared memory per round
constexpr int kStageVecs = kStage * kWalkVecs;
constexpr int kWarpW = 32;     // a warp's rectangle: 32 x kRows pixels
constexpr int kRows = 8;       // rows a thread owns

// a*x + b*y + c with every operation rounded (no FMA contraction), in the
// order the plain PyTorch version evaluates it, so kernel and plain version
// agree bit for bit.
__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// The largest value the rounded plane takes over pixel centres [xl, xh] x
// [yl, yh]: monotone in each coordinate, so it is at one corner.
__device__ __forceinline__ float plane_max(float a, float b, float c, float xl,
                                           float xh, float yl, float yh) {
  return plane(a, b, c, a >= 0.f ? xh : xl, b >= 0.f ? yh : yl);
}

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

// A block's two staging buffers: the coverage and depth planes of a round's
// faces, and their ids.
struct Stage {
  float4 planes[2][kStageVecs];
  int id[2][kStage];
};

// A warp's 32 x kRows rectangle and the lane's pixel column in it.
struct WarpRect {
  int x, yl;  // the lane's column; the rectangle's first row
  float px;   // the column's pixel centre
  bool live;  // some pixel of the rectangle is in the image
  float cxl, cxh, cyl, cyh;  // its pixel centres, clipped to the image
};

__device__ __forceinline__ WarpRect warp_rect(int xl, int yl, int lane, int H, int W) {
  WarpRect w;
  w.x = xl + lane;
  w.yl = yl;
  w.px = (float)w.x + 0.5f;
  w.live = xl < W && yl < H;
  w.cxl = (float)xl + 0.5f;
  w.cxh = (float)min(xl + kWarpW - 1, W - 1) + 0.5f;
  w.cyl = (float)yl + 0.5f;
  w.cyh = (float)min(yl + kRows - 1, H - 1) + 0.5f;
  return w;
}

// Depth-test the faces ids1[0:n1) ++ ids2[0:n2) (rows of this sample's
// params p), in that order, against the warp's rectangle: zbuf/win take
// each row's winning inverse depth (0 = background) and face.  Strict '>'
// keeps the first face, in list order, with the largest inverse depth.
//
// The whole block (kThreads threads, one dimension) must call it with the
// same lists: it stages them in rounds and synchronises.  No rounds at all
// leave zbuf at 0.
template <int kThreads>
__device__ __forceinline__ void culled_walk(const float4* __restrict__ p,
                                            const int* __restrict__ ids1, int n1,
                                            const int* __restrict__ ids2, int n2,
                                            Stage& s, const WarpRect& w,
                                            float (&zbuf)[kRows], int (&win)[kRows]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int total = n1 + n2;
  const int rounds = (total + kStage - 1) / kStage;

  // Round r (faces r*128 ... of the first list ++ the second) into buffer
  // r & 1: each face's three coverage/depth float4 by cp.async, and its id.
  auto fetch = [&](int r) {
    const int c = r * kStage;
    const int n = min(kStage, total - c);
    for (int i = tid; i < n * kWalkVecs; i += kThreads) {
      const int j = i / kWalkVecs;
      const int f = __ldg(c + j < n1 ? ids1 + c + j : ids2 + (c + j - n1));
      cp_async16(&s.planes[r & 1][i], p + (size_t)f * kParamVecs + i % kWalkVecs);
      if (i % kWalkVecs == 0) s.id[r & 1][j] = f;
    }
    cp_async_commit();
  };

  if (rounds > 0) fetch(0);
  for (int r = 0; r < rounds; ++r) {
    if (r + 1 < rounds) {
      fetch(r + 1);
      cp_async_wait<1>();  // round r has landed (this thread's copies)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and every thread's
    const int n = min(kStage, total - r * kStage);
    const float4* sb = s.planes[r & 1];
    for (int q = 0; w.live && q * 32 < n; ++q) {
      const int j = q * 32 + lane;
      bool hit = false;
      if (j < n) {
        const float4 p0 = sb[j * kWalkVecs], p1 = sb[j * kWalkVecs + 1],
                     p2 = sb[j * kWalkVecs + 2];
        hit = plane_max(p0.x, p0.y, p0.z, w.cxl, w.cxh, w.cyl, w.cyh) >= 0.f &&
              plane_max(p0.w, p1.x, p1.y, w.cxl, w.cxh, w.cyl, w.cyh) >= 0.f &&
              plane_max(p1.z, p1.w, p2.x, w.cxl, w.cxh, w.cyl, w.cyh) >= 0.f &&
              plane_max(p2.y, p2.z, p2.w, w.cxl, w.cxh, w.cyl, w.cyh) > 0.f;
      }
      for (unsigned m = __ballot_sync(0xffffffffu, hit); m; m &= m - 1) {
        const int jj = q * 32 + __ffs(m) - 1;
        const float4 p0 = sb[jj * kWalkVecs], p1 = sb[jj * kWalkVecs + 1],
                     p2 = sb[jj * kWalkVecs + 2];
        const int f = s.id[r & 1][jj];
        // a*x rounds the same for every row: take it once.
        const float ax0 = __fmul_rn(p0.x, w.px), ax1 = __fmul_rn(p0.w, w.px);
        const float ax2 = __fmul_rn(p1.z, w.px), axz = __fmul_rn(p2.y, w.px);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float py = (float)(w.yl + k) + 0.5f;
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
}

// The winners' colour planes, read once per covered pixel (L2), then one
// divide per pixel: depth = 1/z where z > 0 (else 0 = background), rgb =
// numerators / z.  Writes (B, 3, H, W) rgb and (B, H, W) depth with edge
// masks (a rectangle may overhang the image).
__device__ __forceinline__ void shade_store(const float4* __restrict__ p,
                                            const float (&zbuf)[kRows],
                                            const int (&win)[kRows], const WarpRect& w,
                                            float* __restrict__ rgb,
                                            float* __restrict__ depth, int b, int H,
                                            int W) {
  float r[kRows] = {}, g[kRows] = {}, bl[kRows] = {};
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (zbuf[k] > 0.f) {
      const float py = (float)(w.yl + k) + 0.5f;
      const float4* q = p + (size_t)win[k] * kParamVecs;
      const float4 p3 = __ldg(q + 3), p4 = __ldg(q + 4), p5 = __ldg(q + 5);
      r[k] = plane(p3.x, p3.y, p3.z, w.px, py);
      g[k] = plane(p3.w, p4.x, p4.y, w.px, py);
      bl[k] = plane(p4.z, p4.w, p5.x, w.px, py);
    }
  }
  if (w.x >= W) return;
  const size_t hw = (size_t)H * W;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = w.yl + k;
    if (y < H) {
      const float inv = 1.0f / fmaxf(zbuf[k], 1e-9f);
      const size_t o = (size_t)y * W + w.x;
      depth[b * hw + o] = zbuf[k] > 0.f ? inv : 0.f;
      float* out = rgb + 3 * b * hw + o;
      out[0] = r[k] * inv;
      out[hw] = g[k] * inv;
      out[2 * hw] = bl[k] * inv;
    }
  }
}

}  // namespace deepim
