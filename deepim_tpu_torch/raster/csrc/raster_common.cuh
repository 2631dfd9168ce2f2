// Device code shared by the three raster kernels (raster_cols.cu,
// raster_sorted.cu, raster_topk.cu).  Face parameter layout, 24 floats per
// face, as packed by raster_cuda.py §_plane_pack:
//   [A0 B0 C0 | A1 B1 C1 | A2 B2 C2 | az bz cz | ar br cr | ag bg cg | ab bb cb | 0 0 0]
// Each triple is a screen-space plane a*x + b*y + c: three barycentrics, the
// inverse depth, and three perspective-correct colour numerators.
#pragma once

#include <cuda_runtime.h>

namespace deepim {

constexpr int kParamVecs = 6;  // 24 floats = 6 float4 per face
constexpr int kStage = 128;    // faces staged in shared memory per round

// a*x + b*y + c with every operation rounded (no FMA contraction), in the
// order the plain PyTorch version evaluates it, so kernel and plain version
// agree bit for bit.
__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// Depth/colour accumulators of the R pixels one thread owns.
template <int R>
struct Pixels {
  float z[R];
  float r[R];
  float g[R];
  float b[R];
};

// Depth-test the faces ids[s:e) (rows of this sample's params) against the
// thread's R pixels at column px and rows row0 + k*rstep.  Faces go through
// shared memory kStage at a time: the block loads their params with
// coalesced float4 reads, then every thread walks them with broadcast
// shared-memory reads.  s and e must be the same for the whole block (the
// walk synchronises it).  Strict '>' keeps the first face, in list order,
// with the largest inverse depth.  The cols and top-k kernels walk this
// way; the sorted kernel has its own per-warp culled walk.
template <int R>
__device__ void walk(const float4* __restrict__ params, const int* __restrict__ ids,
                     int s, int e, float4* stage, float px, int row0, int rstep,
                     Pixels<R>& acc) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int c = s; c < e; c += kStage) {
    const int n = min(kStage, e - c);
    __syncthreads();  // the previous round's faces are consumed
    for (int i = tid; i < n * kParamVecs; i += nthreads) {
      const int f = __ldg(ids + c + i / kParamVecs);
      stage[i] = __ldg(params + (size_t)f * kParamVecs + i % kParamVecs);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4* q = stage + j * kParamVecs;
      const float4 p0 = q[0], p1 = q[1], p2 = q[2];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float py = (float)(row0 + k * rstep) + 0.5f;
        const float l0 = plane(p0.x, p0.y, p0.z, px, py);
        const float l1 = plane(p0.w, p1.x, p1.y, px, py);
        const float l2 = plane(p1.z, p1.w, p2.x, px, py);
        const float iz = plane(p2.y, p2.z, p2.w, px, py);
        if (l0 >= 0.f && l1 >= 0.f && l2 >= 0.f && iz > acc.z[k]) {
          const float4 p3 = q[3], p4 = q[4], p5 = q[5];
          acc.z[k] = iz;
          acc.r[k] = plane(p3.x, p3.y, p3.z, px, py);
          acc.g[k] = plane(p3.w, p4.x, p4.y, px, py);
          acc.b[k] = plane(p4.z, p4.w, p5.x, px, py);
        }
      }
    }
  }
}

// One divide per pixel: depth = 1/z where z > 0 (else 0 = background),
// rgb = numerators / z.  Writes (B, 3, H, W) rgb and (B, H, W) depth with
// edge masks (a tile may overhang the image).
template <int R>
__device__ void store(const Pixels<R>& acc, float* __restrict__ rgb,
                      float* __restrict__ depth, int b, int H, int W, int x,
                      int row0, int rstep) {
  if (x >= W) return;
  const size_t hw = (size_t)H * W;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int y = row0 + k * rstep;
    if (y < H) {
      const float inv = 1.0f / fmaxf(acc.z[k], 1e-9f);
      const size_t o = (size_t)y * W + x;
      depth[b * hw + o] = acc.z[k] > 0.f ? inv : 0.f;
      float* out = rgb + 3 * b * hw + o;
      out[0] = acc.r[k] * inv;
      out[hw] = acc.g[k] * inv;
      out[2 * hw] = acc.b[k] * inv;
    }
  }
}

}  // namespace deepim
