// K4: 3D capsule voxelizer for Hopper (sm_90a).
//
// Replaces the TPU kernel octa_tpu/ops/pallas_splat.py:222
// (_splat3d_tile_kernel) behind splat_capsules_3d_pallas (:284). For every
// voxel v of an [X, Y, Z] volume (centre c = v + 0.5) and every valid edge
// (a, b, r) whose voxel-index bbox
//     [floor(min(a, b) - r*sqrt2), ceil(max(a, b) + r*sqrt2 + 1))
// holds v on all three axes:
//     d0 = c - a, s = b - a, t = (d0 . s) / max(|s|^2, 1e-12)
//     d_end  = min(|c - a|, |c - b|)
//     d_orth = |d0 - t s|
//     contrib = 1 - (d - (r - sqrt3/2)) / sqrt3, taken at d_end, and where
//               0 < t < 1 the larger of that and the value at d_orth
// and the output is clip(max over edges, 0, 1). The bbox is tested on the
// voxel index, not the centre; an edge whose bbox misses the volume, or an
// invalid edge, contributes nothing; max(., 1e-12) guards a zero-length edge.
//
// Every product, sum and difference is rounded on its own (__fmul_rn and
// friends keep the compiler from contracting them into fused multiply-adds)
// and taken in the order the plain PyTorch version takes them; the division
// and the square roots are IEEE-rounded (no fast-math flag). The distance is
// taken relative to a (d0 - t s), never as c - (a + t s): near coordinate
// 1000 the latter rounds by 1.2e-4.
//
// Design: scatter, one block per edge. Vessel segments are a few voxels long,
// so an edge's bbox is small against the 78 M-voxel volume at (1216, 1216,
// 53): the work is the sum of the bbox volumes, not voxels x edges per tile.
// The block walks its edge's own bbox (clipped to the volume), z fastest so
// that neighbouring threads touch neighbouring addresses, and merges with an
// atomic max. Since clip(max(-inf, c...), 0, 1) = min(1, max(0, c...)), the
// volume starts at 0, only contributions above 0 are written, and a
// non-negative float orders as its bit pattern: atomicMax on int. Max is
// order-free, so the result is exact and the same from run to run. There is
// no binning, no per-tile edge limit and so no overflow rule: every edge
// counts, which is what the tiled versions give when no tile overflows.
//
// What bounds it: bytes at the main path's shape, the one write of the 313 MB
// volume (the wrapper's zero fill), against about 50 float operations per
// (voxel, edge) pair inside the bboxes (18-28 M pairs for one tree); on a
// small volume with many edges the operations take over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSqrt2 = 1.41421356237309515f;
constexpr float kDiag = 1.73205080756887719f;
constexpr float kHalfDiag = 0.86602540378443860f;

// v is integral (a floor or a ceil) and may be far outside [0, n]
__device__ __forceinline__ int clamp_index(float v, int n) {
  return (int)fminf(fmaxf(v, 0.0f), (float)n);
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(kThreads)
splat3d_kernel(const float* __restrict__ a,       // [E, 3] voxel coordinates
               const float* __restrict__ b,       // [E, 3]
               const float* __restrict__ radius,  // [E] voxels
               const uint8_t* __restrict__ valid, // [E] bool
               int* __restrict__ vol,             // [X, Y, Z] float bits, >= 0
               int X, int Y, int Z) {
  const int e = blockIdx.x;
  if (!valid[e]) return;
  const float ax = a[3 * e], ay = a[3 * e + 1], az = a[3 * e + 2];
  const float bx = b[3 * e], by = b[3 * e + 1], bz = b[3 * e + 2];
  const float r = radius[e];
  const float off = __fmul_rn(r, kSqrt2);

  const int x0 = clamp_index(floorf(__fsub_rn(fminf(ax, bx), off)), X);
  const int y0 = clamp_index(floorf(__fsub_rn(fminf(ay, by), off)), Y);
  const int z0 = clamp_index(floorf(__fsub_rn(fminf(az, bz), off)), Z);
  const int x1 = clamp_index(
      ceilf(__fadd_rn(__fadd_rn(fmaxf(ax, bx), off), 1.0f)), X);
  const int y1 = clamp_index(
      ceilf(__fadd_rn(__fadd_rn(fmaxf(ay, by), off), 1.0f)), Y);
  const int z1 = clamp_index(
      ceilf(__fadd_rn(__fadd_rn(fmaxf(az, bz), off), 1.0f)), Z);
  const int nx = x1 - x0, ny = y1 - y0, nz = z1 - z0;
  if (nx <= 0 || ny <= 0 || nz <= 0) return;

  const float sx = __fsub_rn(bx, ax), sy = __fsub_rn(by, ay),
              sz = __fsub_rn(bz, az);
  const float invd = 1.0f / fmaxf(dot3(sx, sy, sz, sx, sy, sz), 1e-12f);
  const float base = __fsub_rn(r, kHalfDiag);

  const long long total = (long long)nx * ny * nz;
  for (long long i = threadIdx.x; i < total; i += kThreads) {
    const int iz = (int)(i % nz);
    const long long t2 = i / nz;
    const int iy = (int)(t2 % ny);
    const int ix = (int)(t2 / ny);
    const int vx = x0 + ix, vy = y0 + iy, vz = z0 + iz;
    const float cx = (float)vx + 0.5f, cy = (float)vy + 0.5f,
                cz = (float)vz + 0.5f;
    const float dx = __fsub_rn(cx, ax), dy = __fsub_rn(cy, ay),
                dz = __fsub_rn(cz, az);
    const float tpar = __fmul_rn(dot3(dx, dy, dz, sx, sy, sz), invd);
    const float px = __fsub_rn(dx, __fmul_rn(tpar, sx));
    const float py = __fsub_rn(dy, __fmul_rn(tpar, sy));
    const float pz = __fsub_rn(dz, __fmul_rn(tpar, sz));
    const float d_orth = sqrtf(dot3(px, py, pz, px, py, pz));
    const float d_a = sqrtf(dot3(dx, dy, dz, dx, dy, dz));
    const float ex = __fsub_rn(cx, bx), ey = __fsub_rn(cy, by),
                ez = __fsub_rn(cz, bz);
    const float d_b = sqrtf(dot3(ex, ey, ez, ex, ey, ez));
    const float d_end = fminf(d_a, d_b);
    const float c_end = __fsub_rn(1.0f, __fsub_rn(d_end, base) / kDiag);
    const float c_seg = __fsub_rn(1.0f, __fsub_rn(d_orth, base) / kDiag);
    const bool inside = tpar > 0.0f && tpar < 1.0f;
    const float c = fminf(inside ? fmaxf(c_seg, c_end) : c_end, 1.0f);
    if (c > 0.0f)
      atomicMax(vol + ((size_t)vx * Y + vy) * Z + vz, __float_as_int(c));
  }
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// `vol` is the [X, Y, Z] float32 volume, zero-filled by the caller; the
// kernel raises it to the clipped maximum. Requires E >= 1; the wrapper
// checks shapes, types and devices.
extern "C" int splat3d_launch(const float* a, const float* b,
                              const float* radius, const uint8_t* valid,
                              float* vol, int E, int X, int Y, int Z,
                              void* stream) {
  splat3d_kernel<<<E, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, radius, valid, reinterpret_cast<int*>(vol), X, Y, Z);
  return (int)cudaGetLastError();
}
