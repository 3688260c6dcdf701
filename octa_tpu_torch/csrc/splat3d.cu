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
// and the output is clip(max over edges, 0, 1): float32, or as uint8
// trunc(clamp(v * 255, 0, 255)), the renderer's quantisation. The bbox is
// tested on the voxel index, not the centre; an edge whose bbox misses the
// volume, or an invalid edge, contributes nothing; max(., 1e-12) guards a
// zero-length edge. There is no per-tile edge limit: every valid edge counts.
//
// Every product, sum and difference of the contribution is rounded on its
// own (__fmul_rn and friends keep the compiler from contracting them into
// fused multiply-adds) and taken in the order the plain PyTorch version takes
// them; the division and the square root are IEEE-rounded (no fast-math
// flag). The distance is taken relative to a (d0 - t s), never as
// c - (a + t s): near coordinate 1000 the latter rounds by 1.2e-4.
//
// One square root and one division a pair. sqrt is correctly rounded and
// monotone, so min(sqrt(p), sqrt(q)) == sqrt(min(p, q)); f(d) = 1 - (d -
// base) / sqrt3, each step rounded to nearest, is monotone non-increasing
// in d, so max(f(x), f(y)) == f(min(x, y)). The contribution is therefore
// f(sqrt(min(|c-a|^2, |c-b|^2, inside ? |d0 - t s|^2 : inf))), the same bits
// as three roots and two divisions.
//
// What bounds it: at (1216, 1216, 53) the one store of the volume (78 MB as
// uint8, 313 MB as float32) against about 50 float operations per (voxel,
// edge) pair inside the bboxes (18-28 M pairs for one tree); on a small
// volume with many edges the operations. One host call launches two
// kernels on the caller's stream, with no sort and nothing read back by the
// host:
//   1. bin_kernel, one block per bin of tile x tile columns (all of z; the
//      wrapper makes about ten bins a side): streams the edges in order,
//      2,048 a round with the next round's loads in flight, computes each
//      edge's clipped bbox with the roundings of edge_bboxes, and compacts
//      the hits in edge order (a ballot a warp, one prefix over the warp
//      counts of a round) into a [nbins, E] list of {edge, x0|x1<<16,
//      y0|y1<<16, z0|z1<<16}: room for every edge of a bin, of which only
//      the written entries are touched. No cap.
//   2. gather_kernel, one block per 8x16-column sub-tile and 64-voxel
//      z-chunk (4 warps, each owning a 4x8 patch of columns, a column a
//      lane). The block keeps a running maximum per voxel in shared memory,
//      starting at 0, stages its bin's entries 128 at a time and keeps those
//      whose bbox touches the sub-tile. Each warp takes, in order, the
//      staged edges that touch its patch. Its lanes test their own column
//      against the bbox and against the edge's shadow in (x, y): the 3D
//      distance is at least the distance in x and y to the segment's
//      projection, so a column beyond the reach at which the contribution
//      falls to 0 (with a margin for rounding) holds no contributing pair,
//      and 60 % of the bbox pairs go. A kept column writes the terms of its
//      distances that do not depend on z to shared memory, and the warp
//      shares out the (kept column, z) pairs of the bbox's z-range flat over
//      its 32 lanes. Within one edge every voxel is one lane's, the warps
//      own disjoint columns, and a __syncwarp orders one edge after the
//      next: no atomics. At the end the block stores every voxel of its
//      sub-tile once, 0 where no edge reached, as float32 or uint8, 16 bytes
//      a lane where the rows allow.
//
// What the design does about the kernel it replaces (one block per edge,
// scattering with atomicMax): (1) the blocks of the largest edges ran 1,144
// trips while the grid idled: work per block is now bounded by its
// sub-tile (at most 16 edges per 8x16 sub-tile at the main path's shapes),
// and pairs are shared out over the lanes flat, 93 % of lanes busy; (2)
// 64-bit division and modulo per pair: 32-bit indices, and the flat pair
// index is stepped with no division at all; (3) three roots and two
// divisions a pair: one of each (a per-pair test that skipped them beyond
// reach cost more in divergence than it saved, and is not made); (4) an
// atomicMax per contribution: a maximum in shared memory owned by one lane a
// voxel; (5) the zero fill and the renderer's three quantising passes: each
// voxel is written once, quantised where the renderer asks.
//
// A volume of few columns and many edges a column ((76, 76, 4) with 13,423
// edges: 180 warps of columns on 132 SMs) is latency-bound here, slower than
// the scatter was: its warps walk hundreds of edges each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinThreads = 512;           // binning: threads a block
constexpr int kBinRounds = 4;              // edges a thread per round
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kBinCounts = kBinRounds * kBinWarps;  // 64 warp counts a round
constexpr int kBinPer = kBinCounts / 32;            // of them a lane scans
constexpr int kSubX = 8, kSubY = 16;       // gather: a block's columns
constexpr int kPatchX = 4, kPatchY = 8;    // a warp's columns, one a lane
constexpr int kPatchesY = kSubY / kPatchY;                // 2
constexpr int kWarps = (kSubX / kPatchX) * kPatchesY;     // 4 patches
constexpr int kThreads = 32 * kWarps;      // 128 = entries staged a round
constexpr int kCols = kSubX * kSubY;       // 128
constexpr int kMaxZ = 64;                  // voxels of z a block holds
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

__device__ __forceinline__ int lo16(int v) { return v & 0xffff; }
__device__ __forceinline__ int hi16(int v) { return (int)((unsigned)v >> 16); }

// An edge's voxel-index bbox clipped to the volume, rounded as edge_bboxes
// rounds it, packed lo | hi << 16 an axis (every dim is at most 65535).
__device__ __forceinline__ int4 edge_entry(int e, const float (&v)[7], int X,
                                           int Y, int Z) {
  const float off = __fmul_rn(v[6], kSqrt2);
  int lo[3], hi[3];
  const int n[3] = {X, Y, Z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = clamp_index(floorf(__fsub_rn(fminf(v[i], v[3 + i]), off)), n[i]);
    hi[i] = clamp_index(
        ceilf(__fadd_rn(__fadd_rn(fmaxf(v[i], v[3 + i]), off), 1.0f)), n[i]);
  }
  return make_int4(e, lo[0] | (hi[0] << 16), lo[1] | (hi[1] << 16),
                   lo[2] | (hi[2] << 16));
}

// a round's edges of one thread: a, b, radius, and whether valid
struct RoundLoads {
  float v[kBinRounds][7];
  bool ok[kBinRounds];
};

__device__ __forceinline__ void load_round(RoundLoads& r, const float* a,
                                           const float* b, const float* radius,
                                           const uint8_t* valid, int e0,
                                           int E) {
#pragma unroll
  for (int u = 0; u < kBinRounds; ++u) {
    const int e = e0 + u * kBinThreads + (int)threadIdx.x;
    const int ec = min(e, E - 1);
    r.ok[u] = e < E && valid[ec];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      r.v[u][i] = a[3 * ec + i];
      r.v[u][3 + i] = b[3 * ec + i];
    }
    r.v[u][6] = radius[ec];
  }
}

// a: [E, 3], b: [E, 3], radius: [E], valid: [E] bool.
__global__ void __launch_bounds__(kBinThreads)
bin_kernel(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ radius, const uint8_t* __restrict__ valid,
           int4* __restrict__ entries,  // [nbins, E]
           int* __restrict__ counts,    // [nbins]
           int E, int X, int Y, int Z, int tile, int nby) {
  __shared__ int s_off[kBinCounts];  // warp counts -> offsets, edge order
  __shared__ int s_round;
  const int bin = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx0 = (bin / nby) * tile, by0 = (bin % nby) * tile;
  int4* out = entries + (size_t)bin * E;
  const unsigned below = (1u << lane) - 1u;
  constexpr int kStep = kBinRounds * kBinThreads;

  RoundLoads cur, next;
  if (E > 0) load_round(cur, a, b, radius, valid, 0, E);
  int total = 0;  // block-uniform
  for (int e0 = 0; e0 < E; e0 += kStep) {
    // the next round's loads in flight while this one is binned
    if (e0 + kStep < E) load_round(next, a, b, radius, valid, e0 + kStep, E);
    unsigned hits[kBinRounds];
    int4 ent[kBinRounds];
#pragma unroll
    for (int u = 0; u < kBinRounds; ++u) {
      ent[u] = edge_entry(e0 + u * kBinThreads + tid, cur.v[u], X, Y, Z);
      const int x0 = lo16(ent[u].y), x1 = hi16(ent[u].y);
      const int y0 = lo16(ent[u].z), y1 = hi16(ent[u].z);
      const bool hit = cur.ok[u] && x0 < x1 && y0 < y1 &&
                       lo16(ent[u].w) < hi16(ent[u].w) && x0 < bx0 + tile &&
                       x1 > bx0 && y0 < by0 + tile && y1 > by0;
      hits[u] = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_off[u * kBinWarps + warp] = __popc(hits[u]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix of the counts, in edge order
      int v[kBinPer], sum = 0;
#pragma unroll
      for (int i = 0; i < kBinPer; ++i) {
        v[i] = s_off[lane * kBinPer + i];
        sum += v[i];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      int run = incl - sum;
#pragma unroll
      for (int i = 0; i < kBinPer; ++i) {
        s_off[lane * kBinPer + i] = run;
        run += v[i];
      }
      if (lane == 31) s_round = incl;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kBinRounds; ++u) {
      if ((hits[u] >> lane) & 1u)
        out[total + s_off[u * kBinWarps + warp] + __popc(hits[u] & below)] =
            ent[u];
    }
    total += s_round;
    cur = next;
    __syncthreads();  // s_off and s_round are rewritten next round
  }
  if (tid == 0) counts[bin] = total;
}

// The stored value of a contribution c <= 1 (the running maximum starts at
// 0, so the result is clip(max, 0, 1)): the float itself, or the renderer's
// uint8 level. The level is monotone in c, so the maximum of the levels is
// the level of the maximum.
template <typename T>
__device__ __forceinline__ T level(float c);
template <>
__device__ __forceinline__ float level<float>(float c) {
  return c;
}
template <>
__device__ __forceinline__ uint8_t level<uint8_t>(float c) {
  return (uint8_t)__float2int_rz(
      fminf(fmaxf(__fmul_rn(c, 255.0f), 0.0f), 255.0f));
}

// A kept column's terms of one edge that do not depend on z: with d = c - a
// and e = c - b, d.x s.x + d.y s.y, |d.xy|^2, |e.xy|^2 (rounded as the first
// two terms of each dot product are), the voxel offset of the column in the
// block's maxima, and d.x, d.y.
struct Column {
  float4 k;  // dot_xy, dd_xy, ee_xy, offset (int bits)
  float2 d;
};

// One (voxel, edge) pair at height cz of a kept column: the contribution,
// rounded step by step as the plain version rounds it (the dot products
// summed x, y, then z).
__device__ __forceinline__ float contrib(const Column& col, float cz, float az,
                                         float bz, float sx, float sy,
                                         float sz, float invd, float base) {
  const float dz = __fsub_rn(cz, az), ez = __fsub_rn(cz, bz);
  const float tpar = __fmul_rn(__fadd_rn(col.k.x, __fmul_rn(dz, sz)), invd);
  float q = fminf(__fadd_rn(col.k.y, __fmul_rn(dz, dz)),
                  __fadd_rn(col.k.z, __fmul_rn(ez, ez)));
  if (tpar > 0.0f && tpar < 1.0f) {
    const float qx = __fsub_rn(col.d.x, __fmul_rn(tpar, sx));
    const float qy = __fsub_rn(col.d.y, __fmul_rn(tpar, sy));
    const float qz = __fsub_rn(dz, __fmul_rn(tpar, sz));
    q = fminf(q, dot3(qx, qy, qz, qx, qy, qz));
  }
  return fminf(__fsub_rn(1.0f, __fsub_rn(sqrtf(q), base) / kDiag), 1.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ a, const float* __restrict__ b,
              const float* __restrict__ radius,
              const int4* __restrict__ entries, const int* __restrict__ counts,
              T* __restrict__ out,  // [X, Y, Z]
              int E, int X, int Y, int Z, int tile, int nby) {
  // [kCols][zs] running maxima, rounded up to 16 bytes
  extern __shared__ __align__(16) unsigned char s_dyn[];
  T* acc = reinterpret_cast<T*>(s_dyn);
  // the staged edges that touch the sub-tile and z-chunk, in list order
  __shared__ float s_ax[kThreads], s_ay[kThreads], s_az[kThreads];
  __shared__ float s_bx[kThreads], s_by[kThreads], s_bz[kThreads];
  __shared__ float s_invd[kThreads], s_base[kThreads];
  __shared__ float s_inv2[kThreads], s_cull[kThreads];
  __shared__ int s_xs[kThreads], s_ys[kThreads], s_zs[kThreads];  // packed
  __shared__ int s_wc[kWarps];
  __shared__ Column s_col[kWarps][32];  // a warp's kept columns, one edge

  const int sy0 = blockIdx.x * kSubY, sx0 = blockIdx.y * kSubX;
  const int zc0 = blockIdx.z * kMaxZ;
  const int zn = min(kMaxZ, Z - zc0), zs = zn | 1;  // odd: no bank conflicts
  const int bin = (sx0 / tile) * nby + (sy0 / tile);
  const int n = counts[bin];
  const int4* list = entries + (size_t)bin * E;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int px0 = sx0 + (warp / kPatchesY) * kPatchX;
  const int py0 = sy0 + (warp % kPatchesY) * kPatchY;
  const int mx = px0 + lane / kPatchY, my = py0 + lane % kPatchY;
  const float mcx = (float)mx + 0.5f, mcy = (float)my + 0.5f;
  for (int i = tid; i < (kCols * zs * (int)sizeof(T) + 15) / 16; i += kThreads)
    reinterpret_cast<uint4*>(s_dyn)[i] = make_uint4(0u, 0u, 0u, 0u);

  for (int s0 = 0; s0 < n; s0 += kThreads) {
    __syncthreads();  // the previous round's staged edges fully consumed
    {
      bool keep = false;
      int4 ent = make_int4(0, 0, 0, 0);
      if (s0 + tid < n) {
        ent = list[s0 + tid];
        keep = lo16(ent.y) < sx0 + kSubX && hi16(ent.y) > sx0 &&
               lo16(ent.z) < sy0 + kSubY && hi16(ent.z) > sy0 &&
               lo16(ent.w) < zc0 + zn && hi16(ent.w) > zc0;
      }
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_wc[warp] = __popc(kept);
      __syncthreads();
      int off = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) off += w < warp ? s_wc[w] : 0;
      if (keep) {
        const int p = off + __popc(kept & below);
        const int e = ent.x;
        const float ax = a[3 * e], ay = a[3 * e + 1], az = a[3 * e + 2];
        const float bx = b[3 * e], by = b[3 * e + 1], bz = b[3 * e + 2];
        const float sx = __fsub_rn(bx, ax), sy = __fsub_rn(by, ay),
                    sz = __fsub_rn(bz, az);
        const float base = __fsub_rn(radius[e], kHalfDiag);
        // a column is skipped only if its distance in (x, y) to the
        // segment is beyond base + sqrt3, where the contribution is <= 0
        // (the 3D distance is at least that), with room for the rounding of
        // both distances: 2^-18 relative, then 2^-7 voxel and 2^-16 of the
        // lengths involved; the square is rounded up
        const float reach = __fadd_rn(
            __fmul_rn(__fadd_rn(base, kDiag), 1.0f + 0x1p-18f), 0x1p-18f);
        const float shadow = __fadd_rn(
            reach,
            __fadd_rn(0x1p-7f,
                      __fmul_rn(__fadd_rn(__fadd_rn(fabsf(sx), fabsf(sy)),
                                          __fadd_rn(fabsf(sz), fabsf(reach))),
                                0x1p-16f)));
        s_ax[p] = ax; s_ay[p] = ay; s_az[p] = az;
        s_bx[p] = bx; s_by[p] = by; s_bz[p] = bz;
        s_invd[p] = 1.0f / fmaxf(dot3(sx, sy, sz, sx, sy, sz), 1e-12f);
        s_base[p] = base;
        s_inv2[p] = 1.0f / fmaxf(
            __fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)), 1e-12f);
        s_cull[p] = shadow > 0.0f
            ? __fmul_rn(__fmul_rn(shadow, shadow), 1.0f + 0x1p-16f) : 0.0f;
        s_xs[p] = ent.y; s_ys[p] = ent.z; s_zs[p] = ent.w;
      }
    }
    __syncthreads();
    int nf = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) nf += s_wc[w];

    for (int j0 = 0; j0 < nf; j0 += 32) {
      const int j = j0 + lane;
      unsigned mine = __ballot_sync(
          0xffffffffu, j < nf && lo16(s_xs[j]) < px0 + kPatchX &&
                           hi16(s_xs[j]) > px0 && lo16(s_ys[j]) < py0 + kPatchY &&
                           hi16(s_ys[j]) > py0);
      while (mine) {  // the staged edges that touch the warp's patch
        const int jj = j0 + __ffs(mine) - 1;
        mine &= mine - 1u;
        const float ax = s_ax[jj], ay = s_ay[jj], az = s_az[jj];
        const float bx = s_bx[jj], by = s_by[jj], bz = s_bz[jj];
        const float sx = __fsub_rn(bx, ax), sy = __fsub_rn(by, ay),
                    sz = __fsub_rn(bz, az);
        // the lane's column: inside the bbox and the (x, y) shadow
        bool col = mx >= lo16(s_xs[jj]) && mx < hi16(s_xs[jj]) &&
                   my >= lo16(s_ys[jj]) && my < hi16(s_ys[jj]);
        const float dx = __fsub_rn(mcx, ax), dy = __fsub_rn(mcy, ay);
        const float dot_xy = __fadd_rn(__fmul_rn(dx, sx), __fmul_rn(dy, sy));
        if (col) {
          const float t2 = fminf(fmaxf(dot_xy * s_inv2[jj], 0.0f), 1.0f);
          const float wx = dx - t2 * sx, wy = dy - t2 * sy;
          col = wx * wx + wy * wy <= s_cull[jj];
        }
        const unsigned cols = __ballot_sync(0xffffffffu, col);
        if (!cols) continue;
        const int zlo = max(lo16(s_zs[jj]), zc0);
        const int nz = min(hi16(s_zs[jj]), zc0 + zn) - zlo;  // 1..64
        if (col) {
          const float ex = __fsub_rn(mcx, bx), ey = __fsub_rn(mcy, by);
          Column& c = s_col[warp][__popc(cols & below)];
          c.k = make_float4(
              dot_xy, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
              __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
              __int_as_float(((mx - sx0) * kSubY + (my - sy0)) * zs + zlo -
                             zc0));
          c.d = make_float2(dx, dy);
        }
        __syncwarp();
        const int ncol = __popc(cols);
        const float invd = s_invd[jj], base = s_base[jj];
        // the pair index p = lane + 32 k as (column ci, z zi): p = ci nz +
        // zi, stepped by 32 = dq nz + dr. (m + 0.5) / nz for m <= 32 is at
        // least 0.5 / nz from an integer, far more than the rounding of
        // the reciprocal and the product, so truncation divides exactly
        const float rnz = __frcp_rn((float)nz);
        int ci = __float2int_rz(((float)lane + 0.5f) * rnz);
        int zi = lane - ci * nz;
        const int dq = __float2int_rz(32.5f * rnz), dr = 32 - dq * nz;
        const float cz0 = (float)zlo + 0.5f;
        while (ci < ncol) {
          const Column c = s_col[warp][ci];
          const T v = level<T>(contrib(c, cz0 + (float)zi, az, bz, sx, sy, sz,
                                       invd, base));
          T* slot = acc + __float_as_int(c.k.w) + zi;
          if (v > *slot) *slot = v;
          ci += dq;
          zi += dr;
          if (zi >= nz) {
            zi -= nz;
            ++ci;
          }
        }
        __syncwarp();  // this edge's maxima and s_col before the next edge
      }
    }
  }
  __syncthreads();
  // every voxel of the sub-tile once. Where the z-chunk is all of z with no
  // padding and a row of 16 columns is 16-byte aligned in the volume, each
  // x-row of the sub-tile is one contiguous run in shared memory and in the
  // volume: 16 bytes a lane. Otherwise a warp a column, lanes along z.
  if (zn == Z && zs == Z && sy0 + kSubY <= Y &&
      ((size_t)Y * Z * sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int rowv = kSubY * Z * (int)sizeof(T) / 16;  // uint4 a row
    for (int lx = 0; lx < kSubX && sx0 + lx < X; ++lx) {
      const uint4* src = reinterpret_cast<const uint4*>(acc + lx * kSubY * zs);
      uint4* dst = reinterpret_cast<uint4*>(
          out + ((size_t)(sx0 + lx) * Y + sy0) * Z);
      for (int k = tid; k < rowv; k += kThreads) dst[k] = src[k];
    }
  } else {
    for (int c = warp; c < kCols; c += kWarps) {
      const int x = sx0 + c / kSubY, y = sy0 + c % kSubY;
      if (x < X && y < Y) {
        T* dst = out + ((size_t)x * Y + y) * Z + zc0;
        for (int z = lane; z < zn; z += 32) dst[z] = acc[c * zs + z];
      }
    }
  }
}

}  // namespace

// Launches K4 on `stream` (binning, then the gather) and returns
// cudaGetLastError() (0 on success). entries: [nbins, max(E, 1)] int4
// scratch, counts: [nbins] int (written: each bin's entry count), with
// nbins = ceil(X / tile) * ceil(Y / tile); out: the [X, Y, Z] volume, float32
// or (out_u8) uint8, every voxel written. Requires tile % 16 == 0 and every
// dim in 1..65535; the wrapper checks shapes, types and devices.
extern "C" int splat3d_launch(const float* a, const float* b,
                              const float* radius, const uint8_t* valid,
                              void* entries, int* counts, void* out,
                              int out_u8, int E, int X, int Y, int Z, int tile,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nbx = (X + tile - 1) / tile, nby = (Y + tile - 1) / tile;
  int4* ent = reinterpret_cast<int4*>(entries);
  bin_kernel<<<nbx * nby, kBinThreads, 0, s>>>(a, b, radius, valid, ent,
                                                counts, E, X, Y, Z, tile, nby);
  const dim3 grid((Y + kSubY - 1) / kSubY, (X + kSubX - 1) / kSubX,
                  (Z + kMaxZ - 1) / kMaxZ);
  const int zs = (Z < kMaxZ ? Z : kMaxZ) | 1;
  const int bytes = (kCols * zs * (out_u8 ? 1 : 4) + 15) / 16 * 16;
  if (out_u8)
    gather_kernel<uint8_t><<<grid, kThreads, bytes, s>>>(
        a, b, radius, ent, counts, reinterpret_cast<uint8_t*>(out), E, X, Y, Z,
        tile, nby);
  else
    gather_kernel<float><<<grid, kThreads, bytes, s>>>(
        a, b, radius, ent, counts, reinterpret_cast<float*>(out), E, X, Y, Z,
        tile, nby);
  return (int)cudaGetLastError();
}
