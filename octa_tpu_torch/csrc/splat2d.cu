// K1: antialiased 2D line splat for Hopper (sm_90a).
//
// Replaces the TPU kernel octa_tpu/ops/pallas_splat.py:41
// (_splat_tile_kernel) behind splat_lines_2d_pallas (:93), with the
// semantics of its oracle octa_tpu/ops/raster.py:253 (splat_lines_2d):
// for pixel centre p and segment (a, b) of half-width h, with d the distance
// from p to the segment,
//     alpha = clip(min(d + h, 0.5) - max(d - h, -0.5), 0, 1),
// and coverage = 1 - prod(1 - alpha) over the edges kept by p's 128x128 bin:
// the first k_max edges, in edge-index order, whose dilated bbox
// (min/max(a, b) -/+ (h + 1)) touches the bin. The product runs in that order.
// d is taken as |(p - a) - t (b - a)|, as the plain version does: the
// oracle's p - (a + t (b - a)) rounds a coordinate near 1000 at 1216^2.
//
// One host call launches two kernels on the caller's stream, with no sort
// and nothing read back by the host:
//   1. bin_kernel, one block per (bin, image): streams the image's edges in
//      order, 1,024 a round, tests each edge's dilated bbox against the bin
//      by the oracle's closed-interval rule (_tile_topk_edges, computed with
//      the same float32 roundings as bin_edges_plain), and compacts the
//      hits in edge order with one ballot per warp and one prefix over the
//      32 warp counts of a round. It writes the bin's first k hits (k =
//      min(k_max, E)) into a fixed [B, nbins, k] id buffer and their number
//      into counts, and stops once the bin is full.
//   2. splat_kernel, one block per 32x32 sub-tile of a bin (16 warps), each
//      warp owning an 8x8 patch of pixels, two a lane. The block stages its
//      bin's edges 512 at a time and keeps, in order, those whose dilated
//      bbox touches the sub-tile (a ballot and one prefix); each warp then
//      picks by ballot, 32 staged edges a step, those that touch its own
//      patch and runs only those, in ascending order. An edge skipped for a
//      pixel has d - h > 1 there, so alpha == 0 and the factor is exactly 1:
//      every pixel's product is the same sequence of factors as over all of
//      its bin's kept edges, and the same from launch to launch.
//
// What bounds it: arithmetic over the (pixel, edge) pairs inside each edge's
// dilated bbox, about 20 float operations each on the non-tensor FP32 pipes;
// the bytes (edges in, one float a pixel out) are small. The pairs it
// evaluates are those of the 8x8 patches an edge's bbox touches, not every
// pixel of each 32x32 sub-tile it touches: a vessel edge's bbox covers a few
// dozen to a few hundred pixels at 304^2 and 1216^2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinThreads = 256;           // binning: threads a block
constexpr int kBinRounds = 4;              // edges a thread per round
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kSub = 32;                   // splat: sub-tile side (pixels)
constexpr int kPatch = 8;                  // a warp's patch side (pixels)
constexpr int kPatchesX = kSub / kPatch;   // 4
constexpr int kWarps = kPatchesX * kPatchesX;  // 16
constexpr int kThreads = 32 * kWarps;      // 512 = edges staged a round

// The edge's dilated bbox, rounded as bin_edges_plain rounds it:
// reach = w * 0.5 + 1, lo = min(a, b) - reach, hi = max(a, b) + reach.
struct Box {
  float lo_y, hi_y, lo_x, hi_x;
};

__device__ __forceinline__ Box dilated_box(float2 a, float2 b, float w) {
  const float reach = __fadd_rn(__fmul_rn(w, 0.5f), 1.0f);
  return {__fsub_rn(fminf(a.x, b.x), reach), __fadd_rn(fmaxf(a.x, b.x), reach),
          __fsub_rn(fminf(a.y, b.y), reach), __fadd_rn(fmaxf(a.y, b.y), reach)};
}

// closed intervals: the box misses [r0, r1] x [c0, c1] iff it lies wholly
// on one side of it
__device__ __forceinline__ bool touches(const Box& e, float r0, float r1,
                                        float c0, float c1) {
  return !(e.hi_y < r0 || e.lo_y > r1 || e.hi_x < c0 || e.lo_x > c1);
}

// a, b: [B, E] (row, col) as float2; width: [B, E]; valid: [B, E] bool.
__global__ void __launch_bounds__(kBinThreads)
bin_kernel(const float2* __restrict__ a, const float2* __restrict__ b,
           const float* __restrict__ width, const uint8_t* __restrict__ valid,
           int* __restrict__ ids,     // [B, nbins, k]
           int* __restrict__ counts,  // [B, nbins]
           int E, int k, int ntx, int tile) {
  __shared__ int s_off[kBinRounds * kBinWarps];  // 32 warp counts -> offsets
  __shared__ int s_round;
  const int img = blockIdx.y, bin = blockIdx.x, nbins = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float r0 = (float)((bin / ntx) * tile), c0 = (float)((bin % ntx) * tile);
  const float r1 = r0 + (float)tile, c1 = c0 + (float)tile;
  const size_t base_e = (size_t)img * E;
  int* out = ids + ((size_t)img * nbins + bin) * k;

  int total = 0;  // block-uniform
  for (int e0 = 0; e0 < E && total < k; e0 += kBinRounds * kBinThreads) {
    unsigned hits[kBinRounds];
#pragma unroll
    for (int u = 0; u < kBinRounds; ++u) {
      const int e = e0 + u * kBinThreads + tid;
      bool hit = false;
      if (e < E && valid[base_e + e])
        hit = touches(dilated_box(a[base_e + e], b[base_e + e],
                                  width[base_e + e]), r0, r1, c0, c1);
      hits[u] = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_off[u * kBinWarps + warp] = __popc(hits[u]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix of the 32 counts, in edge order
      const int v = s_off[lane];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      s_off[lane] = incl - v;
      if (lane == 31) s_round = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < kBinRounds; ++u) {
      if ((hits[u] >> lane) & 1u) {
        const int pos = total + s_off[u * kBinWarps + warp] +
                        __popc(hits[u] & below);
        if (pos < k) out[pos] = e0 + u * kBinThreads + tid;
      }
    }
    total += s_round;
    __syncthreads();  // s_off and s_round are rewritten next round
  }
  if (tid == 0) counts[(size_t)img * nbins + bin] = min(total, k);
}

__global__ void __launch_bounds__(kThreads)
splat_kernel(const float2* __restrict__ a, const float2* __restrict__ b,
             const float* __restrict__ width, const int* __restrict__ ids,
             const int* __restrict__ counts, float* __restrict__ out,
             int E, int H, int W, int k, int ntx, int nty, int tile) {
  // the staged edges that touch the sub-tile, in order
  __shared__ float s_ay[kThreads], s_ax[kThreads], s_aby[kThreads],
      s_abx[kThreads], s_invd[kThreads], s_h[kThreads];
  __shared__ Box s_box[kThreads];
  __shared__ int s_wc[kWarps];

  const int img = blockIdx.z;
  const int row0 = blockIdx.y * kSub, col0 = blockIdx.x * kSub;
  const int bin = (row0 / tile) * ntx + (col0 / tile);
  const size_t slot = (size_t)img * nty * ntx + bin;
  const int* list = ids + slot * k;
  const int n = counts[slot];
  const size_t base_e = (size_t)img * E;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pr0 = row0 + (warp / kPatchesX) * kPatch;
  const int pc0 = col0 + (warp % kPatchesX) * kPatch;
  const int col = pc0 + (lane & 7);
  const int row = pr0 + (lane >> 3);  // and row + 4
  const float px = (float)col + 0.5f;
  const float py0 = (float)row + 0.5f, py1 = (float)(row + 4) + 0.5f;
  float acc0 = 1.0f, acc1 = 1.0f;
  // pixel-centre extents of the sub-tile and of the warp's patch
  const float sr0 = (float)row0 + 0.5f, sr1 = (float)(row0 + kSub) - 0.5f;
  const float sc0 = (float)col0 + 0.5f, sc1 = (float)(col0 + kSub) - 0.5f;
  const float wr0 = (float)pr0 + 0.5f, wr1 = (float)(pr0 + kPatch) - 0.5f;
  const float wc0 = (float)pc0 + 0.5f, wc1 = (float)(pc0 + kPatch) - 0.5f;
  const unsigned below = (1u << lane) - 1u;

  for (int s0 = 0; s0 < n; s0 += kThreads) {
    __syncthreads();  // the previous round's staged edges fully consumed
    bool keep = false;
    float ay = 0.f, ax = 0.f, aby = 0.f, abx = 0.f, invd = 0.f, h = 0.f;
    Box box{};
    if (s0 + tid < n) {
      const int e = list[s0 + tid];
      const float2 ea = a[base_e + e], eb = b[base_e + e];
      const float w = width[base_e + e];
      ay = ea.x;
      ax = ea.y;
      aby = eb.x - ea.x;
      abx = eb.y - ea.y;
      invd = 1.0f / fmaxf(aby * aby + abx * abx, 1e-12f);
      h = w * 0.5f;
      box = dilated_box(ea, eb, w);
      keep = touches(box, sr0, sr1, sc0, sc1);
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_wc[warp] = __popc(kept);
    __syncthreads();
    int off = 0, nf = 0;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) {
      const int c = s_wc[w2];
      off += w2 < warp ? c : 0;
      nf += c;
    }
    if (keep) {
      const int p = off + __popc(kept & below);
      s_ay[p] = ay;
      s_ax[p] = ax;
      s_aby[p] = aby;
      s_abx[p] = abx;
      s_invd[p] = invd;
      s_h[p] = h;
      s_box[p] = box;
    }
    __syncthreads();
    for (int j0 = 0; j0 < nf; j0 += 32) {
      const int j = j0 + lane;
      unsigned mine = __ballot_sync(
          0xffffffffu, j < nf && touches(s_box[j], wr0, wr1, wc0, wc1));
      while (mine) {  // ascending: the product keeps the bin's order
        const int jj = j0 + __ffs(mine) - 1;
        mine &= mine - 1u;
        const float eay = s_ay[jj], eax = s_ax[jj];
        const float eaby = s_aby[jj], eabx = s_abx[jj];
        const float einvd = s_invd[jj], eh = s_h[jj];
        const float dx0 = px - eax;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float dy0 = (i ? py1 : py0) - eay;
          float t = (dy0 * eaby + dx0 * eabx) * einvd;
          t = fminf(fmaxf(t, 0.0f), 1.0f);
          const float dy = dy0 - t * eaby;  // relative to a: small terms only
          const float dx = dx0 - t * eabx;
          const float d = sqrtf(dy * dy + dx * dx);
          float alpha = fminf(d + eh, 0.5f) - fmaxf(d - eh, -0.5f);
          alpha = fminf(fmaxf(alpha, 0.0f), 1.0f);
          if (i)
            acc1 *= 1.0f - alpha;
          else
            acc0 *= 1.0f - alpha;
        }
      }
    }
  }

  if (col < W) {
    if (row < H) out[((size_t)img * H + row) * W + col] = 1.0f - acc0;
    if (row + 4 < H) out[((size_t)img * H + row + 4) * W + col] = 1.0f - acc1;
  }
}

}  // namespace

// Launches K1 on `stream` (binning, then the splat) and returns
// cudaGetLastError() (0 on success). ids: [B, nbins, k] int scratch, counts:
// [B, nbins] int (written: the bins' kept edge counts, <= k); a, b must be
// 8-byte aligned. Requires tile % 32 == 0 and B <= 65535; the wrapper checks
// shapes, types and devices.
extern "C" int splat2d_launch(const float* a, const float* b,
                              const float* width, const uint8_t* valid,
                              int* ids, int* counts, float* out, int B, int E,
                              int H, int W, int tile, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ntx = (W + tile - 1) / tile;
  const int nty = (H + tile - 1) / tile;
  const float2* a2 = reinterpret_cast<const float2*>(a);
  const float2* b2 = reinterpret_cast<const float2*>(b);
  bin_kernel<<<dim3(ntx * nty, B), kBinThreads, 0, s>>>(
      a2, b2, width, valid, ids, counts, E, k, ntx, tile);
  const dim3 grid((W + kSub - 1) / kSub, (H + kSub - 1) / kSub, B);
  splat_kernel<<<grid, kThreads, 0, s>>>(a2, b2, width, ids, counts, out, E,
                                         H, W, k, ntx, nty, tile);
  return (int)cudaGetLastError();
}
