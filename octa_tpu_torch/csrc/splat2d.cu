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
// Binning (bin_edges in octa_tpu_torch/ops/splat.py) is done by PyTorch ops
// before the launch, as the JAX package does it in XLA: a stable sort of
// (bin, edge) pairs, so each bin's edge ids sit contiguously in edge order,
// with per-bin starts and counts already clamped to k_max.
//
// What bounds it: arithmetic. Each (pixel, binned edge) pair costs about 20
// float operations (projection, clamp, sqrt, coverage, product) on the
// non-tensor FP32 pipes; the bytes (edge endpoints in, one float per pixel
// out) are small. The design therefore
//   - gives each block a 32x32 sub-tile of one bin (256 threads, 4 pixels a
//     thread, accumulators in registers), so 304^2 at batch 4 is 400 blocks
//     for 132 SMs instead of 36 bins; which edges a bin keeps is unchanged;
//   - stages the bin's edges through shared memory in chunks of 256, one
//     edge per thread, computing (a, b - a, 1/|b - a|^2, h) once per edge;
//   - skips, block-uniformly, every edge whose dilated bbox misses the
//     sub-tile's pixel centres: such an edge has alpha == 0 at every pixel
//     of the sub-tile (d - h > 1 there), so the product is unchanged exactly;
//   - writes straight into the [B, H, W] output, masking the ragged edge
//     (304 = 2*128 + 48).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSub = 32;                  // sub-tile edge (pixels)
constexpr int kThreads = 256;             // 32 columns x 8 row groups
constexpr int kRowsPerThread = kSub * kSub / kThreads;  // 4
constexpr int kChunk = kThreads;          // edges staged per round

__global__ void __launch_bounds__(kThreads)
splat2d_kernel(const float* __restrict__ a,      // [B, E, 2] (row, col)
               const float* __restrict__ b,      // [B, E, 2]
               const float* __restrict__ width,  // [B, E] stroke width (px)
               const int* __restrict__ pair_eid, // [P] edge ids, sorted by (bin, id)
               const int* __restrict__ starts,   // [B * nbins] first pair of a bin
               const int* __restrict__ counts,   // [B * nbins] kept edges (<= k_max)
               float* __restrict__ out,          // [B, H, W]
               int E, int H, int W, int ntx, int nty, int tile) {
  __shared__ float s_ay[kChunk], s_ax[kChunk], s_aby[kChunk], s_abx[kChunk];
  __shared__ float s_invd[kChunk], s_h[kChunk];
  __shared__ int s_hit[kChunk];

  const int img = blockIdx.z;
  const int row0 = blockIdx.y * kSub;
  const int col0 = blockIdx.x * kSub;
  const int bin = img * nty * ntx + (row0 / tile) * ntx + (col0 / tile);
  const int start = starts[bin];
  const int n = counts[bin];

  const int tx = threadIdx.x % kSub;
  const int ty = threadIdx.x / kSub;
  const float px = (float)(col0 + tx) + 0.5f;
  float py[kRowsPerThread], acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    py[i] = (float)(row0 + ty + i * (kThreads / kSub)) + 0.5f;
    acc[i] = 1.0f;
  }
  // pixel-centre extent of this sub-tile
  const float r_lo = (float)row0 + 0.5f, r_hi = (float)(row0 + kSub) - 0.5f;
  const float c_lo = (float)col0 + 0.5f, c_hi = (float)(col0 + kSub) - 0.5f;

  const float* a_img = a + (size_t)img * E * 2;
  const float* b_img = b + (size_t)img * E * 2;
  const float* w_img = width + (size_t)img * E;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    __syncthreads();  // previous chunk fully consumed
    if (threadIdx.x < m) {
      const int e = pair_eid[start + c0 + threadIdx.x];
      const float ay = a_img[2 * e], ax = a_img[2 * e + 1];
      const float by = b_img[2 * e], bx = b_img[2 * e + 1];
      const float h = w_img[e] * 0.5f;
      const float reach = h + 1.0f;
      const float aby = by - ay, abx = bx - ax;
      const float denom = aby * aby + abx * abx;
      s_ay[threadIdx.x] = ay;
      s_ax[threadIdx.x] = ax;
      s_aby[threadIdx.x] = aby;
      s_abx[threadIdx.x] = abx;
      s_invd[threadIdx.x] = 1.0f / fmaxf(denom, 1e-12f);
      s_h[threadIdx.x] = h;
      const bool miss = (fmaxf(ay, by) + reach < r_lo) ||
                        (fminf(ay, by) - reach > r_hi) ||
                        (fmaxf(ax, bx) + reach < c_lo) ||
                        (fminf(ax, bx) - reach > c_hi);
      s_hit[threadIdx.x] = miss ? 0 : 1;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      if (!s_hit[j]) continue;  // uniform across the block
      const float ay = s_ay[j], ax = s_ax[j], aby = s_aby[j], abx = s_abx[j];
      const float invd = s_invd[j], h = s_h[j];
      const float dx0 = px - ax;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float dy0 = py[i] - ay;
        float t = (dy0 * aby + dx0 * abx) * invd;
        t = fminf(fmaxf(t, 0.0f), 1.0f);
        const float dy = dy0 - t * aby;  // relative to a: small terms only
        const float dx = dx0 - t * abx;
        const float d = sqrtf(dy * dy + dx * dx);
        float alpha = fminf(d + h, 0.5f) - fmaxf(d - h, -0.5f);
        alpha = fminf(fmaxf(alpha, 0.0f), 1.0f);
        acc[i] *= 1.0f - alpha;
      }
    }
  }

  const int col = col0 + tx;
  if (col < W) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row0 + ty + i * (kThreads / kSub);
      if (row < H) out[((size_t)img * H + row) * W + col] = 1.0f - acc[i];
    }
  }
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// Requires tile % 32 == 0; the wrapper checks shapes, types and devices.
extern "C" int splat2d_launch(const float* a, const float* b,
                              const float* width, const int* pair_eid,
                              const int* starts, const int* counts, float* out,
                              int B, int E, int H, int W, int tile,
                              void* stream) {
  const int ntx = (W + tile - 1) / tile;
  const int nty = (H + tile - 1) / tile;
  dim3 grid((W + kSub - 1) / kSub, (H + kSub - 1) / kSub, B);
  splat2d_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, width, pair_eid, starts, counts, out, E, H, W, ntx, nty, tile);
  return (int)cudaGetLastError();
}
