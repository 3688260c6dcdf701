// K5: banded masked nearest-neighbour distances for Hopper (sm_90a).
//
// Replaces the TPU kernel octa_tpu/ops/pallas_nearest.py:204 (_banded_kernel)
// behind masked_nearest_banded_pallas (:269). K2 (nearest.cu) with one mask
// and a pruning rule: the points of a row are scanned in chunks of 1024, and
// a tile of 128 queries skips every chunk whose valid points' y-range
// [plo, phi] misses the tile's own y-range
//     [lo, hi] = [min over alive queries of qy - band,
//                 max over alive queries of qy + band].
// For an alive query every point within `band` of it lies in a chunk that is
// scanned, so wherever the true nearest distance is <= band the result is
// K2's, bit for bit (same d2 arithmetic; the least d2 and, among equal
// ones, the lowest index, as K2's ascending scan under `<`). Beyond the band
// the result is the nearest among the scanned chunks only; where nothing was
// scanned or no point is valid it is +inf and index 0.
//
// The function is fixed everywhere, not only inside the band: the plain
// PyTorch version uses the same 128-query tiles, the same 1024-point chunks
// and the same skip rule, so the two agree bit for bit at every query.
//
// One host call launches two kernels on the caller's stream:
//   1. stage_kernel, one block per (chunk, row): a float4 copy of the points
//      with every refused point at (+inf, +inf, +inf), and per chunk its
//      valid points' y-range and its first and last valid point. It reads
//      the points and the mask through their row strides, so row views of
//      larger arrays (the growth loop's node and sink arrays) need no copy.
//   2. scan_kernel, the design of K2 (nearest.cu) with one mask:
//      (a) refused points are +inf, so the inner loop tests no mask bit:
//          q - inf squared is +inf and never beats the best under `<`;
//      (b) a thread holds four queries (kQpt), so one shared load serves
//          four pairs: a warp holds the block's whole tile of 128 queries,
//          the pruning tile, and the four warps share each staged chunk's
//          points out in four consecutive quarters. At the end the warps'
//          results are merged by (distance, index), so ties keep the lowest
//          index as a sequential scan would;
//      (c) a chunk is staged and scanned only between its first and last
//          valid point, and skipped, block-uniformly and before any point
//          is loaded, when its y-range misses the tile's [lo, hi] (an
//          all-invalid chunk has +inf / -inf and misses every tile). The
//          pruning tile is the block's, so four queries a thread cost no
//          extra pairs, and every warp works on every chunk its tile scans;
//      (d) the point range is split, in whole chunks, over gridDim.z
//          blocks, and the last block of a query tile to finish merges the
//          partials in ascending split order (lower splits hold lower
//          indices: ties keep the lowest). A grid of fewer than 8 blocks an
//          SM is split as K2's is; any grid into splits of at most 4
//          chunks, since a tile that spans all y (the candidates, the tail
//          appended since the last restage) scans every chunk and would
//          otherwise hold the launch up (ops/nearest.py banded_plan).
// What bounds it: operations, as K2, over the (query, valid point) pairs of
// the hit (tile, chunk) pairs: 8 float operations a pair, no fused
// multiply-add, so at best twice the FP32-peak bound. With unsorted points
// every chunk spans the whole y-range and nothing is skipped: a full scan,
// still exact.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // scan threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kQpt = 4;                   // queries per thread
constexpr int kTile = 32 * kQpt;          // 128 queries: a block's tile,
                                          // the pruning tile
constexpr int kChunk = 1024;              // points: the pruning granule
constexpr int kStageThreads = 256;

// Per (row, chunk): valid points' y-range, first and last valid point
// (kChunk and -1 when there is none), as one float4 {lo, hi, first, last}.
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const float* __restrict__ points,   // [R, N, 3], row stride p_row
             long long p_row,
             const uint8_t* __restrict__ mask,   // [R, N], row stride m_row
             long long m_row,
             float4* __restrict__ staged,        // [R, N]
             float4* __restrict__ info,          // [R, n_chunks]
             int N) {
  __shared__ float s_lo[kStageThreads / 32], s_hi[kStageThreads / 32];
  __shared__ int s_first[kStageThreads / 32], s_last[kStageThreads / 32];
  const int row = blockIdx.y, c = blockIdx.x, tid = threadIdx.x;
  const int c0 = c * kChunk, n = min(kChunk, N - c0);
  const float* prow = points + row * p_row + (size_t)c0 * 3;
  const uint8_t* mrow = mask + row * m_row + c0;
  float4* srow = staged + (size_t)row * N + c0;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  int first = kChunk, last = -1;
  for (int j = tid; j < n; j += kStageThreads) {
    const float x = prow[3 * j], y = prow[3 * j + 1], z = prow[3 * j + 2];
    if (mrow[j]) {
      srow[j] = make_float4(x, y, z, 0.0f);
      lo = fminf(lo, y);
      hi = fmaxf(hi, y);
      first = min(first, j);
      last = j;
    } else {
      srow[j] = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.0f);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  if ((tid & 31) == 0) {
    s_lo[tid >> 5] = lo;
    s_hi[tid >> 5] = hi;
    s_first[tid >> 5] = first;
    s_last[tid >> 5] = last;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kStageThreads / 32; ++w) {
      lo = fminf(lo, s_lo[w]);
      hi = fmaxf(hi, s_hi[w]);
      first = min(first, s_first[w]);
      last = max(last, s_last[w]);
    }
    info[(size_t)row * gridDim.x + c] =
        make_float4(lo, hi, __int_as_float(first), __int_as_float(last));
  }
}

template <bool WANT_IDX>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ query,    // [R, Q, 3], row stride q_row
            long long q_row,
            const uint8_t* __restrict__ alive,  // [R, Q] bool
            const float* __restrict__ band,     // [R]
            const float4* __restrict__ staged,  // [R, N]
            const float4* __restrict__ info,    // [R, n_chunks]
            float* __restrict__ dist,           // [R, Q]
            int* __restrict__ idx,              // [R, Q] (WANT_IDX)
            float* __restrict__ part_d,         // [S, R, Q] (S > 1)
            int* __restrict__ part_i,           // [S, R, Q] (S > 1, WANT_IDX)
            int* __restrict__ counters,         // [R, tiles], zero (S > 1)
            int Q, int N, int per_split) {
  __shared__ float4 s_pt[kChunk];
  __shared__ float s_bd[kWarps][kTile];
  __shared__ int s_bi[kWarps][kTile];
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.y, split = blockIdx.z, S = gridDim.z;
  const int q0 = blockIdx.x * kTile;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const float bnd = band[row];

  // every warp holds the tile's 128 queries, four a lane (query u * 32 +
  // lane of the tile), and reduces the tile's banded y-range over its
  // alive queries by shuffles: the same in every warp. Dead queries and
  // the idle lanes of a ragged tile carry +inf / -inf, so an all-dead tile
  // has lo = +inf, hi = -inf and skips every chunk.
  float qx[kQpt], qy[kQpt], qz[kQpt], best[kQpt];
  int besti[kQpt];
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    const int qi = q0 + u * 32 + lane;
    const int ql = min(qi, Q - 1);  // ragged tile: repeat the last query
    const float* qp = query + row * q_row + (size_t)ql * 3;
    qx[u] = qp[0];
    qy[u] = qp[1];
    qz[u] = qp[2];
    best[u] = CUDART_INF_F;
    besti[u] = 0;
    if (qi < Q && alive[(size_t)row * Q + ql]) {
      lo = fminf(lo, __fsub_rn(qy[u], bnd));
      hi = fmaxf(hi, __fadd_rn(qy[u], bnd));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }

  const float4* srow = staged + (size_t)row * N;
  const int c_begin = split * (per_split / kChunk);
  const int c_end = min(n_chunks, c_begin + per_split / kChunk);
  for (int c = c_begin; c < c_end; ++c) {
    // block-uniform: every thread reads the same 16 bytes
    const float4 ci = info[(size_t)row * n_chunks + c];
    const int jlo = __float_as_int(ci.z), jhi = __float_as_int(ci.w);
    if (!(ci.y >= lo && ci.x <= hi) || jlo > jhi) continue;
    const int c0 = c * kChunk;
    __syncthreads();  // the previous chunk fully consumed
    for (int j = jlo + tid; j <= jhi; j += kThreads) s_pt[j] = srow[c0 + j];
    __syncthreads();
    // this warp's quarter of the chunk's span, in ascending order
    const int quarter = (jhi - jlo + kWarps) / kWarps;
    const int j0 = jlo + warp * quarter, j1 = min(jhi, j0 + quarter - 1);
#pragma unroll 4
    for (int j = j0; j <= j1; ++j) {
      const float4 p = s_pt[j];
#pragma unroll
      for (int u = 0; u < kQpt; ++u) {
        const float dx = __fsub_rn(qx[u], p.x);
        const float dy = __fsub_rn(qy[u], p.y);
        const float dz = __fsub_rn(qz[u], p.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (WANT_IDX) {
          if (d2 < best[u]) {
            best[u] = d2;
            besti[u] = c0 + j;
          }
        } else {
          best[u] = fminf(best[u], d2);  // d2 >= 0: as the strict `<`
        }
      }
    }
  }

  // merge the four warps' results: thread t takes the tile's query t, the
  // least distance and, among equal ones, the least index (a warp's points
  // are not all below the next warp's: each warp saw a quarter of every
  // chunk)
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    s_bd[warp][u * 32 + lane] = best[u];
    if (WANT_IDX) s_bi[warp][u * 32 + lane] = besti[u];
  }
  __syncthreads();
  float b = s_bd[0][tid];
  int bi = WANT_IDX ? s_bi[0][tid] : 0;
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float d = s_bd[w][tid];
    if (WANT_IDX) {
      const int i = s_bi[w][tid];
      if (d < b || (d == b && i < bi)) {
        b = d;
        bi = i;
      }
    } else {
      b = fminf(b, d);
    }
  }
  const int qi = q0 + tid;

  if (S > 1) {  // write the partials; the last block of the tile merges
    const size_t o = ((size_t)split * gridDim.y + row) * Q + qi;
    if (qi < Q) {
      part_d[o] = b;
      if (WANT_IDX) part_i[o] = bi;
    }
    __threadfence();
    __syncthreads();
    int* counter = counters + (size_t)row * gridDim.x + blockIdx.x;
    if (tid == 0) s_last = atomicAdd(counter, 1) == S - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (qi < Q) {
      b = CUDART_INF_F;
      bi = 0;
      for (int s = 0; s < S; ++s) {  // ascending: ties keep the lower split
        const size_t os = ((size_t)s * gridDim.y + row) * Q + qi;
        const float d = __ldcg(part_d + os);
        if (d < b) {
          b = d;
          if (WANT_IDX) bi = __ldcg(part_i + os);
        }
      }
    }
    if (tid == 0) *counter = 0;  // ready for the next call
  }

  if (qi < Q) {
    const size_t o = (size_t)row * Q + qi;
    dist[o] = sqrtf(fmaxf(b, 0.0f));
    if (WANT_IDX) idx[o] = bi;
  }
}

}  // namespace

// Launches K5 on `stream` (the staging kernel, then the scan) and returns
// cudaGetLastError() (0 on success). `idx` may be null (distances only).
// q_row, p_row, m_row: elements between rows of query, points and mask, whose
// inner dimensions are contiguous. staged: [R, N] float4 scratch; info: [R,
// ceil(N / 1024)] float4 scratch. splits, per_split: the point range is cut
// into `splits` ranges of `per_split` points (a multiple of 1024); with
// splits > 1, part_d/part_i hold [splits, R, Q] and counters [R, query
// tiles] zeros, which the kernel leaves zero. Requires R <= 65535 and Q, N
// >= 1; the wrapper checks shapes, types and devices.
extern "C" int nearest_banded_launch(
    const float* query, long long q_row, const float* points, long long p_row,
    const uint8_t* mask, long long m_row, const uint8_t* alive,
    const float* band, float4* staged, float4* info, float* dist, int* idx,
    float* part_d, int* part_i, int* counters, int R, int Q, int N,
    int splits, int per_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  stage_kernel<<<dim3((N + kChunk - 1) / kChunk, R), kStageThreads, 0, s>>>(
      points, p_row, mask, m_row, staged, info, N);
  const dim3 grid((Q + kTile - 1) / kTile, R, splits);
  if (idx)
    scan_kernel<true><<<grid, kThreads, 0, s>>>(
        query, q_row, alive, band, staged, info, dist, idx, part_d, part_i,
        counters, Q, N, per_split);
  else
    scan_kernel<false><<<grid, kThreads, 0, s>>>(
        query, q_row, alive, band, staged, info, dist, idx, part_d, part_i,
        counters, Q, N, per_split);
  return (int)cudaGetLastError();
}
