// K5: banded masked nearest-neighbour distances for Hopper (sm_90a).
//
// Replaces the TPU kernel octa_tpu/ops/pallas_nearest.py:204 (_banded_kernel)
// behind masked_nearest_banded_pallas (:269). K2 (nearest.cu) with one mask
// and a pruning rule: the points of a row are scanned in chunks of 1024, and
// a block of 128 queries skips every chunk whose valid points' y-range
// [plo, phi] misses the block's own y-range
//     [lo, hi] = [min over alive queries of qy - band,
//                 max over alive queries of qy + band].
// For an alive query every point within `band` of it lies in a chunk that is
// scanned, so wherever the true nearest distance is <= band the result is
// K2's, bit for bit (same d2 arithmetic, same ascending order, same strict
// `<`, so the lowest index on ties). Beyond the band the result is the
// nearest among the scanned chunks only; where nothing was scanned or no
// point is valid it is +inf and index 0.
//
// The function is fixed everywhere, not only inside the band: the plain
// PyTorch version uses the same 128-query tiles, the same 1024-point chunks
// and the same skip rule, so the two agree bit for bit at every query.
//
// What bounds it: operations, as K2, but over the pairs actually scanned. The
// design is K2's (one query per thread, points staged through shared memory
// as float4, one 16-byte broadcast load per pair) plus:
//   - [lo, hi] by a block reduction (warp shuffles, then one shared round);
//     dead queries and the idle lanes of a ragged tile carry +inf / -inf, so
//     an all-dead tile has lo = +inf, hi = -inf and skips every chunk;
//   - the per-chunk [plo, phi] come from the wrapper (two PyTorch
//     reductions over the valid points; an all-invalid chunk has +inf / -inf
//     and is skipped by every tile);
//   - the skip is block-uniform and tested before the chunk is staged, so a
//     skipped chunk costs two scalar loads and no point traffic.
// With unsorted points every chunk spans the whole y-range and nothing is
// skipped: a full scan, still exact.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // queries per block (the pruning tile)
constexpr int kChunk = 1024;   // points per chunk (the pruning granule)

template <bool WANT_IDX>
__global__ void __launch_bounds__(kThreads)
banded_kernel(const float* __restrict__ query,    // [R, Q, 3]
              const float* __restrict__ points,   // [R, N, 3]
              const uint8_t* __restrict__ mask,   // [R, N] bool
              const uint8_t* __restrict__ alive,  // [R, Q] bool
              const float* __restrict__ band,     // [R]
              const float* __restrict__ plo,      // [R, n_chunks]
              const float* __restrict__ phi,      // [R, n_chunks]
              float* __restrict__ dist,           // [R, Q]
              int* __restrict__ idx,              // [R, Q] (WANT_IDX)
              int Q, int N) {
  __shared__ float4 s_pt[kChunk];
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];

  const int row = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int ql = min(qi, Q - 1);  // ragged tile: idle lanes repeat the last query
  const float* qp = query + ((size_t)row * Q + ql) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* prow = points + (size_t)row * N * 3;
  const uint8_t* mrow = mask + (size_t)row * N;
  const int n_chunks = (N + kChunk - 1) / kChunk;

  // the tile's banded y-range over its alive queries
  const bool live = qi < Q && alive[(size_t)row * Q + ql];
  const float bnd = band[row];
  float lo = live ? __fsub_rn(qy, bnd) : CUDART_INF_F;
  float hi = live ? __fadd_rn(qy, bnd) : -CUDART_INF_F;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x >> 5] = lo;
    s_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }

  float best = CUDART_INF_F;
  int besti = 0;
  for (int c = 0; c < n_chunks; ++c) {
    // block-uniform: every thread reads the same two scalars
    const float cl = plo[(size_t)row * n_chunks + c];
    const float ch = phi[(size_t)row * n_chunks + c];
    if (!(ch >= lo && cl <= hi)) continue;
    const int c0 = c * kChunk;
    const int n = min(kChunk, N - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* pp = prow + (size_t)(c0 + j) * 3;
      s_pt[j] = make_float4(pp[0], pp[1], pp[2],
                            __int_as_float(mrow[c0 + j] ? 1 : 0));
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 p = s_pt[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float cand = __float_as_int(p.w) ? d2 : CUDART_INF_F;
      if (cand < best) {
        best = cand;
        if (WANT_IDX) besti = c0 + j;
      }
    }
  }

  if (qi < Q) {
    const size_t o = (size_t)row * Q + qi;
    dist[o] = sqrtf(fmaxf(best, 0.0f));
    if (WANT_IDX) idx[o] = besti;
  }
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success).
// `idx` may be null (distances only). `plo`, `phi` are [R, ceil(N / 1024)].
// Requires R <= 65535 and Q, N >= 1; the wrapper checks shapes, types and
// devices.
extern "C" int nearest_banded_launch(
    const float* query, const float* points, const uint8_t* mask,
    const uint8_t* alive, const float* band, const float* plo,
    const float* phi, float* dist, int* idx, int R, int Q, int N,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((Q + kThreads - 1) / kThreads, R);
  if (idx)
    banded_kernel<true><<<grid, kThreads, 0, s>>>(
        query, points, mask, alive, band, plo, phi, dist, idx, Q, N);
  else
    banded_kernel<false><<<grid, kThreads, 0, s>>>(
        query, points, mask, alive, band, plo, phi, dist, idx, Q, N);
  return (int)cudaGetLastError();
}
