// K2: masked nearest-neighbour distances for Hopper (sm_90a).
//
// Replaces the TPU kernel octa_tpu/ops/pallas_nearest.py:46 (_nearest_kernel)
// behind masked_nearest_pallas (:110). For every row r, mask m and query q:
//     d2[r, m, q]  = min over points n with masks[r, m, n] of
//                    (qx - px)^2 + (qy - py)^2 + (qz - pz)^2,
//     idx[r, m, q] = the lowest n that attains it,
// and the output is d = sqrt(d2). A query with no valid point gets +inf and
// index 0, as the chunked-scan oracle (_chunked_nearest) returns.
//
// d2 is the exact difference form: three subtractions, three products and two
// sums per pair, each rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn
// keep the compiler from contracting them into fused multiply-adds), summed
// x, y, z in that order. The plain PyTorch version rounds at the same places,
// so kernel and plain version agree bit for bit, ties included. The expanded
// form |q|^2 + |p|^2 - 2 q.p is never used: it cancels for pairs much closer
// than their norms and flips accept decisions near the eps/delta thresholds.
//
// What bounds it: operations. R*Q*N*M pairs of 8 float operations each. The
// FP32 peak (67 TFLOP/s) counts a fused multiply-add as two operations; this
// form has none, so each of the 8 operations is one instruction at half that
// rate, and even a kernel that issued nothing else would take twice the
// bound. The design cuts what it issues besides them:
//   (a) with one mask, a point the mask refuses is staged as (+inf, +inf,
//       +inf): q - inf squared is +inf and never beats the best under a
//       strict `<`, so the inner loop tests no mask bit (a query with
//       nothing valid keeps +inf and index 0). With several masks the bits
//       ride in the staged float4's w and are tested per mask;
//   (b) a thread holds kQpt = 4 queries, their coordinates and running (min,
//       argmin) in registers, so one shared load and the loop's own
//       instructions serve four pairs; a block owns one row and 128 threads;
//   (c) points are staged through shared memory 1,024 at a time; while
//       staging, the block finds the chunk's first and last admitted point
//       (a warp reduction and one shared atomicMin/Max a warp) and scans
//       only between them, and skips a chunk that no mask admits. Node
//       arrays are valid on a prefix and the new-node window on a few slots,
//       so much of a growth scan goes this way, exactly;
//   (d) a grid of fewer than 8 blocks an SM splits the point range, in whole
//       chunks, over gridDim.z blocks; each writes its partial (d2, idx) to
//       scratch, and the last block of a query tile to finish (a counter per
//       tile, which it resets) merges the partials in ascending split order
//       with a strict `<` and takes the square root. Lower splits hold lower
//       indices, so ties still go to the lowest index.
// Instructions in the inner loop a pair, as cuobjdump -sass counts them with
// one mask: 11.69 with indices, 9.56 without (the 8 operations, then a
// compare and two selects, or one minimum). The earlier design (one query a
// thread, mask bits tested for every pair, no trimming, no split) issued
// 16.75 and 15.25. So the largest call can at best come to about 2.9x the
// bound over the pairs it scans.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kChunk = 1024;   // points staged per round
constexpr int kQpt = 4;        // queries per thread

template <int M, bool WANT_IDX>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ query,   // [R, Q, 3]
               const float* __restrict__ points,  // [R, N, 3]
               const uint8_t* __restrict__ masks, // [R, M, N] bool
               float* __restrict__ dist,          // [R, M, Q]
               int* __restrict__ idx,             // [R, M, Q] (WANT_IDX)
               float* __restrict__ part_d,        // [S, R, M, Q] (S > 1)
               int* __restrict__ part_i,          // [S, R, M, Q] (S > 1, WANT_IDX)
               int* __restrict__ counters,        // [R, tiles], zero (S > 1)
               int Q, int N, int per_split) {
  constexpr bool MASK_BITS = M > 1;  // one mask: refused points are +inf
  __shared__ float4 s_pt[kChunk];
  __shared__ int s_lo[2], s_hi[2];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int row = blockIdx.y, split = blockIdx.z, S = gridDim.z;
  const int q0 = blockIdx.x * (kThreads * kQpt);
  const float* prow = points + (size_t)row * N * 3;
  const uint8_t* mrow = masks + (size_t)row * M * N;

  float qx[kQpt], qy[kQpt], qz[kQpt], best[kQpt][M];
  int besti[kQpt][M];
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    const int ql = min(q0 + u * kThreads + tid, Q - 1);  // ragged tile: repeat
    const float* qp = query + ((size_t)row * Q + ql) * 3;
    qx[u] = qp[0];
    qy[u] = qp[1];
    qz[u] = qp[2];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      best[u][m] = CUDART_INF_F;
      besti[u][m] = 0;
    }
  }

  const int p_begin = split * per_split;
  const int p_end = min(N, p_begin + per_split);
  if (tid == 0) {
    s_lo[0] = s_lo[1] = kChunk;
    s_hi[0] = s_hi[1] = -1;
  }
  for (int c0 = p_begin, round = 0; c0 < p_end; c0 += kChunk, ++round) {
    const int n = min(kChunk, p_end - c0), buf = round & 1;
    __syncthreads();  // previous chunk consumed, its bounds read
    if (tid == 0) {   // the next round's bounds (read two rounds ago)
      s_lo[buf ^ 1] = kChunk;
      s_hi[buf ^ 1] = -1;
    }
    int lo = kChunk, hi = -1;
    for (int j = tid; j < n; j += kThreads) {
      const float* pp = prow + (size_t)(c0 + j) * 3;
      int bits = 0;
#pragma unroll
      for (int m = 0; m < M; ++m)
        bits |= (mrow[(size_t)m * N + c0 + j] ? 1 : 0) << m;
      if (MASK_BITS)
        s_pt[j] = make_float4(pp[0], pp[1], pp[2], __int_as_float(bits));
      else if (bits)
        s_pt[j] = make_float4(pp[0], pp[1], pp[2], 0.0f);
      else
        s_pt[j] = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.0f);
      if (bits) {
        lo = min(lo, j);
        hi = j;
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((tid & 31) == 0 && hi >= 0) {
      atomicMin(&s_lo[buf], lo);
      atomicMax(&s_hi[buf], hi);
    }
    __syncthreads();
    const int jlo = s_lo[buf], jhi = s_hi[buf];  // none admitted: jlo > jhi
#pragma unroll 4
    for (int j = jlo; j <= jhi; ++j) {
      const float4 p = s_pt[j];
#pragma unroll
      for (int u = 0; u < kQpt; ++u) {
        const float dx = __fsub_rn(qx[u], p.x);
        const float dy = __fsub_rn(qy[u], p.y);
        const float dz = __fsub_rn(qz[u], p.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float c = (!MASK_BITS || ((__float_as_int(p.w) >> m) & 1))
                              ? d2 : CUDART_INF_F;
          if (WANT_IDX) {
            if (c < best[u][m]) {
              best[u][m] = c;
              besti[u][m] = c0 + j;
            }
          } else {
            best[u][m] = fminf(best[u][m], c);  // d2 >= 0: as the strict `<`
          }
        }
      }
    }
  }

  if (S > 1) {  // write the partials; the last block of the tile merges
#pragma unroll
    for (int u = 0; u < kQpt; ++u) {
      const int qi = q0 + u * kThreads + tid;
      if (qi >= Q) continue;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const size_t o = (((size_t)split * gridDim.y + row) * M + m) * Q + qi;
        part_d[o] = best[u][m];
        if (WANT_IDX) part_i[o] = besti[u][m];
      }
    }
    __threadfence();
    __syncthreads();
    int* counter = counters + (size_t)row * gridDim.x + blockIdx.x;
    if (tid == 0) s_last = atomicAdd(counter, 1) == S - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int u = 0; u < kQpt; ++u) {
      const int qi = q0 + u * kThreads + tid;
      if (qi >= Q) continue;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float b = CUDART_INF_F;
        int bi = 0;
        for (int s = 0; s < S; ++s) {  // ascending: ties keep the lower split
          const size_t o = (((size_t)s * gridDim.y + row) * M + m) * Q + qi;
          const float d = __ldcg(part_d + o);
          if (d < b) {
            b = d;
            if (WANT_IDX) bi = __ldcg(part_i + o);
          }
        }
        best[u][m] = b;
        besti[u][m] = bi;
      }
    }
    if (tid == 0) *counter = 0;  // ready for the next call
  }

#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    const int qi = q0 + u * kThreads + tid;
    if (qi >= Q) continue;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const size_t o = ((size_t)row * M + m) * Q + qi;
      dist[o] = sqrtf(fmaxf(best[u][m], 0.0f));
      if (WANT_IDX) idx[o] = besti[u][m];
    }
  }
}

struct Args {
  const float* q;
  const float* p;
  const uint8_t* masks;
  float* d;
  int* idx;
  float* part_d;
  int* part_i;
  int* counters;
  int R, Q, N, per_split, splits;
};

template <int M>
void launch(const Args& a, cudaStream_t stream) {
  dim3 grid((a.Q + kThreads * kQpt - 1) / (kThreads * kQpt), a.R, a.splits);
  if (a.idx)
    nearest_kernel<M, true><<<grid, kThreads, 0, stream>>>(
        a.q, a.p, a.masks, a.d, a.idx, a.part_d, a.part_i, a.counters, a.Q,
        a.N, a.per_split);
  else
    nearest_kernel<M, false><<<grid, kThreads, 0, stream>>>(
        a.q, a.p, a.masks, a.d, a.idx, a.part_d, a.part_i, a.counters, a.Q,
        a.N, a.per_split);
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// `idx` may be null (distances only). A block takes 4 x 128 queries of one
// row. splits, per_split: the point range is cut into `splits` ranges of
// `per_split` points; with splits > 1, part_d/part_i hold [splits, R, M, Q]
// and counters [R, query tiles] zeros, which the kernel leaves zero.
// Requires 1 <= M <= 4, R <= 65535, Q, N >= 1; the wrapper checks shapes,
// types and devices.
extern "C" int nearest_launch(const float* query, const float* points,
                              const uint8_t* masks, float* dist, int* idx,
                              float* part_d, int* part_i, int* counters,
                              int R, int Q, int N, int M, int splits,
                              int per_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Args a{query, points, masks, dist, idx, part_d, part_i, counters,
               R, Q, N, per_split, splits};
  switch (M) {
    case 1: launch<1>(a, s); break;
    case 2: launch<2>(a, s); break;
    case 3: launch<3>(a, s); break;
    case 4: launch<4>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
