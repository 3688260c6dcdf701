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
// sums per pair, each rounded on its own (__fmul_rn / __fadd_rn keep the
// compiler from contracting them into fused multiply-adds), summed x, y, z in
// that order. The plain PyTorch version rounds at the same places, so kernel
// and plain version agree bit for bit, ties included. The expanded form
// |q|^2 + |p|^2 - 2 q.p is never used: it cancels for pairs much closer than
// their norms and flips accept decisions near the eps/delta thresholds.
//
// What bounds it: operations. R*Q*N*M pairs of 8 float operations each on the
// FP32 pipes against a few bytes per query and point. The design therefore
//   - gives each block one row and a tile of 128 queries, one query per
//     thread, its coordinates and the running (min, argmin) of every mask in
//     registers;
//   - stages the row's points through shared memory 1024 at a time as float4
//     (x, y, z, mask bits), read straight from the bool masks, so the inner
//     loop takes one 16-byte broadcast load per pair and nothing from device
//     memory;
//   - keeps the strict `<` over ascending point indices, which leaves the
//     lowest index on ties;
//   - pads nothing: the ragged last query tile and point chunk are masked.
// Occupancy: grids with Q = 2000 give 16 blocks per row (128 at R = 8, under
// one wave of 132 SMs); the large grids give several thousand blocks.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kChunk = 1024;   // points staged per round

template <int M, bool WANT_IDX>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ query,   // [R, Q, 3]
               const float* __restrict__ points,  // [R, N, 3]
               const uint8_t* __restrict__ masks, // [R, M, N] bool
               float* __restrict__ dist,          // [R, M, Q]
               int* __restrict__ idx,             // [R, M, Q] (WANT_IDX)
               int Q, int N) {
  __shared__ float4 s_pt[kChunk];

  const int row = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int ql = min(qi, Q - 1);  // ragged tile: idle lanes repeat the last query
  const float* qp = query + ((size_t)row * Q + ql) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* prow = points + (size_t)row * N * 3;
  const uint8_t* mrow = masks + (size_t)row * M * N;

  float best[M];
  int besti[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    best[m] = CUDART_INF_F;
    besti[m] = 0;
  }

  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int n = min(kChunk, N - c0);
    __syncthreads();  // previous chunk fully consumed
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* pp = prow + (size_t)(c0 + j) * 3;
      int bits = 0;
#pragma unroll
      for (int m = 0; m < M; ++m)
        bits |= (mrow[(size_t)m * N + c0 + j] ? 1 : 0) << m;
      s_pt[j] = make_float4(pp[0], pp[1], pp[2], __int_as_float(bits));
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 p = s_pt[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const int bits = __float_as_int(p.w);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float c = ((bits >> m) & 1) ? d2 : CUDART_INF_F;
        if (c < best[m]) {
          best[m] = c;
          if (WANT_IDX) besti[m] = c0 + j;
        }
      }
    }
  }

  if (qi < Q) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const size_t o = ((size_t)row * M + m) * Q + qi;
      dist[o] = sqrtf(fmaxf(best[m], 0.0f));
      if (WANT_IDX) idx[o] = besti[m];
    }
  }
}

template <int M>
void launch_m(const float* q, const float* p, const uint8_t* masks, float* d,
              int* idx, int R, int Q, int N, cudaStream_t stream) {
  dim3 grid((Q + kThreads - 1) / kThreads, R);
  if (idx)
    nearest_kernel<M, true><<<grid, kThreads, 0, stream>>>(q, p, masks, d, idx, Q, N);
  else
    nearest_kernel<M, false><<<grid, kThreads, 0, stream>>>(q, p, masks, d, idx, Q, N);
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// `idx` may be null (distances only). Requires 1 <= M <= 4, R <= 65535 and
// Q, N >= 1; the wrapper checks shapes, types and devices.
extern "C" int nearest_launch(const float* query, const float* points,
                              const uint8_t* masks, float* dist, int* idx,
                              int R, int Q, int N, int M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 1: launch_m<1>(query, points, masks, dist, idx, R, Q, N, s); break;
    case 2: launch_m<2>(query, points, masks, dist, idx, R, Q, N, s); break;
    case 3: launch_m<3>(query, points, masks, dist, idx, R, Q, N, s); break;
    case 4: launch_m<4>(query, points, masks, dist, idx, R, Q, N, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
