// K6: blocked greedy spacing of growth's candidate sinks, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package takes this step as a lax.scan over
// 64 blocks (octa_tpu/sim/greenhouse.py:313, _blocked_greedy_spacing); the
// port's plain version (ops/spacing.py::spacing_plain) takes every pairwise
// distance of a row at once, a [R, n, n, 3] tensor, and then combines boolean
// masks block by block: about 9 GB of traffic and some 340 launches a call at
// R = 32, n = 2000, for a decision worth about 0.6 GFLOP. This kernel is one
// launch that writes nothing but the answer.
//
// What it computes, for each row r of R, candidates pos[r, k] and valid[r, k]
// (k < n), eps = eps[r]: with bs = ceil(n / n_blocks), candidate k lies in
// block k / bs;
//   ok[k]       = valid[k] and no valid j < k of k's block is close to k
//                 (the conservative rule inside a block);
//   accepted[k] = ok[k] and no accepted j of an earlier block is close to k;
//   close(k, j) = sqrt((dx*dx + dz*dz) + dy*dy) <= eps, d = pos[k] - pos[j],
// each operation correctly rounded and none contracted into an FMA
// (__fsub_rn, __fmul_rn, __fadd_rn, __fsqrt_rn): the plain version's
// arithmetic on the card, so that both reach the same decisions bit for
// bit. The order of the sum is the one PyTorch's reduction over an axis of
// 3 takes on the card (its four accumulators combined as a tree: x with z,
// then y), which chip_smoke.py's [k6] phase holds bit for bit. The square
// root is taken once a row, not once a pair: a correctly rounded square root
// never decreases, so __fsqrt_rn(s) <= eps holds exactly for the sums s up
// to the largest float t for which it holds, and each pair compares its sum
// with t (close_limit finds t from eps * eps in a few float steps).
//
// What bounds it: not bytes (16 a candidate in, one out) nor operations (9 a
// pair, at most n^2 / 2 pairs a row) but the chain of n_blocks rounds, each of
// which needs the acceptances of the one before. The design keeps every round
// short and inside one block of threads:
//   - one block a row; the row's positions are staged in shared memory as
//     x / y / z arrays (12 B a candidate) where they fit beside the rest
//     (n up to about 17,000), else read through L1 / L2 from the input;
//   - phase 1, every thread a candidate at a time: the in-block rule against
//     the at most bs - 1 earlier candidates of its block; the result is a
//     byte a candidate in shared memory (ok);
//   - round i: warp 0 writes block i's answers (its ok bytes, which every
//     earlier round has already cleared where an acceptance was close) and
//     appends the positions of its acceptances, in order, to a list of the
//     round's new entries (ballot and popc), padded with NaN (close to
//     nothing) to a multiple of 4; then every thread tests each still-ok
//     candidate of the later blocks against those new entries only, four
//     independent tests at a time, and clears its ok byte on the first four
//     that hold a close one. So no candidate is
//     ever tested against an accepted position twice, the round's serial
//     part is one warp's ballot, and the work of a round spreads over all
//     the block's threads; a round that accepts nothing ends after one
//     barrier. The new-entry list and its count are double-buffered, so a
//     thread still reading round i's count never sees round i + 1's.
// No [n, n] tensor is written and nothing is allocated: shared memory holds
// 8 + 24 bs4 + n bytes (bs4: bs rounded up to a multiple of 4), plus 12 n
// where staged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxShared = 232448;  // what a block of an H100 may use

// The largest float t with __fsqrt_rn(t) <= eps (+inf where every sum
// passes), so that for every sum of squares s (never negative, or NaN),
// s <= t exactly when __fsqrt_rn(s) <= eps. NaN where nothing passes (eps
// NaN), -1 for eps < 0.
__device__ float close_limit(float eps) {
  if (!(eps >= 0.0f)) return eps < 0.0f ? -1.0f : eps;
  float t = __fmul_rn(eps, eps);
  while (t > 0.0f && !(__fsqrt_rn(t) <= eps)) t = nextafterf(t, 0.0f);
  while (t < INFINITY && __fsqrt_rn(nextafterf(t, INFINITY)) <= eps)
    t = nextafterf(t, INFINITY);
  return t;
}

// sqrt((dx*dx + dz*dz) + dy*dy) <= eps, with t = close_limit(eps)
__device__ __forceinline__ bool close_to(float ax, float ay, float az,
                                         float bx, float by, float bz,
                                         float t) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)),
                            __fmul_rn(dy, dy));
  return s <= t;
}

template <bool STAGED>
__global__ void __launch_bounds__(kMaxThreads)
spacing_kernel(const float* __restrict__ pos, const uint8_t* __restrict__ valid,
               const float* __restrict__ eps, int eps_stride,
               uint8_t* __restrict__ out, int n, int bs, int n_blocks) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int bs4 = (bs + 3) & ~3;  // a round's new entries, padded
  int* s_count = reinterpret_cast<int*>(s_raw);              // [2]
  float* s_new = reinterpret_cast<float*>(s_raw + 8);        // [2][3][bs4]
  float* s_x = s_new + 6 * bs4;                              // [n] if STAGED
  float* s_y = s_x + n;
  float* s_z = s_y + n;
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(STAGED ? s_z + n : s_x);  // [n]

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t row = blockIdx.x;
  const float* p = pos + row * (size_t)n * 3;
  const uint8_t* v = valid + row * (size_t)n;
  uint8_t* o = out + row * (size_t)n;
  const float t = close_limit(eps[row * (size_t)eps_stride]);

  auto at = [&](int k, float& x, float& y, float& z) {
    if constexpr (STAGED) {
      x = s_x[k];
      y = s_y[k];
      z = s_z[k];
    } else {
      x = p[3 * k];
      y = p[3 * k + 1];
      z = p[3 * k + 2];
    }
  };

  if constexpr (STAGED) {
    for (int k = tid; k < n; k += T) {
      s_x[k] = p[3 * k];
      s_y[k] = p[3 * k + 1];
      s_z[k] = p[3 * k + 2];
    }
    __syncthreads();
  }

  // phase 1: the in-block rule against earlier valid candidates
  for (int k = tid; k < n; k += T) {
    bool keep = v[k] != 0;
    if (keep) {
      float x, y, z;
      at(k, x, y, z);
      for (int j = (k / bs) * bs; j < k; ++j) {
        if (!v[j]) continue;
        float jx, jy, jz;
        at(j, jx, jy, jz);
        if (close_to(x, y, z, jx, jy, jz, t)) {
          keep = false;
          break;
        }
      }
    }
    s_ok[k] = keep;
  }
  __syncthreads();

  // phase 2: the blocks in order
  for (int i = 0; i < n_blocks; ++i) {
    const int b0 = i * bs;
    if (b0 >= n) break;  // the same for every thread
    const int b1 = min(b0 + bs, n);
    const int buf = i & 1;
    float* nx = s_new + buf * 3 * bs4;
    float* ny = nx + bs4;
    float* nz = ny + bs4;
    if (tid < 32) {  // warp 0: the block's answers and its new entries
      int m = 0;
      for (int base = b0; base < b1; base += 32) {
        const int k = base + tid;
        const bool acc = k < b1 && s_ok[k];
        if (k < b1) o[k] = acc;
        const unsigned ball = __ballot_sync(0xffffffffu, acc);
        if (acc) {
          const int slot = m + __popc(ball & ((1u << tid) - 1u));
          at(k, nx[slot], ny[slot], nz[slot]);
        }
        m += __popc(ball);
      }
      if (tid < ((4 - m) & 3)) nx[m + tid] = ny[m + tid] = nz[m + tid] = NAN;
      if (tid == 0) s_count[buf] = m;
    }
    __syncthreads();
    const int m = s_count[buf];
    if (m == 0) continue;
    for (int k = b1 + tid; k < n; k += T) {
      if (!s_ok[k]) continue;
      float x, y, z;
      at(k, x, y, z);
      for (int q = 0; q < m; q += 4) {
        bool hit = false;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          hit |= close_to(x, y, z, nx[q + u], ny[q + u], nz[q + u], t);
        if (hit) {
          s_ok[k] = 0;
          break;
        }
      }
    }
    __syncthreads();
  }
}

template <bool STAGED>
int launch(const float* pos, const uint8_t* valid, const float* eps,
           int eps_stride, uint8_t* out, int R, int n, int bs, int n_blocks,
           int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spacing_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  spacing_kernel<STAGED><<<R, threads, smem, stream>>>(
      pos, valid, eps, eps_stride, out, n, bs, n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K6 on `stream` and returns a cudaError_t (0 on success). pos
// [R, n, 3] f32 and valid [R, n] bool, both contiguous; out [R, n] bool, every
// entry written. eps[r * eps_stride] is row r's eps (eps_stride 0: one for
// every row). bs = ceil(n / n_blocks); threads (a multiple of 32, at
// most 1024), staged and smem (the shared bytes) are the wrapper's plan
// (ops/spacing.py::spacing_plan), which checks shapes, types and devices.
extern "C" int spacing_launch(const float* pos, const void* valid,
                              const float* eps, int eps_stride, void* out,
                              int R, int n, int bs, int n_blocks, int threads,
                              int staged, int smem, void* stream) {
  if (R < 1 || n < 1 || bs < 1 || n_blocks < 1 || (long long)bs * n_blocks < n ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem > kMaxShared)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint8_t* o = static_cast<uint8_t*>(out);
  return staged ? launch<true>(pos, v, eps, eps_stride, o, R, n, bs, n_blocks,
                               threads, smem, s)
                : launch<false>(pos, v, eps, eps_stride, o, R, n, bs, n_blocks,
                                threads, smem, s);
}
