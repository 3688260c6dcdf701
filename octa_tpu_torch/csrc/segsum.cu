// K3: segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel octa_tpu/ops/pallas_segsum.py:42 (_segsum_kernel)
// behind segsum_onehot_pallas (:72):
//     out[r, n, f] = sum over s with seg[r, s] == n of feats[r, s, f],
// seg in [0, nc]; rows with seg == nc (the drop sentinel) add nowhere. The
// base-128 digit one-hot, the Khatri-Rao block and the bf16 hi/lo split of
// the TPU kernel feed a matrix unit and are not carried over: the sums are
// taken in float32.
//
// What bounds it: bytes (seg and feats read once, out written once; one
// addition per feature value).
//
// Design: a sort and a segmented reduction, so that the sum has a fixed
// order. The wrapper sorts each row's segment ids stably (PyTorch sort),
// which leaves every node's rows contiguous and in ascending row order.
// One thread per (row, node, feature) finds its node's range in the sorted
// ids by binary search and adds its rows' values one after the other,
// starting from 0, in ascending row order: the order in which a sequential
// scatter-add meets them. Float atomics into a zeroed output would add in an
// order that changes from run to run, and with F = 18 many rows add into one
// node: a last-bit difference there can flip a growth decision downstream.
// Threads of one node are neighbours and read neighbouring features.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int* __restrict__ seg_sorted,  // [R, Sq] ascending
              const int64_t* __restrict__ perm,    // [R, Sq] row of each entry
              const float* __restrict__ feats,     // [R, Sq, F]
              float* __restrict__ out,             // [R, nc, F]
              int Sq, int nc, int F) {
  const int row = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= nc * F) return;
  const int node = t / F;
  const int f = t - node * F;
  const int* seg = seg_sorted + (size_t)row * Sq;
  const int64_t* pr = perm + (size_t)row * Sq;
  const float* fr = feats + (size_t)row * Sq * F;

  int lo = 0, hi = Sq;  // first position with seg >= node
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] < node) lo = mid + 1; else hi = mid;
  }
  float acc = 0.0f;
  for (int k = lo; k < Sq && seg[k] == node; ++k)
    acc = __fadd_rn(acc, fr[(size_t)pr[k] * F + f]);
  out[((size_t)row * nc + node) * F + f] = acc;
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 on success).
// Requires R <= 65535; the wrapper sorts, checks shapes, types and devices.
extern "C" int segsum_launch(const int* seg_sorted, const int64_t* perm,
                             const float* feats, float* out, int R, int Sq,
                             int nc, int F, void* stream) {
  dim3 grid((nc * F + kThreads - 1) / kThreads, R);
  segsum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      seg_sorted, perm, feats, out, Sq, nc, F);
  return (int)cudaGetLastError();
}
