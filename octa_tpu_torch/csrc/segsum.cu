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
// The order of the sums is fixed: every node's values are added one after
// the other, starting from 0, in ascending source order, the order of a
// sequential scatter-add. Float atomics would add in an order that changes
// from run to run, and with F = 18 many sources add into one node: a
// last-bit difference there can flip a growth decision downstream. So the
// kernel is equal, bit for bit, to the scatter-add on the CPU.
//
// What bounds it: bytes (seg and feats read once, out written once; one
// addition per feature value). The design is one launch with no sort and no
// scratch memory:
//   - grid (node tiles, R, feature blocks): a block of T threads owns T
//     consecutive nodes of one row (T = 1024 at F = 1, 512 at F = 18, 256
//     otherwise, fewer where the grid would get under ~2 blocks an SM, as
//     the wrapper chooses) and FB features of each (FB = F for F = 1 and
//     18, else blocks of 4);
//   - the block streams the row's ids in ascending order, 4,096 a round
//     (2,048 at T = 256), each thread a run of consecutive ids taken with
//     16- or 8-byte loads, the next round's loaded ahead; the ids in the
//     tile are compacted stably into a list in shared memory (a source and
//     a local node packed into 32 bits) through one block-wide prefix of the
//     per-thread counts: one __syncthreads a round;
//   - when the list is nearly full, and after the last round, the list is
//     walked in order: the values of a batch of its entries are loaded into
//     shared memory all at once (so no thread waits on device memory per
//     entry), then every warp picks the entries of its own 32 nodes out of
//     each 32 with a ballot and its lanes add them, in ascending order, with
//     __fadd_rn into registers;
//   - the tile's sums go out through shared memory as one coalesced block.
// Sentinel ids (== nc) fall in no tile. The price is that every block reads
// its row's ids from L2 again (nc / T reads of Sq ids a row). One node with
// thousands of sources serialises its warp: exact, but slow.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSpare = 1024;             // list entries kept beyond a round's
constexpr int kLocalBits = 11;           // a list entry: source << 11 | node
constexpr unsigned kNoNode = (1u << kLocalBits) - 1u;  // no tile is this big

// list entries whose values are staged in shared memory at a time
template <int FB>
struct Batch {
  static constexpr int kEntries = FB >= 16 ? 256 : (FB >= 4 ? 1024 : 2048);
};

// The KV consecutive ids of one thread from row position s: 16- or 8-byte
// loads where the row is aligned for them (vec), else one at a time; ids
// past the row read as the sentinel.
template <typename Id, int KV>
__device__ __forceinline__ void load_ids(const Id* __restrict__ row, int s,
                                         int Sq, bool vec, Id nc, Id (&id)[KV]) {
  constexpr int kBytes = KV * (int)sizeof(Id);
  using Vec = typename std::conditional<
      kBytes % 16 == 0, uint4,
      typename std::conditional<kBytes % 8 == 0, uint2, Id>::type>::type;
  constexpr int kN = kBytes / (int)sizeof(Vec);
  if (vec && s + KV <= Sq) {
    union {
      Vec v[kN];
      Id i[KV];
    } u;
#pragma unroll
    for (int n = 0; n < kN; ++n) u.v[n] = reinterpret_cast<const Vec*>(row + s)[n];
#pragma unroll
    for (int v = 0; v < KV; ++v) id[v] = u.i[v];
  } else {
#pragma unroll
    for (int v = 0; v < KV; ++v) id[v] = s + v < Sq ? row[s + v] : nc;
  }
}

// One block of THREADS threads owns THREADS consecutive nodes of one row
// (thread t the node n0 + t) and FB features of each, and scans the row's
// ids CHUNK at a time, kV = CHUNK / THREADS consecutive ids a thread: 4,096
// a round, or 2,048 for a tile of 256, where 16 ids a thread cost more
// registers than the fewer rounds save.
template <typename Id, int THREADS, int FB>
__global__ void __launch_bounds__(THREADS)
segsum_kernel(const Id* __restrict__ seg,      // [R, Sq] in [0, nc]
              const float* __restrict__ feats, // [R, Sq, F]
              float* __restrict__ out,         // [R, nc, F]
              int Sq, int nc, int F, int vec) {
  constexpr int CHUNK = THREADS == 256 ? 2048 : 4096;
  constexpr int kWarps = THREADS / 32;
  constexpr int kCap = CHUNK + kSpare;   // list entries in shared memory
  constexpr int kV = CHUNK / THREADS;    // consecutive ids a thread takes
  static_assert(kV * THREADS == CHUNK && kWarps <= 32, "round layout");
  static_assert(THREADS < (int)kNoNode, "local node ids fit the entry");
  constexpr int kB = Batch<FB>::kEntries;
  // while scanning: the list and the values of a batch of its entries; at
  // the end: the tile's sums
  constexpr int kListBytes = kCap * 4 + kB * FB * 4;
  constexpr int kOutBytes = THREADS * FB * 4;
  __shared__ __align__(16)
      unsigned char s_raw[kListBytes > kOutBytes ? kListBytes : kOutBytes];
  __shared__ int s_wsum[2][32];
  unsigned* s_ent = reinterpret_cast<unsigned*>(s_raw);
  float* s_val = reinterpret_cast<float*>(s_raw + kCap * 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int n0 = blockIdx.x * THREADS;
  const int f0 = blockIdx.z * FB;
  const int span = min(THREADS, nc - n0);
  const Id* srow = seg + (size_t)row * Sq;
  const float* frow = feats + (size_t)row * Sq * F + f0;

  float acc[FB];
#pragma unroll
  for (int f = 0; f < FB; ++f) acc[f] = 0.0f;

  // the ids of the first round; each round loads the next one's ahead
  Id id[kV];
  load_ids<Id, kV>(srow, tid * kV, Sq, vec, (Id)nc, id);

  int len = 0;  // entries in the list (the same in every thread)
  for (int c0 = 0, round = 0; c0 < Sq; c0 += CHUNK, ++round) {
    const int buf = round & 1;
    int loc[kV];
    unsigned hit = 0;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const Id l = id[v] - (Id)n0;  // the sentinel and other tiles: outside
      loc[v] = (int)l;
      if (l >= 0 && l < (Id)span) hit |= 1u << v;
    }
    load_ids<Id, kV>(srow, c0 + CHUNK + tid * kV, Sq, vec, (Id)nc, id);
    // the block's exclusive prefix of the counts, in thread (= id) order
    const int cnt = __popc(hit);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) s_wsum[buf][warp] = incl;
    __syncthreads();
    const int w = lane < kWarps ? s_wsum[buf][lane] : 0;
    int wincl = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, wincl, o);
      if (lane >= o) wincl += x;
    }
    const int total = __shfl_sync(0xffffffffu, wincl, 31);
    int k = len + __shfl_sync(0xffffffffu, wincl - w, warp) + incl - cnt;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (hit >> v & 1)
        s_ent[k++] = (unsigned)(c0 + tid * kV + v) << kLocalBits | (unsigned)loc[v];
    len += total;
    if (len <= kCap - CHUNK && c0 + CHUNK < Sq) continue;

    // walk the list in order, a batch of entries at a time: their values are
    // loaded into shared memory all at once, then every warp takes the
    // entries of its own 32 nodes, 32 entries a step, in ascending order
    for (int b0 = 0; b0 < len; b0 += kB) {
      const int nb = min(kB, len - b0);
      __syncthreads();  // the list is written; the last batch is consumed
      for (int e = tid; e < nb * FB; e += THREADS) {
        const int q = e / FB, f = e - q * FB;
        s_val[e] = (FB == 1 || f0 + f < F)
                       ? frow[(size_t)(s_ent[b0 + q] >> kLocalBits) * F + f]
                       : 0.0f;
      }
      __syncthreads();
      for (int k0 = 0; k0 < nb; k0 += 32) {
        const unsigned nd = k0 + lane < nb
                                ? s_ent[b0 + k0 + lane] & kNoNode : kNoNode;
        unsigned mine = __ballot_sync(0xffffffffu, (int)(nd >> 5) == warp);
        while (mine) {  // the same in every lane: ascending entries
          const int b = __ffs(mine) - 1;
          mine &= mine - 1;
          if (lane == (int)(__shfl_sync(0xffffffffu, nd, b) & 31)) {
#pragma unroll
            for (int f = 0; f < FB; ++f)
              acc[f] = __fadd_rn(acc[f], s_val[(k0 + b) * FB + f]);
          }
        }
      }
    }
    __syncthreads();  // the list is consumed before it is written again
    len = 0;
  }

  if (FB == F) {  // the tile's [span, F] block of out is contiguous
    float* s_out = reinterpret_cast<float*>(s_raw);
#pragma unroll
    for (int f = 0; f < FB; ++f) s_out[tid * FB + f] = acc[f];
    __syncthreads();
    float* o = out + ((size_t)row * nc + n0) * F;
    for (int q = tid; q < span * F; q += THREADS) o[q] = s_out[q];
  } else if (tid < span) {
    float* o = out + ((size_t)row * nc + n0 + tid) * F + f0;
#pragma unroll
    for (int f = 0; f < FB; ++f)
      if (f0 + f < F) o[f] = acc[f];
  }
}

template <typename Id, int THREADS, int FB>
void launch(const void* seg, const float* feats, float* out, int R, int Sq,
            int nc, int F, cudaStream_t stream) {
  dim3 grid((nc + THREADS - 1) / THREADS, R, (F + FB - 1) / FB);
  // vector loads need every row to start on a 16-byte boundary
  const int vec = ((uintptr_t)seg % 16 == 0) && ((size_t)Sq * sizeof(Id)) % 16 == 0;
  segsum_kernel<Id, THREADS, FB><<<grid, THREADS, 0, stream>>>(
      static_cast<const Id*>(seg), feats, out, Sq, nc, F, vec);
}

// F = 1 (the Murray sweep) takes tiles of 256, 512 or 1024 nodes; F = 18
// (the attraction sums) 256 or 512; any other F blocks of 4 features, 256.
template <typename Id>
int launch_id(const void* seg, const float* feats, float* out, int R, int Sq,
              int nc, int F, int tile, cudaStream_t s) {
  if (F == 1 && tile == 256) launch<Id, 256, 1>(seg, feats, out, R, Sq, nc, F, s);
  else if (F == 1 && tile == 512) launch<Id, 512, 1>(seg, feats, out, R, Sq, nc, F, s);
  else if (F == 1 && tile == 1024) launch<Id, 1024, 1>(seg, feats, out, R, Sq, nc, F, s);
  else if (F == 18 && tile == 256) launch<Id, 256, 18>(seg, feats, out, R, Sq, nc, F, s);
  else if (F == 18 && tile == 512) launch<Id, 512, 18>(seg, feats, out, R, Sq, nc, F, s);
  else if (F != 1 && F != 18 && tile == 256) launch<Id, 256, 4>(seg, feats, out, R, Sq, nc, F, s);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 on success).
// `seg` is int32 (id64 == 0) or int64 (id64 == 1); `tile` is the nodes (and
// threads) of a block, as launch_id allows. Requires R <= 65535, F >= 1 and
// Sq < 2^21 (a list entry packs the source into 21 bits); the wrapper checks
// shapes, types and devices.
extern "C" int segsum_launch(const void* seg, int id64, const float* feats,
                             float* out, int R, int Sq, int nc, int F, int tile,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err =
      id64 ? launch_id<int64_t>(seg, feats, out, R, Sq, nc, F, tile, s)
           : launch_id<int>(seg, feats, out, R, Sq, nc, F, tile, s);
  return err ? err : (int)cudaGetLastError();
}
