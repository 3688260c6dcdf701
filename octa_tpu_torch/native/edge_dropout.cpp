// Hierarchical edge dropout's per-edge pass (ops/raster.py::edge_dropout).
//
// Over the radius-kept edges in order: an edge whose proximal node (node2)
// is blacklisted is dropped without a draw; any other takes the next draw
// and is dropped if it is below p; a dropped edge blacklists its distal
// node (node1). Python's loop holds the interpreter lock for every edge;
// this one runs with the lock released (ctypes). The draws are Python's
// own, made beforehand from the generator's state (numpy's Mersenne
// Twister gives the same numbers); the caller advances the generator by
// the draws taken.
//
// Nodes compare as Python's tuples of floats do: by value, so -0.0 equals
// 0.0 and a NaN equals nothing.
//
// Built by octa_tpu_torch/native/__init__.py at first use:
//   g++ -O3 -shared -fPIC -o build/native/libedge_dropout_<hash>.so edge_dropout.cpp
#include <cstdint>
#include <cstring>
#include <unordered_set>

namespace {

struct Node {
  double x, y, z;
};

uint64_t bits(double v) {
  v += 0.0;  // -0.0 -> 0.0, so that equal values hash alike
  uint64_t b;
  std::memcpy(&b, &v, sizeof b);
  return b;
}

struct NodeHash {
  size_t operator()(const Node& n) const {
    uint64_t h = bits(n.x) * 0x9E3779B97F4A7C15ULL;
    h ^= bits(n.y) + 0x632BE59BD9B4E019ULL + (h << 6) + (h >> 2);
    h ^= bits(n.z) + 0x94D049BB133111EBULL + (h << 6) + (h >> 2);
    return static_cast<size_t>(h);
  }
};

struct NodeEq {
  bool operator()(const Node& a, const Node& b) const {
    return a.x == b.x && a.y == b.y && a.z == b.z;
  }
};

Node at(const double* xyz, int64_t i) {
  return Node{xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
}

}  // namespace

extern "C" {

// node1, node2: [E, 3]; kept: the n radius-kept edge indices, in order;
// draws: at least n numbers; black: the n_black blacklisted nodes [n_black,
// 3] on entry. Clears keep[e] of every dropped edge e and writes the
// dropped edges, in order, to dropped (*n_dropped of them). Returns the
// number of draws taken.
int64_t edge_dropout(const double* node1, const double* node2,
                     const int64_t* kept, int64_t n, const double* draws,
                     double p, const double* black, int64_t n_black,
                     uint8_t* keep, int64_t* dropped, int64_t* n_dropped) {
  std::unordered_set<Node, NodeHash, NodeEq> blacklist;
  for (int64_t i = 0; i < n_black; ++i) blacklist.insert(at(black, i));
  int64_t taken = 0, nd = 0;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t e = kept[j];
    bool drop = !blacklist.empty() && blacklist.count(at(node2, e)) > 0;
    if (!drop) drop = draws[taken++] < p;
    if (drop) {
      keep[e] = 0;
      dropped[nd++] = e;
      blacklist.insert(at(node1, e));
    }
  }
  *n_dropped = nd;
  return taken;
}

}  // extern "C"
