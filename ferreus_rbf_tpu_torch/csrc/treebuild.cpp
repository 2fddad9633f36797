// Interaction lists of the FMM's cell table, on the host.
//
// The port's own copy of the JAX package's ferreus_rbf_tpu/native/treebuild.cpp:
// the u/v/w lists of ferreus_rbf_tpu_torch/ops/fmm/tree.py
// (_build_interaction_lists_numpy, its plain version) walked cell by cell
// with one hash lookup per (level, anchor) instead of a vectorised numpy
// sweep per level and offset. Integer combinatorics only; no floating point.
//
//   v: for each cell of level >= 2, the children of its parent's colleagues
//      that hold points and are not adjacent to it (|delta|_inf >= 2), with
//      the base-7 id of delta = anchor(target) - anchor(source);
//   u: for each leaf, itself, every adjacent leaf of its level or coarser
//      (found by walking up from the would-be colleague), and every
//      adjacent leaf below a same-level internal colleague;
//   w: for each leaf, the cells below a same-level internal colleague that
//      are not adjacent to it (where the descent stops).
//
// The v list keeps only sources that hold points (the numpy builder leaves
// that filter to the FMM plan, ops/fmm/api.py, which applies it to both).
// Order: v in cell order, u and w in the order the walk meets them;
// tree.py sorts u and w into unique rows.
//
// Build (tree.py does it at first use, into build/):
//   g++ -O3 -std=c++17 -shared -fPIC treebuild.cpp -o treebuild_<digest>.so
//
// ABI: plain C functions over int64 and uint8 arrays (ctypes).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxDim = 3;

struct CellTable {
  int64_t ncells;
  int dim;
  const int64_t* anchors;   // (ncells, dim)
  const int64_t* levels;    // (ncells,)
  const int64_t* parent;    // (ncells,), -1 at the root
  const int64_t* children;  // (ncells, 2^dim), -1 where absent
  const uint8_t* is_leaf;   // (ncells,)
  const uint8_t* has_points;  // (ncells,)
  std::unordered_map<uint64_t, int64_t> lookup;  // packed (level, anchor) -> cell
};

// tree.py _pack: 16 bits per axis (axis 0 lowest), 5 bits of level.
inline uint64_t pack(int level, const int64_t* a, int dim) {
  uint64_t key = 0;
  for (int j = dim - 1; j >= 0; --j) key = (key << 16) | static_cast<uint64_t>(a[j] & 0xFFFF);
  return (key << 5) | static_cast<uint64_t>(level);
}

inline int64_t find(const CellTable& t, int level, const int64_t* anchor) {
  const auto it = t.lookup.find(pack(level, anchor, t.dim));
  return it == t.lookup.end() ? -1 : it->second;
}

struct Lists {
  std::vector<int64_t> v;  // (target, source, vector id) triples
  std::vector<int64_t> u;  // (target, source) pairs
  std::vector<int64_t> w;  // (target, source) pairs
};

// The 3^dim - 1 offsets in {-1, 0, 1}^dim other than 0, axis 0 slowest
// (tree.py _neighbor_offsets).
std::vector<int64_t> neighbour_offsets(int dim) {
  int total = 1;
  for (int i = 0; i < dim; ++i) total *= 3;
  std::vector<int64_t> offs;
  for (int i = 0; i < total; ++i) {
    int64_t off[kMaxDim];
    int v = i;
    bool zero = true;
    for (int j = dim - 1; j >= 0; --j) {
      off[j] = (v % 3) - 1;
      v /= 3;
      zero = zero && off[j] == 0;
    }
    if (!zero) offs.insert(offs.end(), off, off + dim);
  }
  return offs;
}

void build_v(const CellTable& t, const std::vector<int64_t>& offs, Lists& out) {
  const int dim = t.dim;
  const int nch = 1 << dim;
  const size_t noff = offs.size() / dim;
  int64_t cand[kMaxDim];
  for (int64_t c = 0; c < t.ncells; ++c) {
    const int lvl = static_cast<int>(t.levels[c]);
    if (lvl < 2) continue;
    const int64_t* ca = t.anchors + c * dim;
    const int64_t* pa = t.anchors + t.parent[c] * dim;
    const int64_t max_box_parent = int64_t(1) << (lvl - 1);
    for (size_t o = 0; o < noff; ++o) {
      bool valid = true;
      for (int j = 0; j < dim; ++j) {
        cand[j] = pa[j] + offs[o * dim + j];
        valid = valid && cand[j] >= 0 && cand[j] < max_box_parent;
      }
      if (!valid) continue;
      const int64_t pc = find(t, lvl - 1, cand);
      if (pc < 0) continue;
      const int64_t* ch = t.children + pc * nch;
      for (int k = 0; k < nch; ++k) {
        const int64_t s = ch[k];
        if (s < 0 || !t.has_points[s]) continue;
        const int64_t* sa = t.anchors + s * dim;
        int64_t vid = 0, dinf = 0;
        for (int j = 0; j < dim; ++j) {
          const int64_t d = ca[j] - sa[j];
          const int64_t ad = d < 0 ? -d : d;
          if (ad > dinf) dinf = ad;
          vid = vid * 7 + (d + 3);
        }
        if (dinf >= 2) out.v.insert(out.v.end(), {c, s, vid});
      }
    }
  }
}

void build_uw(const CellTable& t, const std::vector<int64_t>& offs, Lists& out) {
  const int dim = t.dim;
  const int nch = 1 << dim;
  const size_t noff = offs.size() / dim;
  int64_t cand[kMaxDim], shifted[kMaxDim];
  std::vector<int64_t> stack;
  for (int64_t b = 0; b < t.ncells; ++b) {
    if (!t.is_leaf[b]) continue;
    out.u.insert(out.u.end(), {b, b});
    const int lvl = static_cast<int>(t.levels[b]);
    const int64_t* ba = t.anchors + b * dim;
    const int64_t max_box = int64_t(1) << lvl;
    for (size_t o = 0; o < noff; ++o) {
      bool valid = true;
      for (int j = 0; j < dim; ++j) {
        cand[j] = ba[j] + offs[o * dim + j];
        valid = valid && cand[j] >= 0 && cand[j] < max_box;
      }
      if (!valid) continue;
      // the deepest existing cell that holds the would-be colleague
      int64_t res = -1;
      for (int l = lvl; l >= 0 && res < 0; --l) {
        for (int j = 0; j < dim; ++j) shifted[j] = cand[j] >> (lvl - l);
        res = find(t, l, shifted);
      }
      if (res < 0) continue;
      if (t.is_leaf[res]) {
        out.u.insert(out.u.end(), {b, res});
        continue;
      }
      if (t.levels[res] != lvl) continue;  // a coarser internal cell holds no leaf near b
      // descend: adjacent leaves -> u, adjacent internal cells recurse,
      // cells not adjacent -> w
      stack.assign(1, res);
      while (!stack.empty()) {
        const int64_t cell = stack.back();
        stack.pop_back();
        const int64_t* ch = t.children + cell * nch;
        for (int k = 0; k < nch; ++k) {
          const int64_t s = ch[k];
          if (s < 0) continue;
          const int dl = static_cast<int>(t.levels[s]) - lvl;
          const int64_t* sa = t.anchors + s * dim;
          bool adjacent = true;
          for (int j = 0; j < dim; ++j) {
            const int64_t lo = (ba[j] << dl) - 1;
            const int64_t hi = (ba[j] + 1) << dl;
            adjacent = adjacent && sa[j] >= lo && sa[j] <= hi;
          }
          if (!adjacent) {
            out.w.insert(out.w.end(), {b, s});
          } else if (t.is_leaf[s]) {
            out.u.insert(out.u.end(), {b, s});
          } else {
            stack.push_back(s);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Builds the lists; returns a handle for the calls below, or null when dim
// is outside [1, 3].
void* ferreus_torch_build_lists(int64_t ncells, int dim, const int64_t* anchors,
                                const int64_t* levels, const int64_t* parent,
                                const int64_t* children, const uint8_t* is_leaf,
                                const uint8_t* has_points) {
  if (dim < 1 || dim > kMaxDim) return nullptr;
  CellTable t{ncells, dim, anchors, levels, parent, children, is_leaf, has_points, {}};
  t.lookup.reserve(static_cast<size_t>(ncells) * 2);
  for (int64_t c = 0; c < ncells; ++c)
    t.lookup.emplace(pack(static_cast<int>(levels[c]), anchors + c * dim, dim), c);
  auto* lists = new Lists();
  const std::vector<int64_t> offs = neighbour_offsets(dim);
  build_v(t, offs, *lists);
  build_uw(t, offs, *lists);
  return lists;
}

int64_t ferreus_torch_num_v(void* h) { return static_cast<Lists*>(h)->v.size() / 3; }
int64_t ferreus_torch_num_u(void* h) { return static_cast<Lists*>(h)->u.size() / 2; }
int64_t ferreus_torch_num_w(void* h) { return static_cast<Lists*>(h)->w.size() / 2; }

void ferreus_torch_copy_lists(void* h, int64_t* v, int64_t* u, int64_t* w) {
  const Lists* l = static_cast<Lists*>(h);
  std::memcpy(v, l->v.data(), l->v.size() * sizeof(int64_t));
  std::memcpy(u, l->u.data(), l->u.size() * sizeof(int64_t));
  std::memcpy(w, l->w.data(), l->w.size() * sizeof(int64_t));
}

void ferreus_torch_free_lists(void* h) { delete static_cast<Lists*>(h); }

}  // extern "C"
