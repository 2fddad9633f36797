// Near field of the FMM (P2P over u-lists, M2P over w-lists, and P2L over
// x-lists with a cell's Chebyshev nodes as the targets) for Hopper
// (sm_90a), in f32 (H1, near_field_f32) and native f64 (H2, near_field_f64),
// its target gradients in native f64 (H3, near_field_grad_f64), and the M2P
// over virtual cell nodes (H4, near_field_cells_{f32,f64,grad_f64}). One
// translation unit, built by ops/fmm/near_field.py build.
//
// Computes, for every target-bucket row r and target slot t,
//     out[r, t, k] = sum_{u < n(r)} sum_s phi(|x[r,t] - y[nbr[u,r], s]|^2) * w[nbr[u,r], k, s]
// with n(r) = cnt[r] when counts are given and U otherwise. Neighbour
// entries equal to the sentinel tile (the last tile, L) are skipped: its
// weights are zero by construction. Every kernel takes the work list of
// ops/fmm/near_field.py work_items instead of the table: it holds only the
// live entries, with each tile's live source slots (scnt), and only each
// row's live target slots (tcnt); dead target slots come out 0. H3 also
// computes
//     gout[r, t, k, i] = sum_{u, s} g(r2) * (x[r,t,i] - y[l,i,s]) * w[l, k, s],
// grad phi at displacement x - y being (x - y) * g(|x - y|^2).
//
// H4 computes the same sums when the neighbour table holds global cell ids
// (sentinel = ncells) and each listed cell's sources are its p^d Chebyshev
// nodes y[c, j] = center[c] + (0.5 * length[c]) * node[j], weighted by the
// cell's multipole coefficients mult[c, j, k]: the M2P of a tree whose node
// tiles are gated off. Nothing is gathered beforehand.
//
// Replaces the Pallas TPU kernels in ferreus_rbf_tpu/ops/fmm/p2p_pallas.py:
//   H1: p2p_leaf_slab (:595), p2p_leaf_pairs (:102), p2p_leaf_fused (:448);
//   H2: p2p_leaf_pairs_df64 (:651), p2p_pairlist_df64 (:698);
//   H3: p2p_pairlist_df64_grad (:779);
//   H4: p2p_rows (:834), whose pre-gathered per-row tables exist only
//       because a TPU kernel wants dense VMEM blocks.
// The Pallas variants differ only in how they work around VMEM, SMEM and
// the MXU (slab gathers, (R, U) grids, sorted pair lists, double-float
// split dots); on Hopper one work-item loop computes what all of them
// compute. A row's pair list is its neighbour list with counts;
// p2p_pairlist_df64's (row, tile) grid, which balances long lists, returns
// as items cut to a budget of live sources.
//
// What bounds them on this card: the phi evaluation on the CUDA cores, one
// sqrt (or log, or divide) per live (target, source) pair plus ~3 + 2 *
// nrhs FMAs (H3 and H4's gradients: one sqrt or log for phi and g together
// and (1 + d) * nrhs FMAs, ~4x). In f32 that is the FP32 pipe and the MUFU
// unit; in f64 it is the FP64 pipe (half the FP32 rate on H100 SXM) and
// the software sqrt/log sequences. Neighbour tiles are re-read by every
// row that lists them, but a tile is (d + nrhs) x S values, a few KB, and
// all tiles of a config-2 matvec (100k points, 8 RHS: ~6 MB in f32, ~11 MB
// in f64) fit in the 50 MB L2, so device-memory traffic is not the limit.
// Tensor cores stay out: the pair loop is sqrt/log/divide bound, and its
// one product, sum phi * w over nrhs <= 8, would run through TF32 in f32,
// which the port forbids (ferreus_rbf_tpu_torch/__init__.py), at a depth of
// 8 at most.
//
// One warp per work item, items built by ops/fmm/near_field.py work_items.
// What held the one-block-per-row design back, and what this one does
// about it:
// 1. Padding computed as work (target rows ~half live, DDM level rows and
//    isosurface gradient sets a few targets in 128, source tiles ~26% live
//    at 1M): an item covers only the live target slots of its row (tcnt)
//    and only the live source slots of each tile (the entries' counts from
//    scnt; a listed cell has all p^d nodes live); dead target slots are
//    written 0 by the second pass.
// 2. One block walking a long, skewed w-list (up to 216 cells) left a tail
//    of a few blocks: each item takes at most near_field.py _ITEM_SOURCES
//    live sources, items run longest first, and a row cut into k items
//    writes k partial blocks that near_field_finish_kernel adds per (row,
//    slot) in item order. The sums are bitwise equal run to run: no
//    atomics.
// 3. A switch over the kernel type inside the pair loop, and a runtime
//    spheroidal power loop: the type is a template parameter (KT), chosen
//    once at launch, so phi_code's switch and phi_gscale_kt's branches fold
//    away and the power loop unrolls.
// 4. Serial staging and 4 scalar shared loads per pair at NR = 1: a source
//    is staged packed as (x, y, z, w0) (one 16-byte load in f32) with
//    cp.async, double-buffered per warp so chunk c + 1 lands while chunk c
//    is computed; each lane keeps up to 4 targets, so a staged source
//    serves 4 pairs per load. A span of tlen <= 16 targets puts
//    next_pow2(tlen) lanes on each target and splits the sources between
//    the 32 / next_pow2(tlen) lane groups, summed by a fixed shuffle tree at
//    the end: a sparse row keeps the warp busy instead of 1 thread in 128.
//
// H1-H4 run one loop, near_field_work_items_kernel, with a compile-time
// source policy (CELLS: stored source tiles, or listed cells) and sum
// policy (GRAD: values, or values and target gradients); both fold away at
// compile time, and H1/H2 on it run as fast as on a loop of their own
// (PERF.md). H3's lane keeps (1 + d) * NR f64 sums per target, 4 targets:
// its rhs block stops at NR = 2 (32 sums, 64 registers) and the grid's y
// dimension covers more right-hand sides. H4 stages a listed cell's nodes
// instead of loading them: the block copies the (p^d, d) f64 reference
// nodes into shared memory once, a lane reads its cell's centre and
// half-length when an entry begins, and makes each node with two rounded
// f64 operations per coordinate, in numpy's order, so the nodes are
// bitwise those of the stored node tiles and H4's items are the ungated
// M2P's items. Instantiations: 80 for H1/H2 (10 types x NR {1, 2, 4, 8} x
// {f32, f64}), 20 for H3 (NR {1, 2}), 100 for H4.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct KernelArgs {
  int code;          // KernelType index (ops/kernels.py KERNEL_CODES)
  int pw;            // spheroidal power
  double s2, ip2, near_slope, far_coef, total_sill;
  double far_grad;   // spheroidal far-branch gradient numerator (H3, H4)
};

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }

// phi(r2) of kernel type `code` (ops/kernels.py KERNEL_CODES) with
// spheroidal power pw; same formulas as ops/kernels.py. Called through
// phi_kt, with both known at compile time: the switch folds away and the
// power loop unrolls.
template <typename T>
__device__ __forceinline__ T phi_code(T r2, const KernelArgs& k, int code, int pw) {
  const T eps = T(2.220446049250313e-16);
  const T r2p = r2 > T(0) ? r2 : T(0);
  switch (code) {
    case 0:  // LinearRbf
      return -dsqrt(r2p);
    case 1:  // ThinPlateSplineRbf
      return r2 > eps ? r2 * (T(0.5) * dlog(r2)) : T(0);
    case 2:  // CubicRbf
      return r2 * dsqrt(r2p);
    case 3:
    case 4:
    case 5:
    case 6: {  // Spheroidal{3,5,7,9}Rbf
      const T sr2 = T(k.s2) * r2;
      if (sr2 <= T(k.ip2)) return T(k.total_sill) - T(k.near_slope) * dsqrt(r2p);
      const T t = T(1) + sr2;
      T tp = t;
      for (int i = 1; i < pw; ++i) tp *= t;
      return T(k.far_coef) / (tp * dsqrt(t));
    }
    case 7:  // Laplacian
      return r2 > eps ? T(1) / dsqrt(r2) : T(0);
    case 8:  // OneOverR2
      return r2 > eps ? T(1) / r2 : T(0);
    case 9:  // OneOverR4
      return r2 > eps ? T(1) / (r2 * r2) : T(0);
  }
  return T(0);
}

// Spheroidal codes 3-6 are orders 3, 5, 7, 9, whose power is KT - 2.
template <int KT>
__host__ __device__ constexpr int spheroidal_power() {
  return KT >= 3 && KT <= 6 ? KT - 2 : 0;
}

// Kernel type KT fixed at compile time.
template <int KT, typename T>
__device__ __forceinline__ T phi_kt(T r2, const KernelArgs& k) {
  return phi_code(r2, k, KT, spheroidal_power<KT>());
}

// phi(r2) and the gradient factor g(r2) (grad phi = (x - y) * g) in f64
// for kernel type KT, sharing one sqrt or log; same formulas and r2 <= eps
// guards as ops/kernels.py (every g is 0 at coincident points).
template <int KT>
__device__ __forceinline__ void phi_gscale_kt(double r2, const KernelArgs& k, double& f,
                                              double& g) {
  const double eps = 2.220446049250313e-16;
  const bool live = r2 > eps;
  const double r2p = r2 > 0.0 ? r2 : 0.0;
  const double rs = live ? r2 : 1.0;  // masked lanes never make inf or NaN
  if constexpr (KT == 0) {  // LinearRbf
    const double r = sqrt(r2p);
    f = -r;
    g = live ? -1.0 / r : 0.0;
  } else if constexpr (KT == 1) {  // ThinPlateSplineRbf
    const double lg = 0.5 * log(rs);
    f = live ? r2 * lg : 0.0;
    g = live ? 2.0 * lg + 1.0 : 0.0;
  } else if constexpr (KT == 2) {  // CubicRbf
    const double r = sqrt(r2p);
    f = r2 * r;
    g = live ? 3.0 * r : 0.0;
  } else if constexpr (KT >= 3 && KT <= 6) {  // Spheroidal{3,5,7,9}Rbf
    const double sr2 = k.s2 * r2;
    if (sr2 <= k.ip2) {
      const double r = sqrt(r2p);
      f = k.total_sill - k.near_slope * r;
      g = live ? -k.near_slope / r : 0.0;
      return;
    }
    const double t = 1.0 + sr2;
    double tp = t;
#pragma unroll
    for (int i = 1; i < spheroidal_power<KT>(); ++i) tp *= t;
    const double den = tp * sqrt(t);
    f = k.far_coef / den;
    g = live ? k.far_grad / (den * t) : 0.0;
  } else if constexpr (KT == 7) {  // Laplacian
    const double r = sqrt(rs);
    f = live ? 1.0 / r : 0.0;
    g = live ? -1.0 / (rs * r) : 0.0;
  } else if constexpr (KT == 8) {  // OneOverR2
    f = live ? 1.0 / rs : 0.0;
    g = live ? -2.0 / (rs * rs) : 0.0;
  } else {  // OneOverR4
    static_assert(KT == 9, "unknown kernel type");
    f = live ? 1.0 / (rs * rs) : 0.0;
    g = live ? -4.0 / (rs * rs * rs) : 0.0;
  }
}

// Calls fn(std::integral_constant<int, KT>) for the kernel type `code`;
// false for an unknown code.
template <typename Fn>
bool dispatch_kt(int code, Fn&& fn) {
  switch (code) {
    case 0: fn(std::integral_constant<int, 0>{}); return true;
    case 1: fn(std::integral_constant<int, 1>{}); return true;
    case 2: fn(std::integral_constant<int, 2>{}); return true;
    case 3: fn(std::integral_constant<int, 3>{}); return true;
    case 4: fn(std::integral_constant<int, 4>{}); return true;
    case 5: fn(std::integral_constant<int, 5>{}); return true;
    case 6: fn(std::integral_constant<int, 6>{}); return true;
    case 7: fn(std::integral_constant<int, 7>{}); return true;
    case 8: fn(std::integral_constant<int, 8>{}); return true;
    case 9: fn(std::integral_constant<int, 9>{}); return true;
  }
  return false;
}

constexpr int kWarps = 4;          // work items (one warp each) per block
constexpr int kChunk = 32;         // sources staged per chunk: one per lane
constexpr int kTpt = 4;            // target slots per lane
constexpr int kSpan = 32 * kTpt;   // target slots per item (near_field.py _SPAN)

// A staged source: coordinates and the first weight of the rhs block, read
// as one 16-byte (f32) or two 16-byte (f64) shared loads.
template <typename T>
struct alignas(4 * sizeof(T)) Src {
  T x, y, z, w;
};

// The second pass, one thread per (row, slot): dead slots (t >= tcnt[r])
// and slots of spans with no item get 0; a span cut into k >= 2 items gets
// the sum of its k partial blocks, added in item order; a span of one item
// was written by it. `width` values per slot: nrhs (values) or nrhs * d
// (gradients, H3/H4).
template <typename T>
__global__ void near_field_finish_kernel(const int2* __restrict__ segtab,  // (R, nspan)
                                         const int* __restrict__ tcnt,     // (R,) or null
                                         const T* __restrict__ part, T* __restrict__ out,
                                         int R, int Tn, int nspan, int width) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * Tn) return;
  const int r = static_cast<int>(i / Tn);
  const int t = static_cast<int>(i % Tn);
  const int2 pk = t < (tcnt ? tcnt[r] : Tn) ? segtab[(size_t)r * nspan + t / kSpan]
                                            : make_int2(0, 0);
  if (pk.y == 1) return;
  const T* pp = part + ((size_t)pk.x * kSpan + t % kSpan) * width;
  T* op = out + i * width;
  for (int q = 0; q < width; ++q) {
    T s = T(0);
    for (int c = 0; c < pk.y; ++c) s += pp[(size_t)c * kSpan * width + q];
    op[q] = s;
  }
}

// Launches the second pass over (R, Tn) slots of `width` values each.
template <typename T>
void launch_finish(const int* segtab, const int* tcnt, const T* part, T* out, int R, int Tn,
                   int nspan, int width, cudaStream_t st) {
  const size_t slots = (size_t)R * Tn;
  const int threads = 256;
  near_field_finish_kernel<T><<<static_cast<unsigned>((slots + threads - 1) / threads),
                                threads, 0, st>>>(reinterpret_cast<const int2*>(segtab), tcnt,
                                                  part, out, R, Tn, nspan, width);
}

// The operands of one call. items (nitems, 6): row, t0, tlen, e0,
// e1, dst; entries (E, 2): tile or cell, live sources; segtab (R, nspan,
// 2) (near_field.py WorkItems).
template <typename T>
struct ItemArgs {
  const T* tgt;           // (R, Tn, d)
  const T* src;           // tiles: (L + 1, ds, S); cells: unused
  const T* w;             // tiles: (L + 1, nrhs, S); cells: mult (ncells, S, nrhs)
  const double* centers;  // cells: (ncells, d)
  const double* lengths;  // cells: (ncells,)
  const double* nodes;    // cells: (S, d) reference nodes
  const int* items;       // (nitems, 6)
  const int2* entries;    // (E,)
  T* out;                 // (R, Tn, nrhs)
  T* part;                // (nparts, kSpan, nrhs)
  T* gout;                // GRAD: (R, Tn, nrhs, d)
  T* gpart;               // GRAD: (nparts, kSpan, nrhs, d)
  int Tn, d, ds, S, nitems, nrhs;  // cells: S = p^d
};

// One warp per work item: target slots [t0, t0 + tlen) of row r against
// the live sources of entries [e0, e1), for rhs rhs0 .. rhs0 + NR. A span
// of more than 16 targets gives each lane up to kTpt targets (t = lane +
// 32 j) and every lane every source; a span of tlen <= 16 gives each target
// tw = next_pow2(tlen) lanes' worth of groups: lane = g * tw + t, and group
// g of the 32 / tw takes sources g, g + 32 / tw, ... of each chunk; the
// groups' sums are added by a fixed xor-shuffle tree at the end. CELLS: the block first copies the
// (S, d) reference nodes into shared memory; a lane staging node j of cell
// c reads the cell's centre and half-length when the entry begins and
// makes the node as centre + half * node[j] in f64, each step rounded on
// its own (no FMA contraction), then rounds it to T: numpy's order
// (cheb.scale_nodes_to_cell), so the nodes are bitwise those of the stored
// node tiles. GRAD: each target also sums g * (x_i - y_i) * w per rhs and
// dimension.
template <int KT, typename T, int NR, bool GRAD, bool CELLS>
__global__ void __launch_bounds__(kWarps * 32)
near_field_work_items_kernel(const ItemArgs<T> a, KernelArgs k) {
  static_assert(!GRAD || std::is_same<T, double>::value, "gradients are f64 only");
  constexpr int NW = NR > 1 ? NR - 1 : 1;
  constexpr int NJ = GRAD ? kTpt : 1;  // gradient sums kept per lane
  __shared__ Src<T> s_p[kWarps][2][kChunk];
  __shared__ T s_w[kWarps][2][NW][kChunk];  // weights 1 .. NR - 1 of the rhs block
  extern __shared__ double s_nodes[];       // CELLS: (S, d)

  if constexpr (CELLS) {
    for (int i = threadIdx.x; i < a.S * a.d; i += blockDim.x) s_nodes[i] = a.nodes[i];
    __syncthreads();
  }
  const int wid = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int it = blockIdx.x * kWarps + wid;
  if (it >= a.nitems) return;  // the whole warp: nothing below syncs the block
  const int* ip = a.items + (size_t)it * 6;
  const int r = ip[0], t0 = ip[1], tlen = ip[2], e0 = ip[3], e1 = ip[4], dst = ip[5];
  const int rhs0 = blockIdx.y * NR;
  auto sp = s_p[wid];  // this warp's two buffers
  auto sw = s_w[wid];

  const int tw = tlen > 32 ? 32 : (tlen <= 1 ? 1 : 1 << (32 - __clz(tlen - 1)));
  const int ng = 32 / tw;
  const int g = lane / tw, tl = lane % tw;
  const int nj = (tlen + tw - 1) / tw;  // <= kTpt

  T x[kTpt][3];
  T acc[kTpt][NR];
  T gacc[NJ][NR][3];
#pragma unroll
  for (int j = 0; j < kTpt; ++j) {
    const int t = tl + j * tw;
    const bool live = j < nj && t < tlen;
    const T* tp = a.tgt + ((size_t)r * a.Tn + t0 + t) * a.d;
#pragma unroll
    for (int i = 0; i < 3; ++i) x[j][i] = (live && i < a.d) ? tp[i] : T(0);
#pragma unroll
    for (int q = 0; q < NR; ++q) acc[j][q] = T(0);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < NR; ++q) gacc[j][q][0] = gacc[j][q][1] = gacc[j][q][2] = T(0);
  // fields never copied: coordinates past d, weights past nrhs
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (a.d < 2) sp[b][lane].y = T(0);
    if (a.d < 3) sp[b][lane].z = T(0);
#pragma unroll
    for (int q = 1; q < NR; ++q)
      if (rhs0 + q >= a.nrhs) sw[b][q - 1][lane] = T(0);
  }

  // stage the next chunk (entry ce, slots cs .. cs + kChunk) into buffer b;
  // returns its sources, 0 past the last entry
  int ce = e0, cs = 0;
  double cc[3] = {0.0, 0.0, 0.0}, half = 0.0;  // CELLS: the entry's cell
  auto stage = [&](int b) -> int {
    if (ce >= e1) return 0;
    const int2 en = a.entries[ce];
    const int n = min(kChunk, en.y - cs);
    if (lane < n) {
      const int j = cs + lane;
      const T* wp;
      size_t wstride;
      if constexpr (CELLS) {
        if (cs == 0) {  // a new cell: its centre and half-length, read once
          half = __dmul_rn(a.lengths[en.x], 0.5);
#pragma unroll
          for (int i = 0; i < 3; ++i) cc[i] = i < a.d ? a.centers[(size_t)en.x * a.d + i] : 0.0;
        }
        const double* nd = s_nodes + (size_t)j * a.d;
        sp[b][lane].x = T(__dadd_rn(cc[0], __dmul_rn(half, nd[0])));
        if (a.d > 1) sp[b][lane].y = T(__dadd_rn(cc[1], __dmul_rn(half, nd[1])));
        if (a.d > 2) sp[b][lane].z = T(__dadd_rn(cc[2], __dmul_rn(half, nd[2])));
        wp = a.w + ((size_t)en.x * a.S + j) * a.nrhs + rhs0;
        wstride = 1;
      } else {
        const T* p = a.src + (size_t)en.x * a.ds * a.S + j;
        __pipeline_memcpy_async(&sp[b][lane].x, p, sizeof(T));
        if (a.d > 1) __pipeline_memcpy_async(&sp[b][lane].y, p + a.S, sizeof(T));
        if (a.d > 2) __pipeline_memcpy_async(&sp[b][lane].z, p + 2 * (size_t)a.S, sizeof(T));
        wp = a.w + ((size_t)en.x * a.nrhs + rhs0) * a.S + j;
        wstride = a.S;
      }
      __pipeline_memcpy_async(&sp[b][lane].w, wp, sizeof(T));
#pragma unroll
      for (int q = 1; q < NR; ++q)
        if (rhs0 + q < a.nrhs)
          __pipeline_memcpy_async(&sw[b][q - 1][lane], wp + q * wstride, sizeof(T));
    }
    cs += kChunk;
    if (cs >= en.y) {
      ++ce;
      cs = 0;
    }
    return n;
  };

  int n = stage(0);
  __pipeline_commit();
  for (int b = 0; n > 0; b ^= 1) {
    const int next = stage(b ^ 1);  // lands while this chunk is computed
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();
    for (int jj = g; jj < n; jj += ng) {
      const Src<T> s = sp[b][jj];
      T wq[NR];
      wq[0] = s.w;
#pragma unroll
      for (int q = 1; q < NR; ++q) wq[q] = sw[b][q - 1][jj];
#pragma unroll
      for (int j = 0; j < kTpt; ++j) {
        if (j < nj) {
          const T dx = x[j][0] - s.x;
          const T dy = x[j][1] - s.y;
          const T dz = x[j][2] - s.z;
          if constexpr (GRAD) {
            double f, gs;
            phi_gscale_kt<KT>(dx * dx + dy * dy + dz * dz, k, f, gs);
            const double gx = gs * dx, gy = gs * dy, gz = gs * dz;
#pragma unroll
            for (int q = 0; q < NR; ++q) {
              acc[j][q] += f * wq[q];
              gacc[j][q][0] += gx * wq[q];
              gacc[j][q][1] += gy * wq[q];
              gacc[j][q][2] += gz * wq[q];
            }
          } else {
            const T f = phi_kt<KT>(dx * dx + dy * dy + dz * dz, k);
#pragma unroll
            for (int q = 0; q < NR; ++q) acc[j][q] += f * wq[q];
          }
        }
      }
    }
    __syncwarp();  // every lane is done with buffer b before it is restaged
    n = next;
  }

  // groups of a short span: a fixed tree, the same order every run
  for (int off = tw; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      acc[0][q] += __shfl_xor_sync(0xffffffffu, acc[0][q], off);
      if constexpr (GRAD) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          gacc[0][q][i] += __shfl_xor_sync(0xffffffffu, gacc[0][q][i], off);
      }
    }
  }
  if (g != 0) return;
#pragma unroll
  for (int j = 0; j < kTpt; ++j) {
    const int t = tl + j * tw;
    if (j < nj && t < tlen) {
      const size_t slot = dst < 0 ? (size_t)r * a.Tn + t0 + t : (size_t)dst * kSpan + t;
      T* op = (dst < 0 ? a.out : a.part) + slot * a.nrhs + rhs0;
#pragma unroll
      for (int q = 0; q < NR; ++q)
        if (rhs0 + q < a.nrhs) op[q] = acc[j][q];
      if constexpr (GRAD) {
        T* gp = (dst < 0 ? a.gout : a.gpart) + (slot * a.nrhs + rhs0) * a.d;
#pragma unroll
        for (int q = 0; q < NR; ++q)
          if (rhs0 + q < a.nrhs)
#pragma unroll
            for (int i = 0; i < 3; ++i)
              if (i < a.d) gp[q * a.d + i] = gacc[j][q][i];
      }
    }
  }
}

// Dynamic shared memory a block may take without raising its limit: 48 KB
// less the largest static use of near_field_work_items_kernel (f64, NR =
// 8: 8 KB of sources and 14 KB of weights).
constexpr size_t kDynSmemFree = 24 * 1024;

// One item launch with kernel type KT. The rhs block of one lane,
// NR, is 1, 2, 4 or 8 for values; for gradients (4 sums per target and
// rhs, kTpt targets per lane) it stops at 2, and the grid's y dimension
// covers the rest of the right-hand sides.
template <int KT, typename T, bool GRAD, bool CELLS>
void launch_work_items_kt(const ItemArgs<T>& a, const KernelArgs& k, size_t dyn,
                          cudaStream_t st) {
  const int nr = a.nrhs;
  const int per = nr == 1 ? 1 : nr == 2 || GRAD ? 2 : nr <= 4 ? 4 : 8;
  const dim3 grid((a.nitems + kWarps - 1) / kWarps, (nr + per - 1) / per);
  auto go = [&](auto kernel) {
    if (dyn > kDynSmemFree)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(dyn));
    kernel<<<grid, kWarps * 32, dyn, st>>>(a, k);
  };
  if (per == 1) {
    go(near_field_work_items_kernel<KT, T, 1, GRAD, CELLS>);
  } else if (per == 2) {
    go(near_field_work_items_kernel<KT, T, 2, GRAD, CELLS>);
  } else if constexpr (!GRAD) {
    if (per == 4)
      go(near_field_work_items_kernel<KT, T, 4, GRAD, CELLS>);
    else
      go(near_field_work_items_kernel<KT, T, 8, GRAD, CELLS>);
  }
}

// The item pass (the kernel type chosen here, once), then the
// second pass for the values and, with gradients, for them. Returns the
// first failing launch's CUDA error code (0 on success).
template <typename T, bool GRAD, bool CELLS>
int launch_work_items(const ItemArgs<T>& a, const int* segtab, const int* tcnt, int R,
                      int nspan, const KernelArgs& k, void* stream) {
  cudaGetLastError();  // clear a stale error so the return reports this launch
  if (R == 0 || a.Tn == 0 || a.nrhs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.nitems > 0) {
    const size_t dyn = CELLS ? (size_t)a.S * a.d * sizeof(double) : 0;
    const bool known = dispatch_kt(k.code, [&](auto kt) {
      launch_work_items_kt<decltype(kt)::value, T, GRAD, CELLS>(a, k, dyn, st);
    });
    if (!known) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_finish<T>(segtab, tcnt, a.part, a.out, R, a.Tn, nspan, a.nrhs, st);
  if constexpr (GRAD) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    launch_finish<T>(segtab, tcnt, a.gpart, a.gout, R, a.Tn, nspan, a.nrhs * a.d, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// H1/H2: stored source tiles, values only.
template <typename T>
int launch_tiles(const T* tgt, const T* src, const T* w, const int* items, const int* entries,
                 const int* segtab, const int* tcnt, T* out, T* part, int R, int Tn, int d,
                 int ds, int S, int nitems, int nspan, int nrhs, const KernelArgs& k,
                 void* stream) {
  const ItemArgs<T> a{tgt, src, w, nullptr, nullptr, nullptr,
                      items, reinterpret_cast<const int2*>(entries),
                      out, part, nullptr, nullptr, Tn, d, ds, S, nitems, nrhs};
  return launch_work_items<T, false, false>(a, segtab, tcnt, R, nspan, k, stream);
}

// H4: listed cells whose nodes are made while staged.
template <typename T, bool GRAD>
int launch_cells(const T* tgt, const double* centers, const double* lengths,
                 const double* nodes, const T* mult, const int* items, const int* entries,
                 const int* segtab, const int* tcnt, T* out, T* gout, T* part, T* gpart, int R,
                 int Tn, int d, int P, int nitems, int nspan, int nrhs, const KernelArgs& k,
                 void* stream) {
  const ItemArgs<T> a{tgt, nullptr, mult, centers, lengths, nodes,
                      items, reinterpret_cast<const int2*>(entries),
                      out, part, gout, gpart, Tn, d, d, P, nitems, nrhs};
  return launch_work_items<T, GRAD, true>(a, segtab, tcnt, R, nspan, k, stream);
}

}  // namespace

extern "C" {

int near_field_f32(const float* tgt, const float* src, const float* w, const int* items,
                   const int* entries, const int* segtab, const int* tcnt, float* out,
                   float* part, int R, int Tn, int d, int ds, int S, int nitems, int nspan,
                   int nrhs, int code, double s2, double ip2, double near_slope,
                   double far_coef, double total_sill, int pw, void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, 0.0};
  return launch_tiles<float>(tgt, src, w, items, entries, segtab, tcnt, out, part, R, Tn, d, ds,
                             S, nitems, nspan, nrhs, k, stream);
}

int near_field_f64(const double* tgt, const double* src, const double* w, const int* items,
                   const int* entries, const int* segtab, const int* tcnt, double* out,
                   double* part, int R, int Tn, int d, int ds, int S, int nitems, int nspan,
                   int nrhs, int code, double s2, double ip2, double near_slope,
                   double far_coef, double total_sill, int pw, void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, 0.0};
  return launch_tiles<double>(tgt, src, w, items, entries, segtab, tcnt, out, part, R, Tn, d,
                              ds, S, nitems, nspan, nrhs, k, stream);
}

int near_field_grad_f64(const double* tgt, const double* src, const double* w, const int* items,
                        const int* entries, const int* segtab, const int* tcnt, double* out,
                        double* gout, double* part, double* gpart, int R, int Tn, int d, int ds,
                        int S, int nitems, int nspan, int nrhs, int code, double s2, double ip2,
                        double near_slope, double far_coef, double total_sill, double far_grad,
                        int pw, void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, far_grad};
  const ItemArgs<double> a{tgt, src, w, nullptr, nullptr, nullptr,
                           items, reinterpret_cast<const int2*>(entries),
                           out, part, gout, gpart, Tn, d, ds, S, nitems, nrhs};
  return launch_work_items<double, true, false>(a, segtab, tcnt, R, nspan, k, stream);
}

int near_field_cells_f32(const float* tgt, const double* centers, const double* lengths,
                         const double* nodes, const float* mult, const int* items,
                         const int* entries, const int* segtab, const int* tcnt, float* out,
                         float* part, int R, int Tn, int d, int P, int nitems, int nspan,
                         int nrhs, int code, double s2, double ip2, double near_slope,
                         double far_coef, double total_sill, int pw, void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, 0.0};
  return launch_cells<float, false>(tgt, centers, lengths, nodes, mult, items, entries, segtab,
                                    tcnt, out, nullptr, part, nullptr, R, Tn, d, P, nitems,
                                    nspan, nrhs, k, stream);
}

int near_field_cells_f64(const double* tgt, const double* centers, const double* lengths,
                         const double* nodes, const double* mult, const int* items,
                         const int* entries, const int* segtab, const int* tcnt, double* out,
                         double* part, int R, int Tn, int d, int P, int nitems, int nspan,
                         int nrhs, int code, double s2, double ip2, double near_slope,
                         double far_coef, double total_sill, int pw, void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, 0.0};
  return launch_cells<double, false>(tgt, centers, lengths, nodes, mult, items, entries,
                                     segtab, tcnt, out, nullptr, part, nullptr, R, Tn, d, P,
                                     nitems, nspan, nrhs, k, stream);
}

int near_field_cells_grad_f64(const double* tgt, const double* centers, const double* lengths,
                              const double* nodes, const double* mult, const int* items,
                              const int* entries, const int* segtab, const int* tcnt,
                              double* out, double* gout, double* part, double* gpart, int R,
                              int Tn, int d, int P, int nitems, int nspan, int nrhs, int code,
                              double s2, double ip2, double near_slope, double far_coef,
                              double total_sill, double far_grad, int pw, void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, far_grad};
  return launch_cells<double, true>(tgt, centers, lengths, nodes, mult, items, entries, segtab,
                                    tcnt, out, gout, part, gpart, R, Tn, d, P, nitems, nspan,
                                    nrhs, k, stream);
}

const char* near_field_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
