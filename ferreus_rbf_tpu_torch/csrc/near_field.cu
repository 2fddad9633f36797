// Near field of the FMM (P2P over u-lists, M2P over w-lists, and P2L over
// x-lists with a cell's Chebyshev nodes as the targets) for Hopper
// (sm_90a), in f32 (H1, near_field_f32) and native f64 (H2, near_field_f64),
// its target gradients in native f64 (H3, near_field_grad_f64), and the M2P
// over virtual cell nodes (H4, near_field_cells_{f32,f64,grad_f64}).
//
// Computes, for every target-bucket row r and target slot t,
//     out[r, t, k] = sum_{u < n(r)} sum_s phi(|x[r,t] - y[nbr[u,r], s]|^2) * w[nbr[u,r], k, s]
// with n(r) = cnt[r] when counts are given and U otherwise. Neighbour
// entries equal to the sentinel tile (the last tile, L) are skipped: its
// weights are zero by construction. H1/H2 take the work list of
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
// tiles are gated off. Nothing is gathered beforehand; the block stages each
// listed cell's nodes and coefficients straight from the (ncells, d)
// centres, (ncells,) lengths, (p^d, d) reference nodes and (ncells, p^d,
// nrhs) multipole array.
//
// Replaces the Pallas TPU kernels in ferreus_rbf_tpu/ops/fmm/p2p_pallas.py:
//   H1: p2p_leaf_slab (:595), p2p_leaf_pairs (:102), p2p_leaf_fused (:448);
//   H2: p2p_leaf_pairs_df64 (:651), p2p_pairlist_df64 (:698);
//   H3: p2p_pairlist_df64_grad (:779);
//   H4: p2p_rows (:834), whose pre-gathered per-row tables exist only
//       because a TPU kernel wants dense VMEM blocks.
// The Pallas variants differ only in how they work around VMEM, SMEM and
// the MXU (slab gathers, (R, U) grids, sorted pair lists, double-float
// split dots); on Hopper one work-item loop per precision computes what all
// of them compute. A row's pair list is its neighbour list with counts;
// p2p_pairlist_df64's (row, tile) grid, which balances long lists, returns
// as items cut to a budget of live sources.
//
// What bounds them on this card: the phi evaluation on the CUDA cores, one
// sqrt (or log, or divide) per live (target, source) pair plus ~3 + 2 *
// nrhs FMAs. In f32 that is the FP32 pipe and the MUFU unit; in f64 it is
// the FP64 pipe (half the FP32 rate on H100 SXM) and the software sqrt/log
// sequences. Neighbour tiles are re-read by every row that lists them, but
// a tile is (d + nrhs) x S values, a few KB, and all tiles of a config-2
// matvec (100k points, 8 RHS: ~6 MB in f32, ~11 MB in f64) fit in the
// 50 MB L2, so device-memory traffic is not the limit. Tensor cores stay
// out: the pair loop is sqrt/log/divide bound, and its one product, sum
// phi * w over nrhs <= 8, would run through TF32 in f32, which the port
// forbids (ferreus_rbf_tpu_torch/__init__.py), at a depth of 8 at most.
//
// H1/H2 (near_field_items_kernel): one warp per work item, items built by
// ops/fmm/near_field.py work_items. What held the one-block-per-row design
// back, and what this one does about it:
// 1. Padding computed as work (target rows ~half live, DDM level rows a few
//    targets in 128, source tiles ~26% live at 1M): an item covers only the
//    live target slots of its row (tcnt) and only the live source slots of
//    each tile (the entries' counts from scnt); dead target slots are
//    written 0 by the second pass.
// 2. One block walking a long, skewed w-list (up to 216 cells) left a tail
//    of a few blocks: each item takes at most _ITEM_SOURCES live sources
//    (near_field.py), items run longest first, and a row cut into k items
//    writes k partial blocks that near_field_finish_kernel adds per (row,
//    slot) in item order. The sums are bitwise equal run to run: no atomics.
// 3. A switch over the kernel type inside the pair loop, and a runtime
//    spheroidal power loop: the type is a template parameter (KT), chosen
//    once at launch, so phi_code's switch folds away and the power loop
//    unrolls (80 instantiations: 10 types x NR {1, 2, 4, 8} x {f32, f64};
//    nvcc builds the file in ~25-35 s on the H100's host).
// 4. Serial staging and 4 scalar shared loads per pair at NR = 1: a source
//    is staged packed as (x, y, z, w0) (one 16-byte load in f32) with
//    cp.async, double-buffered per warp so chunk c + 1 lands while chunk c
//    is computed; each lane keeps up to 4 targets, so a staged source
//    serves 4 pairs per load. A span of tlen <= 16 targets puts
//    next_pow2(tlen) lanes on each target and splits the sources between
//    the 32 / next_pow2(tlen) lane groups, summed by a fixed shuffle tree at
//    the end: a sparse row keeps the warp busy instead of 1 thread in 128.
//
// H3 keeps the one-block-per-row loop, with phi and g from one shared
// sqrt (or log) per pair and (1 + d) * NR FMAs instead of NR: it is bound
// by the FP64 pipe and the f64 sqrt/divide sequences, at ~4x H2's FMAs.
// Its design: one block per (row, 128-target chunk, rhs block); each thread
// owns one target and keeps its NR value and 3 * NR gradient sums in
// registers; the block walks the row's neighbour list, stages 128 sources
// at a time through shared memory, and every thread reads them as
// broadcasts. H4 has the same layout and inner loop in kernels of its own:
// sharing H1-H3's loop through a source policy took H1 at one right-hand
// side from 29 to 36 registers and cost it 8-9%, measured on the H100. H4's
// staging adds 3 f64 multiply-adds per staged node against 128 pair
// evaluations per node: a small share. H4 evaluates phi_code with the type
// and power read at run time: one formula source for all four kernels.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 128;

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
// spheroidal power pw; same formulas as ops/kernels.py. H1/H2 call it with
// both known at compile time (phi_kt: the switch folds away and the power
// loop unrolls), H4 with both read at run time (phi).
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

// Kernel type KT fixed at compile time; spheroidal codes 3-6 are orders 3,
// 5, 7, 9, whose power is KT - 2.
template <int KT, typename T>
__device__ __forceinline__ T phi_kt(T r2, const KernelArgs& k) {
  return phi_code(r2, k, KT, KT >= 3 && KT <= 6 ? KT - 2 : 0);
}

// Kernel type and power read at run time (H4).
template <typename T>
__device__ __forceinline__ T phi(T r2, const KernelArgs& k) {
  return phi_code(r2, k, k.code, k.pw);
}

// phi(r2) and the gradient factor g(r2) (grad phi = (x - y) * g) in f64,
// sharing one sqrt or log; same formulas and r2 <= eps guards as
// ops/kernels.py (every g is 0 at coincident points).
__device__ __forceinline__ void phi_gscale(double r2, const KernelArgs& k, double& f,
                                           double& g) {
  const double eps = 2.220446049250313e-16;
  const bool live = r2 > eps;
  const double r2p = r2 > 0.0 ? r2 : 0.0;
  const double rs = live ? r2 : 1.0;  // masked lanes never make inf or NaN
  switch (k.code) {
    case 0: {  // LinearRbf
      const double r = sqrt(r2p);
      f = -r;
      g = live ? -1.0 / r : 0.0;
      return;
    }
    case 1: {  // ThinPlateSplineRbf
      const double lg = 0.5 * log(rs);
      f = live ? r2 * lg : 0.0;
      g = live ? 2.0 * lg + 1.0 : 0.0;
      return;
    }
    case 2: {  // CubicRbf
      const double r = sqrt(r2p);
      f = r2 * r;
      g = live ? 3.0 * r : 0.0;
      return;
    }
    case 3:
    case 4:
    case 5:
    case 6: {  // Spheroidal{3,5,7,9}Rbf
      const double sr2 = k.s2 * r2;
      if (sr2 <= k.ip2) {
        const double r = sqrt(r2p);
        f = k.total_sill - k.near_slope * r;
        g = live ? -k.near_slope / r : 0.0;
        return;
      }
      const double t = 1.0 + sr2;
      double tp = t;
      for (int i = 1; i < k.pw; ++i) tp *= t;
      const double den = tp * sqrt(t);
      f = k.far_coef / den;
      g = live ? k.far_grad / (den * t) : 0.0;
      return;
    }
    case 7: {  // Laplacian
      const double r = sqrt(rs);
      f = live ? 1.0 / r : 0.0;
      g = live ? -1.0 / (rs * r) : 0.0;
      return;
    }
    case 8:  // OneOverR2
      f = live ? 1.0 / rs : 0.0;
      g = live ? -2.0 / (rs * rs) : 0.0;
      return;
    case 9:  // OneOverR4
      f = live ? 1.0 / (rs * rs) : 0.0;
      g = live ? -4.0 / (rs * rs * rs) : 0.0;
      return;
  }
  f = 0.0;
  g = 0.0;
}

// ---------------------------------------------------------------- H1 / H2
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

// The operands of one H1/H2 call. items (nitems, 6): row, t0, tlen, e0,
// e1, dst; entries (E, 2): tile, live sources; segtab (R, nspan, 2): first
// partial block, items (near_field.py WorkItems).
template <typename T>
struct Tiles {
  const T* tgt;       // (R, Tn, d)
  const T* src;       // (L + 1, ds, S)
  const T* w;         // (L + 1, nrhs, S)
  const int* items;   // (nitems, 6)
  const int2* entries;  // (E,)
  T* out;             // (R, Tn, nrhs)
  T* part;            // (nparts, kSpan, nrhs)
  int Tn, d, ds, S, nitems, nrhs;
};

// One warp per work item: target slots [t0, t0 + tlen) of row r against
// the live sources of entries [e0, e1), for rhs rhs0 .. rhs0 + NR. A span
// of more than 16 targets gives each lane up to kTpt targets (t = lane +
// 32 j) and every lane every source; a span of tlen <= 16 gives each target
// tw = next_pow2(tlen) lanes' worth of groups: lane = g * tw + t, and group
// g of the 32 / tw takes sources g, g + 32 / tw, ... of each chunk; the
// groups' sums are added by a fixed xor-shuffle tree at the end.
template <int KT, typename T, int NR>
__global__ void __launch_bounds__(kWarps * 32)
near_field_items_kernel(const Tiles<T> a, KernelArgs k) {
  constexpr int NW = NR > 1 ? NR - 1 : 1;
  __shared__ Src<T> s_p[kWarps][2][kChunk];
  __shared__ T s_w[kWarps][2][NW][kChunk];  // weights 1 .. NR - 1 of the rhs block

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
  // fields never copied: coordinates past d, weights past nrhs
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (a.d < 2) sp[b][lane].y = T(0);
    if (a.d < 3) sp[b][lane].z = T(0);
#pragma unroll
    for (int q = 1; q < NR; ++q)
      if (rhs0 + q >= a.nrhs) sw[b][q - 1][lane] = T(0);
  }

  // stage the next chunk (entry ce, slots cs .. cs + kChunk) into buffer b
  // with cp.async; returns its sources, 0 past the last entry
  int ce = e0, cs = 0;
  auto stage = [&](int b) -> int {
    if (ce >= e1) return 0;
    const int2 en = a.entries[ce];
    const int n = min(kChunk, en.y - cs);
    if (lane < n) {
      const T* p = a.src + (size_t)en.x * a.ds * a.S + cs + lane;
      const T* wp = a.w + ((size_t)en.x * a.nrhs + rhs0) * a.S + cs + lane;
      __pipeline_memcpy_async(&sp[b][lane].x, p, sizeof(T));
      if (a.d > 1) __pipeline_memcpy_async(&sp[b][lane].y, p + a.S, sizeof(T));
      if (a.d > 2) __pipeline_memcpy_async(&sp[b][lane].z, p + 2 * (size_t)a.S, sizeof(T));
      __pipeline_memcpy_async(&sp[b][lane].w, wp, sizeof(T));
#pragma unroll
      for (int q = 1; q < NR; ++q)
        if (rhs0 + q < a.nrhs)
          __pipeline_memcpy_async(&sw[b][q - 1][lane], wp + (size_t)q * a.S, sizeof(T));
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
          const T f = phi_kt<KT>(dx * dx + dy * dy + dz * dz, k);
#pragma unroll
          for (int q = 0; q < NR; ++q) acc[j][q] += f * wq[q];
        }
      }
    }
    __syncwarp();  // every lane is done with buffer b before it is restaged
    n = next;
  }

  // groups of a short span: a fixed tree, the same order every run
  for (int off = tw; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < NR; ++q) acc[0][q] += __shfl_xor_sync(0xffffffffu, acc[0][q], off);
  }
  if (g != 0) return;
#pragma unroll
  for (int j = 0; j < kTpt; ++j) {
    const int t = tl + j * tw;
    if (j < nj && t < tlen) {
      T* op = dst < 0 ? a.out + ((size_t)r * a.Tn + t0 + t) * a.nrhs + rhs0
                      : a.part + ((size_t)dst * kSpan + t) * a.nrhs + rhs0;
#pragma unroll
      for (int q = 0; q < NR; ++q)
        if (rhs0 + q < a.nrhs) op[q] = acc[j][q];
    }
  }
}

// The second pass, one thread per (row, slot): dead slots (t >= tcnt[r])
// and slots of spans with no item get 0; a span cut into k >= 2 items gets
// the sum of its k partial blocks, added in item order; a span of one item
// was written by it.
template <typename T>
__global__ void near_field_finish_kernel(const int2* __restrict__ segtab,  // (R, nspan)
                                         const int* __restrict__ tcnt,     // (R,) or null
                                         const T* __restrict__ part, T* __restrict__ out,
                                         int R, int Tn, int nspan, int nrhs) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * Tn) return;
  const int r = static_cast<int>(i / Tn);
  const int t = static_cast<int>(i % Tn);
  const int2 pk = t < (tcnt ? tcnt[r] : Tn) ? segtab[(size_t)r * nspan + t / kSpan]
                                            : make_int2(0, 0);
  if (pk.y == 1) return;
  const T* pp = part + ((size_t)pk.x * kSpan + t % kSpan) * nrhs;
  T* op = out + i * nrhs;
  for (int q = 0; q < nrhs; ++q) {
    T s = T(0);
    for (int c = 0; c < pk.y; ++c) s += pp[(size_t)c * kSpan * nrhs + q];
    op[q] = s;
  }
}

// H3: values and target gradients, f64. Same block layout and staging as
// near_field_kernel; the d gradient sums ride beside the value sums.
template <int NR>
__global__ void __launch_bounds__(kBlock)
near_field_grad_kernel(const double* __restrict__ tgt,  // (R, Tn, d)
                       const double* __restrict__ src,  // (L + 1, ds, S)
                       const double* __restrict__ w,    // (L + 1, nrhs, S)
                       const int* __restrict__ nbr,     // (U, R)
                       const int* __restrict__ cnt,     // (R,) or null
                       double* __restrict__ out,        // (R, Tn, nrhs)
                       double* __restrict__ gout,       // (R, Tn, nrhs, d)
                       int R, int Tn, int d, int ds, int S, int L, int U, int nrhs,
                       KernelArgs k) {
  __shared__ double s_y[3][kBlock];
  __shared__ double s_w[NR][kBlock];

  const int r = blockIdx.x;
  const int t = blockIdx.y * kBlock + threadIdx.x;
  const int rhs0 = blockIdx.z * NR;
  const bool live = t < Tn;

  double x[3] = {0.0, 0.0, 0.0};
  if (live) {
    const double* tp = tgt + ((size_t)r * Tn + t) * d;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < d) x[i] = tp[i];
  }
  double acc[NR];
  double gacc[NR][3];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    acc[q] = 0.0;
    gacc[q][0] = gacc[q][1] = gacc[q][2] = 0.0;
  }

  const int nu = cnt ? min(cnt[r], U) : U;
  for (int u = 0; u < nu; ++u) {
    const int l = nbr[(size_t)u * R + r];  // block-uniform
    if (l == L) continue;
    const double* sp = src + (size_t)l * ds * S;
    const double* wp = w + ((size_t)l * nrhs + rhs0) * S;
    for (int s0 = 0; s0 < S; s0 += kBlock) {
      const int j = s0 + threadIdx.x;
      const bool in = j < S;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        s_y[i][threadIdx.x] = (in && i < d) ? sp[(size_t)i * S + j] : 0.0;
#pragma unroll
      for (int q = 0; q < NR; ++q)
        s_w[q][threadIdx.x] = (in && rhs0 + q < nrhs) ? wp[(size_t)q * S + j] : 0.0;
      __syncthreads();
      const int n = min(kBlock, S - s0);
      if (live) {
        for (int jj = 0; jj < n; ++jj) {
          const double dx = x[0] - s_y[0][jj];
          const double dy = x[1] - s_y[1][jj];
          const double dz = x[2] - s_y[2][jj];
          double f, g;
          phi_gscale(dx * dx + dy * dy + dz * dz, k, f, g);
          const double gx = g * dx, gy = g * dy, gz = g * dz;
#pragma unroll
          for (int q = 0; q < NR; ++q) {
            const double wq = s_w[q][jj];
            acc[q] += f * wq;
            gacc[q][0] += gx * wq;
            gacc[q][1] += gy * wq;
            gacc[q][2] += gz * wq;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    const size_t o = ((size_t)r * Tn + t) * nrhs + rhs0;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (rhs0 + q < nrhs) {
        out[o + q] = acc[q];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (i < d) gout[(o + q) * d + i] = gacc[q][i];
      }
    }
  }
}

// H4: stage nodes s0 .. s0 + kBlock of cell c and their coefficients for
// rhs rhs0 .. rhs0 + NR. The node is center + (length * 0.5) * node in f64,
// each step rounded on its own (no FMA contraction), then rounded to T:
// numpy's order (cheb.scale_nodes_to_cell), so the nodes are bitwise those
// of the stored node tiles. The (n x NR) coefficient block is read
// coalesced over j * nrhs + q.
template <typename T, int NR>
__device__ __forceinline__ void stage_cell(const double* __restrict__ centers,
                                           const double* __restrict__ lengths,
                                           const double* __restrict__ nodes,
                                           const T* __restrict__ mult, int c, int s0, int rhs0,
                                           int d, int P, int nrhs, T (*s_y)[kBlock],
                                           T (*s_w)[kBlock]) {
  const int j = s0 + threadIdx.x;
  const bool in = j < P;
  const double half = __dmul_rn(lengths[c], 0.5);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    s_y[i][threadIdx.x] =
        (in && i < d)
            ? T(__dadd_rn(centers[(size_t)c * d + i], __dmul_rn(half, nodes[(size_t)j * d + i])))
            : T(0);
  const int n = min(kBlock, P - s0);
  const T* mp = mult + ((size_t)c * P + s0) * nrhs + rhs0;
  for (int e = threadIdx.x; e < kBlock * NR; e += kBlock) {
    const int jj = e / NR;
    const int q = e - jj * NR;
    s_w[q][jj] = (jj < n && rhs0 + q < nrhs) ? mp[(size_t)jj * nrhs + q] : T(0);
  }
}

// H4 values: near_field_kernel's layout and loop over the listed cells;
// ids outside [0, ncells) (the sentinel ncells) are skipped.
template <typename T, int NR>
__global__ void __launch_bounds__(kBlock)
near_field_cells_kernel(const T* __restrict__ tgt,         // (R, Tn, d)
                        const int* __restrict__ cells,     // (U, R) global cell ids
                        const int* __restrict__ cnt,       // (R,) or null
                        const double* __restrict__ centers,  // (ncells, d)
                        const double* __restrict__ lengths,  // (ncells,)
                        const double* __restrict__ nodes,    // (P, d)
                        const T* __restrict__ mult,        // (ncells, P, nrhs)
                        T* __restrict__ out,               // (R, Tn, nrhs)
                        int R, int Tn, int d, int P, int ncells, int U, int nrhs,
                        KernelArgs k) {
  __shared__ T s_y[3][kBlock];
  __shared__ T s_w[NR][kBlock];

  const int r = blockIdx.x;
  const int t = blockIdx.y * kBlock + threadIdx.x;
  const int rhs0 = blockIdx.z * NR;
  const bool live = t < Tn;

  T x[3] = {T(0), T(0), T(0)};
  if (live) {
    const T* tp = tgt + ((size_t)r * Tn + t) * d;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < d) x[i] = tp[i];
  }
  T acc[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) acc[q] = T(0);

  const int nu = cnt ? min(cnt[r], U) : U;
  for (int u = 0; u < nu; ++u) {
    const int c = cells[(size_t)u * R + r];  // block-uniform
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(ncells)) continue;
    for (int s0 = 0; s0 < P; s0 += kBlock) {
      stage_cell<T, NR>(centers, lengths, nodes, mult, c, s0, rhs0, d, P, nrhs, s_y, s_w);
      __syncthreads();
      const int n = min(kBlock, P - s0);
      if (live) {
        for (int jj = 0; jj < n; ++jj) {
          const T dx = x[0] - s_y[0][jj];
          const T dy = x[1] - s_y[1][jj];
          const T dz = x[2] - s_y[2][jj];
          const T f = phi<T>(dx * dx + dy * dy + dz * dz, k);
#pragma unroll
          for (int q = 0; q < NR; ++q) acc[q] += f * s_w[q][jj];
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    T* op = out + ((size_t)r * Tn + t) * nrhs + rhs0;
#pragma unroll
    for (int q = 0; q < NR; ++q)
      if (rhs0 + q < nrhs) op[q] = acc[q];
  }
}

// H4 values and target gradients, f64: near_field_grad_kernel's sums over
// near_field_cells_kernel's loop.
template <int NR>
__global__ void __launch_bounds__(kBlock)
near_field_cells_grad_kernel(const double* __restrict__ tgt,      // (R, Tn, d)
                             const int* __restrict__ cells,       // (U, R)
                             const int* __restrict__ cnt,         // (R,) or null
                             const double* __restrict__ centers,  // (ncells, d)
                             const double* __restrict__ lengths,  // (ncells,)
                             const double* __restrict__ nodes,    // (P, d)
                             const double* __restrict__ mult,     // (ncells, P, nrhs)
                             double* __restrict__ out,            // (R, Tn, nrhs)
                             double* __restrict__ gout,           // (R, Tn, nrhs, d)
                             int R, int Tn, int d, int P, int ncells, int U, int nrhs,
                             KernelArgs k) {
  __shared__ double s_y[3][kBlock];
  __shared__ double s_w[NR][kBlock];

  const int r = blockIdx.x;
  const int t = blockIdx.y * kBlock + threadIdx.x;
  const int rhs0 = blockIdx.z * NR;
  const bool live = t < Tn;

  double x[3] = {0.0, 0.0, 0.0};
  if (live) {
    const double* tp = tgt + ((size_t)r * Tn + t) * d;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < d) x[i] = tp[i];
  }
  double acc[NR];
  double gacc[NR][3];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    acc[q] = 0.0;
    gacc[q][0] = gacc[q][1] = gacc[q][2] = 0.0;
  }

  const int nu = cnt ? min(cnt[r], U) : U;
  for (int u = 0; u < nu; ++u) {
    const int c = cells[(size_t)u * R + r];  // block-uniform
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(ncells)) continue;
    for (int s0 = 0; s0 < P; s0 += kBlock) {
      stage_cell<double, NR>(centers, lengths, nodes, mult, c, s0, rhs0, d, P, nrhs, s_y, s_w);
      __syncthreads();
      const int n = min(kBlock, P - s0);
      if (live) {
        for (int jj = 0; jj < n; ++jj) {
          const double dx = x[0] - s_y[0][jj];
          const double dy = x[1] - s_y[1][jj];
          const double dz = x[2] - s_y[2][jj];
          double f, g;
          phi_gscale(dx * dx + dy * dy + dz * dz, k, f, g);
          const double gx = g * dx, gy = g * dy, gz = g * dz;
#pragma unroll
          for (int q = 0; q < NR; ++q) {
            const double wq = s_w[q][jj];
            acc[q] += f * wq;
            gacc[q][0] += gx * wq;
            gacc[q][1] += gy * wq;
            gacc[q][2] += gz * wq;
          }
        }
      }
      __syncthreads();
    }
  }
  if (live) {
    const size_t o = ((size_t)r * Tn + t) * nrhs + rhs0;
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (rhs0 + q < nrhs) {
        out[o + q] = acc[q];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (i < d) gout[(o + q) * d + i] = gacc[q][i];
      }
    }
  }
}

template <int NR>
void launch_grad_nr(const double* tgt, const double* src, const double* w, const int* nbr,
                    const int* cnt, double* out, double* gout, int R, int Tn, int d, int ds,
                    int S, int L1, int U, int nrhs, const KernelArgs& k,
                    cudaStream_t stream) {
  const dim3 grid(R, (Tn + kBlock - 1) / kBlock, (nrhs + NR - 1) / NR);
  near_field_grad_kernel<NR><<<grid, kBlock, 0, stream>>>(
      tgt, src, w, nbr, cnt, out, gout, R, Tn, d, ds, S, L1 - 1, U, nrhs, k);
}

// One H1/H2 item launch; NR (the rhs block of one lane) is 1, 2, 4 or 8.
template <int KT, typename T>
void launch_items_kt(const Tiles<T>& a, const KernelArgs& k, cudaStream_t stream) {
  const int nr = a.nrhs;
  const int per = nr == 1 ? 1 : nr == 2 ? 2 : nr <= 4 ? 4 : 8;
  const dim3 grid((a.nitems + kWarps - 1) / kWarps, (nr + per - 1) / per);
  if (per == 1)
    near_field_items_kernel<KT, T, 1><<<grid, kWarps * 32, 0, stream>>>(a, k);
  else if (per == 2)
    near_field_items_kernel<KT, T, 2><<<grid, kWarps * 32, 0, stream>>>(a, k);
  else if (per == 4)
    near_field_items_kernel<KT, T, 4><<<grid, kWarps * 32, 0, stream>>>(a, k);
  else
    near_field_items_kernel<KT, T, 8><<<grid, kWarps * 32, 0, stream>>>(a, k);
}

// H1/H2: the item pass (the kernel type chosen here, once), then the
// second pass. Returns the first failing launch's CUDA error code (0 on
// success).
template <typename T>
int launch(const T* tgt, const T* src, const T* w, const int* items, const int* entries,
           const int* segtab, const int* tcnt, T* out, T* part, int R, int Tn, int d, int ds,
           int S, int nitems, int nspan, int nrhs, int code, double s2, double ip2,
           double near_slope, double far_coef, double total_sill, int pw, void* stream) {
  cudaGetLastError();  // clear a stale error so the return reports this launch
  if (R == 0 || Tn == 0 || nrhs == 0) return 0;
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, 0.0};
  const Tiles<T> a{tgt, src, w, items, reinterpret_cast<const int2*>(entries), out, part,
                   Tn, d, ds, S, nitems, nrhs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nitems > 0) {
    switch (code) {
      case 0: launch_items_kt<0, T>(a, k, st); break;
      case 1: launch_items_kt<1, T>(a, k, st); break;
      case 2: launch_items_kt<2, T>(a, k, st); break;
      case 3: launch_items_kt<3, T>(a, k, st); break;
      case 4: launch_items_kt<4, T>(a, k, st); break;
      case 5: launch_items_kt<5, T>(a, k, st); break;
      case 6: launch_items_kt<6, T>(a, k, st); break;
      case 7: launch_items_kt<7, T>(a, k, st); break;
      case 8: launch_items_kt<8, T>(a, k, st); break;
      case 9: launch_items_kt<9, T>(a, k, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t slots = (size_t)R * Tn;
  const int threads = 256;
  near_field_finish_kernel<T><<<static_cast<unsigned>((slots + threads - 1) / threads),
                                threads, 0, st>>>(reinterpret_cast<const int2*>(segtab), tcnt,
                                                  part, out, R, Tn, nspan, nrhs);
  return static_cast<int>(cudaGetLastError());
}

int launch_grad(const double* tgt, const double* src, const double* w, const int* nbr,
                const int* cnt, double* out, double* gout, int R, int Tn, int d, int ds, int S,
                int L1, int U, int nrhs, int code, double s2, double ip2, double near_slope,
                double far_coef, double total_sill, double far_grad, int pw, void* stream) {
  cudaGetLastError();  // clear a stale error so the return reports this launch
  if (R == 0 || Tn == 0 || nrhs == 0) return 0;
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, far_grad};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nrhs == 1)
    launch_grad_nr<1>(tgt, src, w, nbr, cnt, out, gout, R, Tn, d, ds, S, L1, U, nrhs, k, st);
  else if (nrhs == 2)
    launch_grad_nr<2>(tgt, src, w, nbr, cnt, out, gout, R, Tn, d, ds, S, L1, U, nrhs, k, st);
  else if (nrhs <= 4)
    launch_grad_nr<4>(tgt, src, w, nbr, cnt, out, gout, R, Tn, d, ds, S, L1, U, nrhs, k, st);
  else
    launch_grad_nr<8>(tgt, src, w, nbr, cnt, out, gout, R, Tn, d, ds, S, L1, U, nrhs, k, st);
  return static_cast<int>(cudaGetLastError());
}

// One H4 launch; NR (the rhs block of one thread) is 1, 2, 4 or 8.
template <typename T, int NR>
void launch_cells_nr(const T* tgt, const int* cells, const int* cnt, const double* centers,
                     const double* lengths, const double* nodes, const T* mult, T* out,
                     double* gout, int R, int Tn, int d, int P, int ncells, int U, int nrhs,
                     const KernelArgs& k, cudaStream_t stream) {
  const dim3 grid(R, (Tn + kBlock - 1) / kBlock, (nrhs + NR - 1) / NR);
  if constexpr (std::is_same<T, double>::value) {
    if (gout) {
      near_field_cells_grad_kernel<NR><<<grid, kBlock, 0, stream>>>(
          tgt, cells, cnt, centers, lengths, nodes, mult, out, gout, R, Tn, d, P, ncells, U,
          nrhs, k);
      return;
    }
  }
  near_field_cells_kernel<T, NR><<<grid, kBlock, 0, stream>>>(
      tgt, cells, cnt, centers, lengths, nodes, mult, out, R, Tn, d, P, ncells, U, nrhs, k);
}

// H4 values (gout null) or values and gradients (T = double). Returns the
// launch's CUDA error code (0 on success).
template <typename T>
int launch_cells(const T* tgt, const int* cells, const int* cnt, const double* centers,
                 const double* lengths, const double* nodes, const T* mult, T* out,
                 double* gout, int R, int Tn, int d, int P, int ncells, int U, int nrhs,
                 const KernelArgs& k, void* stream) {
  cudaGetLastError();  // clear a stale error so the return reports this launch
  if (R == 0 || Tn == 0 || nrhs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nrhs == 1)
    launch_cells_nr<T, 1>(tgt, cells, cnt, centers, lengths, nodes, mult, out, gout, R, Tn, d,
                          P, ncells, U, nrhs, k, st);
  else if (nrhs == 2)
    launch_cells_nr<T, 2>(tgt, cells, cnt, centers, lengths, nodes, mult, out, gout, R, Tn, d,
                          P, ncells, U, nrhs, k, st);
  else if (nrhs <= 4)
    launch_cells_nr<T, 4>(tgt, cells, cnt, centers, lengths, nodes, mult, out, gout, R, Tn, d,
                          P, ncells, U, nrhs, k, st);
  else
    launch_cells_nr<T, 8>(tgt, cells, cnt, centers, lengths, nodes, mult, out, gout, R, Tn, d,
                          P, ncells, U, nrhs, k, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int near_field_f32(const float* tgt, const float* src, const float* w, const int* items,
                   const int* entries, const int* segtab, const int* tcnt, float* out,
                   float* part, int R, int Tn, int d, int ds, int S, int nitems, int nspan,
                   int nrhs, int code, double s2, double ip2, double near_slope,
                   double far_coef, double total_sill, int pw, void* stream) {
  return launch<float>(tgt, src, w, items, entries, segtab, tcnt, out, part, R, Tn, d, ds, S,
                       nitems, nspan, nrhs, code, s2, ip2, near_slope, far_coef, total_sill,
                       pw, stream);
}

int near_field_f64(const double* tgt, const double* src, const double* w, const int* items,
                   const int* entries, const int* segtab, const int* tcnt, double* out,
                   double* part, int R, int Tn, int d, int ds, int S, int nitems, int nspan,
                   int nrhs, int code, double s2, double ip2, double near_slope,
                   double far_coef, double total_sill, int pw, void* stream) {
  return launch<double>(tgt, src, w, items, entries, segtab, tcnt, out, part, R, Tn, d, ds, S,
                        nitems, nspan, nrhs, code, s2, ip2, near_slope, far_coef, total_sill,
                        pw, stream);
}

int near_field_grad_f64(const double* tgt, const double* src, const double* w, const int* nbr,
                        const int* cnt, double* out, double* gout, int R, int Tn, int d,
                        int ds, int S, int L1, int U, int nrhs, int code, double s2,
                        double ip2, double near_slope, double far_coef, double total_sill,
                        double far_grad, int pw, void* stream) {
  return launch_grad(tgt, src, w, nbr, cnt, out, gout, R, Tn, d, ds, S, L1, U, nrhs, code, s2,
                     ip2, near_slope, far_coef, total_sill, far_grad, pw, stream);
}

int near_field_cells_f32(const float* tgt, const int* cells, const int* cnt,
                         const double* centers, const double* lengths, const double* nodes,
                         const float* mult, float* out, int R, int Tn, int d, int P, int ncells,
                         int U, int nrhs, int code, double s2, double ip2, double near_slope,
                         double far_coef, double total_sill, int pw, void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, 0.0};
  return launch_cells<float>(tgt, cells, cnt, centers, lengths, nodes, mult, out, nullptr, R,
                             Tn, d, P, ncells, U, nrhs, k, stream);
}

int near_field_cells_f64(const double* tgt, const int* cells, const int* cnt,
                         const double* centers, const double* lengths, const double* nodes,
                         const double* mult, double* out, int R, int Tn, int d, int P,
                         int ncells, int U, int nrhs, int code, double s2, double ip2,
                         double near_slope, double far_coef, double total_sill, int pw,
                         void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, 0.0};
  return launch_cells<double>(tgt, cells, cnt, centers, lengths, nodes, mult, out, nullptr, R,
                              Tn, d, P, ncells, U, nrhs, k, stream);
}

int near_field_cells_grad_f64(const double* tgt, const int* cells, const int* cnt,
                              const double* centers, const double* lengths, const double* nodes,
                              const double* mult, double* out, double* gout, int R, int Tn,
                              int d, int P, int ncells, int U, int nrhs, int code, double s2,
                              double ip2, double near_slope, double far_coef, double total_sill,
                              double far_grad, int pw, void* stream) {
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, far_grad};
  return launch_cells<double>(tgt, cells, cnt, centers, lengths, nodes, mult, out, gout, R, Tn,
                              d, P, ncells, U, nrhs, k, stream);
}

const char* near_field_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
