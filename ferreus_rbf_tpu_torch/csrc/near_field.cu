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
// weights are zero by construction. H3 also computes
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
// split dots); on Hopper one count-aware neighbour loop per precision
// computes what all of them compute. A row's pair list is its neighbour
// list with counts.
//
// What bounds it on this card: the phi evaluation on the CUDA cores, one
// sqrt (or log, or divide) per (target, source) pair plus ~3 + 2 * nrhs
// FMAs. In f32 that is the FP32 pipe and the MUFU unit; in f64 it is the
// FP64 pipe (half the FP32 rate on H100 SXM) and the software sqrt/log
// sequences. Neighbour tiles are re-read by every row that lists them, but
// a tile is (d + nrhs) x S values, a few KB, and all tiles of a config-2
// matvec (100k points, 8 RHS: ~6 MB in f32, ~11 MB in f64) fit in the
// 50 MB L2, so device-memory traffic is not the limit. H4's staging adds
// 3 f64 multiply-adds per staged node against 128 pair evaluations per node
// in a 128-target block: a small share.
//
// H3 does the same pair loop with phi and g from one shared sqrt (or log)
// per pair and (1 + d) * NR FMAs instead of NR: it is bound by the FP64
// pipe and the f64 sqrt/divide sequences, like H2, at ~4x H2's FMAs.
//
// Design: one block per (row, 128-target chunk, rhs block). Each thread
// owns one target and keeps its NR right-hand-side sums in registers
// (H3: NR values and 3 * NR gradient sums, 32 f64 accumulators at NR = 8). The
// block walks the row's neighbour list; for each neighbour tile it stages
// 128 sources at a time (coordinates and weights) through shared memory,
// and every thread reads them as broadcasts. No atomics, no cross-block
// reduction: every output element is written once. H4 has the same layout
// and inner loop in kernels of its own: sharing H1-H3's loop through a
// source policy took H1 at one right-hand side from 29 to 36 registers and
// cost it 8-9% (lower occupancy), measured on the H100.

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

// phi(r2) for the ten registry kernels; same formulas as ops/kernels.py.
template <typename T>
__device__ __forceinline__ T phi(T r2, const KernelArgs& k) {
  const T eps = T(2.220446049250313e-16);
  const T r2p = r2 > T(0) ? r2 : T(0);
  switch (k.code) {
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
      for (int i = 1; i < k.pw; ++i) tp *= t;
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

template <typename T, int NR>
__global__ void __launch_bounds__(kBlock)
near_field_kernel(const T* __restrict__ tgt,    // (R, Tn, d)
                  const T* __restrict__ src,    // (L + 1, ds, S)
                  const T* __restrict__ w,      // (L + 1, nrhs, S)
                  const int* __restrict__ nbr,  // (U, R)
                  const int* __restrict__ cnt,  // (R,) or null
                  T* __restrict__ out,          // (R, Tn, nrhs)
                  int R, int Tn, int d, int ds, int S, int L, int U, int nrhs,
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
    const int l = nbr[(size_t)u * R + r];  // block-uniform
    if (l == L) continue;
    const T* sp = src + (size_t)l * ds * S;
    const T* wp = w + ((size_t)l * nrhs + rhs0) * S;
    for (int s0 = 0; s0 < S; s0 += kBlock) {
      const int j = s0 + threadIdx.x;
      const bool in = j < S;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        s_y[i][threadIdx.x] = (in && i < d) ? sp[(size_t)i * S + j] : T(0);
#pragma unroll
      for (int q = 0; q < NR; ++q)
        s_w[q][threadIdx.x] = (in && rhs0 + q < nrhs) ? wp[(size_t)q * S + j] : T(0);
      __syncthreads();
      const int n = min(kBlock, S - s0);
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

template <typename T, int NR>
void launch_nr(const T* tgt, const T* src, const T* w, const int* nbr, const int* cnt,
               T* out, int R, int Tn, int d, int ds, int S, int L1, int U, int nrhs,
               const KernelArgs& k, cudaStream_t stream) {
  const dim3 grid(R, (Tn + kBlock - 1) / kBlock, (nrhs + NR - 1) / NR);
  near_field_kernel<T, NR><<<grid, kBlock, 0, stream>>>(
      tgt, src, w, nbr, cnt, out, R, Tn, d, ds, S, L1 - 1, U, nrhs, k);
}

template <typename T>
int launch(const T* tgt, const T* src, const T* w, const int* nbr, const int* cnt, T* out,
           int R, int Tn, int d, int ds, int S, int L1, int U, int nrhs, int code,
           double s2, double ip2, double near_slope, double far_coef, double total_sill,
           int pw, void* stream) {
  cudaGetLastError();  // clear a stale error so the return reports this launch
  if (R == 0 || Tn == 0 || nrhs == 0) return 0;
  const KernelArgs k{code, pw, s2, ip2, near_slope, far_coef, total_sill, 0.0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nrhs == 1)
    launch_nr<T, 1>(tgt, src, w, nbr, cnt, out, R, Tn, d, ds, S, L1, U, nrhs, k, st);
  else if (nrhs == 2)
    launch_nr<T, 2>(tgt, src, w, nbr, cnt, out, R, Tn, d, ds, S, L1, U, nrhs, k, st);
  else if (nrhs <= 4)
    launch_nr<T, 4>(tgt, src, w, nbr, cnt, out, R, Tn, d, ds, S, L1, U, nrhs, k, st);
  else
    launch_nr<T, 8>(tgt, src, w, nbr, cnt, out, R, Tn, d, ds, S, L1, U, nrhs, k, st);
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

int near_field_f32(const float* tgt, const float* src, const float* w, const int* nbr,
                   const int* cnt, float* out, int R, int Tn, int d, int ds, int S, int L1,
                   int U, int nrhs, int code, double s2, double ip2, double near_slope,
                   double far_coef, double total_sill, int pw, void* stream) {
  return launch<float>(tgt, src, w, nbr, cnt, out, R, Tn, d, ds, S, L1, U, nrhs, code, s2,
                       ip2, near_slope, far_coef, total_sill, pw, stream);
}

int near_field_f64(const double* tgt, const double* src, const double* w, const int* nbr,
                   const int* cnt, double* out, int R, int Tn, int d, int ds, int S, int L1,
                   int U, int nrhs, int code, double s2, double ip2, double near_slope,
                   double far_coef, double total_sill, int pw, void* stream) {
  return launch<double>(tgt, src, w, nbr, cnt, out, R, Tn, d, ds, S, L1, U, nrhs, code, s2,
                        ip2, near_slope, far_coef, total_sill, pw, stream);
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
